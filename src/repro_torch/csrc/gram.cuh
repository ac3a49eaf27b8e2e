// Per-leaf-block Gram contraction shared by the tree kernels.
//
// block_gram_tile computes one 32 x 32 tile of Sigma = Wb^T Wb for one leaf
// block Wb (block rows of R floats, row-major).  Every entry is a float32
// FMA chain over rows 0..block-1 in that fixed order (no TF32, no split
// sums), so any kernel that calls this on the same rows produces the same
// bits: a full build and a later rebuild of selected blocks agree exactly,
// which the dynamic-catalog tree maintenance requires.  The chain is also
// symmetric bit for bit (W[r][i] * W[r][j] == W[r][j] * W[r][i]).
#pragma once

namespace repro_torch {

constexpr int kGramTile = 32;       // output tile edge
constexpr int kGramRowsY = 8;       // threadIdx.y extent: 4 outputs a thread
constexpr int kGramChunk = 32;      // rows staged in shared memory per pass

// Must be called by all kGramTile x kGramRowsY threads of the CTA.
// wb: the block's first row; out: the block's R x R output; (i0, j0): the
// tile's top-left entry.
__device__ __forceinline__ void block_gram_tile(
    const float* __restrict__ wb, int block, int R, int i0, int j0,
    float* __restrict__ out) {
  __shared__ float sa[kGramChunk][kGramTile + 1];
  __shared__ float sb[kGramChunk][kGramTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  float acc[kGramTile / kGramRowsY] = {0.f, 0.f, 0.f, 0.f};
  for (int r0 = 0; r0 < block; r0 += kGramChunk) {
    const int rows = min(kGramChunk, block - r0);
    for (int r = ty; r < rows; r += kGramRowsY) {
      const float* src = wb + (long long)(r0 + r) * R;
      sa[r][tx] = (i0 + tx < R) ? src[i0 + tx] : 0.f;
      sb[r][tx] = (j0 + tx < R) ? src[j0 + tx] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float b = sb[r][tx];
#pragma unroll
      for (int k = 0; k < kGramTile / kGramRowsY; ++k)
        acc[k] = fmaf(sa[r][ty + kGramRowsY * k], b, acc[k]);
    }
    __syncthreads();
  }
  const int j = j0 + tx;
  if (j < R) {
#pragma unroll
    for (int k = 0; k < kGramTile / kGramRowsY; ++k) {
      const int i = i0 + ty + kGramRowsY * k;
      if (i < R) out[(long long)i * R + j] = acc[k];
    }
  }
}

}  // namespace repro_torch
