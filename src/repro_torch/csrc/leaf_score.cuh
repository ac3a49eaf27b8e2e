// Leaf-block scoring of descend_score (spec_round.cu).
//
// leaf_block_scores writes the raw scores z_b^T Q z_b of `block` rows
// z_b (row-major, R floats each) against one R x R projector Q.  Warp w
// scores rows w, w + n_warps, ...: the row is staged in shared memory,
// lane j accumulates column j, j + 32, ... of z^T Q as one float32 FMA
// chain over i = 0..R-1, multiplies it into z_j with a second FMA chain,
// and the warp adds its 32 partial sums by xor shuffles.  bilinear_batched
// (bilinear.cu) runs the very same chains and butterfly in another
// schedule (8 rows a warp), so its score of a block equals descend_score's
// raw score of the same block bit for bit: a change to the arithmetic here
// must be made there too.
#pragma once

namespace repro_torch {

// Must be called by every thread of the CTA (blockDim.x a multiple of 32).
// wb: the first row; q: Q, row-major, in shared or global memory; stage:
// (blockDim.x / 32) * R floats of shared memory; out: `block` scores.
__device__ __forceinline__ void leaf_block_scores(
    const float* __restrict__ wb, const float* __restrict__ q, int block,
    int R, float* __restrict__ stage, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  float* z = stage + warp * R;
  for (int b = warp; b < block; b += n_warps) {
    const float* src = wb + (long long)b * R;
    for (int i = lane; i < R; i += 32) z[i] = src[i];
    __syncwarp();
    float acc = 0.f;
    for (int j = lane; j < R; j += 32) {
      float c = 0.f;
      for (int i = 0; i < R; ++i) c = fmaf(z[i], q[i * R + j], c);
      acc = fmaf(c, z[j], acc);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[b] = acc;
    __syncwarp();
  }
}

}  // namespace repro_torch
