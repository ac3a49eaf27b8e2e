// Per-leaf-block Gram contractions shared by the tree kernels.
//
// The chain: every entry (i, j) of Sigma = Wb^T Wb for one leaf block Wb
// (block rows of R floats, row-major) is one float32 FMA chain
//     acc = 0;  for r = 0 .. block-1:  acc = fmaf(Wb[r][i], Wb[r][j], acc)
// in that fixed order (no TF32, no split sums).  Any kernel that runs this
// chain on the same rows produces the same bits, so a full build and a later
// rebuild of selected blocks agree exactly, which the dynamic-catalog tree
// maintenance requires.  The chain is also symmetric bit for bit: fmaf
// rounds once, after the exact product, and Wb[r][i] * Wb[r][j] ==
// Wb[r][j] * Wb[r][i], so entry (j, i) may be written as a copy of (i, j).
//
// gram_stage_rows, gram_tri_tile and gram_tile_8x8 below run the chain as
// block_outer_sums_kernel (tree_sum.cu) schedules it for both of its entry
// points, block_outer_sums and gathered_block_grams: one 8 x 8 register
// tile a thread, the upper triangle of tiles only, 16 floats loaded a row
// for 64 FMAs.
#pragma once

#include "cp_async.cuh"

namespace repro_torch {

// Columns are grouped in T = ceil(R / 8) tiles of 8; tile t is columns
// 8t .. 8t+7.  A staged row holds 8T floats as two halves of T float4s:
// half h, float4 t is columns 8t + 4h .. 8t + 4h + 3 (zero past R).  So the
// threads of a warp that read consecutive tiles read consecutive float4s
// (no bank conflict), and a thread reads its tile's 8 columns as two
// 16-byte loads.
constexpr int kGramReg = 8;  // a thread's output tile: kGramReg x kGramReg

__host__ __device__ __forceinline__ int gram_col_tiles(int R) {
  return (R + kGramReg - 1) / kGramReg;
}

// Stage rows r0 .. r0+rows-1 of the block wb into s (rows x 8T floats, the
// layout above).  vec: R % 4 == 0 and wb 16-byte aligned, so every group of
// 4 columns is one 16-byte cp.async.  Called by every thread of the CTA;
// the caller synchronises the CTA after it.
__device__ __forceinline__ void gram_stage_rows(
    const float* __restrict__ wb, int R, int T, int r0, int rows,
    float* __restrict__ s, bool vec) {
  const int per_row = 2 * T;  // float4s a staged row
  float4* s4 = reinterpret_cast<float4*>(s);
  if (vec) {
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int r = e / per_row, q = e - r * per_row;  // columns 4q .. 4q+3
      float4* dst = s4 + (long long)r * per_row + (q & 1) * T + (q >> 1);
      if (4 * q < R)
        cp_async16(dst, wb + (long long)(r0 + r) * R + 4 * q);
      else
        *dst = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    const int width = 8 * T;
    for (int e = threadIdx.x; e < rows * width; e += blockDim.x) {
      const int r = e / width, c = e - r * width;
      s[(long long)r * width + ((c >> 2) & 1) * 4 * T + (c >> 3) * 4 +
        (c & 3)] = c < R ? wb[(long long)(r0 + r) * R + c] : 0.f;
    }
  }
}

// The p-th tile (ti, tj) of the upper triangle of T x T tiles, column by
// column: p = tj (tj + 1) / 2 + ti, 0 <= ti <= tj.  Neighbouring threads
// take neighbouring ti under one tj: their row operands are consecutive
// float4s, their column operand one broadcast.
__device__ __forceinline__ void gram_tri_tile(int p, int& ti, int& tj) {
  int j = (int)((sqrtf(8.f * (float)p + 1.f) - 1.f) * 0.5f);
  while (j > 0 && j * (j + 1) / 2 > p) --j;
  while ((j + 1) * (j + 2) / 2 <= p) ++j;
  tj = j;
  ti = p - j * (j + 1) / 2;
}

// acc[a][b] = fmaf(W[r][8ti + a], W[r][8tj + b], acc[a][b]) for the staged
// rows r = 0 .. rows-1 in order: the chain above for entry
// (8ti + a, 8tj + b), continued across calls on consecutive row chunks.
__device__ __forceinline__ void gram_tile_8x8(
    const float* __restrict__ s, int T, int rows, int ti, int tj,
    float (&acc)[kGramReg][kGramReg]) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const int per_row = 2 * T;
#pragma unroll 2
  for (int r = 0; r < rows; ++r) {
    const float4* row = s4 + (long long)r * per_row;
    const float4 a0 = row[ti], a1 = row[T + ti];
    const float4 b0 = row[tj], b1 = row[T + tj];
    const float a[kGramReg] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[kGramReg] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int x = 0; x < kGramReg; ++x)
#pragma unroll
      for (int y = 0; y < kGramReg; ++y)
        acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
  }
}

}  // namespace repro_torch
