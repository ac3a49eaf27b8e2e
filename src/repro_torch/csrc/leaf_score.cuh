// Leaf-block scoring shared by descend_score (spec_round.cu) and
// bilinear_batched (bilinear.cu): the raw scores z_b^T Q z_b of rows z_b
// against one R x R matrix Q.
//
// The arithmetic, which both kernels run through these functions: for each
// column j, c_j = one float32 fmaf chain of z_b[i] q[i][j] over i =
// 0..R-1 from 0; lane l's partial = one fmaf(c_j, z_b[j], .) chain over
// its columns j = j0 + 32 k + l, k ascending (j0 = 0, kLeafMaxR, ... when
// Q is read in passes); then the xor butterfly 16, 8, 4, 2, 1.  So a
// block's scores from either kernel are equal bit for bit.
//
// The schedule: a warp scores kLeafRows = 8 rows at once, so a
// shared-memory load of q[i][j] feeds 8 FMAs, and column i of its 8 rows
// (staged transposed: zw[8 i + t] is row t's column i) comes in as two
// 16-byte broadcasts.
#pragma once

namespace repro_torch {

constexpr int kLeafRows = 8;                 // rows a warp scores at once
constexpr int kLeafSlots = 7;                // columns j0 + 32 k + lane, k < 7
constexpr int kLeafMaxR = 32 * kLeafSlots;   // columns of one pass

// c[t][k] = fmaf(z_t[i], q[i][jc[k]], c[t][k]) for i = i0 .. i1-1 in
// order.  zw: the warp's rows, transposed (column i's 8 values at zw[8i],
// 16-byte aligned).
__device__ __forceinline__ void leaf_columns(
    const float* __restrict__ zw, const float* __restrict__ q, int R,
    int i0, int i1, const int (&jc)[kLeafSlots],
    float (&c)[kLeafRows][kLeafSlots]) {
#pragma unroll 2
  for (int i = i0; i < i1; ++i) {
    const float4 za = *reinterpret_cast<const float4*>(zw + 8 * i);
    const float4 zb = *reinterpret_cast<const float4*>(zw + 8 * i + 4);
    const float z[kLeafRows] = {za.x, za.y, za.z, za.w,
                                zb.x, zb.y, zb.z, zb.w};
    const float* qi = q + (long long)i * R;
#pragma unroll
    for (int k = 0; k < kLeafSlots; ++k) {
      const float qv = qi[jc[k]];
#pragma unroll
      for (int t = 0; t < kLeafRows; ++t) c[t][k] = fmaf(z[t], qv, c[t][k]);
    }
  }
}

// acc[t] = fmaf(c[t][k], z_t[j], acc[t]) for the valid columns j = j0 +
// 32k + lane, k ascending.
__device__ __forceinline__ void leaf_partials(
    const float* __restrict__ zw, int R, int j0, int lane,
    const float (&c)[kLeafRows][kLeafSlots], float (&acc)[kLeafRows]) {
#pragma unroll
  for (int k = 0; k < kLeafSlots; ++k) {
    const int j = j0 + 32 * k + lane;
    if (j < R) {
      const float4 za = *reinterpret_cast<const float4*>(zw + 8 * j);
      const float4 zb = *reinterpret_cast<const float4*>(zw + 8 * j + 4);
      const float z[kLeafRows] = {za.x, za.y, za.z, za.w,
                                  zb.x, zb.y, zb.z, zb.w};
#pragma unroll
      for (int t = 0; t < kLeafRows; ++t)
        acc[t] = fmaf(c[t][k], z[t], acc[t]);
    }
  }
}

// The butterfly of each row's 32 lane partials; lane t < kLeafRows gets
// row t's score.
__device__ __forceinline__ float leaf_butterfly(float (&acc)[kLeafRows],
                                                int lane) {
  float mine = 0.f;
#pragma unroll
  for (int t = 0; t < kLeafRows; ++t) {
    for (int o = 16; o > 0; o >>= 1)
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
    if (lane == t) mine = acc[t];
  }
  return mine;
}

}  // namespace repro_torch
