// bilinear_batched and bilinear: batched quadratic forms on Hopper.
//
// bilinear_batched replaces the TPU kernel repro/kernels/bilinear/
// bilinear.py::bilinear_batched_pallas (_bilinear_batched_kernel):
// p[n, b] = z_{n,b}^T Q_n z_{n,b} for N lanes, each with its own (B, R)
// rows and R x R matrix.  It scores the leaf blocks of the item-sharded
// tree descent (core/tree.py, the sharded branch of
// sample_elementary_batch), where every shard scores the lanes whose
// block it owns.
//
// Bound on the H100: bytes.  A lane reads its Q_n (R^2 floats) and its
// rows (B R floats) once and does about R(R+1) FLOP a row on the
// symmetric part of Q_n: at the sharded path's shape (N = 64 lanes,
// B = 64, R = 200) 13.5 MB (4.0 us at 3.35 TB/s) against 165 MFLOP
// (2.5 us at 67 TFLOP/s).
//
// Design: a CTA of 4 warps takes 32 rows of one lane, so the sharded
// path's 64 lanes x 64 rows run as 128 CTAs on the 132 SMs, and each warp
// scores 8 rows at once with leaf_score.cuh's functions, which
// descend_score's leaf stage runs too: a shared-memory load of q[i][j]
// feeds 8 FMAs, and column i of its 8 rows (staged transposed) comes in as
// two 16-byte broadcasts.  Q_n is copied into shared memory with cp.async
// in two halves of its rows (up to R = kMaxR, 196 KB), the first half's
// FMAs running while the second lands; above kMaxR it is read from global
// memory (L1/L2), 224 columns a pass.  The chains are leaf_score.cuh's, so
// a block's scores are bit-equal to descend_score's raw scores of that
// block.
//
// bilinear replaces bilinear_pallas (_bilinear_kernel): p[m] =
// z_m^T W z_m over the rows of Z (M, R) against one R x R matrix, float32
// or bfloat16 inputs, float32 accumulation and output.  It is score_all at
// C = 1: quad_form.cuh's kernel, the resident route up to R = 224 (the
// upper triangle of W + W^T held in shared memory, Z streamed through
// persistent CTAs), the panel route above; per-row arithmetic does not
// depend on M or on the row's place, so bilinear_sharded's slices are
// bit-equal to one call over all rows.  Bound: operations, M R(R+1) + R^2
// FLOP (42.2 GFLOP, 0.63 ms at M = 2^20, R = 200) against (M R + R^2) input
// elements and M float32 outputs (0.84 GB in float32, 0.25 ms; in bfloat16
// 0.42 GB, 0.13 ms, under the FMAs all the same: bfloat16 is widened
// before any arithmetic).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "leaf_score.cuh"
#include "quad_form.cuh"

namespace {

using repro_torch::kLeafSlots;
using repro_torch::leaf_butterfly;
using repro_torch::leaf_columns;
using repro_torch::leaf_partials;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = repro_torch::kLeafRows;  // a warp's rows at once
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;
constexpr int kMaxR = repro_torch::kLeafMaxR;          // Q on chip up to here
constexpr int kMaxSmem = 232448;                 // bytes a CTA may use

// One CTA per (lane n, group of kRowsPerCta rows); groups = ceil(B / 32).
// vec: R % 4 == 0 and Q 16-byte aligned (Q_n copied 16 bytes at a time).
template <bool kQOnChip>
__global__ void __launch_bounds__(kThreads)
bilinear_batched_kernel(const float* __restrict__ Z,
                        const float* __restrict__ Q, int B, int R,
                        int groups, bool vec, float* __restrict__ out) {
  extern __shared__ float4 leaf_smem[];
  float* zs = reinterpret_cast<float*>(leaf_smem);  // kRowsPerCta * R
  const long long n = blockIdx.x / groups;
  const int row0 = (int)(blockIdx.x % groups) * kRowsPerCta;
  const long long RR = (long long)R * R;
  const float* qn = Q + n * RR;
  const float* zn = Z + n * B * R;
  const int half = R / 2;  // Q's rows 0 .. half-1 land first
  float* sq = zs + kRowsPerCta * R;                 // R * R, on chip only
  if (kQOnChip) {
    const long long cut = (long long)half * R;
    if (vec) {
      for (long long e = threadIdx.x; 4 * e < cut; e += kThreads)
        repro_torch::cp_async16(sq + 4 * e, qn + 4 * e);
      repro_torch::cp_async_commit();
      for (long long e = cut / 4 + threadIdx.x; 4 * e < RR; e += kThreads)
        repro_torch::cp_async16(sq + 4 * e, qn + 4 * e);
    } else {
      for (long long e = threadIdx.x; e < cut; e += kThreads)
        repro_torch::cp_async4(sq + e, qn + e);
      repro_torch::cp_async_commit();
      for (long long e = cut + threadIdx.x; e < RR; e += kThreads)
        repro_torch::cp_async4(sq + e, qn + e);
    }
    repro_torch::cp_async_commit();
  }
  // The CTA's rows, transposed per warp: row row0 + 8w + t, column i at
  // zs[(w R + i) 8 + t]; rows past B are zero (scored, never written).
  for (int e = threadIdx.x; e < kRowsPerCta * R; e += kThreads) {
    const int t = e / R, i = e - t * R;
    const int row = row0 + t;
    zs[((t >> 3) * R + i) * kRowsPerWarp + (t & 7)] =
        row < B ? zn[(long long)row * R + i] : 0.f;
  }
  if (kQOnChip) repro_torch::cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* zw = zs + (long long)warp * R * kRowsPerWarp;
  float acc[kRowsPerWarp];
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) acc[t] = 0.f;
  for (int j0 = 0; j0 < R; j0 += kMaxR) {  // one pass when Q is on chip
    float c[kRowsPerWarp][kLeafSlots];
    int jc[kLeafSlots];  // past R: any valid column, its c is never used
#pragma unroll
    for (int k = 0; k < kLeafSlots; ++k) {
      jc[k] = min(j0 + 32 * k + lane, R - 1);
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t) c[t][k] = 0.f;
    }
    if (kQOnChip) {
      leaf_columns(zw, sq, R, 0, half, jc, c);
      repro_torch::cp_async_wait<0>();
      __syncthreads();
      leaf_columns(zw, sq, R, half, R, jc, c);
    } else {
      leaf_columns(zw, qn, R, 0, R, jc, c);
    }
    leaf_partials(zw, R, j0, lane, c, acc);
  }
  const float mine = leaf_butterfly(acc, lane);
  const int row = row0 + warp * kRowsPerWarp + lane;
  if (lane < kRowsPerWarp && row < B) out[n * B + row] = mine;
}

}  // namespace

// Z: (N, B, R) float32, Q: (N, R, R) float32, out: (N, B) float32, all
// contiguous on the current device.  Launches on `stream`; returns the
// cudaError_t of the set-up or the launch.
extern "C" int bilinear_batched_launch(const float* Z, const float* Q,
                                       float* out, long long N, int B, int R,
                                       void* stream) {
  if (N <= 0 || B <= 0) return cudaSuccess;
  if (R <= 0) return cudaErrorInvalidValue;
  const int groups = (B + kRowsPerCta - 1) / kRowsPerCta;
  if (N * groups > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool on_chip = R <= kMaxR;
  const size_t smem = ((size_t)kRowsPerCta * R +
                       (on_chip ? (size_t)R * R : 0)) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  const bool vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(Q) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)(N * groups);
  if (on_chip) {
    cudaError_t err = cudaFuncSetAttribute(
        bilinear_batched_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    bilinear_batched_kernel<true><<<grid, kThreads, smem, s>>>(
        Z, Q, B, R, groups, vec, out);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        bilinear_batched_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    bilinear_batched_kernel<false><<<grid, kThreads, smem, s>>>(
        Z, Q, B, R, groups, vec, out);
  }
  return cudaGetLastError();
}

// Z: (M, R), W: (R, R), both float32 (bf16 == 0) or both bfloat16
// (bf16 == 1); out: (M,) float32; all contiguous on the current device.
// Launches on `stream` on the route bilinear_route(R) gives; returns the
// cudaError_t of the set-up or the launch.
extern "C" int bilinear_launch(const void* Z, const void* W, float* out,
                               long long M, int R, int bf16, void* stream) {
  if (bf16)
    return repro_torch::quad_form_launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(Z),
        static_cast<const __nv_bfloat16*>(W), out, M, 1, R, stream);
  return repro_torch::quad_form_launch<float>(
      static_cast<const float*>(Z), static_cast<const float*>(W), out, M, 1,
      R, stream);
}

// The route bilinear_launch takes at width R: 1 "resident", 0 "panel".
extern "C" int bilinear_route(int R) {
  return repro_torch::quad_form_route(R);
}
