// score_all: the MCMC all-candidate move scorer on Hopper.
//
// Replaces the TPU kernel repro/kernels/mcmc_score/mcmc_score.py::
// score_all_pallas (_score_all_kernel): s[c, m] = z_m^T A_c z_m for every
// row z_m of Z (M, R) and every chain's score matrix A_c (C, R, R).  The
// greedy start of the fixed-size MCMC chain (core/mcmc.py::_greedy_round)
// calls it once per round over the whole catalog.
//
// Bound on the H100: operations.  A quadratic form sees only the
// symmetric part of its matrix, z^T A z = z^T ((A + A^T) / 2) z, so the
// least work is C R^2 to symmetrize plus C M R (R + 1) FLOP over i <= j
// (42 GFLOP at C = 1, M = 2^20, R = 200: 0.63 ms at the 67 TFLOP/s fp32
// peak) against (M R + C R^2 + C M) * 4 bytes (0.84 GB, 0.25 ms at
// 3.35 TB/s).  This kernel does the full 2 C M R^2 FLOP instead (twice
// the bound's count): it keeps A_c as given.
//
// Design: one CTA per (chain c, tile of 64 rows of Z), 128 threads.  The
// tile is staged once in shared memory, transposed (zs[k][row]), and A_c
// streams through shared memory in panels of 32 columns, so each CTA reads
// A_c once.  Each thread owns a 4-row x 4-column register block of the
// tile's z_m A_c panel (16 float32 FMAs per two 16-byte shared loads);
// at the end of a panel it reduces its block against z_m's matching
// columns in registers, and the 8 threads of a row group add their
// partial sums by warp shuffles.  float32 FMA only, no TF32: the
// reference's contract is full float32.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                 // rows of Z per CTA
constexpr int kPanel = 32;                // columns of A_c per panel
constexpr int kThreadsX = kPanel / 4;     // 8 column groups of 4
constexpr int kThreadsY = kRows / 4;      // 16 row groups of 4
constexpr int kZStride = kRows + 4;       // padded, keeps float4 alignment

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
score_all_kernel(const float* __restrict__ Z, const float* __restrict__ A,
                 float* __restrict__ out, long long M, int R) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);     // [R][kZStride]
  float* as = zs + (long long)R * kZStride;        // [R][kPanel]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int nthreads = kThreadsX * kThreadsY;
  const long long m0 = (long long)blockIdx.x * kRows;
  const int c = blockIdx.y;
  const float* a_c = A + (long long)c * R * R;

  // the row tile, transposed; rows past M are zeros
  for (int idx = tid; idx < kRows * R; idx += nthreads) {
    const int row = idx / R, k = idx % R;
    const long long m = m0 + row;
    zs[k * kZStride + row] = (m < M) ? Z[m * R + k] : 0.f;
  }

  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p0 = 0; p0 < R; p0 += kPanel) {
    __syncthreads();  // the tile is staged; the previous panel is consumed
    for (int idx = tid; idx < R * kPanel; idx += nthreads) {
      const int k = idx / kPanel, col = p0 + idx % kPanel;
      as[idx] = (col < R) ? a_c[(long long)k * R + col] : 0.f;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < R; ++k) {
      const float4 zv = *reinterpret_cast<const float4*>(
          zs + k * kZStride + ty * 4);
      const float4 av = *reinterpret_cast<const float4*>(
          as + k * kPanel + tx * 4);
      const float z[4] = {zv.x, zv.y, zv.z, zv.w};
      const float a[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(z[i], a[j], acc[i][j]);
    }
    // (z_m A_c)[col] * z_m[col] over this thread's four columns
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = p0 + tx * 4 + j;
      if (col < R) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          part[i] = fmaf(acc[i][j], zs[col * kZStride + ty * 4 + i], part[i]);
      }
    }
  }
  // the 8 threads of a row group are 8 adjacent lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = kThreadsX / 2; off > 0; off >>= 1)
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + ty * 4 + i;
      if (m < M) out[(long long)c * M + m] = part[i];
    }
  }
}

}  // namespace

// Z: (M, R) float32, A: (C, R, R) float32, out: (C, M) float32, all
// contiguous on the current device.  Launches on `stream`; returns the
// cudaError_t of the set-up or the launch.
extern "C" int score_all_launch(const float* Z, const float* A, float* out,
                                long long M, int C, int R, void* stream) {
  if (M <= 0 || C <= 0) return cudaSuccess;
  if (R <= 0 || C > 65535) return cudaErrorInvalidValue;
  const size_t smem = (size_t)R * (kZStride + kPanel) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      score_all_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (M + kRows - 1) / kRows;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)tiles, (unsigned)C);
  dim3 threads(kThreadsX, kThreadsY);
  score_all_kernel<<<grid, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(Z, A, out, M, R);
  return cudaGetLastError();
}
