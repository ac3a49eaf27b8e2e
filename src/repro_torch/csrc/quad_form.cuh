// The quadratic-form tile shared by score_all (mcmc_score.cu) and bilinear
// (bilinear.cu): s[c, m] = z_m^T A_c z_m for every row z_m of Z (M, R) and
// every matrix A_c (C, R, R), accumulated in float32.
//
// Design: one CTA per (matrix c, tile of 64 rows of Z), 128 threads.  The
// tile is staged once in shared memory as float32, transposed
// (zs[k][row]), and A_c streams through shared memory in panels of 32
// columns, so each CTA reads A_c once.  Each thread owns a 4-row x
// 4-column register block of the tile's z_m A_c panel (16 float32 FMAs per
// two 16-byte shared loads); at the end of a panel it reduces its block
// against z_m's matching columns in registers, and the 8 threads of a row
// group add their partial sums by warp shuffles.  float32 FMA only, no
// TF32.  A row's arithmetic depends on its own z_m and A_c only, never on
// M or on where the row sits, so scoring a slice of Z's rows gives the
// same bits as scoring all of them (the sharded scorers rely on that).
// T is float or __nv_bfloat16; bfloat16 inputs are widened to float32 as
// they are staged.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kQuadRows = 64;                 // rows of Z per CTA
constexpr int kQuadPanel = 32;                // columns of A_c per panel
constexpr int kQuadThreadsX = kQuadPanel / 4; // 8 column groups of 4
constexpr int kQuadThreadsY = kQuadRows / 4;  // 16 row groups of 4
constexpr int kQuadZStride = kQuadRows + 4;   // padded, keeps float4 alignment

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kQuadThreadsX * kQuadThreadsY)
quad_form_kernel(const T* __restrict__ Z, const T* __restrict__ A,
                 float* __restrict__ out, long long M, int R) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);     // [R][kQuadZStride]
  float* as = zs + (long long)R * kQuadZStride;    // [R][kQuadPanel]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kQuadThreadsX + tx;
  const int nthreads = kQuadThreadsX * kQuadThreadsY;
  const long long m0 = (long long)blockIdx.x * kQuadRows;
  const int c = blockIdx.y;
  const T* a_c = A + (long long)c * R * R;

  // the row tile, transposed; rows past M are zeros
  for (int idx = tid; idx < kQuadRows * R; idx += nthreads) {
    const int row = idx / R, k = idx % R;
    const long long m = m0 + row;
    zs[k * kQuadZStride + row] = (m < M) ? to_f32(Z[m * R + k]) : 0.f;
  }

  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p0 = 0; p0 < R; p0 += kQuadPanel) {
    __syncthreads();  // the tile is staged; the previous panel is consumed
    for (int idx = tid; idx < R * kQuadPanel; idx += nthreads) {
      const int k = idx / kQuadPanel, col = p0 + idx % kQuadPanel;
      as[idx] = (col < R) ? to_f32(a_c[(long long)k * R + col]) : 0.f;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < R; ++k) {
      const float4 zv = *reinterpret_cast<const float4*>(
          zs + k * kQuadZStride + ty * 4);
      const float4 av = *reinterpret_cast<const float4*>(
          as + k * kQuadPanel + tx * 4);
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
          part[i] = fmaf(acc[i][j], zs[col * kQuadZStride + ty * 4 + i],
                         part[i]);
      }
    }
  }
  // the 8 threads of a row group are 8 adjacent lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = kQuadThreadsX / 2; off > 0; off >>= 1)
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

// Z: (M, R), A: (C, R, R), both T; out: (C, M) float32; all contiguous on
// the current device.  Launches on `stream`; returns the cudaError_t of
// the set-up or the launch.
template <typename T>
int quad_form_launch(const T* Z, const T* A, float* out, long long M, int C,
                     int R, void* stream) {
  if (M <= 0 || C <= 0) return cudaSuccess;
  if (R <= 0 || C > 65535) return cudaErrorInvalidValue;
  const size_t smem = (size_t)R * (kQuadZStride + kQuadPanel) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      quad_form_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (M + kQuadRows - 1) / kQuadRows;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)tiles, (unsigned)C);
  dim3 threads(kQuadThreadsX, kQuadThreadsY);
  quad_form_kernel<T><<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(Z, A, out, M, R);
  return cudaGetLastError();
}

}  // namespace repro_torch
