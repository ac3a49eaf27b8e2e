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
// Design: descend_score's leaf stage without the descent (spec_round.cu).
// One CTA of 512 threads per lane; Q_n is copied once into dynamic shared
// memory (160 KB at R = 200) when R <= kMaxR, else read from global memory
// (L1/L2), and each warp scores rows with leaf_score.cuh's
// leaf_block_scores, the very code of descend_score's leaf stage, so a
// block's scores are bit-equal to descend_score's raw scores of that block.
//
// bilinear replaces bilinear_pallas (_bilinear_kernel): p[m] =
// z_m^T W z_m over the rows of Z (M, R) against one R x R matrix, float32
// or bfloat16 inputs, float32 accumulation and output.  It is score_all at
// C = 1: quad_form.cuh's tile, whose per-row arithmetic does not depend on
// M or on the row's place, so bilinear_sharded's slices are bit-equal to
// one call over all rows.  Bound: operations, M R(R+1) + R^2 FLOP (42.2
// GFLOP, 0.63 ms at M = 2^20, R = 200) against (M R + R^2 + M) floats read
// and written (0.84 GB, 0.25 ms); the tile does the full 2 M R^2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "leaf_score.cuh"
#include "quad_form.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 224;  // Q on chip up to here, as in descend_score

template <bool kQOnChip>
__global__ void __launch_bounds__(kThreads)
bilinear_batched_kernel(const float* __restrict__ Z,
                        const float* __restrict__ Q, int B, int R,
                        float* __restrict__ out) {
  extern __shared__ float leaf_smem[];
  const long long n = blockIdx.x;
  const long long RR = (long long)R * R;
  const float* qn = Q + n * RR;
  float* stage = leaf_smem;                  // kWarps * R: one row per warp
  const float* q = qn;
  if (kQOnChip) {
    float* sq = leaf_smem + kWarps * R;      // R * R
    for (long long e = threadIdx.x; e < RR; e += kThreads) sq[e] = qn[e];
    __syncthreads();
    q = sq;
  }
  repro_torch::leaf_block_scores(Z + n * B * R, q, B, R, stage, out + n * B);
}

}  // namespace

// Z: (N, B, R) float32, Q: (N, R, R) float32, out: (N, B) float32, all
// contiguous on the current device.  Launches on `stream`; returns the
// cudaError_t of the set-up or the launch.
extern "C" int bilinear_batched_launch(const float* Z, const float* Q,
                                       float* out, long long N, int B, int R,
                                       void* stream) {
  if (N <= 0 || B <= 0) return cudaSuccess;
  if (R <= 0 || N > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= kMaxR) {
    const size_t smem = ((size_t)kWarps * R + (size_t)R * R) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        bilinear_batched_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    bilinear_batched_kernel<true><<<(unsigned)N, kThreads, smem, s>>>(
        Z, Q, B, R, out);
  } else {
    const size_t smem = (size_t)kWarps * R * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        bilinear_batched_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    bilinear_batched_kernel<false><<<(unsigned)N, kThreads, smem, s>>>(
        Z, Q, B, R, out);
  }
  return cudaGetLastError();
}

// Z: (M, R), W: (R, R), both float32 (bf16 == 0) or both bfloat16
// (bf16 == 1); out: (M,) float32; all contiguous on the current device.
// Launches on `stream`; returns the cudaError_t of the set-up or the
// launch.
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
