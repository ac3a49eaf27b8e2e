// descend_score: one speculative-round lane's tree descent + leaf scoring
// on Hopper.
//
// Replaces the TPU kernel repro/kernels/spec_round/spec_round.py::
// descend_score_pallas (_descend_score_kernel).  Per lane n: walk the flat
// level-indexed tree from the root to a leaf block against the lane's
// R x R projector Q_n, going left iff u * max(p_all, 1e-30) <= max(p_left,
// 0) with p_left = <Q_n, Sigma_left> and the parent's mass carried down;
// then the raw leaf scores z_b^T Q_n z_b for the block's rows.
//
// Bound on the H100: bytes.  A lane reads its Q (R^2 floats), one left
// child per level (R^2 floats each) and its leaf block (block * R floats)
// and does about 2 FLOP per byte read, far below the card's fp32 balance
// point (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte).
//
// Design: one CTA of 512 threads per lane.  Q is read from HBM once into
// dynamic shared memory (160 KB at R = 200) and every <Q, Sigma> and every
// leaf bilinear form reads it from there; tree nodes stream from HBM/L2 in
// coalesced passes, so unlike the Pallas kernel (which holds the whole
// level stack in VMEM) the tree size is unbounded.  The on-chip Q sets a
// hard maximum R of kMaxR.  Thread 0 takes each decision with the
// reference's exact float32 expression and broadcasts it through shared
// memory.  depth == 0 (one leaf block) runs the same code with no levels.
// The leaf stage is leaf_score.cuh's, shared with bilinear_batched
// (bilinear.cu), so both give the same bits for the same block and Q.
// Faster designs (several lanes per CTA, Q split across a cluster, CUDA
// graphs around the round) are later work.
#include <cuda_runtime.h>

#include "leaf_score.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 224;

// Sum of v over the CTA; the result is valid in thread 0.
__device__ __forceinline__ float cta_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (warp == 0) {
    s = lane < kWarps ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
descend_score_kernel(const float* __restrict__ nodes,
                     const float* __restrict__ W,
                     const float* __restrict__ q,
                     const float* __restrict__ us, int us_stride, int depth,
                     int block, int R, long long* __restrict__ blk_out,
                     float* __restrict__ scores) {
  extern __shared__ float smem[];
  const long long RR = (long long)R * R;
  float* sq = smem;               // R*R: the lane's projector
  float* rows = sq + RR;          // kWarps*R: one leaf row per warp
  float* red = rows + kWarps * R; // 32: reduction scratch
  __shared__ long long s_idx;
  __shared__ float s_pall;

  const int tid = threadIdx.x;
  const long long n = blockIdx.x;
  const float* qn = q + n * RR;

  float part = 0.f;
  for (long long e = tid; e < RR; e += kThreads) {
    const float v = qn[e];
    sq[e] = v;
    part += v * nodes[e];          // the root: p_all = <Q, Sigma_root>
  }
  const float root = cta_sum(part, red);
  if (tid == 0) {
    s_pall = root;
    s_idx = 0;
  }
  __syncthreads();

  for (int lvl = 1; lvl <= depth; ++lvl) {
    const float* left = nodes + (((1LL << lvl) - 1) + 2 * s_idx) * RR;
    part = 0.f;
    for (long long e = tid; e < RR; e += kThreads) part += sq[e] * left[e];
    const float p_left = cta_sum(part, red);
    if (tid == 0) {
      const float p_all = s_pall;
      const float u = us[n * us_stride + (lvl - 1)];
      const bool go_left = u * fmaxf(p_all, 1e-30f) <= fmaxf(p_left, 0.f);
      s_idx = 2 * s_idx + (go_left ? 0 : 1);
      s_pall = fmaxf(go_left ? p_left : p_all - p_left, 0.f);
    }
    __syncthreads();
  }

  // leaf block: the shared leaf stage (leaf_score.cuh), Q from shared memory
  const long long idx = s_idx;
  repro_torch::leaf_block_scores(W + idx * block * R, sq, block, R, rows,
                                 scores + n * block);
  if (tid == 0) blk_out[n] = idx;
}

}  // namespace

extern "C" int descend_score_max_r() { return kMaxR; }

// nodes: (2^(depth+1) - 1, R, R) stacked tree levels, root first; W:
// (2^depth * block, R) leaf rows; q: (n, R, R); us: (n, us_stride) with
// us_stride >= depth; blk_out: (n,) int64; scores: (n, block).  All float32
// (but blk_out) and contiguous on the current device.  Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int descend_score_launch(const float* nodes, const float* W,
                                    const float* q, const float* us,
                                    int us_stride, long long n, int depth,
                                    int block, int R, long long* blk_out,
                                    float* scores, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (R <= 0 || R > kMaxR || block <= 0 || depth < 0 || depth > 40 ||
      us_stride < depth || n > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = ((size_t)R * R + (size_t)kWarps * R + 32) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      descend_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  descend_score_kernel<<<(unsigned)n, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      nodes, W, q, us, us_stride, depth, block, R, blk_out, scores);
  return cudaGetLastError();
}
