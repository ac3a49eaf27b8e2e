// descend_score: the speculative round's tree descent and leaf scoring, one
// lane a cluster of CTAs, on Hopper.
//
// Replaces the TPU kernel repro/kernels/spec_round/spec_round.py::
// descend_score_pallas (:57; body _descend_score_kernel, :30-53).  Per lane
// n: walk the flat level-indexed tree from the root to a leaf block against
// the lane's R x R projector Q_n, going left iff u * max(p_all, 1e-30) <=
// max(p_left, 0) with p_left = <Q_n, Sigma_left> and the parent's mass
// carried down; then the raw leaf scores z_b^T Q_n z_b of the block's rows.
//
// Bound on the H100: bytes.  A lane reads its Q (R^2 floats), one left
// child a level (R^2 floats, 160 KB at R = 200) and its leaf block, about
// 2 FLOP a byte, far below the card's fp32 balance point (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP a byte).  What holds it back is the chain: each
// level's address depends on the decision before it, so a lane makes
// depth + 1 dependent trips to L2 or HBM, and every byte of a level has to
// be in flight at once for a trip to cost one round trip.
//
// Design.  A lane is a cluster of c CTAs of 512 threads, one CTA an SM (Q
// fills most of its shared memory).  The caller picks c, a power of two
// <= 8 with N c <= the SM count (c = 2 at the main path's N = 64 on 132
// SMs; c = 1 once N reaches the SM count).
//   Q: every CTA holds all of Q_n in shared memory.  Thread 0 issues two
//     bulk copies (cp.async.bulk, completing on mbarriers): first the
//     CTA's own rows [k R / c, (k + 1) R / c), which its descent reads,
//     then the rest, which only the leaf stage reads and which lands
//     during the descent.  The c copies of a lane's Q are separate reads,
//     not a multicast; all but the first come mostly from L2.  The few
//     floats off the 16-byte grid, and a Q_n that is not 16-byte aligned
//     (odd R), are plain loads.  The root's loads are issued before the
//     wait for Q.
//   Descent: at each level CTA k reads only its rows of the left child
//     (80 KB at R = 200, c = 2) in 16-byte ld.global.nc loads, every
//     thread issuing ten before it uses the first, so the whole slice is
//     in flight at once.  Each warp sends its sum (a butterfly) into its
//     slot of every CTA of the cluster (st.async, completing on that CTA's
//     mbarrier); each thread waits on its own CTA's barrier alone and adds
//     the c x 16 sums in one fixed order.  So all of them take the same
//     decision, with the reference's float32 expression, with no CTA or
//     cluster barrier in the level and no broadcast, and two calls give
//     the same bits (no atomics).  The slots and their barriers are
//     double-buffered by the level's parity: a CTA sends level L + 2's
//     sums only once it holds every peer's sums of level L + 1, which each
//     peer sent after it had read level L's; a cluster barrier after the
//     last level keeps every CTA until its peers hold all it sent.
//   Leaf: CTA k scores rows k, k + c, ... of the chosen block with
//     leaf_score.cuh's functions, which bilinear_batched (bilinear.cu)
//     runs too, so both give the same bits for the same block and Q: a
//     warp takes 8 rows at once, staged transposed by cp.async, 32 rows a
//     round (one round at c = 2 and block 64).  One row a warp spends two
//     shared-memory loads on every FMA, so the shared-memory pipe bounds
//     it (~50 us for 32 rows at R = 200 on an H100); 8 rows a warp feed 8
//     FMAs with one.  CTA 0 writes the block id.
// depth == 0 (one leaf block) runs the same kernel with no levels.  The
// on-chip Q sets the largest R, kMaxR.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "leaf_score.cuh"

namespace {

using repro_torch::bulk_load;
using repro_torch::mbar_expect_tx;
using repro_torch::mbar_init;
using repro_torch::mbar_wait;

using repro_torch::kLeafRows;
using repro_torch::kLeafSlots;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = repro_torch::kLeafMaxR;  // 224: Q on chip, one pass
constexpr int kStageRows = 4 * kLeafRows;      // leaf rows staged a round
constexpr int kMaxCluster = 8;
constexpr int kMaxDepth = 40;
constexpr int kInFlight = 10;  // 16-byte loads a thread issues before its FMAs
constexpr int kMaxDevices = 64;
static_assert(kWarps <= 32, "one warp sums the warp sums");
static_assert(kStageRows <= kWarps * kLeafRows, "a staged row has a warp");

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_ctas() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives (release) and waits
// (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// v into `slot` of the cluster's CTA `rank`, completing 4 bytes on that
// CTA's `bar` (both given as this CTA's addresses; st.async).
__device__ __forceinline__ void send_to_peer(float* slot, uint64_t* bar,
                                             unsigned rank, float v) {
  uint32_t rs, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rs)
               : "r"(repro_torch::shared_addr(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rb)
               : "r"(repro_torch::shared_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(rs),
      "f"(v), "r"(rb)
      : "memory");
}

// mbar_wait for a barrier that other CTAs' st.async complete: acquire at
// cluster scope, so their data is visible once the phase has completed.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(repro_torch::shared_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The 16-byte-aligned middle [a, b) of the float range [x, y) for a
// 16-byte-aligned base; [x, a) and [b, y) are what a bulk copy cannot take.
__device__ __forceinline__ void aligned_span(int x, int y, int& a, int& b) {
  a = min((x + 3) & ~3, y);
  b = max(y & ~3, a);
}

// Plain loads of the floats of q[x, y) off the 16-byte grid, by all threads.
__device__ __forceinline__ void load_edges(float* sq, const float* q, int x,
                                           int y) {
  int a, b;
  aligned_span(x, y, a, b);
  for (int e = x + threadIdx.x; e < a; e += kThreads) sq[e] = q[e];
  for (int e = b + threadIdx.x; e < y; e += kThreads) sq[e] = q[e];
}

// This thread's share of sum_i sq[a + i] * g[i] over the nv float4s at
// gv (16-byte aligned; kAligned: sq + a too).  `first`, if not null, is
// the barrier of the CTA's rows of Q, waited on once the first loads are
// in flight.
template <bool kAligned>
__device__ __forceinline__ float slice_body(const float* __restrict__ sq,
                                            const float4* __restrict__ gv,
                                            int a, int nv, uint64_t* first) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  for (int i0 = threadIdx.x; i0 < nv; i0 += kThreads * kInFlight) {
    float4 x[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * kThreads;
      x[u] = i < nv ? __ldg(gv + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (first) {
      mbar_wait(first, 0);
      first = nullptr;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nv) {
        const float* s = sq + a + 4 * i;
        const float4 q4 = kAligned ? *reinterpret_cast<const float4*>(s)
                                   : make_float4(s[0], s[1], s[2], s[3]);
        s0 = fmaf(q4.x, x[u].x, s0);
        s1 = fmaf(q4.y, x[u].y, s1);
        s2 = fmaf(q4.z, x[u].z, s2);
        s3 = fmaf(q4.w, x[u].w, s3);
      }
    }
  }
  if (first) mbar_wait(first, 0);
  return (s0 + s1) + (s2 + s3);
}

// This thread's share of sum_{e in [lo, hi)} sq[e] * node[e]: the
// 16-byte-aligned middle in float4s, the at most 3 + 3 floats around it by
// threads 0-3 and 4-7.
__device__ __forceinline__ float slice_dot(const float* __restrict__ sq,
                                           const float* __restrict__ node,
                                           int lo, int hi, uint64_t* first) {
  const unsigned pos = (reinterpret_cast<uintptr_t>(node + lo) >> 2) & 3u;
  const int a = min(lo + (int)((4u - pos) & 3u), hi);
  const int nv = (hi - a) >> 2;
  const int b = a + 4 * nv;
  const float4* gv = reinterpret_cast<const float4*>(node + a);
  float part = (a & 3) == 0 ? slice_body<true>(sq, gv, a, nv, first)
                            : slice_body<false>(sq, gv, a, nv, first);
  const int t = threadIdx.x;
  if (t < a - lo)
    part = fmaf(sq[lo + t], __ldg(node + lo + t), part);
  else if (t >= 4 && t - 4 < hi - b)
    part = fmaf(sq[b + t - 4], __ldg(node + b + t - 4), part);
  return part;
}

// The sum of every thread's v over the cluster, the same bits in every
// thread of every CTA: each warp's sum (a butterfly) goes by st.async into
// slot[rank * kWarps + warp] of every CTA of the cluster, completing on
// that CTA's `bar`; once its phase `parity` holds all c * kWarps sums,
// every warp adds them in the same order (lane l the slots l, l + 32, ...,
// then a butterfly).
__device__ __forceinline__ float cluster_total(float v, float* slot,
                                              uint64_t* bar, uint32_t parity,
                                              int c, unsigned rank) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) mbar_expect_tx(bar, 4u * kWarps * c);
  v = warp_sum(v);
  if (lane < c) send_to_peer(slot + rank * kWarps + warp, bar, lane, v);
  mbar_wait_cluster(bar, parity);
  float t = 0.f;
  for (int k = lane; k < c * kWarps; k += 32) t += slot[k];
  return warp_sum(t);
}

__global__ void __launch_bounds__(kThreads, 1)
descend_score_kernel(const float* __restrict__ nodes,
                     const float* __restrict__ W,
                     const float* __restrict__ q,
                     const float* __restrict__ us, int us_stride, int depth,
                     int block, int R, long long* __restrict__ blk_out,
                     float* __restrict__ scores) {
  extern __shared__ __align__(128) float smem[];
  __shared__ float slots[2][kMaxCluster * kWarps];  // warp sums, by parity
  __shared__ float s_us[kMaxDepth];
  __shared__ __align__(8) uint64_t bar[2];  // Q: this CTA's rows; the rest
  __shared__ __align__(8) uint64_t sbar[2];  // the slots, by parity

  const int RR = R * R;
  float* zs = smem;                  // kStageRows * R: leaf rows, transposed
  float* sq = zs + kStageRows * R;   // RR: the lane's projector
  const int tid = threadIdx.x;
  const int c = (int)cluster_ctas();
  const unsigned rank = cluster_rank();
  const long long n = cluster_index();
  const float* qn = q + n * RR;
  const int lo = (int)rank * R / c * R, hi = ((int)rank + 1) * R / c * R;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bar[i], 1);
      mbar_init(&sbar[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < depth) s_us[tid] = us[n * us_stride + tid];
  const bool bulk = (reinterpret_cast<uintptr_t>(qn) & 15) == 0;
  if (bulk) {
    load_edges(sq, qn, lo, hi);
    load_edges(sq, qn, 0, lo);
    load_edges(sq, qn, hi, RR);
  } else {
    for (int e = tid; e < RR; e += kThreads) sq[e] = qn[e];
  }
  __syncthreads();
  if (tid == 0) {
    int a0, b0, a1, b1, a2, b2;
    aligned_span(lo, hi, a0, b0);
    aligned_span(0, lo, a1, b1);
    aligned_span(hi, RR, a2, b2);
    if (!bulk) a0 = b0, a1 = b1, a2 = b2;  // nothing to copy: both arrive
    mbar_expect_tx(&bar[0], 4u * (b0 - a0));
    if (b0 > a0) bulk_load(sq + a0, qn + a0, 4u * (b0 - a0), &bar[0]);
    mbar_expect_tx(&bar[1], 4u * ((b1 - a1) + (b2 - a2)));
    if (b1 > a1) bulk_load(sq + a1, qn + a1, 4u * (b1 - a1), &bar[1]);
    if (b2 > a2) bulk_load(sq + a2, qn + a2, 4u * (b2 - a2), &bar[1]);
  }

  long long idx = 0;
  if (depth > 0) {
    // every CTA of the cluster runs, its barriers set up, before the first
    // store into it
    if (c > 1) cluster_arrive();
    float p_all = 0.f;
    for (int lvl = 0; lvl <= depth; ++lvl) {
      const long long node = lvl == 0 ? 0 : (1LL << lvl) - 1 + 2 * idx;
      const float part = slice_dot(sq, nodes + node * RR, lo, hi,
                                   lvl == 0 ? &bar[0] : nullptr);
      if (lvl == 0 && c > 1) cluster_wait();
      const float p = cluster_total(part, slots[lvl & 1], &sbar[lvl & 1],
                                    (lvl >> 1) & 1, c, rank);
      if (lvl == 0) {
        p_all = p;  // the root: p_all = <Q, Sigma_root>
        continue;
      }
      const float u = s_us[lvl - 1];
      const bool go_left = u * fmaxf(p_all, 1e-30f) <= fmaxf(p, 0.f);
      idx = 2 * idx + (go_left ? 0 : 1);
      p_all = fmaxf(go_left ? p : p_all - p, 0.f);
    }
    // no CTA exits before its peers hold every sum it sent (the wait is at
    // the end)
    if (c > 1) cluster_arrive();
  }

  // leaf block: CTA k scores rows k, k + c, ... (`mine` of them),
  // kStageRows a round, each warp 8 of them transposed at zw[8 i + t]
  const float* wb = W + idx * block * R;
  const int mine = (int)rank < block ? (block - 1 - (int)rank) / c + 1 : 0;
  const int warp = tid >> 5, lane = tid & 31;
  for (int r0 = 0; r0 < mine; r0 += kStageRows) {
    if (r0 > 0) __syncthreads();  // the last round's warps are done with zs
    for (int e = tid; e < kStageRows * R; e += kThreads) {
      const int t = e / R, i = e - t * R;
      float* dst = zs + ((t / kLeafRows) * R + i) * kLeafRows + t % kLeafRows;
      if (r0 + t < mine)
        repro_torch::cp_async4(
            dst, wb + (long long)((int)rank + (r0 + t) * c) * R + i);
      else
        *dst = 0.f;  // scored, never written
    }
    repro_torch::cp_async_commit();
    if (r0 == 0) {
      mbar_wait(&bar[0], 0);
      mbar_wait(&bar[1], 0);
    }
    repro_torch::cp_async_wait<0>();
    __syncthreads();
    if (warp < kStageRows / kLeafRows && r0 + warp * kLeafRows < mine) {
      const float* zw = zs + warp * R * kLeafRows;
      float cc[kLeafRows][kLeafSlots], acc[kLeafRows];
      int jc[kLeafSlots];  // past R: any valid column, its c is never used
#pragma unroll
      for (int k = 0; k < kLeafSlots; ++k) {
        jc[k] = min(32 * k + lane, R - 1);
#pragma unroll
        for (int t = 0; t < kLeafRows; ++t) cc[t][k] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < kLeafRows; ++t) acc[t] = 0.f;
      repro_torch::leaf_columns(zw, sq, R, 0, R, jc, cc);
      repro_torch::leaf_partials(zw, R, 0, lane, cc, acc);
      const float score = repro_torch::leaf_butterfly(acc, lane);
      const int r = r0 + warp * kLeafRows + lane;
      if (lane < kLeafRows && r < mine)
        scores[n * block + (int)rank + r * c] = score;
    }
  }
  if (mine == 0) {  // no rows: the copies into shared memory still land
    mbar_wait(&bar[0], 0);
    mbar_wait(&bar[1], 0);
  }
  if (rank == 0 && tid == 0) blk_out[n] = idx;
  if (depth > 0 && c > 1) cluster_wait();
}

size_t smem_bytes(int R) {
  return ((size_t)R * R + (size_t)kStageRows * R) * sizeof(float);
}

bool valid_cluster(int c) { return c == 1 || c == 2 || c == 4 || c == 8; }

// Raise the kernel's dynamic shared-memory limit to what kMaxR needs, once
// a device.
cudaError_t prepare() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(descend_score_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxR));
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

// A launch of n clusters of c CTAs at R; `attr` holds the cluster shape.
cudaLaunchConfig_t launch_config(long long n, int c, int R,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * c));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(R);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" int descend_score_max_r() { return kMaxR; }

// nodes: (2^(depth+1) - 1, R, R) stacked tree levels, root first; W:
// (2^depth * block, R) leaf rows; q: (n, R, R); us: (n, us_stride) with
// us_stride >= depth; blk_out: (n,) int64; scores: (n, block).  All float32
// (but blk_out) and contiguous on the current device.  `cluster`: CTAs a
// lane, 1, 2, 4 or 8.  Launches on `stream`; returns the cudaError_t of the
// launch.
extern "C" int descend_score_launch(const float* nodes, const float* W,
                                    const float* q, const float* us,
                                    int us_stride, long long n, int depth,
                                    int block, int R, int cluster,
                                    long long* blk_out, float* scores,
                                    void* stream) {
  if (n <= 0) return cudaSuccess;
  if (R <= 0 || R > kMaxR || block <= 0 || depth < 0 || depth > kMaxDepth ||
      us_stride < depth || !valid_cluster(cluster) ||
      n * cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      n, cluster, R, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, descend_score_kernel, nodes, W, q, us,
                           us_stride, depth, block, R, blk_out, scores);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of `cluster` CTAs at R the current device holds at
// once (cudaOccupancyMaxActiveClusters), into *out; returns the
// cudaError_t.
extern "C" int descend_score_max_active_clusters(int cluster, int R,
                                                 int* out) {
  if (R <= 0 || R > kMaxR || !valid_cluster(cluster))
    return cudaErrorInvalidValue;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, cluster, R, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(descend_score_kernel), &cfg);
}
