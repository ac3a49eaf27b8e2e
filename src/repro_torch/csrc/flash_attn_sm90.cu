// flash_attn_sm90: causal GQA flash attention on Hopper's tensor cores,
// forward and backward, for bfloat16 q, k, v with a head dim D that is a
// multiple of 16 up to 128 (the route ``kernels/attention/ops.py::_route``
// calls "wgmma"; float32 and the other head dims keep the SIMT kernels of
// csrc/flash_attn.cu).
//
// The forward replaces the TPU kernel repro/kernels/attention/flash.py::
// flash_attention_pallas (:87, _flash_kernel), which runs its two products
// on the MXU: O = softmax(scale q k^T + mask) v for q (B, H, Sq, D) against
// k, v (B, KVH, Sk, D), head h reading kv head h / (H / KVH), the queries
// being the last Sq of the Sk key positions (q_off = Sk - Sq); it writes O,
// O in float32 and the row log-sum-exp, as csrc/flash_attn.cu does.  The
// backward is the port's own, as there: a delta prologue (delta =
// rowsum(dO o O) from the float32 O), a dK/dV pass and a dQ pass, two
// deterministic passes with no atomics.
//
// Bound on the H100: operations.  At the train path's shape (B = 2,
// H = 16, KVH = 8, S = 4096, D = 128) the forward's causal half is
// 4 D per live (query, key) pair, 1.37e11 FLOP, 0.139 ms at 989 TFLOP/s
// against ~168 MB moved (0.050 ms at 3.35 TB/s, O in float32 the most);
// the backward counts 10 D a pair (dV, dP, dQ, dK and the recomputed
// scores), 0.347 ms.  The kernels execute more than that: P V twice
// forward (the hi + lo pair below), 3 products a pair against 2; S and
// dP in both backward passes and dK and dQ twice, 9 against 5.
//
// Design.  Every product is a wgmma on bfloat16 operands with float32
// accumulators in registers.  A CTA is two consumer warpgroups (256
// threads, no producer warp): thread 0 issues the TMA loads, 3-D tensor
// maps (D, S, B x heads) whose boxes are 64 columns (128 bytes) by a tile
// of rows under the 128-byte swizzle the wgmma descriptors read, so a
// D = 128 row is two boxes and D = 80 is two boxes with the second
// zero-filled past column 80 (D is padded to DP = 64 or 128 in shared
// memory).  The streamed tiles (K and V in the forward and dQ pass, q, dO,
// log-sum-exp and delta in the dK/dV pass) come through a ring of two
// stages, each behind an mbarrier that the TMA completes; the next tile's
// copy is in flight while the current one is computed, and a stage is
// refilled once both warpgroups have waited out their wgmmas on it.
//   forward: a CTA takes 128 query rows (64 a warpgroup) of one (b, h);
//     q stays resident, K and V come in tiles of 128 keys.  S = q K^T is
//     one wgmma chain with both operands in shared memory (K is K-major
//     as stored); the online softmax runs on the accumulator fragment in
//     base 2 (scale log2 e folded in), a row's max and sum over the 4
//     threads of a quad (__shfl_xor_sync over 1 and 2); P goes to bf16 in
//     registers as wgmma's A operand and V is the B operand, MN-major
//     (transpose bit).
//   dK/dV: a CTA takes 128 keys (64 a warpgroup) of one (b, kv head); K
//     and V stay resident and the CTA walks the g query heads of the
//     group and their live query tiles of 64 rows, so the GQA sum stays
//     in the CTA.  S^T = K q^T and dP^T = V dO^T put keys on the wgmma's
//     M, so P^T and dS^T = P^T o (dP^T - delta) land in the register-A
//     layout of dV += P^T dO and dK += dS^T q (dO and q MN-major).
//   dQ: a CTA takes 128 query rows (64 a warpgroup) of one (b, h) and
//     walks its live key tiles of 64: S = q K^T, dP = dO V^T, then
//     dQ += dS K with dS in registers and K MN-major.
// Only the diagonal tiles (and a ragged last key tile) are masked; a tile
// past a warpgroup's diagonal is skipped by that warpgroup, and tiles past
// the CTA's are never loaded.  TMA zero-fills rows past Sq or Sk, so the
// masks still drop keys >= Sk; the backward's log-sum-exp (scaled by log2 e)
// and delta are copied into arrays padded to a multiple of 128 rows, with
// +inf and 0 past Sq, so that padded query rows give P = 0.
//
// Precision.  The reference rounds nothing inside the softmax; a bfloat16
// P or dS carries a relative error of 2^-9, and an error in the float32 O
// also enters delta and so every dS.  A product whose operand rounded once
// fails ref.bf16_excess's tolerance takes it as a bf16 pair hi + lo, two
// wgmmas (x - hi rounded again leaves ~2^-17): O += P V, dK += dS^T q and
// dQ += dS K.  dV += P^T dO rounds P^T once.  In units of that tolerance,
// tools/flash_rounding.py's CPU emulation (normal inputs, seeds 1-4,
// S = 2048 with g = 8 and S = 4096 with g = 2) reads dq 1.45 with nothing
// split (S = 2048, seed 1), through delta, and 1.08 with only dS split for
// dQ; dS once for dK up to 1.0045 (S = 2048, seed 2); P once for dV
// 0.64-0.73.  On the H100, dS once for dQ read dq 1.016 at Sq = Sk = 200,
// D = 80, g = 2 (tests/test_torch_gpu.py) with the forward split.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "wgmma.cuh"

namespace {

using namespace repro_torch;

constexpr int kWG = 128;           // threads of a warpgroup
constexpr int kThreads = 2 * kWG;  // two consumer warpgroups a CTA
constexpr int kBox = 64;           // bf16 columns of a TMA box: 128 bytes
constexpr int kRowBytes = kBox * 2;
constexpr int kPadRows = 128;      // the padded lse / delta row multiple

// The rows of the backward's padded lse / delta scratch for Sq query rows:
// whole dQ tiles.
int pad_rows(int Sq) { return (Sq + kPadRows - 1) / kPadRows * kPadRows; }
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------------- TMA
// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int mat) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(mat)
      : "memory");
}

// The key range [0, k_end) that query rows [q0, q0 + rows) may see.
__device__ __forceinline__ int key_end(int q0, int rows, int Sq, int Sk,
                                       int causal) {
  if (!causal) return Sk;
  return min(Sk, (Sk - Sq) + min(q0 + rows, Sq));
}

// ------------------------------------------------------------------ forward
template <int DP>
struct FwdTiles {
  static constexpr int NB = DP / kBox;  // boxes a row
  static constexpr int BM = 128;        // query rows a CTA, 64 a warpgroup
  static constexpr int BN = 128;        // keys a tile
  static constexpr int Q_BYTES = NB * BM * kRowBytes;
  static constexpr int KV_BYTES = NB * BN * kRowBytes;  // K or V, a stage
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + 2 * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + 2 * KV_BYTES;  // q, full[2]
  static constexpr int SMEM = BAR_OFF + 3 * 8 + 1024;
};

template <int DP>
__device__ __forceinline__ void fwd_load_kv(uint8_t* sm, uint64_t* full,
                                            const CUtensorMap* mk,
                                            const CUtensorMap* mv, int stage,
                                            int k0, int bkh) {
  using T = FwdTiles<DP>;
  mbar_expect_tx(full, 2 * T::KV_BYTES);
#pragma unroll
  for (int x = 0; x < T::NB; ++x) {
    const int off = stage * T::KV_BYTES + x * T::BN * kRowBytes;
    tma_load(sm + T::K_OFF + off, mk, full, x * kBox, k0, bkh);
    tma_load(sm + T::V_OFF + off, mv, full, x * kBox, k0, bkh);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                __nv_bfloat16* __restrict__ O, float* __restrict__ O32,
                float* __restrict__ LSE, int H, int KVH, int Sq, int Sk, int D,
                float scale, int causal) {
  using T = FwdTiles<DP>;
  constexpr int BM = T::BM, BN = T::BN, NB = T::NB;
  uint8_t* sm = smem_base();
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + T::BAR_OFF);
  const int tid = threadIdx.x, wg = tid / kWG;
  const int warp = (tid % kWG) / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int bkh = b * KVH + h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the longest rows first
  const int n_kt = (key_end(q0, BM, Sq, Sk, causal) + BN - 1) / BN;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], T::Q_BYTES);
    for (int x = 0; x < NB; ++x)
      tma_load(sm + x * BM * kRowBytes, &mq, &bar[0], x * kBox, q0, bh);
    for (int s = 0; s < 2 && s < n_kt; ++s)
      fwd_load_kv<DP>(sm, &bar[1 + s], &mk, &mv, s, s * BN, bkh);
  }
  const float sl2 = scale * kLog2e;
  const int wfirst = (Sk - Sq) + q0 + wg * 64;  // the warpgroup's first row
  const int rq = warp * 16 + (lane >> 2);       // rows rq and rq + 8
  float o[DP / 2], m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  mbar_wait(&bar[0], 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1, k0 = kt * BN;
    mbar_wait(&bar[1 + s], (kt >> 1) & 1);
    if (!causal || k0 <= wfirst + 63) {  // a key this warpgroup's rows see
      const uint8_t* ks = sm + T::K_OFF + s * T::KV_BYTES;
      const uint8_t* vs = sm + T::V_OFF + s * T::KV_BYTES;
      float sc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
      hold(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int box = kk / 4, col = (kk % 4) * 32;
        wgmma_ss_n128(
            sc,
            sw128_desc(sm + (box * BM + wg * 64) * kRowBytes + col, 16, 1024),
            sw128_desc(ks + box * BN * kRowBytes + col, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      hold(sc);
      // scale into base 2; mask the diagonal tile and a ragged last tile
      const bool mask = (causal && k0 + BN - 1 > wfirst) || k0 + BN > Sk;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = sc[i] * sl2;
        if (mask) {
          const int kpos = k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
          const int qpos = wfirst + rq + 8 * ((i >> 1) & 1);
          if (kpos >= Sk || (causal && kpos > qpos)) x = kNegBig;
        }
        sc[i] = x;
      }
      // online softmax: a row lives on the 4 threads of a quad
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2f(sc[i] - mx[r]);
        rs[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // O += P V, P as a bf16 pair hi + lo in registers, V MN-major
      uint32_t ph[BN / 16][4], pl[BN / 16][4];
      to_a_split<BN / 16>(sc, ph, pl);
      hold(o);
      hold(ph);
      hold(pl);
      wg_fence();
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        const uint64_t dv =
            sw128_desc(vs + c * 16 * kRowBytes, BN * kRowBytes, 1024);
        wgmma_rs<DP>(o, ph[c], dv);
        wgmma_rs<DP>(o, pl[c], dv);
      }
      wg_commit();
      wg_wait_all();
      hold(o);
      hold(ph);
      hold(pl);
    }
    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && kt + 2 < n_kt)
      fwd_load_kv<DP>(sm, &bar[1 + s], &mk, &mv, s, (kt + 2) * BN, bkh);
  }
  // epilogue: O = acc / l, O in float32 and bf16, lse = ln 2 m + ln l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + wg * 64 + rq + 8 * r;
    if (row >= Sq) continue;
    const float ll = fmaxf(l[r], 1e-30f), inv = 1.f / ll;
    const long long base = ((long long)bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col >= D) continue;
      const float x = o[4 * j + 2 * r] * inv, y = o[4 * j + 2 * r + 1] * inv;
      *reinterpret_cast<__nv_bfloat162*>(O + base + col) =
          __floats2bfloat162_rn(x, y);
      *reinterpret_cast<float2*>(O32 + base + col) = make_float2(x, y);
    }
    if ((lane & 3) == 0) LSE[(long long)bh * Sq + row] = m[r] * kLn2 + logf(ll);
  }
}

// ---------------------------------------------------------------- backward
// delta = rowsum(dO o O) from the float32 O, one warp a row, and the
// log-sum-exp scaled by log2 e, both into (B H, Sq_pad) arrays: past Sq,
// delta 0 and +inf, so a padded query row gets P = exp2(s - inf) = 0.
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_wgmma(const float* __restrict__ O,
                     const __nv_bfloat16* __restrict__ dO,
                     const float* __restrict__ LSE, float* __restrict__ delta,
                     float* __restrict__ lse2, int Sq, int Sq_pad, int D,
                     long long rows) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long bh = row / Sq_pad;
  const int r = (int)(row % Sq_pad);
  if (r >= Sq) {
    if (lane == 0) {
      delta[row] = 0.f;
      lse2[row] = __int_as_float(0x7f800000);  // +inf
    }
    return;
  }
  const long long src = bh * Sq + r;
  const float* o = O + src * D;
  const __nv_bfloat16* g = dO + src * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc = fmaf(o[c], __bfloat162float(g[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = LSE[src] * kLog2e;
  }
}

template <int DP>
struct KvTiles {
  static constexpr int NB = DP / kBox;
  static constexpr int BN = 128;  // keys a CTA, 64 a warpgroup (resident)
  static constexpr int BM = 64;   // query rows a tile
  static constexpr int KV_BYTES = NB * BN * kRowBytes;  // K or V
  static constexpr int QT_BYTES = NB * BM * kRowBytes;  // q or dO, a stage
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + 2 * QT_BYTES;
  static constexpr int L_OFF = DO_OFF + 2 * QT_BYTES;  // lse2[2][BM]
  static constexpr int D_OFF = L_OFF + 2 * BM * 4;     // delta[2][BM]
  static constexpr int BAR_OFF = D_OFF + 2 * BM * 4;   // K and V, full[2]
  static constexpr int SMEM = BAR_OFF + 3 * 8 + 1024;
};

template <int DP>
__device__ __forceinline__ void kv_load_q(uint8_t* sm, uint64_t* full,
                                          const CUtensorMap* mq,
                                          const CUtensorMap* mdo,
                                          const float* lse2,
                                          const float* delta, int stage,
                                          int q0, int bh, int Sq_pad) {
  using T = KvTiles<DP>;
  mbar_expect_tx(full, 2 * T::QT_BYTES + 2 * T::BM * 4);
#pragma unroll
  for (int x = 0; x < T::NB; ++x) {
    const int off = stage * T::QT_BYTES + x * T::BM * kRowBytes;
    tma_load(sm + T::Q_OFF + off, mq, full, x * kBox, q0, bh);
    tma_load(sm + T::DO_OFF + off, mdo, full, x * kBox, q0, bh);
  }
  const long long at = (long long)bh * Sq_pad + q0;
  bulk_load(sm + T::L_OFF + stage * T::BM * 4, lse2 + at, T::BM * 4, full);
  bulk_load(sm + T::D_OFF + stage * T::BM * 4, delta + at, T::BM * 4, full);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkdv_wgmma(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mdo,
                 const float* __restrict__ lse2,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dK,
                 __nv_bfloat16* __restrict__ dV,
                 int H, int KVH, int Sq, int Sk, int Sq_pad, int D, float scale,
                 int causal) {
  using T = KvTiles<DP>;
  constexpr int BM = T::BM, BN = T::BN, NB = T::NB;
  uint8_t* sm = smem_base();
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + T::BAR_OFF);
  const int tid = threadIdx.x, wg = tid / kWG;
  const int warp = (tid % kWG) / 32, lane = tid % 32;
  const int bkh = blockIdx.x, b = bkh / KVH, kh = bkh % KVH;
  const int k0 = blockIdx.y * BN;  // the early keys, seen by most rows, first
  const int g = H / KVH, q_off = Sk - Sq;
  int qt0 = 0;  // the first query tile whose last row sees key k0
  if (causal) {
    const int lo = k0 - q_off - (BM - 1);
    qt0 = lo <= 0 ? 0 : (lo + BM - 1) / BM;
  }
  const int per = (Sq + BM - 1) / BM - qt0;  // live query tiles a head
  const int n_t = g * per;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], 2 * T::KV_BYTES);
    for (int x = 0; x < NB; ++x) {
      tma_load(sm + x * BN * kRowBytes, &mk, &bar[0], x * kBox, k0, bkh);
      tma_load(sm + T::V_OFF + x * BN * kRowBytes, &mv, &bar[0], x * kBox,
               k0, bkh);
    }
    for (int s = 0; s < 2 && s < n_t; ++s)
      kv_load_q<DP>(sm, &bar[1 + s], &mq, &mdo, lse2, delta, s,
                    (qt0 + s % per) * BM, b * H + kh * g + s / per, Sq_pad);
  }
  const float sl2 = scale * kLog2e;
  const int kw0 = k0 + wg * 64;             // the warpgroup's first key
  const int rk = warp * 16 + (lane >> 2);   // keys kw0 + rk and + 8
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&bar[0], 0);

  for (int t = 0; t < n_t; ++t) {
    const int s = t & 1, q0 = (qt0 + t % per) * BM;
    mbar_wait(&bar[1 + s], (t >> 1) & 1);
    if (kw0 < Sk && (!causal || q_off + q0 + BM - 1 >= kw0)) {
      const uint8_t* qs = sm + T::Q_OFF + s * T::QT_BYTES;
      const uint8_t* dos = sm + T::DO_OFF + s * T::QT_BYTES;
      const float* ls = reinterpret_cast<const float*>(sm + T::L_OFF) + s * BM;
      const float* ds = reinterpret_cast<const float*>(sm + T::D_OFF) + s * BM;
      // S^T = K q^T and dP^T = V dO^T: keys on M, queries on N
      float st[BM / 2], dpt[BM / 2];
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) st[i] = dpt[i] = 0.f;
      hold(st);
      hold(dpt);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int box = kk / 4, col = (kk % 4) * 32;
        const int a_off = (box * BN + wg * 64) * kRowBytes + col;
        const int b_off = box * BM * kRowBytes + col;
        wgmma_ss_n64(st, sw128_desc(sm + a_off, 16, 1024),
                     sw128_desc(qs + b_off, 16, 1024), kk > 0);
        wgmma_ss_n64(dpt, sw128_desc(sm + T::V_OFF + a_off, 16, 1024),
                     sw128_desc(dos + b_off, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      hold(st);
      hold(dpt);
      // P^T = exp2(s scale log2 e - lse2), dS^T = P^T o (dP^T - delta)
      const bool mask =
          (causal && kw0 + 63 > q_off + q0) || kw0 + 64 > Sk;
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) {
        const int qc = (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
        float p = exp2f(st[i] * sl2 - ls[qc]);
        if (mask) {
          const int kpos = kw0 + rk + 8 * ((i >> 1) & 1);
          if (kpos >= Sk || (causal && kpos > q_off + q0 + qc)) p = 0.f;
        }
        dpt[i] = p * (dpt[i] - ds[qc]);
        st[i] = p;
      }
      // dV += P^T dO, P^T rounded once; dK += dS^T q, dS^T as hi + lo
      uint32_t ph[BM / 16][4], dh[BM / 16][4], dl[BM / 16][4];
      to_a<BM / 16>(st, ph);
      to_a_split<BM / 16>(dpt, dh, dl);
      hold(dv);
      hold(dk);
      hold(ph);
      hold(dh);
      hold(dl);
      wg_fence();
#pragma unroll
      for (int c = 0; c < BM / 16; ++c) {
        const int off = c * 16 * kRowBytes;
        const uint64_t bdo = sw128_desc(dos + off, BM * kRowBytes, 1024);
        const uint64_t bq = sw128_desc(qs + off, BM * kRowBytes, 1024);
        wgmma_rs<DP>(dv, ph[c], bdo);
        wgmma_rs<DP>(dk, dh[c], bq);
        wgmma_rs<DP>(dk, dl[c], bq);
      }
      wg_commit();
      wg_wait_all();
      hold(dv);
      hold(dk);
      hold(ph);
      hold(dh);
      hold(dl);
    }
    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && t + 2 < n_t) {
      const int u = t + 2;
      kv_load_q<DP>(sm, &bar[1 + s], &mq, &mdo, lse2, delta, s,
                    (qt0 + u % per) * BM, b * H + kh * g + u / per, Sq_pad);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + rk + 8 * r;
    if (key >= Sk) continue;
    const long long base = ((long long)bkh * Sk + key) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(dK + base + col) =
          __floats2bfloat162_rn(dk[4 * j + 2 * r] * scale,
                                dk[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dV + base + col) =
          __floats2bfloat162_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

template <int DP>
struct QTiles {
  static constexpr int NB = DP / kBox;
  static constexpr int BM = 128;  // query rows a CTA, 64 a warpgroup
  static constexpr int BN = 64;   // keys a tile
  static constexpr int Q_BYTES = NB * BM * kRowBytes;  // q or dO
  static constexpr int KT_BYTES = NB * BN * kRowBytes;  // K or V, a stage
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + 2 * KT_BYTES;
  static constexpr int BAR_OFF = V_OFF + 2 * KT_BYTES;  // q and dO, full[2]
  static constexpr int SMEM = BAR_OFF + 3 * 8 + 1024;
};

template <int DP>
__device__ __forceinline__ void q_load_kv(uint8_t* sm, uint64_t* full,
                                          const CUtensorMap* mk,
                                          const CUtensorMap* mv, int stage,
                                          int k0, int bkh) {
  using T = QTiles<DP>;
  mbar_expect_tx(full, 2 * T::KT_BYTES);
#pragma unroll
  for (int x = 0; x < T::NB; ++x) {
    const int off = stage * T::KT_BYTES + x * T::BN * kRowBytes;
    tma_load(sm + T::K_OFF + off, mk, full, x * kBox, k0, bkh);
    tma_load(sm + T::V_OFF + off, mv, full, x * kBox, k0, bkh);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_wgmma(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv,
               const __grid_constant__ CUtensorMap mdo,
               const float* __restrict__ lse2, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dQ, int H, int KVH, int Sq, int Sk,
               int Sq_pad, int D, float scale, int causal) {
  using T = QTiles<DP>;
  constexpr int BM = T::BM, BN = T::BN, NB = T::NB;
  uint8_t* sm = smem_base();
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + T::BAR_OFF);
  const int tid = threadIdx.x, wg = tid / kWG;
  const int warp = (tid % kWG) / 32, lane = tid % 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int bkh = b * KVH + h / (H / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the longest rows first
  const int n_kt = (key_end(q0, BM, Sq, Sk, causal) + BN - 1) / BN;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], 2 * T::Q_BYTES);
    for (int x = 0; x < NB; ++x) {
      tma_load(sm + x * BM * kRowBytes, &mq, &bar[0], x * kBox, q0, bh);
      tma_load(sm + T::DO_OFF + x * BM * kRowBytes, &mdo, &bar[0], x * kBox,
               q0, bh);
    }
    for (int s = 0; s < 2 && s < n_kt; ++s)
      q_load_kv<DP>(sm, &bar[1 + s], &mk, &mv, s, s * BN, bkh);
  }
  const float sl2 = scale * kLog2e;
  const int wfirst = (Sk - Sq) + q0 + wg * 64;  // the warpgroup's first row
  const int rq = warp * 16 + (lane >> 2);       // rows rq and rq + 8
  float lr[2], dr[2];  // the rows' lse2 and delta (padded rows: +inf, 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = (long long)bh * Sq_pad + q0 + wg * 64 + rq + 8 * r;
    lr[r] = lse2[at];
    dr[r] = delta[at];
  }
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  mbar_wait(&bar[0], 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1, k0 = kt * BN;
    mbar_wait(&bar[1 + s], (kt >> 1) & 1);
    if (!causal || k0 <= wfirst + 63) {
      const uint8_t* ks = sm + T::K_OFF + s * T::KT_BYTES;
      const uint8_t* vs = sm + T::V_OFF + s * T::KT_BYTES;
      float sc[BN / 2], dp[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
      hold(sc);
      hold(dp);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int box = kk / 4, col = (kk % 4) * 32;
        const int a_off = (box * BM + wg * 64) * kRowBytes + col;
        const int b_off = box * BN * kRowBytes + col;
        wgmma_ss_n64(sc, sw128_desc(sm + a_off, 16, 1024),
                     sw128_desc(ks + b_off, 16, 1024), kk > 0);
        wgmma_ss_n64(dp, sw128_desc(sm + T::DO_OFF + a_off, 16, 1024),
                     sw128_desc(vs + b_off, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      hold(sc);
      hold(dp);
      const bool mask = (causal && k0 + BN - 1 > wfirst) || k0 + BN > Sk;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2f(sc[i] * sl2 - lr[r]);
        if (mask) {
          const int kpos = k0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
          if (kpos >= Sk || (causal && kpos > wfirst + rq + 8 * r)) p = 0.f;
        }
        dp[i] = p * (dp[i] - dr[r]);
      }
      // dQ += dS K, dS as hi + lo in registers, K MN-major
      uint32_t dh[BN / 16][4], dl[BN / 16][4];
      to_a_split<BN / 16>(dp, dh, dl);
      hold(dq);
      hold(dh);
      hold(dl);
      wg_fence();
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        const uint64_t bk =
            sw128_desc(ks + c * 16 * kRowBytes, BN * kRowBytes, 1024);
        wgmma_rs<DP>(dq, dh[c], bk);
        wgmma_rs<DP>(dq, dl[c], bk);
      }
      wg_commit();
      wg_wait_all();
      hold(dq);
      hold(dh);
      hold(dl);
    }
    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && kt + 2 < n_kt)
      q_load_kv<DP>(sm, &bar[1 + s], &mk, &mv, s, (kt + 2) * BN, bkh);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + rq + 8 * r;
    if (row >= Sq) continue;
    const long long base = ((long long)bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(dQ + base + col) =
          __floats2bfloat162_rn(dq[4 * j + 2 * r] * scale,
                                dq[4 * j + 2 * r + 1] * scale);
    }
  }
}

// ------------------------------------------------------------------ launch
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which PyTorch has loaded, so
// this library links against the CUDA runtime only.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous bfloat16 (mats, S, D) tensor: boxes of 64
// columns by `rows` rows of one matrix under the 128-byte swizzle, zero
// filled past D, S and mats.  The map embeds `base`, so it is built per
// call.
cudaError_t tensor_map(CUtensorMap* map, const void* base, int mats, int S,
                       int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Shape {
  int B, H, KVH, Sq, Sk, D;
  float scale;
  int causal;
};

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool valid(const Shape& s) {
  return s.B > 0 && s.H > 0 && s.KVH > 0 && s.H % s.KVH == 0 && s.Sq > 0 &&
         s.Sq <= s.Sk && s.D >= 16 && s.D % 16 == 0 && s.D <= 128 &&
         (long long)s.B * s.H <= 0x7fffffffLL &&
         (s.Sq + 127) / 128 <= 65535 && (s.Sk + 127) / 128 <= 65535;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

#define TRY(expr)                               \
  do {                                          \
    const cudaError_t err_ = (expr);            \
    if (err_ != cudaSuccess) return err_;       \
  } while (0)

template <int DP>
cudaError_t fwd(const Shape& s, const void* q, const void* k, const void* v,
                void* o, float* o32, float* lse, cudaStream_t st) {
  using T = FwdTiles<DP>;
  CUtensorMap mq, mk, mv;
  TRY(tensor_map(&mq, q, s.B * s.H, s.Sq, s.D, T::BM));
  TRY(tensor_map(&mk, k, s.B * s.KVH, s.Sk, s.D, T::BN));
  TRY(tensor_map(&mv, v, s.B * s.KVH, s.Sk, s.D, T::BN));
  TRY(allow_smem(flash_fwd_wgmma<DP>, T::SMEM));
  const dim3 grid(s.B * s.H, (s.Sq + T::BM - 1) / T::BM);
  flash_fwd_wgmma<DP><<<grid, kThreads, T::SMEM, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), o32, lse, s.H, s.KVH, s.Sq,
      s.Sk, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t bwd(const Shape& s, const void* q, const void* k, const void* v,
                const float* o32, const void* dout, const float* lse,
                float* delta, float* lse2, void* dq, void* dk, void* dv,
                cudaStream_t st) {
  using KV = KvTiles<DP>;
  using Q = QTiles<DP>;
  const int sq_pad = pad_rows(s.Sq);
  const long long rows = (long long)s.B * s.H * sq_pad;
  const long long row_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_prep_wgmma<<<(unsigned)row_blocks, kThreads, 0, st>>>(
      o32, static_cast<const __nv_bfloat16*>(dout), lse, delta, lse2, s.Sq,
      sq_pad, s.D, rows);
  TRY(cudaGetLastError());

  CUtensorMap mq, mk, mv, mdo;
  TRY(tensor_map(&mq, q, s.B * s.H, s.Sq, s.D, KV::BM));
  TRY(tensor_map(&mdo, dout, s.B * s.H, s.Sq, s.D, KV::BM));
  TRY(tensor_map(&mk, k, s.B * s.KVH, s.Sk, s.D, KV::BN));
  TRY(tensor_map(&mv, v, s.B * s.KVH, s.Sk, s.D, KV::BN));
  TRY(allow_smem(flash_dkdv_wgmma<DP>, KV::SMEM));
  const dim3 grid_kv(s.B * s.KVH, (s.Sk + KV::BN - 1) / KV::BN);
  flash_dkdv_wgmma<DP><<<grid_kv, kThreads, KV::SMEM, st>>>(
      mq, mk, mv, mdo, lse2, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s.H, s.KVH, s.Sq, s.Sk, sq_pad, s.D,
      s.scale, s.causal);
  TRY(cudaGetLastError());

  TRY(tensor_map(&mq, q, s.B * s.H, s.Sq, s.D, Q::BM));
  TRY(tensor_map(&mdo, dout, s.B * s.H, s.Sq, s.D, Q::BM));
  TRY(tensor_map(&mk, k, s.B * s.KVH, s.Sk, s.D, Q::BN));
  TRY(tensor_map(&mv, v, s.B * s.KVH, s.Sk, s.D, Q::BN));
  TRY(allow_smem(flash_dq_wgmma<DP>, Q::SMEM));
  const dim3 grid_q(s.B * s.H, (s.Sq + Q::BM - 1) / Q::BM);
  flash_dq_wgmma<DP><<<grid_q, kThreads, Q::SMEM, st>>>(
      mq, mk, mv, mdo, lse2, delta, static_cast<__nv_bfloat16*>(dq), s.H,
      s.KVH, s.Sq, s.Sk, sq_pad, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, D), k/v (B, KVH, Sk, D), o like q, all contiguous bfloat16
// at 16-byte aligned addresses; o32 like q in float32 (O before its
// rounding), lse (B, H, Sq) float32.  Sq <= Sk, H a multiple of KVH, D a
// multiple of 16 from 16 to 128.  Launches on `stream`; returns the
// cudaError_t of the set-up or the launch.
extern "C" int flash_attn_sm90_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, float* o32,
                                          float* lse, int B, int H, int KVH,
                                          int Sq, int Sk, int D, float scale,
                                          int causal, void* stream) {
  const Shape s{B, H, KVH, Sq, Sk, D, scale, causal};
  if (!valid(s) || !aligned(q) || !aligned(k) || !aligned(v) || !aligned(o) ||
      !aligned(o32) || !aligned(lse))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return fwd<64>(s, q, k, v, o, o32, lse, st);
  return fwd<128>(s, q, k, v, o, o32, lse, st);
}

// The rows of the scratch delta and lse2 that flash_attn_sm90_bwd_launch
// takes, for Sq query rows.
extern "C" int flash_attn_sm90_scratch_rows(int Sq) { return pad_rows(Sq); }

// The forward's inputs, its float32 O and lse, dout (like q), scratch
// delta and lse2 of (B, H, flash_attn_sm90_scratch_rows(Sq)) float32, and
// dq, dk, dv like q, k, v.  Three launches on `stream`
// (the delta prologue, dK/dV, dQ); returns the first cudaError_t that is
// not cudaSuccess.
extern "C" int flash_attn_sm90_bwd_launch(
    const void* q, const void* k, const void* v, const float* o32,
    const void* dout, const float* lse, float* delta, float* lse2, void* dq,
    void* dk, void* dv, int B, int H, int KVH, int Sq, int Sk, int D,
    float scale, int causal, void* stream) {
  const Shape s{B, H, KVH, Sq, Sk, D, scale, causal};
  if (!valid(s) || !aligned(q) ||
      !aligned(k) || !aligned(v) || !aligned(dout) || !aligned(delta) ||
      !aligned(lse2) || !aligned(dq) || !aligned(dk) || !aligned(dv))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return bwd<64>(s, q, k, v, o32, dout, lse, delta, lse2, dq, dk, dv, st);
  return bwd<128>(s, q, k, v, o32, dout, lse, delta, lse2, dq, dk, dv, st);
}
