// flash_attn: causal GQA flash attention on Hopper, forward and backward.
//
// The forward replaces the TPU kernel repro/kernels/attention/flash.py::
// flash_attention_pallas (_flash_kernel): O = softmax(scale q k^T + mask) v
// for q (B, H, Sq, D) against k, v (B, KVH, Sk, D), head h reading kv head
// h / (H / KVH), the queries being the last Sq of the Sk key positions
// (q_offset = Sk - Sq), online softmax in float32, masked scores -1e30 and
// the final divide clamping l at 1e-30, as flash.py:62-85.  Besides O it
// writes the row log-sum-exp (B, H, Sq) in float32 for the backward and,
// for bfloat16 inputs, O in float32 before its rounding.
//
// The backward is the port's own (the JAX package differentiates the plain
// chunked path instead): from dO, O, the log-sum-exp and q, k, v it gives
// dq, dk, dv in two deterministic passes, with no atomics:
//   0. delta = rowsum(dO o O), one warp a row (a small prologue launch),
//      from the float32 O the forward kept: O rounded to bfloat16 would
//      put an error of up to 2^-8 sum|dO o O| into delta, and so into
//      dS = P o (dp - delta), which swamps dq of a row whose P sits on
//      one key (there dp - delta is nearly 0);
//   1. dK/dV, one CTA per (b, kv head, key tile): it walks the g query
//      heads of its group and their live query tiles, recomputes
//      P = exp(scale q k^T - lse), and sums dV += P^T dO and
//      dK += scale dS^T q with dS = P o (dO v^T - delta), so the GQA sum
//      over a group's heads stays inside the CTA;
//   2. dQ, one CTA per (b, head, query tile), walking the live key tiles:
//      dQ += scale dS K.
//
// Bound on the H100: operations.  At the train path's shape (B = 2,
// H = 16, KVH = 8, S = 4096, D = 128, bfloat16) the forward's causal half
// is 4 B H S^2 D / 2 = 1.37e11 FLOP, 0.139 ms at 989 TFLOP/s, against
// ~50 MB moved (0.015 ms at 3.35 TB/s); the backward is 2.5x the forward.
//
// Design: a first, simple kernel.  bfloat16 loads are widened to float32
// into shared-memory tiles and every product is a float32 FMA outside the
// tensor cores (no wgmma, no TMA yet), so it runs far from its bound; a
// fast version is later work.  A CTA is a 16 x 16 grid of threads, each
// holding a (BM/16) x (BN/16) block of the score tile and a (BM/16) x
// (D_PAD/16) block of its output rows in registers; the k and q tiles are
// stored with a row stride of D + 1 (odd), so the 16 threads of a row
// group read 16 distinct banks.  Only the key tiles (query tiles, in the
// dK/dV pass) that the causal mask leaves live are visited: the grid is
// triangular in effect, which the Pallas grid could not express
// (flash.py:8-11), and the forward and dQ grids start from the longest
// query tiles.  Ragged tails (Sq, Sk not multiples of the tile) are
// zero-filled on load and masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Tile sizes by the padded head dim: BM query rows and BN keys a tile.
template <int D_PAD>
struct Tiles {
  static constexpr int BM = 64, BN = 64;
};
template <>
struct Tiles<256> {
  static constexpr int BM = 32, BN = 32;
};

// Rows [row0, row0 + rows) of a row-major (S, D) matrix into shared memory
// with row stride ld, widened to float32; rows at or past S are zero.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ g, int row0,
                                          int rows, int S, int D,
                                          float* __restrict__ s, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const int gr = row0 + r;
    float* dst = s + r * ld;
    if (gr < S) {
      const T* src = g + (long long)gr * D;
      for (int c = lane; c < D; c += 32) dst[c] = to_f(src[c]);
    } else {
      for (int c = lane; c < D; c += 32) dst[c] = 0.f;
    }
  }
}

// Sum (or max) over the 16 threads of one row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The key range [0, k_end) that query rows [q0, q0 + BM) may see.
__device__ __forceinline__ int key_end(int q0, int BM, int Sq, int Sk,
                                       int causal) {
  if (!causal) return Sk;
  const int q_last = (Sk - Sq) + min(q0 + BM, Sq) - 1;
  return min(Sk, q_last + 1);
}

// ------------------------------------------------------------------ forward
template <typename T, int D_PAD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                 const T* __restrict__ V, T* __restrict__ O,
                 float* __restrict__ O32, float* __restrict__ LSE, int H,
                 int KVH, int Sq, int Sk, int D, float scale, int causal) {
  constexpr int BM = Tiles<D_PAD>::BM, BN = Tiles<D_PAD>::BN;
  constexpr int TM = BM / 16, TN = BN / 16, NJ = D_PAD / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;              // BM x ld
  float* Ks = Qs + BM * ld;      // BN x ld; P (BM x (BN + 1)) once S is done
  float* Ps = Ks;
  float* Vs = Ks + max(BN * ld, BM * (BN + 1));  // BN x D
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int q0 = qt * BM, q_off = Sk - Sq;
  const long long bh = (long long)b * H + h;
  const long long bkh = (long long)b * KVH + kh;
  const T* k = K + bkh * Sk * D;
  const T* v = V + bkh * Sk * D;
  load_rows(Q + bh * Sq * D, q0, BM, Sq, D, Qs, ld);

  float m[TM], l[TM], acc[TM][NJ];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int n_kt = (key_end(q0, BM, Sq, Sk, causal) + BN - 1) / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the last tile's P and V reads are done
    load_rows(k, k0, BN, Sk, D, Ks, ld);
    load_rows(v, k0, BN, Sk, D, Vs, D);
    __syncthreads();
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[TM], bk[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) bk[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
    // online softmax of the tile, rows in registers, sums over row groups
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q_off + q0 + ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = kpos < Sk && (!causal || qpos >= kpos);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(rmax));
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rsum += s[i][j];
      }
      l[i] = l[i] * alpha + group_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // every thread is done reading Ks: P takes its place
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        Ps[(ty + 16 * i) * (BN + 1) + tx + 16 * j] = s[i][j];
    __syncthreads();
    const int kn = min(BN, Sk - k0);
    for (int c = 0; c < kn; ++c) {
      float p[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) p[i] = Ps[(ty + 16 * i) * (BN + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < D ? Vs[c * D + col] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float ll = fmaxf(l[i], 1e-30f);
    T* o = O + (bh * Sq + r) * D;
    float* o32 = O32 ? O32 + (bh * Sq + r) * D : nullptr;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col >= D) continue;
      const float val = acc[i][j] / ll;
      o[col] = from_f<T>(val);
      if (o32) o32[col] = val;
    }
    if (tx == 0) LSE[bh * Sq + r] = m[i] + logf(ll);
  }
}

// ---------------------------------------------------------------- backward
// delta[row] = sum_d dO[row, d] * O[row, d], one warp a row, O in float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const float* __restrict__ O, const T* __restrict__ dO,
                       float* __restrict__ delta, long long rows, int D) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* o = O + row * D;
  const T* g = dO + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(o[c], to_f(g[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// s = q k^T and dp = dO v^T for the tile, rows ty + 16 i, keys tx + 16 j.
template <int TM, int TN>
__device__ __forceinline__ void scores_and_dp(const float* Qs, const float* dOs,
                                              const float* Ks, const float* Vs,
                                              int ld, int D, int tx, int ty,
                                              float (&s)[TM][TN],
                                              float (&dp)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float a[TM], ga[TM], bk[TN], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      a[i] = Qs[(ty + 16 * i) * ld + d];
      ga[i] = dOs[(ty + 16 * i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      bk[j] = Ks[(tx + 16 * j) * ld + d];
      bv[j] = Vs[(tx + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(ga[i], bv[j], dp[i][j]);
      }
  }
}

// P = exp(scale s - lse) (0 where masked) into s, dS = P o (dp - delta)
// into dp.
template <int TM, int TN>
__device__ __forceinline__ void probs_and_ds(float (&s)[TM][TN],
                                             float (&dp)[TM][TN],
                                             const float* lse_s,
                                             const float* del_s, int q0,
                                             int k0, int q_off, int Sq, int Sk,
                                             float scale, int causal, int tx,
                                             int ty) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q_off + q0 + r;
    const float lse = lse_s[r], del = del_s[r];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool live =
          q0 + r < Sq && kpos < Sk && (!causal || qpos >= kpos);
      const float p = live ? expf(s[i][j] * scale - lse) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - del);
    }
  }
}

template <typename T, int D_PAD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                      const T* __restrict__ V, const T* __restrict__ dO,
                      const float* __restrict__ LSE,
                      const float* __restrict__ Delta, T* __restrict__ dK,
                      T* __restrict__ dV, int H, int KVH, int Sq, int Sk,
                      int D, float scale, int causal) {
  constexpr int BM = Tiles<D_PAD>::BM, BN = Tiles<D_PAD>::BN;
  constexpr int TM = BM / 16, TN = BN / 16, NJ = D_PAD / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Ks = smem;               // BN x ld
  float* Vs = Ks + BN * ld;       // BN x ld
  float* Qs = Vs + BN * ld;       // BM x ld
  float* dOs = Qs + BM * ld;      // BM x ld
  float* Ps = dOs + BM * ld;      // BM x (BN + 1)
  float* dSs = Ps + BM * (BN + 1);  // BM x (BN + 1)
  float* lse_s = dSs + BM * (BN + 1);  // BM
  float* del_s = lse_s + BM;           // BM
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int g = H / KVH;
  const int k0 = kt * BN, q_off = Sk - Sq;
  const long long bkh = (long long)b * KVH + kh;
  load_rows(K + bkh * Sk * D, k0, BN, Sk, D, Ks, ld);
  load_rows(V + bkh * Sk * D, k0, BN, Sk, D, Vs, ld);

  float dk[TN][NJ], dv[TN][NJ];
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  // the first query tile whose last row sees key k0
  int qt0 = 0;
  if (causal) {
    const int lo = k0 - q_off - (BM - 1);
    qt0 = lo <= 0 ? 0 : (lo + BM - 1) / BM;
  }
  const int n_qt = (Sq + BM - 1) / BM;
  for (int gi = 0; gi < g; ++gi) {
    const long long bh = (long long)b * H + (long long)kh * g + gi;
    const T* q = Q + bh * Sq * D;
    const T* go = dO + bh * Sq * D;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();  // the last tile's reads of Qs, dOs, Ps, dSs are done
      load_rows(q, q0, BM, Sq, D, Qs, ld);
      load_rows(go, q0, BM, Sq, D, dOs, ld);
      for (int r = threadIdx.x; r < BM; r += kThreads) {
        const bool in = q0 + r < Sq;
        lse_s[r] = in ? LSE[bh * Sq + q0 + r] : 0.f;
        del_s[r] = in ? Delta[bh * Sq + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[TM][TN], dp[TM][TN];
      scores_and_dp<TM, TN>(Qs, dOs, Ks, Vs, ld, D, tx, ty, s, dp);
      probs_and_ds<TM, TN>(s, dp, lse_s, del_s, q0, k0, q_off, Sq, Sk, scale,
                           causal, tx, ty);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          Ps[(ty + 16 * i) * (BN + 1) + tx + 16 * j] = s[i][j];
          dSs[(ty + 16 * i) * (BN + 1) + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      // dV += P^T dO and dK += dS^T q over the tile's rows; this thread
      // holds keys ty + 16 i, columns tx + 16 j
      const int rn = min(BM, Sq - q0);
      for (int r = 0; r < rn; ++r) {
        float p[TN], ds[TN];
#pragma unroll
        for (int i = 0; i < TN; ++i) {
          p[i] = Ps[r * (BN + 1) + ty + 16 * i];
          ds[i] = dSs[r * (BN + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          const float go_rc = col < D ? dOs[r * ld + col] : 0.f;
          const float q_rc = col < D ? Qs[r * ld + col] : 0.f;
#pragma unroll
          for (int i = 0; i < TN; ++i) {
            dv[i][j] = fmaf(p[i], go_rc, dv[i][j]);
            dk[i][j] = fmaf(ds[i], q_rc, dk[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= Sk) continue;
    T* dkr = dK + (bkh * Sk + kr) * D;
    T* dvr = dV + (bkh * Sk + kr) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) {
        dkr[col] = from_f<T>(dk[i][j] * scale);
        dvr[col] = from_f<T>(dv[i][j]);
      }
    }
  }
}

template <typename T, int D_PAD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                    const T* __restrict__ V, const T* __restrict__ dO,
                    const float* __restrict__ LSE,
                    const float* __restrict__ Delta, T* __restrict__ dQ,
                    int H, int KVH, int Sq, int Sk, int D, float scale,
                    int causal) {
  constexpr int BM = Tiles<D_PAD>::BM, BN = Tiles<D_PAD>::BN;
  constexpr int TM = BM / 16, TN = BN / 16, NJ = D_PAD / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;               // BM x ld
  float* dOs = Qs + BM * ld;      // BM x ld
  float* Ks = dOs + BM * ld;      // BN x ld
  float* Vs = Ks + BN * ld;       // BN x ld; dS (BM x (BN + 1)) once dp is done
  float* dSs = Vs;
  float* lse_s = Vs + max(BN * ld, BM * (BN + 1));  // BM
  float* del_s = lse_s + BM;      // BM
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KVH);
  const int q0 = qt * BM, q_off = Sk - Sq;
  const long long bh = (long long)b * H + h;
  const long long bkh = (long long)b * KVH + kh;
  const T* k = K + bkh * Sk * D;
  const T* v = V + bkh * Sk * D;
  load_rows(Q + bh * Sq * D, q0, BM, Sq, D, Qs, ld);
  load_rows(dO + bh * Sq * D, q0, BM, Sq, D, dOs, ld);
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const bool in = q0 + r < Sq;
    lse_s[r] = in ? LSE[bh * Sq + q0 + r] : 0.f;
    del_s[r] = in ? Delta[bh * Sq + q0 + r] : 0.f;
  }

  float dq[TM][NJ];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;
  const int n_kt = (key_end(q0, BM, Sq, Sk, causal) + BN - 1) / BN;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the last tile's reads of Ks and dSs are done
    load_rows(k, k0, BN, Sk, D, Ks, ld);
    load_rows(v, k0, BN, Sk, D, Vs, ld);
    __syncthreads();
    float s[TM][TN], dp[TM][TN];
    scores_and_dp<TM, TN>(Qs, dOs, Ks, Vs, ld, D, tx, ty, s, dp);
    probs_and_ds<TM, TN>(s, dp, lse_s, del_s, q0, k0, q_off, Sq, Sk, scale,
                         causal, tx, ty);
    __syncthreads();  // every thread is done reading Vs: dS takes its place
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        dSs[(ty + 16 * i) * (BN + 1) + tx + 16 * j] = dp[i][j];
    __syncthreads();
    const int kn = min(BN, Sk - k0);
    for (int c = 0; c < kn; ++c) {
      float ds[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) ds[i] = dSs[(ty + 16 * i) * (BN + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float kc = col < D ? Ks[c * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) dq[i][j] = fmaf(ds[i], kc, dq[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    T* o = dQ + (bh * Sq + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) o[col] = from_f<T>(dq[i][j] * scale);
    }
  }
}

// ------------------------------------------------------------------ launch
struct Shape {
  int B, H, KVH, Sq, Sk, D;
  float scale;
  int causal;
};

bool valid(const Shape& s) {
  return s.B > 0 && s.H > 0 && s.KVH > 0 && s.H % s.KVH == 0 && s.Sq > 0 &&
         s.Sq <= s.Sk && s.D > 0 && s.D % 8 == 0 && s.D <= 256 &&
         s.B <= 65535 && s.H <= 65535;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D_PAD>
cudaError_t fwd(const Shape& s, const T* q, const T* k, const T* v, T* o,
                float* o32, float* lse, cudaStream_t st) {
  constexpr int BM = Tiles<D_PAD>::BM, BN = Tiles<D_PAD>::BN;
  const int ld = s.D + 1;
  const size_t p_or_k = (size_t)(BN * ld > BM * (BN + 1) ? BN * ld
                                                          : BM * (BN + 1));
  const size_t smem = ((size_t)BM * ld + p_or_k + (size_t)BN * s.D) *
                      sizeof(float);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D_PAD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.Sq + BM - 1) / BM, s.H, s.B);
  flash_fwd_kernel<T, D_PAD><<<grid, kThreads, smem, st>>>(
      q, k, v, o, o32, lse, s.H, s.KVH, s.Sq, s.Sk, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

template <typename T, int D_PAD>
cudaError_t bwd(const Shape& s, const T* q, const T* k, const T* v,
                const float* o, const T* dout, const float* lse, float* delta,
                T* dq, T* dk, T* dv, cudaStream_t st) {
  constexpr int BM = Tiles<D_PAD>::BM, BN = Tiles<D_PAD>::BN;
  const int ld = s.D + 1;
  const long long rows = (long long)s.B * s.H * s.Sq;
  const long long row_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_delta_kernel<T><<<(unsigned)row_blocks, kThreads, 0, st>>>(
      o, dout, delta, rows, s.D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = ((size_t)(2 * BN + 2 * BM) * ld +
                          2 * (size_t)BM * (BN + 1) + 2 * BM) * sizeof(float);
  err = allow_smem(flash_bwd_dkdv_kernel<T, D_PAD>, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((s.Sk + BN - 1) / BN, s.KVH, s.B);
  flash_bwd_dkdv_kernel<T, D_PAD><<<grid_kv, kThreads, smem_kv, st>>>(
      q, k, v, dout, lse, delta, dk, dv, s.H, s.KVH, s.Sq, s.Sk, s.D,
      s.scale, s.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t v_or_ds = (size_t)(BN * ld > BM * (BN + 1) ? BN * ld
                                                          : BM * (BN + 1));
  const size_t smem_q = ((size_t)(2 * BM + BN) * ld + v_or_ds + 2 * BM) *
                        sizeof(float);
  err = allow_smem(flash_bwd_dq_kernel<T, D_PAD>, smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((s.Sq + BM - 1) / BM, s.H, s.B);
  flash_bwd_dq_kernel<T, D_PAD><<<grid_q, kThreads, smem_q, st>>>(
      q, k, v, dout, lse, delta, dq, s.H, s.KVH, s.Sq, s.Sk, s.D, s.scale,
      s.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_any(const Shape& s, const void* q, const void* k,
                    const void* v, void* o, float* o32, float* lse,
                    cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  if (s.D <= 64) return fwd<T, 64>(s, qq, kk, vv, oo, o32, lse, st);
  if (s.D <= 128) return fwd<T, 128>(s, qq, kk, vv, oo, o32, lse, st);
  return fwd<T, 256>(s, qq, kk, vv, oo, o32, lse, st);
}

template <typename T>
cudaError_t bwd_any(const Shape& s, const void* q, const void* k,
                    const void* v, const float* o, const void* dout,
                    const float* lse, float* delta, void* dq, void* dk,
                    void* dv, cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const float* oo = o;
  const T* gg = static_cast<const T*>(dout);
  T* a = static_cast<T*>(dq);
  T* b = static_cast<T*>(dk);
  T* c = static_cast<T*>(dv);
  if (s.D <= 64)
    return bwd<T, 64>(s, qq, kk, vv, oo, gg, lse, delta, a, b, c, st);
  if (s.D <= 128)
    return bwd<T, 128>(s, qq, kk, vv, oo, gg, lse, delta, a, b, c, st);
  return bwd<T, 256>(s, qq, kk, vv, oo, gg, lse, delta, a, b, c, st);
}

}  // namespace

// q (B, H, Sq, D), k/v (B, KVH, Sk, D), o like q, all contiguous and all
// float32 (bf16 == 0) or all bfloat16 (bf16 == 1); lse (B, H, Sq) float32;
// o32 null, or shaped like q in float32 for O before its rounding.
// Sq <= Sk, H a multiple of KVH, D a multiple of 8 up to 256.  Launches on
// `stream`; returns the cudaError_t of the set-up or the launch.
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, void* o, float* o32,
                                     float* lse, int B, int H, int KVH,
                                     int Sq, int Sk, int D, float scale,
                                     int causal, int bf16, void* stream) {
  const Shape s{B, H, KVH, Sq, Sk, D, scale, causal};
  if (!valid(s)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return fwd_any<__nv_bfloat16>(s, q, k, v, o, o32, lse, st);
  return fwd_any<float>(s, q, k, v, o, o32, lse, st);
}

// The forward's inputs, O in float32, its lse, dout (like q), delta
// (B, H, Sq) float32 scratch, and dq, dk, dv like q, k, v.  Three launches on
// `stream` (delta, dK/dV, dQ); returns the first cudaError_t that is not
// cudaSuccess.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const float* o,
                                     const void* dout, const float* lse,
                                     float* delta, void* dq, void* dk,
                                     void* dv, int B, int H, int KVH, int Sq,
                                     int Sk, int D, float scale, int causal,
                                     int bf16, void* stream) {
  const Shape s{B, H, KVH, Sq, Sk, D, scale, causal};
  if (!valid(s)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bwd_any<__nv_bfloat16>(s, q, k, v, o, dout, lse, delta, dq, dk,
                                  dv, st);
  return bwd_any<float>(s, q, k, v, o, dout, lse, delta, dq, dk, dv, st);
}
