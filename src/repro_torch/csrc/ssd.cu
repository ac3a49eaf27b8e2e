// ssd: the chunked Mamba2 SSD scan on Hopper, forward and backward.
//
// The forward replaces the TPU kernel repro/kernels/ssd/ssd.py::ssd_pallas
// (_ssd_kernel, ssd.py:34-76).  Per (batch, head) the sequence is cut into
// chunks of Q steps, with cum the inclusive cumulative sum of
// log max(a, 1e-37) inside the chunk and total = cum[Q-1]:
//   y = (C B^T o L) X + (C o exp(cum)) H_prev,
//       L[i, j] = exp(cum_i - cum_j) for i >= j, else 0 (masked before exp),
//   H = exp(total) H_prev + (B o exp(total - cum))^T X,
// with y written in x's dtype and the last H in float32.  Arithmetic is
// float32 from float32 or bfloat16 inputs, as the Pallas kernel casts.
// The forward can also write every chunk's starting state H_prev
// (B, H, S/Q, N, P) float32 for the backward (its wgmma route always
// writes them, into a scratch when the caller keeps none).
//
// The backward is the port's own (the JAX package differentiates the plain
// chunked path, repro/kernels/ssd/ops.py::ssd_chunked_ref): from dy and the
// gradient of the last state it gives dx, da, db and dc as JAX's autodiff
// of ssd_chunked_ref would.  dH (N x P, float32), the gradient of a
// chunk's end state, is carried across the chunks in reverse; within a
// chunk, with G = C B^T, dS = dY X^T masked to i >= j, M = dS o L,
// T = M o G, w = exp(total - cum), e = exp(cum), D = dY H_prev^T:
//   dx = (G o L)^T dY + (B o w) dH,
//   dc = M B + e o D,
//   db = M^T C + w o (X dH^T),
//   dH_prev = exp(total) dH + (C o e)^T dY,
//   dcum_i = sum_j T_ij - sum_j T_ji + e_i (c_i . D_i) - w_i dw_i
//            + [i = Q-1] (sum_j w_j dw_j + exp(total) <H_prev, dH>),
//       dw_j = b_j . (X dH^T)_j,
//   d log a = the reverse cumulative sum of dcum inside the chunk,
//   da = d log a / a where a > 1e-37, else 0 (the gradient of the max).
// L is never factored as exp(cum_i) exp(-cum_j): with strong decays cum
// reaches ~-1,400 in a chunk of 128 and exp(-cum) overflows.  H_prev comes
// from the states the forward wrote.
//
// Bound on the H100: at the train path's shape (B = 2, S = 4,096, H = 64,
// P = 64, N = 128, Q = 128, bfloat16) the forward does Q(Q+1)(N + P) +
// 4QNP FLOP a (batch, head, chunk), C B^T and its product with X over the
// causally live pairs only, 30.2 GFLOP in all (0.031 ms at 989 TFLOP/s,
// 0.45 ms at the 67 TFLOP/s of float32 FMA), against ~145 MB moved
// (0.043 ms at 3.35 TB/s): bytes bound it.  The backward's products, each
// once over the live pairs, are 69 GFLOP (0.070 ms at 989 TFLOP/s, 1.03
// at float32 FMA) against ~0.21 GB moved: operations bound it.
//
// The "simt" routes (float32, and every shape the wgmma routes do not
// take): the first, simple kernels, ssd_fwd_kernel and ssd_bwd_kernel.  One
// CTA of 256 threads (a 16 x 16 grid) per (batch, head) walks its chunks
// (128 CTAs at the train shape, one wave on 132 SMs), the backward in
// reverse carrying dH; inputs are widened to float32 in shared-memory tiles
// and every product is a float32 FMA outside the tensor cores, each thread
// holding a register block of its output.  Shared memory: B and X of the
// whole chunk, the state, and C and the masked C B^T in row tiles (RF rows
// forward, RB backward), about 200 KB; rows of an odd stride (N + 1,
// P + 1) keep the 16 threads of a row group on 16 distinct banks.  Only
// the causally live tiles of C B^T are computed.
//
// The "wgmma" routes (bf16, Q of 64 or 128, N and P multiples of 16;
// ops.py::_route): the same algebra, chunk-parallel on the tensor cores.
// Each has one sequential part, a state carried across the chunks, so each
// runs as three launches, every output element written by one CTA
// (deterministic, no atomics), with one float32 buffer (B, H, S/Q, N, P):
//   A. a product (M o s)^T R a chunk (chunk_state, two warpgroups): the
//      forward's S_q = (B o w)^T X (ssd_fwd_state_kernel, into chunk
//      q + 1's slot, the last chunk's into h_last), the backward's U_q =
//      (C o e)^T dY (ssd_bwd_u_kernel, chunks q >= 1);
//   B. the carry, in place and elementwise over N x P: forward H_start(q
//      + 1) = exp(total_q) H_start(q) + S_q from H_start(0) = 0, leaving
//      every chunk's starting state (the states the backward reads) and
//      h_last (ssd_fwd_carry_kernel); backward dH_end(q - 1) =
//      exp(total_q) dH_end(q) + U_q from dh_last (ssd_bwd_carry_kernel);
//   C. the outputs.  Forward (ssd_fwd_chunk_kernel): one CTA of Q/64
//      warpgroups per (batch, head, chunk), warpgroup w taking rows 64w..,
//      y = e o (C H_prev) + the tiles jt <= w of (G o L) X, G = C B^T;
//      113 KB of shared memory (the cumulative sums in registers), two
//      CTAs an SM.  Backward (ssd_bwd_chunk_kernel): one CTA of Q/64
//      warpgroups per (batch, head, chunk): warpgroup w takes rows 64w..
//      as i (dc, sum_j T_ij, c_i . D_i) and then as j (dx, db, sum_i T_ij,
//      dw_j), G and dS computed in both orientations (G = C B^T and G^T =
//      B C^T, 64 x 64 tiles, the tiles past the diagonal skipped), then the
//      d log a scan.
// X, dY, B and C are staged with cp.async in 128-byte-swizzled boxes that
// the wgmma descriptors read (a fence makes the stores visible to the
// async proxy); rows not on 16 bytes are read an element at a time (kVec
// false).  A float32 operand enters its product as a bf16 pair hi + lo,
// two wgmmas: B o w and C o e (built in registers), M and G o L (from the
// accumulators, ``to_a_split``), H_prev and dH (staged as pairs).  Scales
// by row stay outside the products (e o (C H_prev), (B o w) dH =
// diag(w) (B dH)); L is masked before its exp.  tools/ssd_rounding.py's
// CPU emulation of these orders reads y 0.477-0.485 of the 2^-8 tolerance,
// h_last 0.002-0.009 and the states 0.008-0.010 of 2^-12 (any one of B o w,
// H_prev, G o L rounded once: 0.86-5.3), and dx, db, dc 0.48-0.49 and
// d log a 0.003-0.008 (any one of the backward's five rounded once:
// 0.82-6.9).  The lines "// PART p1", "// PART p2", "// PART scan" and
// "// PART end" in ssd_bwd_chunk_kernel mark its phase 1, phase 2 and
// d log a scan, each running to the next mark: tools/ssd_bwd_parts.py
// builds copies with parts between them compiled out, to time each.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "wgmma.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int QM = 128;        // the largest chunk
constexpr int NM = 128;        // the largest state size N
constexpr int PM = 64;         // the largest head dim P
constexpr int LDN = NM + 1;    // odd row strides: no bank conflicts
constexpr int LDP = PM + 1;
constexpr int RF = 64;         // forward row tile of C and C B^T
constexpr int RB = 32;         // backward row / column tile
constexpr float kMinA = 1e-37f;

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

// rows [0, rows_pad) x cols [0, cols_pad) of a matrix whose row r starts at
// g + r * rs (unit column stride) into shared memory with row stride ld,
// widened to float32; rows >= rows and cols >= cols are zero.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ g,
                                          long long rs, int rows, int cols,
                                          int rows_pad, int cols_pad,
                                          float* __restrict__ s, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows_pad; r += kThreads / 32) {
    float* dst = s + r * ld;
    if (r < rows) {
      const T* src = g + (long long)r * rs;
      for (int c = lane; c < cols_pad; c += 32)
        dst[c] = c < cols ? to_f(src[c]) : 0.f;
    } else {
      for (int c = lane; c < cols_pad; c += 32) dst[c] = 0.f;
    }
  }
}

// Sum over the 16 threads of one row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One warp: c[e] = cum[4 lane + e], where cum[i] = sum_{k <= i}
// log max(a[k * as], 1e-37) for i < Q and cum[i] = 0 for Q <= i < QM.
__device__ __forceinline__ void chunk_cum(const float* __restrict__ a,
                                          long long as, int Q,
                                          float (&c)[4]) {
  const int lane = threadIdx.x & 31;
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = lane * 4 + e;
    run += i < Q ? logf(fmaxf(a[i * as], kMinA)) : 0.f;
    v[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const float excl = incl - run;
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = lane * 4 + e < Q ? excl + v[e] : 0.f;
}

// One warp: chunk_cum into shared memory, cum[i] for i < QM.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a,
                                             long long as, int Q,
                                             float* __restrict__ cum) {
  float c[4];
  chunk_cum(a, as, Q, c);
#pragma unroll
  for (int e = 0; e < 4; ++e) cum[(threadIdx.x & 31) * 4 + e] = c[e];
}

// cum[i] out of a warp's chunk_cum registers; every lane calls it, i may
// differ by lane.
__device__ __forceinline__ float cum_at(const float (&c)[4], int i) {
  const int src = i >> 2, e = i & 3;
  const float v0 = __shfl_sync(0xffffffffu, c[0], src);
  const float v1 = __shfl_sync(0xffffffffu, c[1], src);
  const float v2 = __shfl_sync(0xffffffffu, c[2], src);
  const float v3 = __shfl_sync(0xffffffffu, c[3], src);
  return e == 0 ? v0 : e == 1 ? v1 : e == 2 ? v2 : v3;
}

// ------------------------------------------------------------------ forward
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ X, const float* __restrict__ A,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               T* __restrict__ Y, float* __restrict__ Hlast,
               float* __restrict__ States, int S, int H, int P, int N, int Q,
               long long xb, long long xs, long long xh, long long bb,
               long long bs, long long bh, long long cb, long long cs,
               long long ch) {
  extern __shared__ float smem[];
  float* sB = smem;              // QM x LDN: B of the chunk
  float* sX = sB + QM * LDN;     // QM x LDP: X of the chunk
  float* sH = sX + QM * LDP;     // NM x LDP: the carried state
  float* sC = sH + NM * LDP;     // RF x LDN: a row tile of C
  float* sS = sC + RF * LDN;     // RF x QM: the tile of C B^T o L
  float* sCum = sS + RF * QM;    // QM
  float* sW = sCum + QM;         // QM: exp(total - cum)
  float* sE = sW + QM;           // QM: exp(cum)

  const int bi = blockIdx.x / H, hi = blockIdx.x % H;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = S / Q;
  const T* xg = X + bi * xb + hi * xh;
  const T* bg = Bm + bi * bb + hi * bh;
  const T* cg = Cm + bi * cb + hi * ch;
  const float* ag = A + ((long long)bi * S) * H + hi;
  T* yg = Y + ((long long)bi * S * H + hi) * P;
  const long long ys = (long long)H * P;

  for (int i = tid; i < NM * LDP; i += kThreads) sH[i] = 0.f;
  __syncthreads();

  for (int q = 0; q < nq; ++q) {
    const int s0 = q * Q;
    if (States != nullptr) {
      float* st = States + (((long long)bi * H + hi) * nq + q) * N * P;
      for (int i = tid; i < N * P; i += kThreads)
        st[i] = sH[(i / P) * LDP + i % P];
    }
    if (tid < 32) chunk_cumsum(ag + (long long)s0 * H, H, Q, sCum);
    load_tile(bg + s0 * bs, bs, Q, N, QM, NM, sB, LDN);
    load_tile(xg + s0 * xs, xs, Q, P, QM, PM, sX, LDP);
    __syncthreads();
    const float total = sCum[Q - 1];
    for (int i = tid; i < QM; i += kThreads) {
      sW[i] = i < Q ? expf(total - sCum[i]) : 0.f;
      sE[i] = i < Q ? expf(sCum[i]) : 0.f;
    }

    for (int r0 = 0; r0 < Q; r0 += RF) {
      load_tile(cg + (s0 + r0) * cs, cs, min(RF, Q - r0), N, RF, NM, sC,
                LDN);
      __syncthreads();
      // C B^T o L: rows r0 + ty + 16k, columns tx + 16m below jmax
      const int jmax = min(Q, r0 + RF);
      float acc[RF / 16][QM / 16];
#pragma unroll
      for (int k = 0; k < RF / 16; ++k)
#pragma unroll
        for (int m = 0; m < QM / 16; ++m) acc[k][m] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RF / 16];
#pragma unroll
        for (int k = 0; k < RF / 16; ++k) cv[k] = sC[(ty + 16 * k) * LDN + n];
#pragma unroll
        for (int m = 0; m < QM / 16; ++m) {
          if (16 * m >= jmax) break;
          const float bv = sB[(tx + 16 * m) * LDN + n];
#pragma unroll
          for (int k = 0; k < RF / 16; ++k)
            acc[k][m] = fmaf(cv[k], bv, acc[k][m]);
        }
      }
#pragma unroll
      for (int k = 0; k < RF / 16; ++k) {
        const int r = ty + 16 * k, i = r0 + r;
#pragma unroll
        for (int m = 0; m < QM / 16; ++m) {
          const int j = tx + 16 * m;
          float v = 0.f;
          if (i < Q && j <= i) v = acc[k][m] * expf(sCum[i] - sCum[j]);
          sS[r * QM + j] = v;
        }
      }
      __syncthreads();
      // y rows r0 + ty + 16k, columns tx + 16m
      float yi[RF / 16][PM / 16], ye[RF / 16][PM / 16];
#pragma unroll
      for (int k = 0; k < RF / 16; ++k)
#pragma unroll
        for (int m = 0; m < PM / 16; ++m) yi[k][m] = ye[k][m] = 0.f;
      for (int j = 0; j < jmax; ++j) {
        float sv[RF / 16], xv[PM / 16];
#pragma unroll
        for (int k = 0; k < RF / 16; ++k) sv[k] = sS[(ty + 16 * k) * QM + j];
#pragma unroll
        for (int m = 0; m < PM / 16; ++m) xv[m] = sX[j * LDP + tx + 16 * m];
#pragma unroll
        for (int k = 0; k < RF / 16; ++k)
#pragma unroll
          for (int m = 0; m < PM / 16; ++m)
            yi[k][m] = fmaf(sv[k], xv[m], yi[k][m]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[RF / 16], hv[PM / 16];
#pragma unroll
        for (int k = 0; k < RF / 16; ++k) cv[k] = sC[(ty + 16 * k) * LDN + n];
#pragma unroll
        for (int m = 0; m < PM / 16; ++m) hv[m] = sH[n * LDP + tx + 16 * m];
#pragma unroll
        for (int k = 0; k < RF / 16; ++k)
#pragma unroll
          for (int m = 0; m < PM / 16; ++m)
            ye[k][m] = fmaf(cv[k], hv[m], ye[k][m]);
      }
#pragma unroll
      for (int k = 0; k < RF / 16; ++k) {
        const int i = r0 + ty + 16 * k;
        if (i >= Q) continue;
        T* yrow = yg + (long long)(s0 + i) * ys;
#pragma unroll
        for (int m = 0; m < PM / 16; ++m) {
          const int p = tx + 16 * m;
          if (p < P) yrow[p] = from_f<T>(fmaf(sE[i], ye[k][m], yi[k][m]));
        }
      }
      __syncthreads();
    }

    // H = exp(total) H + (B o w)^T X: rows ty + 16k, columns tx + 16m
    float hacc[NM / 16][PM / 16];
#pragma unroll
    for (int k = 0; k < NM / 16; ++k)
#pragma unroll
      for (int m = 0; m < PM / 16; ++m) hacc[k][m] = 0.f;
    for (int j = 0; j < Q; ++j) {
      const float wj = sW[j];
      float bv[NM / 16], xv[PM / 16];
#pragma unroll
      for (int k = 0; k < NM / 16; ++k) bv[k] = sB[j * LDN + ty + 16 * k] * wj;
#pragma unroll
      for (int m = 0; m < PM / 16; ++m) xv[m] = sX[j * LDP + tx + 16 * m];
#pragma unroll
      for (int k = 0; k < NM / 16; ++k)
#pragma unroll
        for (int m = 0; m < PM / 16; ++m)
          hacc[k][m] = fmaf(bv[k], xv[m], hacc[k][m]);
    }
    const float et = expf(total);
#pragma unroll
    for (int k = 0; k < NM / 16; ++k)
#pragma unroll
      for (int m = 0; m < PM / 16; ++m) {
        float* h = sH + (ty + 16 * k) * LDP + tx + 16 * m;
        *h = fmaf(et, *h, hacc[k][m]);
      }
    __syncthreads();
  }
  float* hl = Hlast + ((long long)bi * H + hi) * N * P;
  for (int i = tid; i < N * P; i += kThreads)
    hl[i] = sH[(i / P) * LDP + i % P];
}

// ----------------------------------------------------------------- backward
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ X, const float* __restrict__ A,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               const float* __restrict__ States, const T* __restrict__ DY,
               const float* __restrict__ DHlast, T* __restrict__ DX,
               float* __restrict__ DA, T* __restrict__ DB,
               T* __restrict__ DC, int S, int H, int P, int N, int Q,
               long long xb, long long xs, long long xh, long long bb,
               long long bs, long long bh, long long cb, long long cs,
               long long ch, long long db_, long long ds, long long dh) {
  extern __shared__ float smem[];
  // regions reused between the row pass (1) and the column pass (2)
  float* rA = smem;              // QM x LDN: (1) B, (2) C
  float* rB = rA + QM * LDN;     // QM x LDP: (1) X, (2) dY
  float* rC = rB + QM * LDP;     // RB x LDN: (1) a row tile of C, (2) of B
  float* rD = rC + RB * LDN;     // RB x LDP: (1) of dY, (2) of X
  float* rE = rD + RB * LDP;     // NM x LDP: (1) H_prev, (2) S, M columns
  float* rF = rE + NM * LDP;     // RB x QM: (1) a row tile of M, (2) sums
  float* sdH = rF + RB * QM;     // NM x LDP: dH, carried across chunks
  float* sCum = sdH + NM * LDP;  // QM
  float* sW = sCum + QM;         // QM: exp(total - cum)
  float* sE = sW + QM;           // QM: exp(cum)
  float* sRowT = sE + QM;        // QM: sum_j T_ij
  float* sColT = sRowT + QM;     // QM: sum_i T_ij
  float* sDec = sColT + QM;      // QM: e_i (c_i . D_i)
  float* sDw = sDec + QM;        // QM: w_j dw_j
  float* sRed = sDw + QM;        // kThreads / 32: <H_prev, dH> by warp
  float* sSt = rE;               // (2) QM x RB: (G o L) columns
  float* sMt = rE + QM * RB;     // (2) QM x RB: M columns

  const int bi = blockIdx.x / H, hi = blockIdx.x % H;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int nq = S / Q;
  const T* xg = X + bi * xb + hi * xh;
  const T* bg = Bm + bi * bb + hi * bh;
  const T* cg = Cm + bi * cb + hi * ch;
  const T* dyg = DY + bi * db_ + hi * dh;
  const float* ag = A + ((long long)bi * S) * H + hi;
  const long long os = (long long)H;  // step stride of the outputs, rows
  T* dxg = DX + ((long long)bi * S * H + hi) * P;
  T* dbg = DB + ((long long)bi * S * H + hi) * N;
  T* dcg = DC + ((long long)bi * S * H + hi) * N;
  float* dag = DA + ((long long)bi * S) * H + hi;

  {
    const float* dl =
        DHlast ? DHlast + ((long long)bi * H + hi) * N * P : nullptr;
    for (int i = tid; i < NM * LDP; i += kThreads) {
      const int n = i / LDP, p = i % LDP;
      sdH[i] = (dl && n < N && p < P) ? dl[n * P + p] : 0.f;
    }
  }

  for (int q = nq - 1; q >= 0; --q) {
    const int s0 = q * Q;
    if (tid < 32) chunk_cumsum(ag + (long long)s0 * H, H, Q, sCum);
    {
      const float* st = States + (((long long)bi * H + hi) * nq + q) * N * P;
      load_tile(st, P, N, P, NM, PM, rE, LDP);
    }
    load_tile(bg + s0 * bs, bs, Q, N, QM, NM, rA, LDN);
    load_tile(xg + s0 * xs, xs, Q, P, QM, PM, rB, LDP);
    __syncthreads();
    const float total = sCum[Q - 1];
    for (int i = tid; i < QM; i += kThreads) {
      sW[i] = i < Q ? expf(total - sCum[i]) : 0.f;
      sE[i] = i < Q ? expf(sCum[i]) : 0.f;
    }
    {  // <H_prev, dH>, one partial a warp
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < NM / 16; ++k)
#pragma unroll
        for (int m = 0; m < PM / 16; ++m) {
          const int o = (ty + 16 * k) * LDP + tx + 16 * m;
          part = fmaf(rE[o], sdH[o], part);
        }
      part = warp_sum(part);
      if (lane == 0) sRed[warp] = part;
    }

    // (1) rows: for each tile of RB rows i, all columns j
    for (int i0 = 0; i0 < Q; i0 += RB) {
      const int rows = min(RB, Q - i0);
      load_tile(cg + (s0 + i0) * cs, cs, rows, N, RB, NM, rC, LDN);
      load_tile(dyg + (s0 + i0) * ds, ds, rows, P, RB, PM, rD, LDP);
      __syncthreads();
      const int jmax = min(Q, i0 + RB);
      float g[RB / 16][QM / 16], d[RB / 16][QM / 16];
#pragma unroll
      for (int k = 0; k < RB / 16; ++k)
#pragma unroll
        for (int m = 0; m < QM / 16; ++m) g[k][m] = d[k][m] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RB / 16];
#pragma unroll
        for (int k = 0; k < RB / 16; ++k) cv[k] = rC[(ty + 16 * k) * LDN + n];
#pragma unroll
        for (int m = 0; m < QM / 16; ++m) {
          if (16 * m >= jmax) break;
          const float bv = rA[(tx + 16 * m) * LDN + n];
#pragma unroll
          for (int k = 0; k < RB / 16; ++k) g[k][m] = fmaf(cv[k], bv, g[k][m]);
        }
      }
      for (int p = 0; p < P; ++p) {
        float dv[RB / 16];
#pragma unroll
        for (int k = 0; k < RB / 16; ++k) dv[k] = rD[(ty + 16 * k) * LDP + p];
#pragma unroll
        for (int m = 0; m < QM / 16; ++m) {
          if (16 * m >= jmax) break;
          const float xv = rB[(tx + 16 * m) * LDP + p];
#pragma unroll
          for (int k = 0; k < RB / 16; ++k) d[k][m] = fmaf(dv[k], xv, d[k][m]);
        }
      }
#pragma unroll
      for (int k = 0; k < RB / 16; ++k) {
        const int r = ty + 16 * k, i = i0 + r;
        float tsum = 0.f;
#pragma unroll
        for (int m = 0; m < QM / 16; ++m) {
          const int j = tx + 16 * m;
          float mv = 0.f;
          if (i < Q && j <= i) {
            mv = d[k][m] * expf(sCum[i] - sCum[j]);
            tsum = fmaf(mv, g[k][m], tsum);
          }
          rF[r * QM + j] = mv;
        }
        tsum = group_sum(tsum);
        if (tx == 0 && i < Q) sRowT[i] = tsum;
      }
      __syncthreads();
      // dc = M B + e o (dY H_prev^T): rows i0 + ty + 16k, columns tx + 16m
      float mb[RB / 16][NM / 16], dd[RB / 16][NM / 16];
#pragma unroll
      for (int k = 0; k < RB / 16; ++k)
#pragma unroll
        for (int m = 0; m < NM / 16; ++m) mb[k][m] = dd[k][m] = 0.f;
      for (int j = 0; j < jmax; ++j) {
        float mv[RB / 16], bv[NM / 16];
#pragma unroll
        for (int k = 0; k < RB / 16; ++k) mv[k] = rF[(ty + 16 * k) * QM + j];
#pragma unroll
        for (int m = 0; m < NM / 16; ++m) bv[m] = rA[j * LDN + tx + 16 * m];
#pragma unroll
        for (int k = 0; k < RB / 16; ++k)
#pragma unroll
          for (int m = 0; m < NM / 16; ++m)
            mb[k][m] = fmaf(mv[k], bv[m], mb[k][m]);
      }
      for (int p = 0; p < P; ++p) {
        float dv[RB / 16], hv[NM / 16];
#pragma unroll
        for (int k = 0; k < RB / 16; ++k) dv[k] = rD[(ty + 16 * k) * LDP + p];
#pragma unroll
        for (int m = 0; m < NM / 16; ++m) hv[m] = rE[(tx + 16 * m) * LDP + p];
#pragma unroll
        for (int k = 0; k < RB / 16; ++k)
#pragma unroll
          for (int m = 0; m < NM / 16; ++m)
            dd[k][m] = fmaf(dv[k], hv[m], dd[k][m]);
      }
#pragma unroll
      for (int k = 0; k < RB / 16; ++k) {
        const int r = ty + 16 * k, i = i0 + r;
        const float ei = sE[i];
        float dec = 0.f;
        T* dcrow = dcg + (long long)(s0 + i) * os * N;
#pragma unroll
        for (int m = 0; m < NM / 16; ++m) {
          const int n = tx + 16 * m;
          dec = fmaf(rC[r * LDN + n], dd[k][m], dec);
          if (i < Q && n < N) dcrow[n] = from_f<T>(fmaf(ei, dd[k][m], mb[k][m]));
        }
        dec = group_sum(dec);
        if (tx == 0 && i < Q) sDec[i] = ei * dec;
      }
      __syncthreads();
    }

    // (2) columns: for each tile of RB columns j, the rows i >= j
    load_tile(cg + s0 * cs, cs, Q, N, QM, NM, rA, LDN);
    load_tile(dyg + s0 * ds, ds, Q, P, QM, PM, rB, LDP);
    for (int j0 = 0; j0 < Q; j0 += RB) {
      const int cols = min(RB, Q - j0);
      load_tile(bg + (s0 + j0) * bs, bs, cols, N, RB, NM, rC, LDN);
      load_tile(xg + (s0 + j0) * xs, xs, cols, P, RB, PM, rD, LDP);
      __syncthreads();
      float g[QM / 16][RB / 16], d[QM / 16][RB / 16];
#pragma unroll
      for (int k = 0; k < QM / 16; ++k)
#pragma unroll
        for (int m = 0; m < RB / 16; ++m) g[k][m] = d[k][m] = 0.f;
      for (int n = 0; n < N; ++n) {
        float bv[RB / 16];
#pragma unroll
        for (int m = 0; m < RB / 16; ++m) bv[m] = rC[(tx + 16 * m) * LDN + n];
#pragma unroll
        for (int k = 0; k < QM / 16; ++k) {
          if (16 * k + 15 < j0 || 16 * k >= Q) continue;
          const float cv = rA[(ty + 16 * k) * LDN + n];
#pragma unroll
          for (int m = 0; m < RB / 16; ++m) g[k][m] = fmaf(cv, bv[m], g[k][m]);
        }
      }
      for (int p = 0; p < P; ++p) {
        float xv[RB / 16];
#pragma unroll
        for (int m = 0; m < RB / 16; ++m) xv[m] = rD[(tx + 16 * m) * LDP + p];
#pragma unroll
        for (int k = 0; k < QM / 16; ++k) {
          if (16 * k + 15 < j0 || 16 * k >= Q) continue;
          const float dv = rB[(ty + 16 * k) * LDP + p];
#pragma unroll
          for (int m = 0; m < RB / 16; ++m) d[k][m] = fmaf(dv, xv[m], d[k][m]);
        }
      }
      float tcol[RB / 16];
#pragma unroll
      for (int m = 0; m < RB / 16; ++m) tcol[m] = 0.f;
#pragma unroll
      for (int k = 0; k < QM / 16; ++k) {
        if (16 * k + 15 < j0 || 16 * k >= Q) continue;
        const int i = ty + 16 * k;
#pragma unroll
        for (int m = 0; m < RB / 16; ++m) {
          const int jj = tx + 16 * m, j = j0 + jj;
          float sv = 0.f, mv = 0.f;
          if (i < Q && j <= i) {
            const float l = expf(sCum[i] - sCum[j]);
            sv = g[k][m] * l;
            mv = d[k][m] * l;
            tcol[m] = fmaf(mv, g[k][m], tcol[m]);
          }
          sSt[i * RB + jj] = sv;
          sMt[i * RB + jj] = mv;
        }
      }
#pragma unroll
      for (int m = 0; m < RB / 16; ++m) rF[ty * RB + tx + 16 * m] = tcol[m];
      __syncthreads();
      if (tid < RB && j0 + tid < Q) {
        float t = 0.f;
        for (int r = 0; r < 16; ++r) t += rF[r * RB + tid];
        sColT[j0 + tid] = t;
      }
      // dx = (G o L)^T dY + w o (B dH): rows j0 + ty + 16k, columns tx + 16m
      {
        float sd[RB / 16][PM / 16], bd[RB / 16][PM / 16];
#pragma unroll
        for (int k = 0; k < RB / 16; ++k)
#pragma unroll
          for (int m = 0; m < PM / 16; ++m) sd[k][m] = bd[k][m] = 0.f;
        for (int i = j0; i < Q; ++i) {
          float sv[RB / 16], dv[PM / 16];
#pragma unroll
          for (int k = 0; k < RB / 16; ++k) sv[k] = sSt[i * RB + ty + 16 * k];
#pragma unroll
          for (int m = 0; m < PM / 16; ++m) dv[m] = rB[i * LDP + tx + 16 * m];
#pragma unroll
          for (int k = 0; k < RB / 16; ++k)
#pragma unroll
            for (int m = 0; m < PM / 16; ++m)
              sd[k][m] = fmaf(sv[k], dv[m], sd[k][m]);
        }
        for (int n = 0; n < N; ++n) {
          float bv[RB / 16], hv[PM / 16];
#pragma unroll
          for (int k = 0; k < RB / 16; ++k) bv[k] = rC[(ty + 16 * k) * LDN + n];
#pragma unroll
          for (int m = 0; m < PM / 16; ++m) hv[m] = sdH[n * LDP + tx + 16 * m];
#pragma unroll
          for (int k = 0; k < RB / 16; ++k)
#pragma unroll
            for (int m = 0; m < PM / 16; ++m)
              bd[k][m] = fmaf(bv[k], hv[m], bd[k][m]);
        }
#pragma unroll
        for (int k = 0; k < RB / 16; ++k) {
          const int j = j0 + ty + 16 * k;
          if (j >= Q) continue;
          T* dxrow = dxg + (long long)(s0 + j) * os * P;
#pragma unroll
          for (int m = 0; m < PM / 16; ++m) {
            const int p = tx + 16 * m;
            if (p < P) dxrow[p] = from_f<T>(fmaf(sW[j], bd[k][m], sd[k][m]));
          }
        }
      }
      // db = M^T C + w o (X dH^T): rows j0 + ty + 16k, columns tx + 16m
      {
        float mc[RB / 16][NM / 16], xd[RB / 16][NM / 16];
#pragma unroll
        for (int k = 0; k < RB / 16; ++k)
#pragma unroll
          for (int m = 0; m < NM / 16; ++m) mc[k][m] = xd[k][m] = 0.f;
        for (int i = j0; i < Q; ++i) {
          float mv[RB / 16], cv[NM / 16];
#pragma unroll
          for (int k = 0; k < RB / 16; ++k) mv[k] = sMt[i * RB + ty + 16 * k];
#pragma unroll
          for (int m = 0; m < NM / 16; ++m) cv[m] = rA[i * LDN + tx + 16 * m];
#pragma unroll
          for (int k = 0; k < RB / 16; ++k)
#pragma unroll
            for (int m = 0; m < NM / 16; ++m)
              mc[k][m] = fmaf(mv[k], cv[m], mc[k][m]);
        }
        for (int p = 0; p < P; ++p) {
          float xv[RB / 16], hv[NM / 16];
#pragma unroll
          for (int k = 0; k < RB / 16; ++k) xv[k] = rD[(ty + 16 * k) * LDP + p];
#pragma unroll
          for (int m = 0; m < NM / 16; ++m) hv[m] = sdH[(tx + 16 * m) * LDP + p];
#pragma unroll
          for (int k = 0; k < RB / 16; ++k)
#pragma unroll
            for (int m = 0; m < NM / 16; ++m)
              xd[k][m] = fmaf(xv[k], hv[m], xd[k][m]);
        }
#pragma unroll
        for (int k = 0; k < RB / 16; ++k) {
          const int jj = ty + 16 * k, j = j0 + jj;
          const float wj = sW[j];
          float dw = 0.f;
          T* dbrow = dbg + (long long)(s0 + j) * os * N;
#pragma unroll
          for (int m = 0; m < NM / 16; ++m) {
            const int n = tx + 16 * m;
            dw = fmaf(rC[jj * LDN + n], xd[k][m], dw);
            if (j < Q && n < N) dbrow[n] = from_f<T>(fmaf(wj, xd[k][m], mc[k][m]));
          }
          dw = group_sum(dw);
          if (tx == 0 && j < Q) sDw[j] = wj * dw;
        }
      }
      __syncthreads();
    }

    // dH_prev = exp(total) dH + (C o e)^T dY: rows ty + 16k, columns tx + 16m
    float nh[NM / 16][PM / 16];
#pragma unroll
    for (int k = 0; k < NM / 16; ++k)
#pragma unroll
      for (int m = 0; m < PM / 16; ++m) nh[k][m] = 0.f;
    for (int i = 0; i < Q; ++i) {
      const float ei = sE[i];
      float cv[NM / 16], dv[PM / 16];
#pragma unroll
      for (int k = 0; k < NM / 16; ++k) cv[k] = rA[i * LDN + ty + 16 * k] * ei;
#pragma unroll
      for (int m = 0; m < PM / 16; ++m) dv[m] = rB[i * LDP + tx + 16 * m];
#pragma unroll
      for (int k = 0; k < NM / 16; ++k)
#pragma unroll
        for (int m = 0; m < PM / 16; ++m) nh[k][m] = fmaf(cv[k], dv[m], nh[k][m]);
    }
    const float et = expf(total);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NM / 16; ++k)
#pragma unroll
      for (int m = 0; m < PM / 16; ++m) {
        float* h = sdH + (ty + 16 * k) * LDP + tx + 16 * m;
        *h = fmaf(et, *h, nh[k][m]);
      }

    // dcum, then d log a by a reverse cumulative sum, then da (one warp)
    if (warp == 0) {
      float hd = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) hd += sRed[w];
      float dwsum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = lane * 4 + e;
        if (i < Q) dwsum += sDw[i];
      }
      dwsum = warp_sum(dwsum);
      const float dtotal = dwsum + et * hd;
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int e = 3; e >= 0; --e) {
        const int i = lane * 4 + e;
        float dc = 0.f;
        if (i < Q) {
          dc = sRowT[i] - sColT[i] + sDec[i] - sDw[i];
          if (i == Q - 1) dc += dtotal;
        }
        run += dc;
        v[e] = run;
      }
      float incl = run;  // sum over lanes >= lane
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += t;
      }
      const float excl = incl - run;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = lane * 4 + e;
        if (i < Q) {
          const float ai = ag[(long long)(s0 + i) * H];
          dag[(long long)(s0 + i) * H] = ai > kMinA ? (excl + v[e]) / ai : 0.f;
        }
      }
    }
    __syncthreads();
  }
}

constexpr size_t kFwdSmem =
    sizeof(float) * (QM * LDN + QM * LDP + NM * LDP + RF * LDN + RF * QM +
                     3 * QM);
constexpr size_t kBwdSmem =
    sizeof(float) * (QM * LDN + QM * LDP + RB * LDN + RB * LDP + NM * LDP +
                     RB * QM + NM * LDP + 8 * QM + kThreads / 32);
static_assert(kFwdSmem <= 232448, "forward tiles exceed shared memory");
static_assert(kBwdSmem <= 232448, "backward tiles exceed shared memory");
static_assert(2 * QM * RB <= NM * LDP, "S and M columns exceed H_prev's room");
static_assert(16 * RB <= RB * QM, "column sums exceed the M tile's room");

template <typename T>
int fwd(const void* x, const float* a, const void* b, const void* c, void* y,
        float* hlast, float* states, int B, int S, int H, int P, int N,
        int Q, long long xb, long long xs, long long xh, long long bb,
        long long bs, long long bh, long long cb, long long cs, long long ch,
        cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_kernel<T><<<B * H, kThreads, kFwdSmem, stream>>>(
      (const T*)x, a, (const T*)b, (const T*)c, (T*)y, hlast, states, S, H,
      P, N, Q, xb, xs, xh, bb, bs, bh, cb, cs, ch);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const float* a, const void* b, const void* c,
        const float* states, const void* dy, const float* dhlast, void* dx,
        float* da, void* db, void* dc, int B, int S, int H, int P, int N,
        int Q, long long xb, long long xs, long long xh, long long bb,
        long long bs, long long bh, long long cb, long long cs, long long ch,
        long long yb, long long ys, long long yh, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBwdSmem);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel<T><<<B * H, kThreads, kBwdSmem, stream>>>(
      (const T*)x, a, (const T*)b, (const T*)c, states, (const T*)dy, dhlast,
      (T*)dx, da, (T*)db, (T*)dc, S, H, P, N, Q, xb, xs, xh, bb, bs, bh, cb,
      cs, ch, yb, ys, yh);
  return (int)cudaGetLastError();
}


// ------------------------------------------------ backward, the wgmma route
constexpr int kWG = 128;     // threads of a warpgroup
constexpr int kRow = 128;    // bytes of a swizzled row: 64 bf16 columns
constexpr int kStateBox = NM * kRow;  // an N x P state as one bf16 box

// Byte offset of element (r, c), c < 64, in a box of 128-byte rows under
// the 128-byte swizzle that the wgmma descriptors read (the 16-byte chunk
// c / 8 of row r is stored at chunk (c / 8) ^ (r % 8)).
__device__ __forceinline__ int sw(int r, int c) {
  return r * kRow + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ float sm_bf(const uint8_t* box, int r, int c) {
  return __bfloat162float(
      *reinterpret_cast<const __nv_bfloat16*>(box + sw(r, c)));
}

// Elements (r, c) and (r, c + 1), c even.
__device__ __forceinline__ float2 sm_bf2(const uint8_t* box, int r, int c) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(box + sw(r, c)));
}

// Four float32 values as bf16 pairs: hi (each rounded) at `hi`, lo (what
// that lost, rounded again) at `lo`, 8 bytes each.
__device__ __forceinline__ void store_pair(uint8_t* hi, uint8_t* lo,
                                           float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  const float2 af = __bfloat1622float2(a), bf = __bfloat1622float2(b);
  *reinterpret_cast<uint2*>(hi) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                 *reinterpret_cast<const uint32_t*>(&b));
  *reinterpret_cast<uint2*>(lo) =
      make_uint2(bf16x2(v.x - af.x, v.y - af.y), bf16x2(v.z - bf.x, v.w - bf.y));
}

// Rows [0, R) and columns [0, 64 NB) of a bf16 matrix whose row r starts at
// g + r * rs (unit column stride, K valid columns, K a multiple of 8) into
// NB swizzled boxes of R rows (box k at s + k R 128 bytes); columns >= K
// are zero.  kVec: g and rs allow 16-byte copies (cp.async), else the
// chunk is read an element at a time.
template <bool kVec>
__device__ __forceinline__ void stage(uint8_t* s, const __nv_bfloat16* g,
                                      long long rs, int R, int NB, int K) {
  for (int i = threadIdx.x; i < R * NB * 8; i += blockDim.x) {
    const int r = i / (NB * 8), c8 = i % (NB * 8);
    uint8_t* dst = s + (c8 >> 3) * R * kRow + sw(r, (c8 & 7) * 8);
    const __nv_bfloat16* src = g + r * rs + c8 * 8;
    if (c8 * 8 >= K) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else if constexpr (kVec) {
      cp_async16(dst, src);
    } else {
      const unsigned short* e = reinterpret_cast<const unsigned short*>(src);
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = (uint32_t)e[2 * k] | ((uint32_t)e[2 * k + 1] << 16);
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Wait for this thread's copies, make every staged tile visible to wgmma
// (the async proxy), then to the CTA.
__device__ __forceinline__ void staged() {
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
}

// The N x P product (M o s)^T R of one chunk (pass A of both wgmma routes),
// float32 into `out()` (row stride P; the pointer is taken only when the
// product is done, which keeps it out of the registers the product holds):
// M the chunk's Q x N rows at m (row
// stride ms), R its Q x P rows at r (row stride rs), a the chunk's decays
// (stride H), s = exp(cum) (kTail false: the backward's U_q = (C o e)^T dY)
// or exp(total - cum) (kTail true: the forward's S_q = (B o w)^T X).  Two
// warpgroups, 64 rows n each; A = (M o s)^T is built in registers as a
// bf16 pair hi + lo from the staged M, B = R MN-major.  Four CTAs an SM
// (64 registers): ptxas spills ~100 bytes of the fragments, which costs
// less than the latency two CTAs an SM leave exposed.
template <int QT, bool kVec, bool kTail, typename Out>
__device__ __forceinline__ void chunk_state(const __nv_bfloat16* m,
                                            long long ms,
                                            const __nv_bfloat16* r,
                                            long long rs, const float* a,
                                            int H, int P, int N, Out out) {
  constexpr int Q = 64 * QT;
  uint8_t* sm = smem_base();
  uint8_t* sM = sm;                 // 2 boxes of Q rows
  uint8_t* sR = sm + 2 * Q * kRow;  // 1 box of Q rows
  float* sCum = reinterpret_cast<float*>(sm + 3 * Q * kRow);  // QM
  float* sS = sCum + QM;                                       // QM

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  stage<kVec>(sM, m, ms, Q, 2, N);
  stage<kVec>(sR, r, rs, Q, 1, P);
  if (tid < 32) chunk_cumsum(a, H, Q, sCum);
  __syncthreads();
  for (int i = tid; i < Q; i += blockDim.x)
    sS[i] = kTail ? expf(sCum[Q - 1] - sCum[i]) : expf(sCum[i]);
  staged();

  // A fragments: register j holds rows n and n + 8 (j odd), columns
  // 16c + 8 (j / 2) + 2 tq and the next
  const int n = 64 * wg + 16 * warp + g;
  uint32_t ah[4 * QT][4], al[4 * QT][4];
#pragma unroll
  for (int c = 0; c < 4 * QT; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = n + 8 * (j & 1), i = 16 * c + 8 * (j >> 1) + 2 * tq;
      const uint8_t* box = sM + (rr >> 6) * Q * kRow;
      const float x = sm_bf(box, i, rr & 63) * sS[i];
      const float y = sm_bf(box, i + 1, rr & 63) * sS[i + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
      const float2 f = __bfloat1622float2(hi);
      ah[c][j] = *reinterpret_cast<const uint32_t*>(&hi);
      al[c][j] = bf16x2(x - f.x, y - f.y);
    }
  float u[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) u[k] = 0.f;
  hold(u);
  hold(ah);
  hold(al);
  wg_fence();
#pragma unroll
  for (int c = 0; c < 4 * QT; ++c) {
    const uint64_t bd = sw128_desc(sR + 16 * c * kRow, Q * kRow, 1024);
    wgmma_rs_n64(u, ah[c], bd, 1);
    wgmma_rs_n64(u, al[c], bd, 1);
  }
  wg_commit();
  wg_wait_all();
  hold(u);
  hold(ah);
  hold(al);
  float* o = out();
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    const int rr = 64 * wg + 16 * warp + g + 8 * ((k >> 1) & 1);
    const int p = 8 * (k >> 2) + 2 * tq;
    if (rr < N && p < P)
      *reinterpret_cast<float2*>(o + rr * P + p) = make_float2(u[k], u[k + 1]);
  }
}

// Pass A of the backward: U_q = (C o e)^T dY of chunk q >= 1 of one (batch,
// head), N x P float32 into dH_end[q] (pass B turns it into dH_end(q) in
// place).
template <int QT, bool kVec>
__global__ void __launch_bounds__(2 * kWG, 4)
ssd_bwd_u_kernel(const __nv_bfloat16* __restrict__ Cm,
                 const float* __restrict__ A,
                 const __nv_bfloat16* __restrict__ DY,
                 float* __restrict__ Dend, int S, int H, int P, int N,
                 long long cb, long long cs, long long ch, long long yb,
                 long long ys, long long yh) {
  constexpr int Q = 64 * QT;
  const int nq = S / Q;
  const int h = blockIdx.x % H, t = blockIdx.x / H;
  const int q = 1 + t % (nq - 1), bi = t / (nq - 1), s0 = q * Q;
  chunk_state<QT, kVec, false>(
      Cm + bi * cb + h * ch + s0 * cs, cs, DY + bi * yb + h * yh + s0 * ys,
      ys, A + ((long long)bi * S + s0) * H + h, H, P, N, [=] {
        return Dend + (((long long)bi * H + h) * nq + q) * N * P;
      });
}

// Pass A of the forward: S_q = (B o w)^T X of chunk q of one (batch, head),
// N x P float32 into chunk q + 1's slot of the states (the last chunk's
// into h_last); pass B turns them into the chunk-start states in place.
template <int QT, bool kVec>
__global__ void __launch_bounds__(2 * kWG, 4)
ssd_fwd_state_kernel(const __nv_bfloat16* __restrict__ X,
                     const float* __restrict__ A,
                     const __nv_bfloat16* __restrict__ Bm,
                     float* __restrict__ States, float* __restrict__ Hlast,
                     int S, int H, int P, int N, long long xb, long long xs,
                     long long xh, long long bb, long long bs, long long bh) {
  constexpr int Q = 64 * QT;
  const int nq = S / Q;
  const int h = blockIdx.x % H, t = blockIdx.x / H;
  const int q = t % nq, bi = t / nq, s0 = q * Q;
  chunk_state<QT, kVec, true>(
      Bm + bi * bb + h * bh + s0 * bs, bs, X + bi * xb + h * xh + s0 * xs,
      xs, A + ((long long)bi * S + s0) * H + h, H, P, N, [=] {
        const long long head = (long long)bi * H + h;
        return q + 1 < nq ? States + (head * nq + q + 1) * N * P
                          : Hlast + head * N * P;
      });
}

// Pass B: dH_end(q) across the chunks of one (batch, head), in reverse and
// in place over pass A's U: dH_end(last) = dh_last (or 0), dH_end(q - 1) =
// exp(total_q) dH_end(q) + U_q.  The warps first take every chunk's
// exp(total_q) from its cumulative sum, as pass C does, into shared memory
// (S / Q floats, dynamic); then each thread carries 4 floats of N x P,
// with the next kCarryDepth chunks' U in flight while it stores the
// current ones' dH_end (the first batch's loads start before the totals).
constexpr int kCarryDepth = 4;

__global__ void __launch_bounds__(kThreads)
ssd_bwd_carry_kernel(float* __restrict__ Dend, const float* __restrict__ A,
                     const float* __restrict__ DHlast, int S, int H, int NP,
                     int Q) {
  extern __shared__ float sDecay[];  // exp(total_q)
  __shared__ float sCum[kThreads / 32][QM];
  const int nq = S / Q, bh = blockIdx.x, bi = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5;
  const int e4 = blockIdx.y * kThreads + threadIdx.x;
  const bool live = 4 * e4 < NP;
  float4* col = reinterpret_cast<float4*>(Dend + (long long)bh * nq * NP) + e4;
  const long long qs = NP / 4;  // float4s from one chunk's dH to the next
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 u[kCarryDepth];  // the U of chunks q0, q0 - 1, ...
#pragma unroll
  for (int k = 0; k < kCarryDepth; ++k)
    u[k] = live && nq - 1 - k >= 1 ? col[(nq - 1 - k) * qs] : zero;
  const float* ag = A + (long long)bi * S * H + h;
  for (int q = 1 + warp; q < nq; q += kThreads / 32) {
    chunk_cumsum(ag + (long long)q * Q * H, H, Q, sCum[warp]);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) sDecay[q] = expf(sCum[warp][Q - 1]);
    __syncwarp();
  }
  __syncthreads();
  if (!live) return;
  float4 run = DHlast != nullptr
                   ? reinterpret_cast<const float4*>(DHlast + (long long)bh * NP)[e4]
                   : zero;
  for (int q0 = nq - 1; q0 >= 0; q0 -= kCarryDepth) {
    float4 un[kCarryDepth];  // the next batch, in flight during this one
#pragma unroll
    for (int k = 0; k < kCarryDepth; ++k) {
      const int q = q0 - kCarryDepth - k;
      un[k] = q >= 1 ? col[q * qs] : zero;
    }
#pragma unroll
    for (int k = 0; k < kCarryDepth; ++k) {
      const int q = q0 - k;
      if (q < 0) break;
      col[q * qs] = run;
      if (q >= 1) {
        const float et = sDecay[q];
        run = make_float4(fmaf(et, run.x, u[k].x), fmaf(et, run.y, u[k].y),
                          fmaf(et, run.z, u[k].z), fmaf(et, run.w, u[k].w));
      }
    }
#pragma unroll
    for (int k = 0; k < kCarryDepth; ++k) u[k] = un[k];
  }
}

// Pass B of the forward: the chunk-start states of one (batch, head), in
// order and in place over pass A's S_q: H_start(0) = 0, H_start(q + 1) =
// exp(total_q) H_start(q) + S_q, and h_last = H_start(last + 1), where S_q
// sits in slot q + 1 (the last chunk's in h_last).  The mirror of
// ssd_bwd_carry_kernel: the warps take every chunk's exp(total_q) into
// shared memory first, then each thread carries 4 floats of N x P with
// the next kCarryDepth chunks' S_q in flight.
__global__ void __launch_bounds__(kThreads)
ssd_fwd_carry_kernel(float* __restrict__ States, float* __restrict__ Hlast,
                     const float* __restrict__ A, int S, int H, int NP,
                     int Q) {
  extern __shared__ float sDecay[];  // exp(total_q)
  __shared__ float sCum[kThreads / 32][QM];
  const int nq = S / Q, bh = blockIdx.x, bi = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5;
  const int e4 = blockIdx.y * kThreads + threadIdx.x;
  const bool live = 4 * e4 < NP;
  float4* col = reinterpret_cast<float4*>(States + (long long)bh * nq * NP) + e4;
  float4* last = reinterpret_cast<float4*>(Hlast + (long long)bh * NP) + e4;
  const long long qs = NP / 4;  // float4s from one chunk's state to the next
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // S_q of chunk q < nq
  auto own = [&](int q) { return q + 1 < nq ? col[(q + 1) * qs] : *last; };
  float4 u[kCarryDepth];  // the S_q of chunks q0, q0 + 1, ...
#pragma unroll
  for (int k = 0; k < kCarryDepth; ++k) u[k] = live && k < nq ? own(k) : zero;
  const float* ag = A + (long long)bi * S * H + h;
  for (int q = warp; q < nq; q += kThreads / 32) {
    chunk_cumsum(ag + (long long)q * Q * H, H, Q, sCum[warp]);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) sDecay[q] = expf(sCum[warp][Q - 1]);
    __syncwarp();
  }
  __syncthreads();
  if (!live) return;
  float4 run = zero;
  for (int q0 = 0; q0 < nq; q0 += kCarryDepth) {
    float4 un[kCarryDepth];  // the next batch, in flight during this one
#pragma unroll
    for (int k = 0; k < kCarryDepth; ++k) {
      const int q = q0 + kCarryDepth + k;
      un[k] = q < nq ? own(q) : zero;
    }
#pragma unroll
    for (int k = 0; k < kCarryDepth; ++k) {
      const int q = q0 + k;
      if (q >= nq) break;
      col[q * qs] = run;
      const float et = sDecay[q];
      run = make_float4(fmaf(et, run.x, u[k].x), fmaf(et, run.y, u[k].y),
                        fmaf(et, run.z, u[k].z), fmaf(et, run.w, u[k].w));
    }
#pragma unroll
    for (int k = 0; k < kCarryDepth; ++k) u[k] = un[k];
  }
  *last = run;
}

template <int QT>
struct BwdTiles {
  static constexpr int Q = 64 * QT;
  static constexpr int X = 0;                  // X: 1 box of Q rows
  static constexpr int DY = Q * kRow;          // dY: 1 box
  static constexpr int B = 2 * Q * kRow;       // B: 2 boxes
  static constexpr int C = 4 * Q * kRow;       // C: 2 boxes
  static constexpr int DHH = 6 * Q * kRow;     // dH hi, N x P
  static constexpr int DHL = DHH + kStateBox;  // dH lo
  static constexpr int HPH = DHL + kStateBox;  // H_prev hi
  static constexpr int HPL = HPH + kStateBox;  // H_prev lo
  static constexpr int F = HPL + kStateBox;    // float arrays below
  static constexpr int SMEM = F + (8 * QM + 8) * 4 + 1024;
};

// Pass C: the outputs of chunk q of one (batch, head) from H_prev (the
// forward's states) and dH = dH_end(q).  QT warpgroups; warpgroup w owns
// rows 64w .. 64w + 63 of the chunk, as i (the rows of dc, phase 1) and
// then as j (the rows of dx and db, phase 2).  Float32 operands enter the
// products as bf16 pairs hi + lo, scales by row stay outside them.
template <int QT, bool kVec>
__global__ void __launch_bounds__(QT * kWG, 1)
ssd_bwd_chunk_kernel(const __nv_bfloat16* __restrict__ X,
                     const float* __restrict__ A,
                     const __nv_bfloat16* __restrict__ Bm,
                     const __nv_bfloat16* __restrict__ Cm,
                     const float* __restrict__ States,
                     const __nv_bfloat16* __restrict__ DY,
                     const float* __restrict__ Dend,
                     __nv_bfloat16* __restrict__ DX, float* __restrict__ DA,
                     __nv_bfloat16* __restrict__ DB,
                     __nv_bfloat16* __restrict__ DC, int S, int H, int P,
                     int N, long long xb, long long xs, long long xh,
                     long long bb, long long bs, long long bh, long long cb,
                     long long cs, long long ch, long long yb, long long ys,
                     long long yh) {
  using T = BwdTiles<QT>;
  constexpr int Q = T::Q;
  uint8_t* sm = smem_base();
  float* sCum = reinterpret_cast<float*>(sm + T::F);  // QM each
  float* sE = sCum + QM;     // exp(cum)
  float* sW = sE + QM;       // exp(total - cum)
  float* sRowT = sW + QM;    // sum_j T_ij
  float* sColT = sRowT + QM;  // sum_i T_ij
  float* sDec = sColT + QM;  // e_i (c_i . D_i)
  float* sDw = sDec + QM;    // w_j dw_j
  float* sA = sDw + QM;      // the chunk's a
  float* sRed = sA + QM;     // <H_prev, dH> by warp

  const int nq = S / Q;
  const int h = blockIdx.x % H, t = blockIdx.x / H;
  const int q = t % nq, bi = t / nq, s0 = q * Q;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rl = 16 * warp + g;  // the thread's rows rl and rl + 8 of a tile

  stage<kVec>(sm + T::X, X + bi * xb + h * xh + s0 * xs, xs, Q, 1, P);
  stage<kVec>(sm + T::DY, DY + bi * yb + h * yh + s0 * ys, ys, Q, 1, P);
  stage<kVec>(sm + T::B, Bm + bi * bb + h * bh + s0 * bs, bs, Q, 2, N);
  stage<kVec>(sm + T::C, Cm + bi * cb + h * ch + s0 * cs, cs, Q, 2, N);
  const float* ag = A + ((long long)bi * S + s0) * H + h;
  if (tid < 32) chunk_cumsum(ag, H, Q, sCum);
  else if (tid < 64)  // the chunk's a, for da at the end
    for (int i = tid - 32; i < Q; i += 32) sA[i] = ag[(long long)i * H];
  {  // dH and H_prev as bf16 pairs, N x P padded to NM x PM; <H_prev, dH>
    const long long off = (((long long)bi * H + h) * nq + q) * N * P;
    constexpr int kF = NM * PM / 4 / (QT * kWG);  // float4s a thread
    constexpr int kBatch = kF < 8 ? kF : 8;       // loads in flight
    float part = 0.f;
#pragma unroll
    for (int f0 = 0; f0 < kF; f0 += kBatch) {
      float4 dd[kBatch], ss[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int f = tid + (f0 + k) * QT * kWG;
        const int r = f / (PM / 4), p = 4 * (f % (PM / 4));
        dd[k] = ss[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < N && p < P) {
          dd[k] = *reinterpret_cast<const float4*>(Dend + off + r * P + p);
          ss[k] = *reinterpret_cast<const float4*>(States + off + r * P + p);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int f = tid + (f0 + k) * QT * kWG;
        const int o = sw(f / (PM / 4), 4 * (f % (PM / 4)));
        const float4 d = dd[k], hp = ss[k];
        part += d.x * hp.x + d.y * hp.y + d.z * hp.z + d.w * hp.w;
        store_pair(sm + T::DHH + o, sm + T::DHL + o, d);
        store_pair(sm + T::HPH + o, sm + T::HPL + o, hp);
      }
    }
    part = warp_sum(part);
    if (lane == 0) sRed[tid >> 5] = part;
  }
  __syncthreads();
  const float total = sCum[Q - 1];
  for (int i = tid; i < Q; i += blockDim.x) {
    sE[i] = expf(sCum[i]);
    sW[i] = expf(total - sCum[i]);
  }
  staged();

  // PART p1
  // ---- phase 1, rows i of tile wg: dc = e o (dY H_prev^T) + M B; the
  // first column tile's G and dS share a wait with D = dY H_prev^T
  {
    const int i0 = 64 * wg;
    float dc[64], dec[2] = {0.f, 0.f}, rowt[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 64; ++k) dc[k] = 0.f;
    for (int jt = 0; jt <= wg; ++jt) {
      float gm[32], ms[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) gm[k] = ms[k] = 0.f;
      hold(dc);
      hold(gm);
      hold(ms);
      wg_fence();
      if (jt == 0) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_ss_n128(
              dc, sw128_desc(sm + T::DY + i0 * kRow + 32 * (kk & 3), 16, 1024),
              sw128_desc(sm + (kk < 4 ? T::HPH : T::HPL) + 32 * (kk & 3), 16,
                         1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int box = (kk >> 2) * Q * kRow, col = 32 * (kk & 3);
        wgmma_ss_n64(gm, sw128_desc(sm + T::C + box + i0 * kRow + col, 16, 1024),
                     sw128_desc(sm + T::B + box + 64 * jt * kRow + col, 16,
                                1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(ms, sw128_desc(sm + T::DY + i0 * kRow + 32 * kk, 16, 1024),
                     sw128_desc(sm + T::X + 64 * jt * kRow + 32 * kk, 16, 1024),
                     kk > 0);
      wg_commit();
      wg_wait_all();
      hold(dc);
      hold(gm);
      hold(ms);
      if (jt == 0) {  // c_i . D_i, then D scaled by e_i
#pragma unroll
        for (int k = 0; k < 64; k += 2) {
          const int r = (k >> 1) & 1, i = i0 + rl + 8 * r;
          const int nn = 8 * (k >> 2) + 2 * tq;
          const float2 cv = sm_bf2(sm + T::C + (nn >> 6) * Q * kRow, i, nn & 63);
          dec[r] = fmaf(cv.x, dc[k], fmaf(cv.y, dc[k + 1], dec[r]));
          dc[k] *= sE[i];
          dc[k + 1] *= sE[i];
        }
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {  // M = dS o L, T = M o G
        const int r = (k >> 1) & 1, i = i0 + rl + 8 * r;
        const int j = 64 * jt + 8 * (k >> 2) + 2 * tq + (k & 1);
        const float l = i >= j ? expf(sCum[i] - sCum[j]) : 0.f;
        ms[k] *= l;
        rowt[r] = fmaf(ms[k], gm[k], rowt[r]);
      }
      uint32_t mh[4][4], ml[4][4];
      to_a_split<4>(ms, mh, ml);
      hold(dc);
      hold(mh);
      hold(ml);
      wg_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint64_t bd = sw128_desc(sm + T::B + (64 * jt + 16 * c) * kRow,
                                       Q * kRow, 1024);
        wgmma_rs_n128(dc, mh[c], bd, 1);
        wgmma_rs_n128(dc, ml[c], bd, 1);
      }
      wg_commit();
      wg_wait_all();
      hold(dc);
      hold(mh);
      hold(ml);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dec[r] += __shfl_xor_sync(0xffffffffu, dec[r], 1);
      dec[r] += __shfl_xor_sync(0xffffffffu, dec[r], 2);
      rowt[r] += __shfl_xor_sync(0xffffffffu, rowt[r], 1);
      rowt[r] += __shfl_xor_sync(0xffffffffu, rowt[r], 2);
      const int i = i0 + rl + 8 * r;
      if (tq == 0) {
        sDec[i] = sE[i] * dec[r];
        sRowT[i] = rowt[r];
      }
    }
    __nv_bfloat16* dcg = DC + (long long)bi * S * H * N + (long long)h * N;
#pragma unroll
    for (int k = 0; k < 64; k += 2) {
      const int i = i0 + rl + 8 * ((k >> 1) & 1);
      const int nn = 8 * (k >> 2) + 2 * tq;
      if (nn < N)
        *reinterpret_cast<__nv_bfloat162*>(
            dcg + (long long)(s0 + i) * H * N + nn) =
            __floats2bfloat162_rn(dc[k], dc[k + 1]);
    }
  }

  // PART p2
  // ---- phase 2, rows j of tile wg: dx = w o (B dH) + (G o L)^T dY,
  // db = w o (X dH^T) + M^T C; the first row tile's G^T and dS^T share a
  // wait with X dH^T and B dH, and M^T C and (G o L)^T dY share one
  {
    const int j0 = 64 * wg;
    float db[64], dx[32], dw[2] = {0.f, 0.f}, colt[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 64; ++k) db[k] = 0.f;
#pragma unroll
    for (int k = 0; k < 32; ++k) dx[k] = 0.f;
    for (int it = wg; it < QT; ++it) {
      float gt[32], mt[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) gt[k] = mt[k] = 0.f;
      hold(db);
      hold(dx);
      hold(gt);
      hold(mt);
      wg_fence();
      if (it == wg) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_ss_n128(
              db, sw128_desc(sm + T::X + j0 * kRow + 32 * (kk & 3), 16, 1024),
              sw128_desc(sm + (kk < 4 ? T::DHH : T::DHL) + 32 * (kk & 3), 16,
                         1024), kk > 0);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t ad = sw128_desc(
              sm + T::B + (kk >> 2) * Q * kRow + j0 * kRow + 32 * (kk & 3), 16,
              1024);
          wgmma_ss_n64_tb(dx, ad, sw128_desc(sm + T::DHH + 16 * kk * kRow,
                                             kStateBox, 1024), kk > 0);
          wgmma_ss_n64_tb(dx, ad, sw128_desc(sm + T::DHL + 16 * kk * kRow,
                                             kStateBox, 1024), 1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int box = (kk >> 2) * Q * kRow, col = 32 * (kk & 3);
        wgmma_ss_n64(gt, sw128_desc(sm + T::B + box + j0 * kRow + col, 16, 1024),
                     sw128_desc(sm + T::C + box + 64 * it * kRow + col, 16,
                                1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(mt, sw128_desc(sm + T::X + j0 * kRow + 32 * kk, 16, 1024),
                     sw128_desc(sm + T::DY + 64 * it * kRow + 32 * kk, 16,
                                1024), kk > 0);
      wg_commit();
      wg_wait_all();
      hold(db);
      hold(dx);
      hold(gt);
      hold(mt);
      if (it == wg) {  // b_j . (X dH^T)_j, then both scaled by w_j
#pragma unroll
        for (int k = 0; k < 64; k += 2) {
          const int r = (k >> 1) & 1, j = j0 + rl + 8 * r;
          const int nn = 8 * (k >> 2) + 2 * tq;
          const float2 bv = sm_bf2(sm + T::B + (nn >> 6) * Q * kRow, j, nn & 63);
          dw[r] = fmaf(bv.x, db[k], fmaf(bv.y, db[k + 1], dw[r]));
          db[k] *= sW[j];
          db[k + 1] *= sW[j];
        }
#pragma unroll
        for (int k = 0; k < 32; ++k) dx[k] *= sW[j0 + rl + 8 * ((k >> 1) & 1)];
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {  // M^T, (G o L)^T, column sums of T
        const int r = (k >> 1) & 1, j = j0 + rl + 8 * r;
        const int i = 64 * it + 8 * (k >> 2) + 2 * tq + (k & 1);
        const float l = i >= j ? expf(sCum[i] - sCum[j]) : 0.f;
        mt[k] *= l;
        colt[r] = fmaf(mt[k], gt[k], colt[r]);
        gt[k] *= l;
      }
      uint32_t mh[4][4], ml[4][4], gh[4][4], gl[4][4];
      to_a_split<4>(mt, mh, ml);
      to_a_split<4>(gt, gh, gl);
      hold(db);
      hold(dx);
      hold(mh);
      hold(ml);
      hold(gh);
      hold(gl);
      wg_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint64_t bc = sw128_desc(sm + T::C + (64 * it + 16 * c) * kRow,
                                       Q * kRow, 1024);
        const uint64_t by = sw128_desc(sm + T::DY + (64 * it + 16 * c) * kRow,
                                       Q * kRow, 1024);
        wgmma_rs_n128(db, mh[c], bc, 1);
        wgmma_rs_n128(db, ml[c], bc, 1);
        wgmma_rs_n64(dx, gh[c], by, 1);
        wgmma_rs_n64(dx, gl[c], by, 1);
      }
      wg_commit();
      wg_wait_all();
      hold(db);
      hold(dx);
      hold(mh);
      hold(ml);
      hold(gh);
      hold(gl);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dw[r] += __shfl_xor_sync(0xffffffffu, dw[r], 1);
      dw[r] += __shfl_xor_sync(0xffffffffu, dw[r], 2);
      colt[r] += __shfl_xor_sync(0xffffffffu, colt[r], 1);
      colt[r] += __shfl_xor_sync(0xffffffffu, colt[r], 2);
      const int j = j0 + rl + 8 * r;
      if (tq == 0) {
        sDw[j] = sW[j] * dw[r];
        sColT[j] = colt[r];
      }
    }
    __nv_bfloat16* dbg = DB + (long long)bi * S * H * N + (long long)h * N;
    __nv_bfloat16* dxg = DX + (long long)bi * S * H * P + (long long)h * P;
#pragma unroll
    for (int k = 0; k < 64; k += 2) {
      const int j = j0 + rl + 8 * ((k >> 1) & 1);
      const int c = 8 * (k >> 2) + 2 * tq;
      if (c < N)
        *reinterpret_cast<__nv_bfloat162*>(
            dbg + (long long)(s0 + j) * H * N + c) =
            __floats2bfloat162_rn(db[k], db[k + 1]);
      if (k < 32 && c < P)
        *reinterpret_cast<__nv_bfloat162*>(
            dxg + (long long)(s0 + j) * H * P + c) =
            __floats2bfloat162_rn(dx[k], dx[k + 1]);
    }
  }
  __syncthreads();

  // PART scan
  // dcum, then d log a by a reverse cumulative sum, then da (one warp)
  if (tid < 32) {
    float hd = 0.f;
    for (int w = 0; w < QT * kWG / 32; ++w) hd += sRed[w];
    float dwsum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = lane * 4 + e;
      if (i < Q) dwsum += sDw[i];
    }
    dwsum = warp_sum(dwsum);
    const float dtotal = dwsum + expf(total) * hd;
    float v[4];
    float run = 0.f;
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      const int i = lane * 4 + e;
      float dc = 0.f;
      if (i < Q) {
        dc = sRowT[i] - sColT[i] + sDec[i] - sDw[i];
        if (i == Q - 1) dc += dtotal;
      }
      run += dc;
      v[e] = run;
    }
    float incl = run;  // sum over lanes >= lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += u;
    }
    const float excl = incl - run;
    float* dag = DA + ((long long)bi * S + s0) * H + h;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = lane * 4 + e;
      if (i < Q) dag[(long long)i * H] = sA[i] > kMinA ? (excl + v[e]) / sA[i] : 0.f;
    }
  }
  // PART end
}

// Pass C of the forward: the outputs y of chunk q of one (batch, head),
// one CTA of Q/64 warpgroups, warpgroup w taking rows 64w .. 64w + 63, from
// H_prev = the chunk's start state (pass B):
//   y = e o (C H_prev) + sum over column tiles jt <= w of (G o L) X,
// G = C B^T in 64 x 64 tiles, the tiles past the diagonal skipped.  X, B
// and C are staged as bf16 boxes, H_prev as a bf16 pair hi + lo; G o L
// enters as a pair from the accumulators (``to_a_split``); e scales the
// rows outside the product.  The cumulative sums stay in each warp's
// registers (chunk_cum, cum_at), so that two CTAs fit an SM's shared
// memory at Q = 128.
template <int QT>
struct FwdTiles {
  static constexpr int Q = 64 * QT;
  static constexpr int X = 0;                  // X: 1 box of Q rows
  static constexpr int B = Q * kRow;           // B: 2 boxes
  static constexpr int C = 3 * Q * kRow;       // C: 2 boxes
  static constexpr int HPH = 5 * Q * kRow;     // H_prev hi, N x P
  static constexpr int HPL = HPH + kStateBox;  // H_prev lo
  static constexpr int SMEM = HPL + kStateBox + 1024;
};

template <int QT, bool kVec>
__global__ void __launch_bounds__(QT * kWG, 2)
ssd_fwd_chunk_kernel(const __nv_bfloat16* __restrict__ X,
                     const float* __restrict__ A,
                     const __nv_bfloat16* __restrict__ Bm,
                     const __nv_bfloat16* __restrict__ Cm,
                     const float* __restrict__ States,
                     __nv_bfloat16* __restrict__ Y, int S, int H, int P,
                     int N, long long xb, long long xs, long long xh,
                     long long bb, long long bs, long long bh, long long cb,
                     long long cs, long long ch) {
  using T = FwdTiles<QT>;
  constexpr int Q = T::Q;
  const int nq = S / Q;
  const int h = blockIdx.x % H, t = blockIdx.x / H;
  const int q = t % nq, bi = t / nq, s0 = q * Q;
  uint8_t* sm = smem_base();
  const int tid = threadIdx.x, wg = tid >> 7, i0 = 64 * wg;
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rl = 16 * warp + g;  // the thread's rows rl and rl + 8 of a tile
  stage<kVec>(sm + T::X, X + bi * xb + h * xh + s0 * xs, xs, Q, 1, P);
  stage<kVec>(sm + T::B, Bm + bi * bb + h * bh + s0 * bs, bs, Q, 2, N);
  stage<kVec>(sm + T::C, Cm + bi * cb + h * ch + s0 * cs, cs, Q, 2, N);
  {  // H_prev as a bf16 pair, N x P padded to NM x PM
    const float* st = States + (((long long)bi * H + h) * nq + q) * N * P;
    constexpr int kF = NM * PM / 4 / (QT * kWG);  // float4s a thread, all
    float4 ss[kF];                                // in flight
#pragma unroll
    for (int k = 0; k < kF; ++k) {
      const int f = tid + k * QT * kWG;
      const int r = f / (PM / 4), p = 4 * (f % (PM / 4));
      ss[k] = r < N && p < P
                  ? *reinterpret_cast<const float4*>(st + r * P + p)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kF; ++k) {
      const int f = tid + k * QT * kWG;
      const int o = sw(f / (PM / 4), 4 * (f % (PM / 4)));
      store_pair(sm + T::HPH + o, sm + T::HPL + o, ss[k]);
    }
  }
  float cum[4];  // every warp its own copy of the chunk's cumulative sums
  chunk_cum(A + ((long long)bi * S + s0) * H + h, H, Q, cum);
  const float ci[2] = {cum_at(cum, i0 + rl), cum_at(cum, i0 + rl + 8)};
  staged();

  float y[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) y[k] = 0.f;
  for (int jt = 0; jt <= wg; ++jt) {
    float gm[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) gm[k] = 0.f;
    hold(y);
    hold(gm);
    wg_fence();
    if (jt == 0) {  // C H_prev, sharing a wait with the first tile of G
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t ad = sw128_desc(
            sm + T::C + (kk >> 2) * Q * kRow + i0 * kRow + 32 * (kk & 3), 16,
            1024);
        wgmma_ss_n64_tb(y, ad, sw128_desc(sm + T::HPH + 16 * kk * kRow,
                                          kStateBox, 1024), kk > 0);
        wgmma_ss_n64_tb(y, ad, sw128_desc(sm + T::HPL + 16 * kk * kRow,
                                          kStateBox, 1024), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int box = (kk >> 2) * Q * kRow, col = 32 * (kk & 3);
      wgmma_ss_n64(gm, sw128_desc(sm + T::C + box + i0 * kRow + col, 16, 1024),
                   sw128_desc(sm + T::B + box + 64 * jt * kRow + col, 16,
                              1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    hold(y);
    hold(gm);
    if (jt == 0) {  // the rows' e = exp(cum_i), outside the product
      const float e0 = expf(ci[0]), e1 = expf(ci[1]);
#pragma unroll
      for (int k = 0; k < 32; ++k) y[k] *= (k >> 1) & 1 ? e1 : e0;
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {  // G o L
      const int r = (k >> 1) & 1, i = i0 + rl + 8 * r;
      const int j = 64 * jt + 8 * (k >> 2) + 2 * tq + (k & 1);
      const float cj = cum_at(cum, j);
      gm[k] *= i >= j ? expf(ci[r] - cj) : 0.f;
    }
    uint32_t gh[4][4], gl[4][4];
    to_a_split<4>(gm, gh, gl);
    hold(y);
    hold(gh);
    hold(gl);
    wg_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint64_t bx = sw128_desc(sm + T::X + (64 * jt + 16 * c) * kRow,
                                     Q * kRow, 1024);
      wgmma_rs_n64(y, gh[c], bx, 1);
      wgmma_rs_n64(y, gl[c], bx, 1);
    }
    wg_commit();
    wg_wait_all();
    hold(y);
    hold(gh);
    hold(gl);
  }
  __nv_bfloat16* yg = Y + ((long long)bi * S + s0 + i0) * H * P +
                      (long long)h * P;
#pragma unroll
  for (int k = 0; k < 32; k += 2) {
    const int i = rl + 8 * ((k >> 1) & 1);
    const int p = 8 * (k >> 2) + 2 * tq;
    if (p < P)
      *reinterpret_cast<__nv_bfloat162*>(yg + (long long)i * H * P + p) =
          __floats2bfloat162_rn(y[k], y[k + 1]);
  }
}

template <int QT, bool kVec>
int fwd_wgmma(const void* x, const float* a, const void* b, const void* c,
              void* y, float* hlast, float* states, int B, int S, int H,
              int P, int N, long long xb, long long xs, long long xh,
              long long bb, long long bs, long long bh, long long cb,
              long long cs, long long ch, cudaStream_t stream) {
  using Bf = __nv_bfloat16;
  constexpr int Q = 64 * QT;
  const int nq = S / Q;
  constexpr int smem_a = 3 * Q * kRow + 2 * QM * 4 + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_state_kernel<QT, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_state_kernel<QT, kVec><<<B * H * nq, 2 * kWG, smem_a, stream>>>(
      (const Bf*)x, a, (const Bf*)b, states, hlast, S, H, P, N, xb, xs, xh,
      bb, bs, bh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int np4 = N * P / 4;
  const int decay_smem = nq * (int)sizeof(float);
  e = cudaFuncSetAttribute(ssd_fwd_carry_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           decay_smem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_carry_kernel<<<dim3(B * H, (np4 + kThreads - 1) / kThreads),
                         kThreads, decay_smem, stream>>>(states, hlast, a, S,
                                                         H, N * P, Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(ssd_fwd_chunk_kernel<QT, kVec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           FwdTiles<QT>::SMEM);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_chunk_kernel<QT, kVec><<<B * H * nq, QT * kWG, FwdTiles<QT>::SMEM,
                                   stream>>>(
      (const Bf*)x, a, (const Bf*)b, (const Bf*)c, states, (Bf*)y, S, H, P,
      N, xb, xs, xh, bb, bs, bh, cb, cs, ch);
  return (int)cudaGetLastError();
}

template <int QT, bool kVec>
int bwd_wgmma(const void* x, const float* a, const void* b, const void* c,
              const float* states, const void* dy, const float* dhlast,
              void* dx, float* da, void* db, void* dc, float* dhend, int B,
              int S, int H, int P, int N, long long xb, long long xs,
              long long xh, long long bb, long long bs, long long bh,
              long long cb, long long cs, long long ch, long long yb,
              long long ys, long long yh, cudaStream_t stream) {
  using Bf = __nv_bfloat16;
  constexpr int Q = 64 * QT;
  const int nq = S / Q;
  if (nq > 1) {
    constexpr int smem = 3 * Q * kRow + 2 * QM * 4 + 1024;
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_u_kernel<QT, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ssd_bwd_u_kernel<QT, kVec><<<B * H * (nq - 1), 2 * kWG, smem, stream>>>(
        (const Bf*)c, a, (const Bf*)dy, dhend, S, H, P, N, cb, cs, ch, yb, ys,
        yh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int np4 = N * P / 4;
  const int decay_smem = nq * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_carry_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      decay_smem);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_carry_kernel<<<dim3(B * H, (np4 + kThreads - 1) / kThreads),
                         kThreads, decay_smem, stream>>>(dhend, a, dhlast, S,
                                                         H, N * P, Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<QT, kVec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BwdTiles<QT>::SMEM);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_chunk_kernel<QT, kVec><<<B * H * nq, QT * kWG, BwdTiles<QT>::SMEM,
                                   stream>>>(
      (const Bf*)x, a, (const Bf*)b, (const Bf*)c, states, (const Bf*)dy,
      dhend, (Bf*)dx, da, (Bf*)db, (Bf*)dc, S, H, P, N, xb, xs, xh, bb, bs,
      bh, cb, cs, ch, yb, ys, yh);
  return (int)cudaGetLastError();
}

static_assert(BwdTiles<2>::SMEM <= 232448, "wgmma tiles exceed shared memory");
// two CTAs an SM: 228 KB of shared memory, 1 KB of it reserved a CTA
static_assert(2 * (FwdTiles<2>::SMEM + 1024) <= 233472,
              "the forward's outputs tiles exceed half an SM");

// Whether p allows 16-byte copies (cp.async).
bool al16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x (B, S, H, P), b and c (B, S, H, N) read through the given (batch, step,
// head) element strides with a unit last stride (a head stride may be 0);
// a (B, S, H) float32 contiguous.  Writes y (B, S, H, P) contiguous in x's
// dtype, h_last (B, H, N, P) float32 and, when states is not null, each
// chunk's starting state (B, H, S/Q, N, P) float32.  Returns the launch's
// cudaError_t.
extern "C" int ssd_fwd_launch(const void* x, const float* a, const void* b,
                              const void* c, void* y, float* hlast,
                              float* states, int B, int S, int H, int P,
                              int N, int Q, long long xb, long long xs,
                              long long xh, long long bb, long long bs,
                              long long bh, long long cb, long long cs,
                              long long ch, int is_bf16, void* stream) {
  if (Q < 1 || Q > QM || N < 1 || N > NM || P < 1 || P > PM || S % Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return fwd<__nv_bfloat16>(x, a, b, c, y, hlast, states, B, S, H, P, N,
                              Q, xb, xs, xh, bb, bs, bh, cb, cs, ch, st);
  return fwd<float>(x, a, b, c, y, hlast, states, B, S, H, P, N, Q, xb, xs,
                    xh, bb, bs, bh, cb, cs, ch, st);
}

// The forward's wgmma route, for bfloat16 x, b, c with a chunk Q of 64 or
// 128 and N, P multiples of 16 (up to 128 and 64), with the arguments of
// ssd_fwd_launch; states may not be null: the route writes every chunk's
// starting state there (scratch when the caller keeps none).  Three
// launches on the stream (passes A, B, C).  Returns the first cudaError_t.
extern "C" int ssd_fwd_wgmma_launch(
    const void* x, const float* a, const void* b, const void* c, void* y,
    float* hlast, float* states, int B, int S, int H, int P, int N, int Q,
    long long xb, long long xs, long long xh, long long bb, long long bs,
    long long bh, long long cb, long long cs, long long ch, void* stream) {
  if ((Q != 64 && Q != 128) || N < 16 || N > NM || N % 16 || P < 16 ||
      P > PM || P % 16 || S % Q || states == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = al16(x) && al16(b) && al16(c) &&
                   (xb | xs | xh | bb | bs | bh | cb | cs | ch) % 8 == 0;
#define SSD_FWD_WGMMA(QT, V)                                                 \
  fwd_wgmma<QT, V>(x, a, b, c, y, hlast, states, B, S, H, P, N, xb, xs, xh, \
                   bb, bs, bh, cb, cs, ch, st)
  if (Q == 128) return vec ? SSD_FWD_WGMMA(2, true) : SSD_FWD_WGMMA(2, false);
  return vec ? SSD_FWD_WGMMA(1, true) : SSD_FWD_WGMMA(1, false);
#undef SSD_FWD_WGMMA
}

// The backward: the forward's inputs and chunk-start states, dy (strided
// like x) and dh_last (B, H, N, P) float32 or null for zero.  Writes dx
// (B, S, H, P) and db, dc (B, S, H, N) contiguous in the inputs' dtype and
// da (B, S, H) float32.  Returns the launch's cudaError_t.
extern "C" int ssd_bwd_launch(const void* x, const float* a, const void* b,
                              const void* c, const float* states,
                              const void* dy, const float* dhlast, void* dx,
                              float* da, void* db, void* dc, int B, int S,
                              int H, int P, int N, int Q, long long xb,
                              long long xs, long long xh, long long bb,
                              long long bs, long long bh, long long cb,
                              long long cs, long long ch, long long yb,
                              long long ys, long long yh, int is_bf16,
                              void* stream) {
  if (Q < 1 || Q > QM || N < 1 || N > NM || P < 1 || P > PM || S % Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return bwd<__nv_bfloat16>(x, a, b, c, states, dy, dhlast, dx, da, db, dc,
                              B, S, H, P, N, Q, xb, xs, xh, bb, bs, bh, cb,
                              cs, ch, yb, ys, yh, st);
  return bwd<float>(x, a, b, c, states, dy, dhlast, dx, da, db, dc, B, S, H,
                    P, N, Q, xb, xs, xh, bb, bs, bh, cb, cs, ch, yb, ys, yh,
                    st);
}

// The backward's wgmma route, for bfloat16 x, b, c, dy with a chunk Q of 64
// or 128 and N, P multiples of 16 (up to 128 and 64), with the arguments
// of ssd_bwd_launch and dh_end, a (B, H, S/Q, N, P) float32 scratch that
// ends holding dH_end(q), the gradient of each chunk's end state.  Three
// launches on the stream (passes A, B, C).  Returns the first cudaError_t.
extern "C" int ssd_bwd_wgmma_launch(
    const void* x, const float* a, const void* b, const void* c,
    const float* states, const void* dy, const float* dhlast, void* dx,
    float* da, void* db, void* dc, float* dhend, int B, int S, int H, int P,
    int N, int Q, long long xb, long long xs, long long xh, long long bb,
    long long bs, long long bh, long long cb, long long cs, long long ch,
    long long yb, long long ys, long long yh, void* stream) {
  if ((Q != 64 && Q != 128) || N < 16 || N > NM || N % 16 || P < 16 ||
      P > PM || P % 16 || S % Q)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = al16(x) && al16(b) && al16(c) && al16(dy) &&
                   (xb | xs | xh | bb | bs | bh | cb | cs | ch | yb | ys |
                    yh) % 8 == 0;
#define SSD_BWD_WGMMA(QT, V)                                                  \
  bwd_wgmma<QT, V>(x, a, b, c, states, dy, dhlast, dx, da, db, dc, dhend, B, \
                   S, H, P, N, xb, xs, xh, bb, bs, bh, cb, cs, ch, yb, ys,   \
                   yh, st)
  if (Q == 128) return vec ? SSD_BWD_WGMMA(2, true) : SSD_BWD_WGMMA(2, false);
  return vec ? SSD_BWD_WGMMA(1, true) : SSD_BWD_WGMMA(1, false);
#undef SSD_BWD_WGMMA
}
