// ssd: the chunked Mamba2 SSD scan on Hopper, forward and backward.
//
// The forward replaces the TPU kernel repro/kernels/ssd/ssd.py::ssd_pallas
// (_ssd_kernel, ssd.py:34-76).  Per (batch, head) the sequence is cut into
// chunks of Q steps, taken in order, with cum the inclusive cumulative sum
// of log max(a, 1e-37) inside the chunk and total = cum[Q-1]:
//   y = (C B^T o L) X + (C o exp(cum)) H_prev,
//       L[i, j] = exp(cum_i - cum_j) for i >= j, else 0 (masked before exp),
//   H = exp(total) H_prev + (B o exp(total - cum))^T X,
// with y written in x's dtype and the last H in float32.  Arithmetic is
// float32 from float32 or bfloat16 inputs, as the Pallas kernel casts.
// The forward can also write every chunk's starting state H_prev
// (B, H, S/Q, N, P) float32 for the backward.
//
// The backward is the port's own (the JAX package differentiates the plain
// chunked path, repro/kernels/ssd/ops.py::ssd_chunked_ref): from dy and the
// gradient of the last state it gives dx, da, db and dc as JAX's autodiff
// of ssd_chunked_ref would.  Per (batch, head) it walks the chunks in
// reverse carrying dH (N x P, float32), the gradient of the chunk's end
// state.  With G = C B^T, dS = dY X^T masked to i >= j, M = dS o L,
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
// (0.043 ms at 3.35 TB/s): bytes bound it.
//
// Design: a first, simple kernel.  One CTA of 256 threads (a 16 x 16 grid)
// per (batch, head) walks its chunks (128 CTAs at the train shape, one
// wave on 132 SMs); inputs are widened to float32 in shared-memory tiles
// and every product is a float32 FMA outside the tensor cores (no wgmma,
// no TMA yet), each thread holding a register block of its output.  Shared
// memory: B and X of the whole chunk, the state, and C and the masked
// C B^T in row tiles (RF rows forward, RB backward), about 200 KB; rows of
// an odd stride (N + 1, P + 1) keep the 16 threads of a row group on 16
// distinct banks.  Only the causally live tiles of C B^T are computed.
// The chunk-parallel form (chunk states, a pass across chunks, then the
// outputs) that would fill the card at small B H is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// One warp: cum[i] = sum_{k <= i} log max(a[k * as], 1e-37) for i < Q
// (lane l holds steps 4l .. 4l + 3), cum[i] = 0 for Q <= i < QM.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a,
                                             long long as, int Q,
                                             float* __restrict__ cum) {
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
  for (int e = 0; e < 4; ++e) {
    const int i = lane * 4 + e;
    cum[i] = i < Q ? excl + v[e] : 0.f;
  }
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
