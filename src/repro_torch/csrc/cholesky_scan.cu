// cholesky_scan: the linear-time Cholesky NDPP sampler's sequential scan
// (Alg. 1), one draw a CTA, on Hopper.
//
// Replaces no TPU kernel: the reference runs this scan as a lax.scan
// (repro/core/cholesky.py::sample_cholesky_inner, :54-75, and the blocked
// variant's inner scan, :107-126) and keeps its 2K x 2K state "in
// VMEM/VREG".  The port needs a kernel of its own because a PyTorch loop
// over M = 2^20 items would be ~5 M launches a draw.  Per draw n, with
// Q = W (the marginal kernel's inner matrix) and for each item i in order:
//   qz = Q z_i,  zq = z_i^T Q,  p = z_i . qz,  take = u_{n,i} < p (strict),
//   denom = take ? max(p, eps) : min(p - 1, -eps),  Q -= qz zq^T / denom.
//
// Bound on the H100: operations.  Each item costs 3 R^2 FMA a draw (the two
// products and the rank-1 downdate), 6 R^2 M FLOP a draw: 0.25 TFLOP at
// R = 200, M = 2^20, against Z's 0.84 GB, which every draw shares through
// L2.  The scan is sequential in i, so a draw has no parallelism beyond one
// item's R^2 work.
//
// Design: one draw a CTA of 512 threads, one CTA an SM, the draw's Q on
// chip for the whole scan.  Warp w owns rows w, w + 16, ... (14 row slots
// at R <= 224); lane l owns columns 4 l .. 4 l + 3, held in registers (56 a
// thread), and columns 128 + 4 l .. 128 + 4 l + 3, held in shared memory
// (R x (RP - 128) floats, RP = R rounded up to 4: 57,600 bytes at R = 200).
// One pass over Q an item applies item i - 1's downdate and, with the
// updated values, accumulates item i's row sums (Q z_i) and column sums
// (z_i^T Q).  A warp's row sums are complete within the warp (a
// reduce-scatter butterfly: 16 shuffles a thread for 16 row slots, not
// 80); the column sums are summed across the 16 warps through shared
// memory by the threads b < RP, which also sum the warps' partials of p,
// draw the decision and store zq / denom for the next pass.  Two barriers
// an item.  Every sum runs in one fixed order, with no atomics, so two
// calls give the same bits.  Z's rows and the uniforms arrive in
// double-buffered tiles of 8 rows by cp.async.  The registers, at their
// cap of 128 a thread (no spills), set the largest R, kMaxR; the shared
// half of Q and the per-item chain of shuffles, barriers and the column
// pass bound the time (PERF.md: ~1.2 us an item at any R, ~3.0 at R = 200).
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using repro_torch::cp_async4;
using repro_torch::cp_async_commit;
using repro_torch::cp_async_wait;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;  // 16: row slots are w + 16 i
constexpr int kSlots = 16;             // row slots the butterfly sums
constexpr int kMaxR = 224;             // rows: 14 register slots of 16 warps
constexpr int kRegSlots = kMaxR / kWarps;  // 14 row slots held in registers
constexpr int kRegCols = 128;          // Q's columns held in registers
constexpr int kTile = 8;               // rows of Z (and uniforms) a tile
constexpr float kEps = 1e-8f;          // the reference's _EPS

__host__ __device__ inline int padded(int r) { return (r + 3) & ~3; }

// Q's columns kept in shared memory: those at and past kRegCols
__host__ __device__ inline int shared_cols(int r) {
  return padded(r) > kRegCols ? padded(r) - kRegCols : 0;
}

size_t smem_bytes(int r) {
  const size_t rp = padded(r);
  return sizeof(float) * (r * shared_cols(r)  // Q's columns >= kRegCols
                          + kWarps * rp      // column partials
                          + 2 * rp           // qz, two buffers
                          + rp               // zq / denom
                          + kWarps           // partials of p
                          + 2 * kTile * rp   // Z tiles
                          + 2 * kTile);      // uniform tiles
}

__device__ __forceinline__ float4 f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// c ? a : b as one selp.  Written as `c ? v[i] : v[j]` on an array, the
// compiler selects the address instead and moves the array to local memory.
__device__ __forceinline__ float sel(bool c, float a, float b) {
  float out;
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\nselp.f32 %0, %1, %2, p;\n}"
      : "=f"(out)
      : "f"(a), "f"(b), "r"(static_cast<int>(c)));
  return out;
}

// One stage of the rows' reduce-scatter: a lane keeps slots [0, kHalf) or
// [kHalf, 2 kHalf) of v by its bit `off`, sends the other half to the lane
// across that bit and adds what it receives into v[0, kHalf).  A template,
// so that every index is a constant and v stays in registers.
template <int kHalf>
__device__ __forceinline__ void scatter_stage(float (&v)[kSlots], int lane,
                                              int off) {
  const bool upper = (lane & off) != 0;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float send = sel(upper, v[k], v[k + kHalf]);
    const float keep = sel(upper, v[k + kHalf], v[k]);
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// One float4 of a row of Q: q -= qa zqs (item i - 1's downdate), then with
// the new values acc += q . zn (the row sum Q z_i) and col += za q (the
// column sums z_i^T Q).
__device__ __forceinline__ void update(float4& q, float qa, float za,
                                       float4 zqs, float4 zn, float& acc,
                                       float4& col) {
  q.x -= qa * zqs.x;
  q.y -= qa * zqs.y;
  q.z -= qa * zqs.z;
  q.w -= qa * zqs.w;
  acc = fmaf(q.x, zn.x, acc);
  acc = fmaf(q.y, zn.y, acc);
  acc = fmaf(q.z, zn.z, acc);
  acc = fmaf(q.w, zn.w, acc);
  col.x = fmaf(za, q.x, col.x);
  col.y = fmaf(za, q.y, col.y);
  col.z = fmaf(za, q.z, col.z);
  col.w = fmaf(za, q.w, col.w);
}

__global__ void __launch_bounds__(kThreads, 1)
    cholesky_scan_kernel(const float* __restrict__ Z,
                         const float* __restrict__ W,
                         const float* __restrict__ U, long long m, int r,
                         unsigned char* __restrict__ take_out,
                         float* __restrict__ p_out) {
  extern __shared__ __align__(16) float smem[];
  const int rp = padded(r), rp4 = rp >> 2, rs = shared_cols(r);
  float* sQ = smem;                    // (r, rs): Q's columns >= kRegCols
  float* sCol = sQ + r * rs;           // (kWarps, rp)
  float* sQz = sCol + kWarps * rp;     // (2, rp)
  float* sZqs = sQz + 2 * rp;          // (rp,)
  float* sPp = sZqs + rp;              // (kWarps,)
  float* sZ = sPp + kWarps;            // (2, kTile, rp)
  float* sU = sZ + 2 * kTile * rp;     // (2, kTile)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long draw = blockIdx.x;
  const float* u = U + draw * m;

  // Q <- W, zero past column r and row r: lane l's columns 4 l .. 4 l + 3
  // of rows w + 16 i in registers, columns >= kRegCols in shared memory;
  // qz and zq / denom <- 0, so that step 0's downdate leaves Q as it is;
  // the tiles' pad columns <- 0 (cp.async writes only columns < r, so they
  // stay 0)
  float4 qr[kRegSlots];
#pragma unroll
  for (int i = 0; i < kRegSlots; ++i) {
    const int a = warp + kWarps * i, b = 4 * lane;
    const float* wr = W + (size_t)a * r;
    const bool in = a < r;
    qr[i] = make_float4(in && b < r ? wr[b] : 0.f,
                        in && b + 1 < r ? wr[b + 1] : 0.f,
                        in && b + 2 < r ? wr[b + 2] : 0.f,
                        in && b + 3 < r ? wr[b + 3] : 0.f);
  }
  for (int k = tid; k < r * rs; k += kThreads) {
    const int a = k / rs, b = kRegCols + (k - a * rs);
    sQ[k] = b < r ? W[(size_t)a * r + b] : 0.f;
  }
  for (int k = tid; k < 3 * rp; k += kThreads) sQz[k] = 0.f;  // sQz, sZqs
  for (int k = tid; k < 2 * kTile * (rp - r); k += kThreads) {
    const int row = k / (rp - r);
    sZ[row * rp + r + (k - row * (rp - r))] = 0.f;
  }

  auto load_tile = [&](long long tile) {
    const int buf = static_cast<int>(tile & 1);
    const long long row0 = tile * kTile;
    const long long left = m - row0;
    const int rows = left < kTile ? (left > 0 ? static_cast<int>(left) : 0)
                                  : kTile;
    float* dz = sZ + buf * kTile * rp;
    for (int k = tid; k < rows * r; k += kThreads) {
      const int i = k / r, b = k - i * r;
      cp_async4(dz + i * rp + b, Z + (row0 + i) * r + b);
    }
    if (tid < rows) cp_async4(sU + buf * kTile + tid, u + row0 + tid);
    cp_async_commit();
  };

  load_tile(0);
  load_tile(1);
  int cur = 0;
  for (long long s = 0; s < m; ++s) {
    const int row = static_cast<int>(s & (kTile - 1));
    const long long tile = s / kTile;
    if (row == 0) {
      // the buffer of tile - 1 is free: its last reader was pass A of step
      // s - 1, two barriers ago
      if (s > 0) load_tile(tile + 1);
      cp_async_wait<1>();
      __syncthreads();
    }
    const int buf = static_cast<int>(tile & 1);
    const float* zr = sZ + (buf * kTile + row) * rp;
    const float* qzc = sQz + cur * rp;
    float* qzn = sQz + (cur ^ 1) * rp;

    // pass A: Q -= qz_{s-1} (zq_{s-1} / denom_{s-1}), and with the new Q
    // the row sums Q z_s (v) and column sums z_s^T Q (col)
    // lane l's column groups: l (registers; zero past rp) and 32 + l
    // (shared memory, where 32 + l < rp4)
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const bool hi = 32 + lane < rp4;
    const float4 zq0 = 4 * lane < rp ? f4(sZqs + 4 * lane) : zero;
    const float4 zn0 = 4 * lane < rp ? f4(zr + 4 * lane) : zero;
    const float4 zq1 = hi ? f4(sZqs + kRegCols + 4 * lane) : zero;
    const float4 zn1 = hi ? f4(zr + kRegCols + 4 * lane) : zero;
    float4 col0 = zero, col1 = zero;
    float v[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int a = warp + kWarps * i;
      v[i] = 0.f;
      if (i < kRegSlots && a < r) {  // uniform across the warp
        const float qa = qzc[a], za = zr[a];
        float acc = 0.f;
        update(qr[i], qa, za, zq0, zn0, acc, col0);
        if (hi) {
          float4* qp = reinterpret_cast<float4*>(sQ + a * rs) + lane;
          float4 q = *qp;
          update(q, qa, za, zq1, zn1, acc, col1);
          *qp = q;
        }
        v[i] = acc;
      }
    }
    // reduce-scatter the 16 row slots over the warp: after the stages at
    // offsets 16, 8, 4, 2 lane l holds slot (l >> 1) & 15 summed over the
    // lane pair {l, l ^ 1}; each partial is formed by one lane, and the two
    // lanes of the last stage form a + b and b + a, the same bits
    scatter_stage<8>(v, lane, 16);
    scatter_stage<4>(v, lane, 8);
    scatter_stage<2>(v, lane, 4);
    scatter_stage<1>(v, lane, 2);
    const float rowsum = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
    const int a = warp + kWarps * ((lane >> 1) & (kSlots - 1));
    if (a < r && !(lane & 1)) qzn[a] = rowsum;
    // the warp's share of p = z_s . qz_s: its 16 slots, each once (the lane
    // pairs hold copies), every lane ending with the same bits
    float pp = a < r ? zr[a] * rowsum : 0.f;
#pragma unroll
    for (int off = 2; off < 32; off <<= 1)
      pp += __shfl_xor_sync(0xffffffffu, pp, off);
    if (lane == 0) sPp[warp] = pp;
    if (4 * lane < rp)
      *reinterpret_cast<float4*>(sCol + warp * rp + 4 * lane) = col0;
    if (hi)
      *reinterpret_cast<float4*>(sCol + warp * rp + kRegCols + 4 * lane) =
          col1;
    __syncthreads();

    // pass B: zq_s across the warps, p_s, the decision, zq_s / denom_s
    if (tid < rp) {
      float zq = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) zq += sCol[w * rp + tid];
      float p = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) p += sPp[w];
      const bool tk = sU[buf * kTile + row] < p;
      const float denom = tk ? fmaxf(p, kEps) : fminf(p - 1.f, -kEps);
      sZqs[tid] = zq / denom;
      if (tid == 0) {
        take_out[draw * m + s] = tk ? 1 : 0;
        p_out[draw * m + s] = p;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

}  // namespace

// Z: (m, R) item rows; W: (R, R) the inner matrix each draw starts from;
// U: (n, m) uniforms; take: (n, m) bytes 0/1; p: (n, m) the marginals.  All
// float32 (but take) and contiguous on the current device.  Launches n CTAs
// on `stream`; returns the cudaError_t of the launch.
extern "C" int cholesky_scan_launch(const float* Z, const float* W,
                                    const float* U, long long m, int R,
                                    int n, unsigned char* take, float* p,
                                    void* stream) {
  if (n <= 0 || m <= 0) return cudaSuccess;
  if (R <= 0 || R > kMaxR) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(R);
  cudaError_t err = cudaFuncSetAttribute(
      cholesky_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cholesky_scan_kernel<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      Z, W, U, m, R, take, p);
  return cudaGetLastError();
}
