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
// Bound on the H100: operations.  Each item costs 3 R^2 multiply-adds a
// draw (the two products and the rank-1 downdate), 6 R^2 M FLOP a draw:
// 0.25 TFLOP at R = 200, M = 2^20, against Z's 0.84 GB, which every draw
// shares through L2: 0.50 s a wave of 132 draws at float32 FMA, 0.20 s at
// the TF32 tensor-core rate for the blocked route's three TF32 products.
//
// Two routes, one draw a CTA and one CTA an SM each, chosen by R alone
// (kernels/cholesky_scan/ops.py::route):
//
// "blocked" (R <= 208): a blocked Schur-complement scan.  For a block Z_b
// of b = 32 items and the draw's Q: A = Q Z_b^T and B = Z_b Q on the
// tensor cores, G = Z_b A.  The block's b decisions are an elimination of G
// whose pivot j is the clamped denominator d_j of item j (its p_j is G's
// j-th diagonal after the eliminations before it), so each decision enters
// the later items' p exactly as the sequential scan's downdates do; Q then
// takes the block's b downdates at once: Q -= (A C) B, C = (G + diag(d -
// p))^-1.  So the per-item chain of CTA-wide sums and barriers becomes one
// warp's elimination step on a 32 x 32 matrix in registers, and the 3 R^2 b
// multiply-adds of a block become products on the tensor cores (wgmma
// m64nNk8, N = 8, 32, 64, TF32 operands, float32 accumulators).  Each
// float32 operand enters as a TF32 pair and each product as hi.hi + hi.lo
// + lo.hi (3xTF32), which keeps float32's headroom under the flip rule
// (tools/cholesky_rounding.py); one TF32 rounding does not.  The tensor
// cores' sums truncate, so no sum runs long in them: A and B^T add each
// stage's partial sums in float32, and the update subtracts A C B from Q
// in float32 (a drift through 2^15 blocks otherwise).
//
// Layout: 128 threads a warpgroup of Q's 64 rows (ceil(R / 64) of them).
// Q (R x R float32) in shared memory; the products read their A operands,
// Q's rows (A) or columns (B^T), from it into registers and split them
// there (TF32 operands in shared memory must be K-major, and only one of
// Q, Q^T is); Z_b is the B operand, in core matrices without swizzle.  Z_b
// raw is read exactly by G's float32 FMA and, since the tensor cores
// ignore a TF32 value's low 13 bits, is also its pair's hi (hi = z
// truncated, lo = what that lost, rounded).  A lands in the buffer of Z's
// lo; B^T stays in the accumulators through the decisions and then becomes
// the update's B pair; G's partial sums and C's pair go where Z raw was.
// One warp decides the block (Gauss-Jordan on G, lane c holding column c,
// the pivot column broadcast through shared memory); the rest is spread
// over the CTA, nine barriers a block.  ptxas serializes wgmmas whose
// register inputs are defined while any wgmma is in flight, so every
// stage's operands are split before its fence (only raw loads overlap it).
// The next block's rows and uniforms are loaded into registers a block
// ahead.  Sums run in one fixed order and no atomics, so two calls give
// the same bits.  Shared memory, 4 R^2 + 256 R16 + 384 bytes (R16 = R
// rounded up to 16), sets the largest R; PERF.md has the time by step
// (tools/cholesky_scan_parts.py).
//
// "resident" (R <= 224, taken past 208; 512 threads): one item at a time
// on the FMA pipe.  Warp w owns rows w, w + 16, ... (14 row slots at
// R <= 224); lane l owns columns 4 l .. 4 l + 3, held in registers (56 a
// thread), and columns 128 + 4 l .. 128 + 4 l + 3, held in shared memory
// (R x (RP - 128) floats, RP = R rounded up to 4: 57,600 bytes at
// R = 200).  One pass over
// Q an item applies item i - 1's downdate and, with the updated values,
// accumulates item i's row sums (Q z_i) and column sums (z_i^T Q).  A
// warp's row sums are complete within the warp (a reduce-scatter
// butterfly: 16 shuffles a thread for 16 row slots, not 80); the column
// sums are summed across the 16 warps through shared memory by the threads
// b < RP, which also sum the warps' partials of p, draw the decision and
// store zq / denom for the next pass.  Two barriers an item, in a fixed
// order.  Z's rows and the uniforms arrive in double-buffered tiles of 8
// rows by cp.async.  The registers, at their cap of 128 a thread (no
// spills), set the largest R; the per-item chain of shuffles, barriers and
// the column pass bounds its time (PERF.md: ~1.2 us an item at any R, ~3.0
// at R = 200).
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "wgmma.cuh"

// ----------------------------------------------------------- resident route
namespace resident {

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

}  // namespace resident

// ------------------------------------------------------------ blocked route
namespace blocked {

using repro_torch::fence_async_smem;
using repro_torch::hold;
using repro_torch::plain_desc;
using repro_torch::tf32_rna;
using repro_torch::tf32_split;
using repro_torch::wg_commit;
using repro_torch::wg_fence;
using repro_torch::wg_wait_all;
using repro_torch::wgmma_tf32_n32;
using repro_torch::wgmma_tf32_n64;
using repro_torch::wgmma_tf32_n8;

constexpr int kMaxWg = 4;      // warpgroups: Q's rows by 64, R <= 256
constexpr int kB = 32;         // items a block
constexpr int kMaxR = 208;     // Q and the block's pair fill 227 KB
constexpr int kLoads = 4;      // float4s of a block's Z a thread: 8 R16 /
                               // (128 warpgroups) <= 4
constexpr float kEps = 1e-8f;  // the reference's _EPS
constexpr uint32_t kCore = 128;  // bytes of a core matrix: 8 rows x 16
// the buffer of Z raw holds in turn G's partial sums (one a warpgroup)
// and C's pair
constexpr int kPair = 0;
constexpr int kScratch = kMaxWg * kB * kB;
#ifdef CHOLESKY_SCAN_CLOCKS
constexpr int kPhases = 9;     // the block's steps, barrier to barrier
// Built so (tools/cholesky_scan_parts.py), thread 0 of CTA 0 adds each
// step's clocks, from the barrier before it to the barrier after it, here.
__device__ unsigned long long g_clocks[kPhases];
#endif

__host__ __device__ inline int r8(int r) { return (r + 7) & ~7; }
// Z's K extent: whole pairs of k-steps
__host__ __device__ inline int r16(int r) { return (r + 15) & ~15; }
__host__ __device__ inline int warpgroups(int r) { return (r + 63) >> 6; }
__host__ __device__ inline int q_floats(int r) { return (r * r + 3) & ~3; }
__host__ __device__ inline int h_floats(int r) {
  return kB * r16(r) > kScratch ? kB * r16(r) : kScratch;
}

size_t smem_bytes(int r) {
  return sizeof(float) * (q_floats(r) + h_floats(r) + kB * r16(r) + 3 * kB);
}

// Element (n, k) of a K-major operand whose K extent is `kk` (a multiple
// of 8), in core matrices [n / 8][k / 4][n % 8][k % 4]: the lbo between
// core matrices along K is 128 bytes, the sbo between 8-row groups kk / 4
// * 128.  A warp's 32 float4s then hold 8 rows x 64 contiguous bytes of a
// row-major source.
__device__ __forceinline__ int core(int n, int k, int kk) {
  return (((n >> 3) * (kk >> 2) + (k >> 2)) << 5) + ((n & 7) << 2) + (k & 3);
}

// Element (x, j) of A (rows of kB floats), its float4 groups XOR-swizzled
// by x so that a warp reading 8 rows at one column is conflict-free.
__device__ __forceinline__ int aswz(int x, int j) {
  return (x << 5) + ((((j >> 2) ^ (x & 7)) << 2) | (j & 3));
}

// x with its 13 low mantissa bits cleared: the TF32 value the tensor
// cores read from x's float32 bits
__device__ __forceinline__ float trunc_tf32(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

// Pin a wgmma's A operand registers: before its fence, every definition
// precedes it (ptxas serializes wgmmas whose inputs are defined inside
// their pipeline stage); after its wait, they stay live until then.
__device__ __forceinline__ void hold4(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
__device__ __forceinline__ void hold4(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) hold4(a[s]);
}
template <int N>
__device__ __forceinline__ void hold_desc(uint64_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+l"(d[i])::"memory");
}

// *p (0 where !in), loaded by an instruction the compiler keeps in place:
// the next block's rows are loaded a block ahead and not consumed before.
__device__ __forceinline__ float ld_early(const float* p, bool in) {
  float v;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\nmov.f32 %0, 0f00000000;\n"
      "@q ld.global.nc.f32 %0, [%1];\n}\n"
      : "=f"(v)
      : "l"(p), "r"(static_cast<int>(in)));
  return v;
}

// Columns x .. x + 3 of the row at p (zero past r; none where !in), by
// loads the compiler keeps in place: one float4 where rows are 16-byte
// aligned (`vec4`), else four floats.
__device__ __forceinline__ float4 ld_early4(const float* p, int x, int r,
                                            bool in, bool vec4) {
  float4 v;
  if (vec4) {
    asm volatile(
        "{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
        "mov.f32 %0, 0f00000000;\nmov.f32 %1, 0f00000000;\n"
        "mov.f32 %2, 0f00000000;\nmov.f32 %3, 0f00000000;\n"
        "@q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n}\n"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p + x), "r"(static_cast<int>(in && x < r)));
  } else {
    v.x = ld_early(p + x, in && x < r);
    v.y = ld_early(p + x + 1, in && x + 1 < r);
    v.z = ld_early(p + x + 2, in && x + 2 < r);
    v.w = ld_early(p + x + 3, in && x + 3 < r);
  }
  return v;
}

// What truncating x to TF32 loses, rounded to TF32: the lo of x's pair
// when its hi is x's own float32 bits
__device__ __forceinline__ float lo_tf32(float x) {
  return __uint_as_float(tf32_rna(x - trunc_tf32(x)));
}

// 1 / x by the SFU (within 1 ulp; one instruction and no branch, which
// keeps the decisions' unrolled chain one basic block)
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The A operands of the block's products at k-step s, rows row0 and row1
// (the A fragment's rows g and g + 8, columns t and t + 4): Q's rows
// (A = Q Z_b^T, qa) and columns (B^T = Q^T Z_b^T, qb), loaded as floats;
// q_split makes them TF32 pairs.  (The pairs, wgmma's inputs, are defined
// only outside a wgmma's fence-to-wait, or ptxas serializes the products;
// loading the next stage's floats under the products would need registers
// that the stage's partial sums hold.)
__device__ __forceinline__ void q_load(const float* sQ, int r, int s,
                                       int row0, int row1, int t,
                                       float (&qa)[4], float (&qb)[4]) {
  const int k0 = 8 * s + t;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int a = e & 1 ? row1 : row0, k = e < 2 ? k0 : k0 + 4;
    const bool in = a < r && k < r;
    qa[e] = in ? sQ[a * r + k] : 0.f;
    qb[e] = in ? sQ[k * r + a] : 0.f;
  }
}
__device__ __forceinline__ void q_split(const float (&qa)[4],
                                        const float (&qb)[4],
                                        uint32_t (&ah)[4], uint32_t (&al)[4],
                                        uint32_t (&bh)[4], uint32_t (&bl)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    tf32_split(qa[e], ah[e], al[e]);
    tf32_split(qb[e], bh[e], bl[e]);
  }
}

// Q -= A B for a chunk of kN columns of Q from n0 (64 rows a warpgroup):
// A B into zeroed accumulators, then subtracted from Q's tile in shared
// memory in float32 (round to nearest: the tensor cores' sums truncate,
// and a state carried through 2^15 blocks must not drift).  A is A C, the
// update's A operand (4 k-steps as TF32 pairs in registers); B's pair is
// at sH / sL (kB x rr, K-major).
// D += A B on the tensor cores, D 64 x kN (kN = 8, 32 or 64)
template <int kN>
__device__ __forceinline__ void mma(float (&d)[kN / 2],
                                    const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kN == 64) {
    wgmma_tf32_n64<1>(d, a, b);
  } else if constexpr (kN == 32) {
    wgmma_tf32_n32<1>(d, a, b);
  } else {
    wgmma_tf32_n8<1>(d, a, b);
  }
}

template <int kN>
__device__ __forceinline__ void update_chunk(
    float* __restrict__ sQ, int r, int rr, int n0, int row0, int row1, int t,
    const float* sH, const float* sL, uint32_t (&fh)[4][4],
    uint32_t (&fl)[4][4]) {
  float d[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) d[i] = 0.f;
  uint64_t bh[4], bl[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int off = kB * n0 + 64 * s;
    bh[s] = plain_desc(sH + off, kCore, kB * 32);
    bl[s] = plain_desc(sL + off, kCore, kB * 32);
  }
  // every register the products read is defined before the fence
  hold(d);
  hold4(fh);
  hold4(fl);
  hold_desc(bh);
  hold_desc(bl);
  wg_fence();
  // the pairs' small terms first, so that only the four hi.hi products add
  // into a sum of their size (each such add truncates)
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint32_t(&a)[4] = s < 4 ? fl[s] : fh[s & 3];
    const uint64_t b = s < 4 ? bh[s] : bl[s & 3];
    mma<kN>(d, a, b);
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) mma<kN>(d, fh[s], bh[s]);
  wg_commit();
  wg_wait_all();
  hold(d);
  // a thread's two columns 2t, 2t + 1 by one float2 where R is even: a
  // warp's 8 rows x 32 bytes then take the 2 wavefronts they must
#pragma unroll
  for (int q = 0; q < kN / 8; ++q) {
    const int col = n0 + 8 * q + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = h ? row1 : row0;
      if (a >= r || col >= r) continue;
      if ((r & 1) == 0) {
        float2* qp = reinterpret_cast<float2*>(sQ + a * r + col);
        float2 v = *qp;
        v.x -= d[4 * q + 2 * h];
        v.y -= d[4 * q + 2 * h + 1];
        *qp = v;
      } else {
        sQ[a * r + col] -= d[4 * q + 2 * h];
        if (col + 1 < r) sQ[a * r + col + 1] -= d[4 * q + 2 * h + 1];
      }
    }
  }
}

__global__ void __launch_bounds__(128 * kMaxWg, 1)
    kernel(const float* __restrict__ Z, const float* __restrict__ W,
           const float* __restrict__ U, long long m, int r,
           unsigned char* __restrict__ take_out, float* __restrict__ p_out) {
  extern __shared__ __align__(128) float smem_b[];
  // Z's rows by float4 where R is a multiple of 4 and Z 16-byte aligned
  const bool vec4 =
      (r & 3) == 0 && (reinterpret_cast<uintptr_t>(Z) & 15) == 0;
  const int rr = r8(r), zk = r16(r), nwg = warpgroups(r);
  const int threads = 128 * nwg;
  float* sQ = smem_b;              // (r, r): the draw's state
  float* sH = sQ + q_floats(r);    // Z raw; G's partials; scratch; B's hi
  float* sL = sH + h_floats(r);    // Z's lo; A (float32); B's lo
  float* sU = sL + kB * zk;        // (kB,): the block's uniforms
  float* sCol = sU + kB;           // (2, kB): the decisions' pivot column
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 64 * (warp >> 2) + 16 * (warp & 3) + g, row1 = row0 + 8;
  const long long draw = blockIdx.x;
  const float* u = U + draw * m;
  const long long nblk = (m + kB - 1) / kB;
  const uint32_t sbo_z = zk * 32;  // Z's 8-row groups (C's: kB * 32)
#ifdef CHOLESKY_SCAN_CLOCKS
  long long clk = clock64();
  auto phase = [&](int k) {
    if (tid == 0 && blockIdx.x == 0) {
      const long long now = clock64();
      g_clocks[k] += now - clk;
      clk = now;
    }
  };
#else
  auto phase = [](int) {};
#endif

  for (int k = tid; k < r * r; k += threads) sQ[k] = W[k];

  // a block's Z in float4s f = tid + threads i, f the float4's place in
  // Z's core-matrix layout (so that a warp reads 8 rows x 64 contiguous
  // bytes), rows past M and columns past R zero; and its uniforms (past M
  // 1: p = 0 there, never taken); loaded a block ahead into registers
  float4 zv[kLoads];
  float uv = 1.f;
  auto load = [&](long long blk) {
    const int per_group = zk >> 2;  // float4s of a row
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int f = tid + threads * i;
      const int cm = f >> 3, ng = cm / per_group;
      const int x = (cm - ng * per_group) << 2, j = (ng << 3) | (f & 7);
      const long long row = blk * kB + j;
      const bool in = f < 8 * zk && row < m;
      zv[i] = ld_early4(Z + (in ? row * r : 0), x, r, in, vec4);
    }
    if (tid < kB) {
      const bool in = blk * kB + tid < m;
      uv = in ? ld_early(u + blk * kB + tid, true) : 1.f;
    }
  };
  load(0);

  for (long long blk = 0; blk < nblk; ++blk) {
    // the block's Z raw and its lo; its uniforms
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int f = tid + threads * i;
      if (f < 8 * zk) {
        const float4 v = zv[i];
        reinterpret_cast<float4*>(sH)[f] = v;
        reinterpret_cast<float4*>(sL)[f] = make_float4(
            lo_tf32(v.x), lo_tf32(v.y), lo_tf32(v.z), lo_tf32(v.w));
      }
    }
    if (tid < kB) sU[tid] = uv;
    fence_async_smem();
    __syncthreads();  // also Q's updates of the block before
    phase(0);

    // A = Q Z_b^T and B^T = Q^T Z_b^T: rows row0, row1 of the warpgroup's
    // 64, two k-steps of 8 a stage over Q's columns (A) or rows (B^T); a
    // stage's products into zeroed partials, added in float32 (rounded to
    // nearest) after it: the tensor cores' sums truncate, and a sum over
    // all of R in them would carry a bias of up to 3 R / 8 units in the
    // last place
    float acc_a[16], acc_b[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc_a[i] = acc_b[i] = 0.f;
    for (int st = 0; st < (zk >> 4); ++st) {
      uint32_t ah[2][4], al[2][4], bh[2][4], bl[2][4];
      uint64_t zd[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float qa[4], qb[4];
        q_load(sQ, r, 2 * st + h, row0, row1, t, qa, qb);
        q_split(qa, qb, ah[h], al[h], bh[h], bl[h]);
        zd[2 * h] = plain_desc(sH + 64 * (2 * st + h), kCore, sbo_z);
        zd[2 * h + 1] = plain_desc(sL + 64 * (2 * st + h), kCore, sbo_z);
      }
      float pa[16], pb[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) pa[i] = pb[i] = 0.f;
      hold_desc(zd);
      hold(pa);
      hold(pb);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        hold4(ah[h]);
        hold4(al[h]);
        hold4(bh[h]);
        hold4(bl[h]);
      }
      wg_fence();
      // the two sums' chains interleaved, the pairs' small terms first
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma<32>(pa, al[h], zd[2 * h]);
        mma<32>(pb, bl[h], zd[2 * h]);
        mma<32>(pa, ah[h], zd[2 * h + 1]);
        mma<32>(pb, bh[h], zd[2 * h + 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma<32>(pa, ah[h], zd[2 * h]);
        mma<32>(pb, bh[h], zd[2 * h]);
      }
      wg_commit();
      wg_wait_all();
      hold(pa);
      hold(pb);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        hold4(ah[h]);
        hold4(al[h]);
        hold4(bh[h]);
        hold4(bl[h]);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        acc_a[i] += pa[i];
        acc_b[i] += pb[i];
      }
    }
    __syncthreads();  // every warpgroup's products have read Z's pair
    phase(1);
    if (blk + 1 < nblk) load(blk + 1);

    // A into Z's lo buffer (float32, rows < rr)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 8 * c + 2 * t;
      if (row0 < rr)
        *reinterpret_cast<float2*>(sL + aswz(row0, j)) =
            make_float2(acc_a[4 * c], acc_a[4 * c + 1]);
      if (row1 < rr)
        *reinterpret_cast<float2*>(sL + aswz(row1, j)) =
            make_float2(acc_a[4 * c + 2], acc_a[4 * c + 3]);
    }
    __syncthreads();
    phase(2);

    // G = Z_b A by float32 FMA: warp w sums the x-quads of its share
    // (w / 4 of the nwg) for the items 8 (w % 4) .. 8 (w % 4) + 7, lane k
    // G's column k
    float gp[8];
    {
      const int nq = rr >> 2, xr = warp >> 2, jg = warp & 3;
      const int q1 = ((xr + 1) * nq) / nwg;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) gp[jj] = 0.f;
#pragma unroll 2
      for (int q = (xr * nq) / nwg; q < q1; ++q) {
        float a4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) a4[e] = sL[aswz(4 * q + e, lane)];
        const float4* zq = reinterpret_cast<const float4*>(sH) +
                           (jg * (zk >> 2) + q) * 8;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float4 z = zq[jj];
          gp[jj] = fmaf(z.x, a4[0], gp[jj]);
          gp[jj] = fmaf(z.y, a4[1], gp[jj]);
          gp[jj] = fmaf(z.z, a4[2], gp[jj]);
          gp[jj] = fmaf(z.w, a4[3], gp[jj]);
        }
      }
    }
    __syncthreads();  // every warp has read Z raw
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      sH[(((warp >> 2) * kB + 8 * (warp & 3) + jj) << 5) + lane] = gp[jj];
    __syncthreads();
    phase(3);

    // The block's decisions on warp 0, lane c holding G's column c:
    // Gauss-Jordan without row exchange whose pivot k is item k's clamped
    // denominator d_k, which leaves C = (G + diag(d - p))^-1 in place.  At
    // step k lane k puts its column in shared memory (two buffers, so one
    // __syncwarp a step) and every lane reads it back by broadcast, decides
    // item k and takes 1 / d_k itself.  Lane k's own column takes -f / d_k
    // as the others' a - f rk: a - f (rk + 1), where its a is f.
    if (warp == 0) {
      float a[kB];
#pragma unroll
      for (int j = 0; j < kB; ++j) a[j] = sH[(j << 5) + lane];
#pragma unroll
      for (int w = 1; w < kMaxWg; ++w)
        if (w < nwg) {
#pragma unroll
          for (int j = 0; j < kB; ++j) a[j] += sH[((w * kB + j) << 5) + lane];
        }
      float myp = 0.f;
      bool mytake = false;
      phase(4);
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        float* col = sCol + (k & 1) * kB;
        const bool me = lane == k;
        if (me) {
#pragma unroll
          for (int i = 0; i < kB; i += 4)
            *reinterpret_cast<float4*>(col + i) =
                make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
        }
        __syncwarp();
        float f[kB];
#pragma unroll
        for (int i = 0; i < kB; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(col + i);
          f[i] = v.x;
          f[i + 1] = v.y;
          f[i + 2] = v.z;
          f[i + 3] = v.w;
        }
        const float pk = f[k];
        const bool tk = sU[k] < pk;
        const float inv = rcp(tk ? fmaxf(pk, kEps) : fminf(pk - 1.f, -kEps));
        if (me) {
          myp = pk;
          mytake = tk;
        }
        const float rk = (me ? 1.f : a[k]) * inv;
        const float mk = me ? rk + 1.f : rk;
#pragma unroll
        for (int i = 0; i < kB; ++i)
          if (i != k) a[i] = fmaf(-f[i], mk, a[i]);
        a[k] = rk;
      }
      phase(5);
      const long long item = blk * kB + lane;
      if (item < m) {
        take_out[draw * m + item] = mytake ? 1 : 0;
        p_out[draw * m + item] = myp;
      }
      // C's pair, the B operand of A C (K-major: C's column c is lane c's)
#pragma unroll
      for (int j = 0; j < kB; j += 4) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(a[j + e], h[e], l[e]);
        const int o = core(lane, j, kB);
        *reinterpret_cast<uint4*>(sH + kPair + o) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(sH + kPair + kB * kB + o) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
    fence_async_smem();
    __syncthreads();
    phase(6);

    // A C on the tensor cores, then as the update's A operand: the
    // accumulator's columns 2t, 2t + 1 moved to the A fragment's t, t + 4
    // by shuffles within the quad, and split into pairs
    uint32_t fh[4][4], fl[4][4];
    {
      float ac[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) ac[i] = 0.f;
      uint32_t xh[4][4], xl[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = e & 1 ? row1 : row0, k = 8 * s + t + (e < 2 ? 0 : 4);
          tf32_split(a < rr ? sL[aswz(a, k)] : 0.f, xh[s][e], xl[s][e]);
        }
      uint64_t ch[4], cl[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        ch[s] = plain_desc(sH + kPair + 64 * s, kCore, kB * 32);
        cl[s] = plain_desc(sH + kPair + kB * kB + 64 * s, kCore, kB * 32);
      }
      float small[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) small[i] = 0.f;
      hold(ac);
      hold(small);
      hold4(xh);
      hold4(xl);
      hold_desc(ch);
      hold_desc(cl);
      wg_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {  // the small terms in their own sum
        mma<32>(small, xl[s], ch[s]);
        mma<32>(ac, xh[s], ch[s]);
        mma<32>(small, xh[s], cl[s]);
      }
      wg_commit();
      wg_wait_all();
      hold(small);
#pragma unroll
      for (int i = 0; i < 16; ++i) ac[i] += small[i];
      hold(ac);
      hold4(xh);
      hold4(xl);
      const int src = (lane & ~3) | (t >> 1);
      const bool odd = t & 1;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float v[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int from = src + 2 * h;
          const float e0 = __shfl_sync(0xffffffffu, ac[4 * s], from);
          const float e1 = __shfl_sync(0xffffffffu, ac[4 * s + 1], from);
          const float f0 = __shfl_sync(0xffffffffu, ac[4 * s + 2], from);
          const float f1 = __shfl_sync(0xffffffffu, ac[4 * s + 3], from);
          v[2 * h] = odd ? e1 : e0;
          v[2 * h + 1] = odd ? f1 : f0;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(v[e], fh[s][e], fl[s][e]);
      }
    }
    __syncthreads();  // A and C's pair read
    phase(7);

    // B's pair (the update's B operand: rows x of B^T, K-major), then
    // Q -= (A C) B, a chunk of 64 columns at a time (the last ones by 32
    // and 8)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 8 * c + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? row1 : row0;
        if (row < rr) {
          uint32_t h0, l0, h1, l1;
          tf32_split(acc_b[4 * c + 2 * h], h0, l0);
          tf32_split(acc_b[4 * c + 2 * h + 1], h1, l1);
          const int o = core(row, j, kB);
          *reinterpret_cast<uint2*>(sH + o) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(sL + o) = make_uint2(l0, l1);
        }
      }
    }
    fence_async_smem();
    __syncthreads();
    {
      int n0 = 0;
      for (; n0 + 64 <= rr; n0 += 64)
        update_chunk<64>(sQ, r, rr, n0, row0, row1, t, sH, sL, fh, fl);
      if (n0 + 32 <= rr) {
        update_chunk<32>(sQ, r, rr, n0, row0, row1, t, sH, sL, fh, fl);
        n0 += 32;
      }
      for (; n0 < rr; n0 += 8)
        update_chunk<8>(sQ, r, rr, n0, row0, row1, t, sH, sL, fh, fl);
    }
    // the next block's Z overwrites B's pair after every update has read it
    __syncthreads();
    phase(8);
  }
}

}  // namespace blocked

// Z: (m, R) item rows; W: (R, R) the inner matrix each draw starts from;
// U: (n, m) uniforms; take: (n, m) bytes 0/1; p: (n, m) the marginals.  All
// float32 (but take) and contiguous on the current device.  Each entry
// launches n CTAs on `stream` on its route and returns the cudaError_t of
// the launch.
template <typename Kernel>
static int launch(Kernel kernel, int threads, size_t smem, const float* Z,
                  const float* W, const float* U, long long m, int R, int n,
                  unsigned char* take, float* p, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      Z, W, U, m, R, take, p);
  return cudaGetLastError();
}

extern "C" int cholesky_scan_blocked(const float* Z, const float* W,
                                     const float* U, long long m, int R,
                                     int n, unsigned char* take, float* p,
                                     void* stream) {
  if (n <= 0 || m <= 0) return cudaSuccess;
  if (R <= 0 || R > blocked::kMaxR) return cudaErrorInvalidValue;
  return launch(blocked::kernel, 128 * blocked::warpgroups(R),
                blocked::smem_bytes(R),
                Z, W, U, m, R, n, take, p, stream);
}

#ifdef CHOLESKY_SCAN_CLOCKS
// The blocked route's clocks by step since the last call (then zeroed).
extern "C" int cholesky_scan_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, blocked::g_clocks,
                                         sizeof(blocked::g_clocks));
  if (err != cudaSuccess) return err;
  const unsigned long long zero[blocked::kPhases] = {};
  return cudaMemcpyToSymbol(blocked::g_clocks, zero, sizeof(zero));
}
#endif

extern "C" int cholesky_scan_resident(const float* Z, const float* W,
                                      const float* U, long long m, int R,
                                      int n, unsigned char* take, float* p,
                                      void* stream) {
  if (n <= 0 || m <= 0) return cudaSuccess;
  if (R <= 0 || R > resident::kMaxR) return cudaErrorInvalidValue;
  return launch(resident::cholesky_scan_kernel, resident::kThreads,
                resident::smem_bytes(R), Z, W, U, m, R, n, take, p, stream);
}
