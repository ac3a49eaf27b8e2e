// The quadratic-form kernel shared by score_all (mcmc_score.cu) and
// bilinear (bilinear.cu): s[c, m] = z_m^T A_c z_m for every row z_m of
// Z (M, R) and every matrix A_c (C, R, R), accumulated in float32.  T is
// float or __nv_bfloat16; bfloat16 inputs are widened to float32 exactly
// (a 16-bit shift) before any arithmetic.  float32 FMA only, no TF32: the
// scores are held to 1e-4 of a chain's largest |score|, which one TF32
// rounding of z would not meet.
//
// Bound on the H100: operations.  A quadratic form sees only the symmetric
// part of its matrix, so the least work is R^2 to form it and R(R+1)/2
// multiply-adds a row over i <= j: C M R(R+1) FLOP (42.2 GFLOP at C = 1,
// M = 2^20, R = 200: 0.63 ms at the 67 TFLOP/s fp32 peak) against
// (M R + C R^2 + C M) elements read and written (0.84 GB in float32,
// 0.25 ms at 3.35 TB/s).
//
// Two routes, chosen by R alone (quad_form_route, which the wrappers read
// to count launches by route), so every shard of a sharded call takes the
// same one:
//
// "resident" (R <= kQuadResidentMaxR), the path's route.  Persistent CTAs
// of 12 warps, one an SM: grid (max(1, SMs / C), C), CTA (x, c) takes row
// tiles x, x + gridDim.x, ... of chain c.  Each CTA forms once, in shared
// memory, the upper triangle U of A_c + A_c^T (U_ii = A_ii, U_ij = A_ij +
// A_ji for i < j; 83 KB at R = 200, packed by 8-column tiles), so
// s = sum_j z_j sum_{i<=j} z_i U_ij, and streams 64-row tiles of Z
// through a two-buffer cp.async ring: A_c crosses L2 once a CTA, not once
// a row tile, and a tile's copy runs under the previous tile's FMAs.  A
// thread holds an 8-row x 8-column register tile (rows g, g+8, ..., g+56
// of the Z tile; one 8-column tile of U): 4 columns of its 8 rows and 4
// rows of U come as 16 loads of 16 bytes for 256 FMAs.  Column tile t
// needs i < 8t + 8, so the tiles are paired, (T-1-t, t): a lane walks
// k = 0 .. 8(T+1)-1, taking i = k on tile T-1-t and then i-block 8T+4-k
// on tile t, the same work for every pair.  A warp's 32 lanes are 8 row
// groups x 4 pairs, and a quarter-warp (one pair, 8 row groups) reads its
// rows' columns in 8 distinct banks and its U row at one address.  The
// pairs' k ranges are laid end to end and cut evenly between the 12 warps
// (a last group of one or two pairs is split over the 4 slots), so the
// triangle's FMAs, 1.03 M R(R+1)/2 at R = 200, spread over the SM's warps
// to within a few percent.  What bounds it on the H100: the shared-memory
// loads.  A 16-byte load a lane costs the SM's shared-memory pipe about 4
// cycles a warp (2.6 when a quarter-warp reads one address), so the
// 16 loads a 256-FMA block hold this loop to ~70% of the FMA rate
// (tools/smem_fma_bench.cu), a larger register tile no better.
//
// "panel" (R up to kQuadMaxR), the first port's tile: one CTA per (chain,
// 64 rows of Z), the tile staged transposed and A_c streamed through
// shared memory in panels of 32 columns, 4 x 4 register blocks, the full
// square.
//
// Position independence (both routes): a row's arithmetic depends only on
// its own z_m, on A_c and on R, never on M, on the row's place, or on the
// CTA that takes it; U is formed by the same expression in every CTA.  So
// scoring a slice of Z's rows gives the same bits as scoring all of them,
// which the sharded scorers rely on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace repro_torch {

constexpr int kQuadMaxR = 512;          // the widest R either route takes
constexpr int kQuadResidentMaxR = 224;  // U and two Z tiles fit up to here
constexpr int kQuadSmemMax = 232448;    // bytes a CTA may use (sm_90)

// The route of R: 1 "resident" (R <= kQuadResidentMaxR), 0 "panel".
inline int quad_form_route(int R) { return R <= kQuadResidentMaxR ? 1 : 0; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Four consecutive elements at p as float32 (p 16-byte aligned for float,
// 8-byte aligned for bfloat16, whose widening is a 16-bit shift).
__device__ __forceinline__ float4 load4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4f(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// ------------------------------------------------------------ resident route
constexpr int kQuadRows = 64;              // rows of Z a tile
constexpr int kQuadWarps = 12;
constexpr int kQuadThreads = 32 * kQuadWarps;
constexpr int kQuadReg = 8;                // a thread's tile: 8 x 8

// Bytes of one staged row of Z (8T elements and a pad): a multiple of 16
// that is 16 mod 32, so the 8 row groups' loads at one column fall in
// distinct banks.
__host__ __device__ __forceinline__ int quad_row_bytes(int T, int elt) {
  return (8 * T * elt + 31) / 32 * 32 + 16;
}

// U packed by column tile: tile t holds rows 0 .. 8t+7 of its 8 columns,
// 8 floats a row, from float quad_u_base(t) (its 4 t floats of skew put
// the tiles that a warp reads at one row in different banks); T tiles take
// quad_u_base(T) floats.
__host__ __device__ __forceinline__ int quad_u_base(int t) {
  return 32 * t * (t + 1) + 4 * t;
}

__host__ __device__ __forceinline__ size_t quad_resident_smem(int R, int elt) {
  const int T = (R + kQuadReg - 1) / kQuadReg;
  return (size_t)quad_u_base(T) * sizeof(float) +
         2 * (size_t)kQuadRows * quad_row_bytes(T, elt) +
         (size_t)kQuadWarps * kQuadRows * sizeof(float);
}

// Rows of Z in row tile `tile` (64, or fewer in the last).
__device__ __forceinline__ int quad_tile_rows(long long tile, long long M) {
  const long long left = M - tile * kQuadRows;
  return left < kQuadRows ? (int)left : kQuadRows;
}

// The copies of a Z tile that one thread makes: column chunk `q` of rows
// r, r + step, ... (set once a kernel, so no copy divides).  mode 16 / 4:
// 16- / 4-byte cp.async (R * sizeof(T) a multiple of that and Z aligned to
// it); 0: element by element through registers.
struct QuadCopy {
  int q, r, step, per;  // per: elements a copy
};

template <typename T>
__device__ __forceinline__ QuadCopy quad_copy_plan(int R, int mode) {
  QuadCopy p;
  p.per = mode > 0 ? mode / (int)sizeof(T) : 1;
  const int per_row = R / p.per;  // copies a row, at most R <= 224
  p.step = kQuadThreads / per_row;
  p.q = threadIdx.x % per_row;
  p.r = threadIdx.x / per_row;
  if (p.r >= p.step) p.r = kQuadRows;  // a thread past the last full row
  return p;
}

// Copy rows m0 .. m0+rows-1 of Z into the staged tile zs (S elements a
// row).
template <typename T>
__device__ __forceinline__ void quad_stage_tile(
    const T* __restrict__ Z, long long m0, int rows, int R,
    T* __restrict__ zs, int S, int mode, const QuadCopy& p) {
  const int c = p.q * p.per;
  for (int r = p.r; r < rows; r += p.step) {
    const T* src = Z + (m0 + r) * R + c;
    T* dst = zs + r * S + c;
    if (mode == 16)
      cp_async16(dst, src);
    else if (mode == 4)
      cp_async4(dst, src);
    else
      *dst = *src;
  }
}

// part[r] += sum_c acc[r][c] * z[row r][8 tile + c] (one FMA chain, c in
// order), then acc = 0.  zg: the thread's first row; row r at zg + r*stride8.
template <typename T>
__device__ __forceinline__ void quad_flush(
    const T* zg, int stride8, int tile, float (&acc)[kQuadReg][kQuadReg],
    float (&part)[kQuadReg]) {
#pragma unroll
  for (int r = 0; r < kQuadReg; ++r) {
    const T* zr = zg + r * stride8 + kQuadReg * tile;
    const float4 lo = load4f(zr), hi = load4f(zr + 4);
    const float z[kQuadReg] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int c = 0; c < kQuadReg; ++c) {
      part[r] = fmaf(acc[r][c], z[c], part[r]);
      acc[r][c] = 0.f;
    }
  }
}

// The pairs' work plan, the same in every CTA and for every row group.
// Column tiles T; pairs P = ceil(T/2): pair p takes tile T-1-p for
// k < 8(T-p) (i = k) and tile p after (i-block 8T+4-k), 8(T+1) steps;
// when T is odd the last pair is the middle tile alone, 4(T+1) steps.
// Groups of 4 pairs share a warp's 4 slots; a last group of 1 or 2 pairs
// gives each pair 4 or 2 slots, each a piece of its k range.
struct QuadPlan {
  int T, P, Q, last_pairs, reps, piece;  // reps, piece: the last group's
  int full;                              // 8(T+1)

  __device__ __forceinline__ explicit QuadPlan(int T_) : T(T_) {
    P = (T + 1) / 2;
    Q = (P + 3) / 4;
    last_pairs = P - 4 * (Q - 1);
    full = 8 * (T + 1);
    reps = last_pairs <= 2 ? 4 / last_pairs : 1;
    // the last group's longest pair: the middle tile alone is half
    const int lg = (last_pairs == 1 && (T & 1)) ? 4 * (T + 1) : full;
    piece = 4 * ((lg + 4 * reps - 1) / (4 * reps));
  }
  __device__ __forceinline__ int pair_len(int p) const {
    return ((T & 1) && p == P - 1) ? 4 * (T + 1) : full;
  }
  __device__ __forceinline__ int group_len(int q) const {
    return q == Q - 1 ? piece : full;
  }
  __device__ __forceinline__ int total() const {
    return (Q - 1) * full + piece;
  }
};

template <typename T>
__global__ void __launch_bounds__(kQuadThreads, 1)
quad_resident_kernel(const T* __restrict__ Z, const T* __restrict__ A,
                     float* __restrict__ out, long long M, int R, int mode) {
  extern __shared__ float4 quad_smem[];
  const int nt = (R + kQuadReg - 1) / kQuadReg;  // column tiles
  const int S = quad_row_bytes(nt, (int)sizeof(T)) / (int)sizeof(T);
  float* us = reinterpret_cast<float*>(quad_smem);
  T* zbuf = reinterpret_cast<T*>(us + quad_u_base(nt));  // 2 tiles
  float* red = reinterpret_cast<float*>(zbuf + 2 * kQuadRows * S);
  const int c = blockIdx.y;
  const T* a_c = A + (long long)c * R * R;
  const long long n_tiles = (M + kQuadRows - 1) / kQuadRows;
  const long long stride = gridDim.x;

  // Columns R .. 8nt-1 of both buffers are zero (U is zero there too, but
  // 0 * garbage need not be 0); no copy writes them.
  for (int e = threadIdx.x; e < 2 * kQuadRows * (8 * nt - R);
       e += kQuadThreads) {
    const int r = e / (8 * nt - R), q = e - r * (8 * nt - R);
    zbuf[r * S + R + q] = zero_of<T>();
  }
  const QuadCopy copy = quad_copy_plan<T>(R, mode);
  long long tile = blockIdx.x;
  if (tile < n_tiles)
    quad_stage_tile(Z, tile * kQuadRows, quad_tile_rows(tile, M), R, zbuf, S,
                    mode, copy);
  cp_async_commit();
  // U, packed by column tile, while the first tile lands
  for (int t = 0; t < nt; ++t) {
    float* ut = us + quad_u_base(t);
    for (int e = threadIdx.x; e < 64 * (t + 1); e += kQuadThreads) {
      const int i = e >> 3, j = 8 * t + (e & 7);
      float v = 0.f;
      if (i < R && j < R) {
        if (i < j)
          v = to_f32(a_c[(long long)i * R + j]) +
              to_f32(a_c[(long long)j * R + i]);
        else if (i == j)
          v = to_f32(a_c[(long long)i * R + i]);
      }
      ut[e] = v;
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane & 7, slot = lane >> 3;  // row group, pair slot
  const QuadPlan plan(nt);
  const int total = plan.total();
  const int per_warp = 4 * ((total + 4 * kQuadWarps - 1) / (4 * kQuadWarps));
  const int w0 = min(total, warp * per_warp);
  const int w1 = min(total, w0 + per_warp);
  const int stride8 = kQuadRows / kQuadReg * S;  // 8 rows
  for (int it = 0; tile < n_tiles; tile += stride, ++it) {
    const T* zb = zbuf + (it & 1) * kQuadRows * S;
    const long long next = tile + stride;
    if (next < n_tiles)  // into the other buffer, free since the last sync
      quad_stage_tile(Z, next * kQuadRows, quad_tile_rows(next, M), R,
                      zbuf + ((it + 1) & 1) * kQuadRows * S, S, mode, copy);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile (and U) visible to every thread

    const T* zg = zb + g * S;
    float part[kQuadReg];
#pragma unroll
    for (int r = 0; r < kQuadReg; ++r) part[r] = 0.f;
    int pos = 0;
    for (int q = 0; q < plan.Q; ++q) {  // the groups this warp's range meets
      const int len = plan.group_len(q);
      const int a = max(w0, pos) - pos, b = min(w1, pos + len) - pos;
      pos += len;
      if (a >= b) continue;
      const int reps = q == plan.Q - 1 ? plan.reps : 1;
      const int pair = 4 * q + slot / reps;
      const int koff = (slot % reps) * len;
      const int kend = pair < plan.P ? plan.pair_len(pair) : 0;
      const int sw = 8 * (nt - pair);  // tile T-1-pair below, tile pair above
      const float* ua = us + quad_u_base(nt - 1 - pair);
      const float* ub = us + quad_u_base(pair);
      float acc[kQuadReg][kQuadReg];
#pragma unroll
      for (int r = 0; r < kQuadReg; ++r)
#pragma unroll
        for (int x = 0; x < kQuadReg; ++x) acc[r][x] = 0.f;
      int cur = -1;  // the column tile acc holds
#pragma unroll 2
      for (int kk = a; kk < b; kk += 4) {
        const int k = koff + kk;
        if (k >= kend) continue;
        const bool lower = k < sw;
        const int t = lower ? nt - 1 - pair : pair;
        const int i0 = lower ? k : 8 * nt + 4 - k;
        if (t != cur) {
          if (cur >= 0) quad_flush(zg, stride8, cur, acc, part);
          cur = t;
        }
        const float4* u4 =
            reinterpret_cast<const float4*>((lower ? ua : ub) + 8 * i0);
        float4 zv[kQuadReg];
#pragma unroll
        for (int r = 0; r < kQuadReg; ++r)
          zv[r] = load4f(zg + r * stride8 + i0);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float4 u0 = u4[2 * ii], u1 = u4[2 * ii + 1];
          const float u[kQuadReg] = {u0.x, u0.y, u0.z, u0.w,
                                     u1.x, u1.y, u1.z, u1.w};
#pragma unroll
          for (int r = 0; r < kQuadReg; ++r) {
            const float z = ii == 0 ? zv[r].x : ii == 1 ? zv[r].y
                          : ii == 2 ? zv[r].z : zv[r].w;
#pragma unroll
            for (int x = 0; x < kQuadReg; ++x)
              acc[r][x] = fmaf(z, u[x], acc[r][x]);
          }
        }
      }
      if (cur >= 0) quad_flush(zg, stride8, cur, acc, part);
    }
    // the 4 slots of a row group: lanes g, g+8, g+16, g+24
#pragma unroll
    for (int r = 0; r < kQuadReg; ++r) {
      part[r] += __shfl_xor_sync(0xffffffffu, part[r], 8);
      part[r] += __shfl_xor_sync(0xffffffffu, part[r], 16);
    }
    if (slot == 0) {
#pragma unroll
      for (int r = 0; r < kQuadReg; ++r)
        red[warp * kQuadRows + g + kQuadReg * r] = part[r];
    }
    __syncthreads();  // red complete; every read of this tile's buffer done
    if (threadIdx.x < kQuadRows) {
      const long long m = tile * kQuadRows + threadIdx.x;
      float s = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < kQuadWarps; ++w)
        s += red[w * kQuadRows + threadIdx.x];
      if (m < M) out[(long long)c * M + m] = s;
    }
  }
  cp_async_wait<0>();
}

// --------------------------------------------------------------- panel route
constexpr int kPanelRows = 64;                   // rows of Z per CTA
constexpr int kPanelCols = 32;                   // columns of A_c per panel
constexpr int kPanelThreadsX = kPanelCols / 4;   // 8 column groups of 4
constexpr int kPanelThreadsY = kPanelRows / 4;   // 16 row groups of 4
constexpr int kPanelZStride = kPanelRows + 4;    // padded, keeps float4 alignment

template <typename T>
__global__ void __launch_bounds__(kPanelThreadsX * kPanelThreadsY)
quad_panel_kernel(const T* __restrict__ Z, const T* __restrict__ A,
                  float* __restrict__ out, long long M, int R) {
  extern __shared__ float4 smem4[];
  float* zs = reinterpret_cast<float*>(smem4);     // [R][kPanelZStride]
  float* as = zs + (long long)R * kPanelZStride;   // [R][kPanelCols]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kPanelThreadsX + tx;
  const int nthreads = kPanelThreadsX * kPanelThreadsY;
  const long long m0 = (long long)blockIdx.x * kPanelRows;
  const int c = blockIdx.y;
  const T* a_c = A + (long long)c * R * R;

  // the row tile, transposed; rows past M are zeros
  for (int idx = tid; idx < kPanelRows * R; idx += nthreads) {
    const int row = idx / R, k = idx % R;
    const long long m = m0 + row;
    zs[k * kPanelZStride + row] = (m < M) ? to_f32(Z[m * R + k]) : 0.f;
  }

  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int p0 = 0; p0 < R; p0 += kPanelCols) {
    __syncthreads();  // the tile is staged; the previous panel is consumed
    for (int idx = tid; idx < R * kPanelCols; idx += nthreads) {
      const int k = idx / kPanelCols, col = p0 + idx % kPanelCols;
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
          zs + k * kPanelZStride + ty * 4);
      const float4 av = *reinterpret_cast<const float4*>(
          as + k * kPanelCols + tx * 4);
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
          part[i] = fmaf(acc[i][j], zs[col * kPanelZStride + ty * 4 + i],
                         part[i]);
      }
    }
  }
  // the 8 threads of a row group are 8 adjacent lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = kPanelThreadsX / 2; off > 0; off >>= 1)
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
// the current device.  Takes the route quad_form_route(R) gives.  Launches
// on `stream`; returns the cudaError_t of the set-up or the launch.
template <typename T>
int quad_form_launch(const T* Z, const T* A, float* out, long long M, int C,
                     int R, void* stream) {
  if (M <= 0 || C <= 0) return cudaSuccess;
  if (R <= 0 || R > kQuadMaxR || C > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quad_form_route(R)) {
    const size_t smem = quad_resident_smem(R, (int)sizeof(T));
    if (smem > (size_t)kQuadSmemMax) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        quad_resident_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long tiles = (M + kQuadRows - 1) / kQuadRows;
    long long gx = sms / C > 1 ? sms / C : 1;
    if (gx > tiles) gx = tiles;
    const int bytes = R * (int)sizeof(T);
    const uintptr_t zp = reinterpret_cast<uintptr_t>(Z);
    const int mode = (bytes % 16 == 0 && zp % 16 == 0) ? 16
                     : (bytes % 4 == 0 && zp % 4 == 0) ? 4 : 0;
    dim3 grid((unsigned)gx, (unsigned)C);
    quad_resident_kernel<T><<<grid, kQuadThreads, smem, s>>>(Z, A, out, M, R,
                                                             mode);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)R * (kPanelZStride + kPanelCols) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      quad_panel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (M + kPanelRows - 1) / kPanelRows;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)tiles, (unsigned)C);
  dim3 threads(kPanelThreadsX, kPanelThreadsY);
  quad_panel_kernel<T><<<grid, threads, smem, s>>>(Z, A, out, M, R);
  return cudaGetLastError();
}

}  // namespace repro_torch
