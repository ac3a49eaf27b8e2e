// block_outer_sums and gathered_block_grams: leaf Grams of the flat
// sample tree on Hopper, both run by one kernel.
//
// block_outer_sums replaces the TPU kernel repro/kernels/tree_sum/
// tree_sum.py::block_outer_sums_pallas (_tree_sum_kernel): for every leaf
// block n of `block` consecutive rows of W (n_blocks*block, R),
// Sigma_n = W_n^T W_n.
//
// gathered_block_grams replaces gathered_block_grams_pallas
// (_gathered_gram_kernel): the Grams of only the blocks named by an index
// vector blks, the dynamic catalog's row update.  The TPU kernel gathers
// its block by scalar prefetch; here CTA i loads blks[i] itself and runs
// block_outer_sums' CTA on that block, writing output i (the kernel's
// kGather instance).  The schedule and every chain are the same, so a
// recomputed block is bit-equal to the same block of block_outer_sums (the
// catalog's tree stays bit-equal to a rebuild).  An id outside
// [0, n_blocks) makes its CTA write an all-NaN Gram without reading W.
//
// Bound on the H100: bytes.  Sigma_n is symmetric, so the work is
// block * R(R+1) FLOP a block against (block*R + R^2) * 4 bytes; at the
// main path's shape (16,384 blocks of 64 rows, R = 200) that is 42 GFLOP,
// 0.63 ms at the 67 TFLOP/s fp32 peak, against 3.46 GB, 1.03 ms at
// 3.35 TB/s (the output, 2.6 GB, is larger than the input); at the
// catalog's (1,024 gathered blocks) 2.6 GFLOP, 39 us, against 216 MB,
// 65 us.
//
// Design: one CTA of 128 threads per output block.  The block's rows are
// staged in shared memory once (cp.async, 51 KB at 64 x 200), and each
// thread owns 8 x 8 register tiles of the upper triangle only
// (gram_tile_8x8 in gram.cuh: two 16-byte loads of its rows' and two of
// its columns' values a row, 64 FMAs), so it does the triangle's FMAs and
// not both halves.  A tile is written twice, as itself and mirrored
// (bit-exact: gram.cuh); when R % 8 == 0 every 8-float row of a tile is
// one 32-byte sector, and two neighbouring threads swap halves by shuffle
// so that each 16-byte store instruction fills whole sectors.  Float32
// FMA only: TF32 (or 3xTF32 on the tensor cores) would change the bits
// that the two entry points must share.  Four CTAs fit an SM, so one
// block's stores overlap the others' loads and FMAs.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "gram.cuh"

namespace {

constexpr int kOuterThreads = 128;
constexpr int kOuterRows = 64;            // rows staged a pass
constexpr int kMaxSmem = 232448;          // bytes a CTA may use (sm_90)

// Lanes 2k and 2k+1 each hold one 8-float row segment (v0 | v1) bound for
// the 32-byte sector at `own`; `par` is the partner's.  Each of the two
// stores writes one whole sector: first the even lane's, then the odd
// lane's.  w_own / w_par: whether this lane's / the partner's segment is
// to be written.  Called by all 32 lanes.
__device__ __forceinline__ void paired_store(float* own, float* par,
                                             float4 v0, float4 v1,
                                             bool w_own, bool w_par,
                                             bool odd) {
  const float4 send = odd ? v0 : v1;
  float4 recv;
  recv.x = __shfl_xor_sync(0xffffffffu, send.x, 1);
  recv.y = __shfl_xor_sync(0xffffffffu, send.y, 1);
  recv.z = __shfl_xor_sync(0xffffffffu, send.z, 1);
  recv.w = __shfl_xor_sync(0xffffffffu, send.w, 1);
  float* d1 = odd ? par + 4 : own;
  const float4 s1 = odd ? recv : v0;
  float* d2 = odd ? own + 4 : par;
  const float4 s2 = odd ? v1 : recv;
  if (odd ? w_par : w_own) *reinterpret_cast<float4*>(d1) = s1;
  if (odd ? w_own : w_par) *reinterpret_cast<float4*>(d2) = s2;
}

// One CTA per output block i = blockIdx.x: leaf block i, or with kGather
// leaf block blks[i] (an id outside [0, n_blocks) gives a NaN Gram).
// T = ceil(R / 8) column tiles; chunk: rows staged a pass (all of the block
// when block <= chunk).  vec_in: R % 4 == 0 and W 16-byte aligned;
// vec_out: R % 8 == 0 and out 32-byte aligned.
template <bool kGather>
__global__ void __launch_bounds__(kOuterThreads, 4)
block_outer_sums_kernel(const float* __restrict__ W,
                        const long long* __restrict__ blks,
                        long long n_blocks, float* __restrict__ out,
                        int block, int R, int T, int chunk, bool vec_in,
                        bool vec_out) {
  using repro_torch::kGramReg;
  extern __shared__ float4 outer_smem[];
  float* s = reinterpret_cast<float*>(outer_smem);
  const long long n = kGather ? blks[blockIdx.x] : (long long)blockIdx.x;
  float* ob = out + (long long)blockIdx.x * R * R;
  if (kGather && (n < 0 || n >= n_blocks)) {  // never read outside W
    for (long long e = threadIdx.x; e < (long long)R * R; e += kOuterThreads)
      ob[e] = nanf("");
    return;
  }
  const float* wb = W + n * block * R;
  const int n_tiles = T * (T + 1) / 2;
  const bool once = block <= chunk;
  if (once) {
    repro_torch::gram_stage_rows(wb, R, T, 0, block, s, vec_in);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const bool odd = lane & 1;
  for (int p0 = 0; p0 < n_tiles; p0 += kOuterThreads) {
    const int p = p0 + threadIdx.x;
    const bool active = p < n_tiles;
    int ti, tj;
    repro_torch::gram_tri_tile(active ? p : 0, ti, tj);
    float acc[kGramReg][kGramReg];
#pragma unroll
    for (int a = 0; a < kGramReg; ++a)
#pragma unroll
      for (int b = 0; b < kGramReg; ++b) acc[a][b] = 0.f;
    for (int r0 = 0; r0 < block; r0 += chunk) {
      const int rows = min(chunk, block - r0);
      if (!once) {
        __syncthreads();
        repro_torch::gram_stage_rows(wb, R, T, r0, rows, s, vec_in);
        __syncthreads();
      }
      if (active) repro_torch::gram_tile_8x8(s, T, rows, ti, tj, acc);
    }
    const int i0 = kGramReg * ti, j0 = kGramReg * tj;
    if (vec_out) {  // R == 8T: no column past R
      const int pti = __shfl_xor_sync(0xffffffffu, ti, 1);
      const int ptj = __shfl_xor_sync(0xffffffffu, tj, 1);
      const bool pact = __shfl_xor_sync(0xffffffffu, (int)active, 1) != 0;
      const int pi0 = kGramReg * pti, pj0 = kGramReg * ptj;
#pragma unroll
      for (int a = 0; a < kGramReg; ++a)  // the tile's own rows
        paired_store(ob + (long long)(i0 + a) * R + j0,
                     ob + (long long)(pi0 + a) * R + pj0,
                     make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]),
                     make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]),
                     active, pact, odd);
      const bool mir = active && ti != tj, pmir = pact && pti != ptj;
#pragma unroll
      for (int b = 0; b < kGramReg; ++b)  // mirrored: row j0 + b, columns i0..
        paired_store(ob + (long long)(j0 + b) * R + i0,
                     ob + (long long)(pj0 + b) * R + pi0,
                     make_float4(acc[0][b], acc[1][b], acc[2][b], acc[3][b]),
                     make_float4(acc[4][b], acc[5][b], acc[6][b], acc[7][b]),
                     mir, pmir, odd);
    } else if (active) {
#pragma unroll
      for (int a = 0; a < kGramReg; ++a)
#pragma unroll
        for (int b = 0; b < kGramReg; ++b) {
          const int i = i0 + a, j = j0 + b;
          if (i < R && j < R) {
            ob[(long long)i * R + j] = acc[a][b];
            if (ti != tj) ob[(long long)j * R + i] = acc[a][b];
          }
        }
    }
  }
}

}  // namespace

// Grams of nb blocks of W (n_blocks * block, R) float32 into out (nb, R, R)
// float32: block i when blks is null (nb == n_blocks), else block blks[i].
// All on the current device, contiguous; launches on `stream` and returns
// the cudaError_t of the set-up or the launch.
static int outer_sums_launch(const float* W, const long long* blks,
                             float* out, long long nb, long long n_blocks,
                             int block, int R, void* stream) {
  if (nb <= 0) return cudaSuccess;
  if (block <= 0 || R <= 0) return cudaErrorInvalidValue;
  if (nb > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int T = repro_torch::gram_col_tiles(R);
  const long long row_bytes = 8LL * T * sizeof(float);
  const int chunk = (int)std::min<long long>(
      std::min<long long>(kOuterRows, block), kMaxSmem / row_bytes);
  if (chunk < 1) return cudaErrorInvalidValue;  // bounds T: T(T+1)/2 fits
  const size_t smem = (size_t)(chunk * row_bytes);
  const bool vec_in = R % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  const bool vec_out =
      R % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 32 == 0;
  auto kernel = blks ? block_outer_sums_kernel<true>
                     : block_outer_sums_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)nb, kOuterThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      W, blks, n_blocks, out, block, R, T, chunk, vec_in, vec_out);
  return cudaGetLastError();
}

// W: (n_blocks * block, R) float32, out: (n_blocks, R, R) float32, both
// contiguous on the current device.  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int block_outer_sums_launch(const float* W, float* out,
                                       long long n_blocks, int block, int R,
                                       void* stream) {
  return outer_sums_launch(W, nullptr, out, n_blocks, n_blocks, block, R,
                           stream);
}

// W: (n_blocks * block, R) float32, blks: (nb,) int64 block ids, out:
// (nb, R, R) float32, all contiguous on the current device.  Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int gathered_block_grams_launch(const float* W,
                                           const long long* blks, float* out,
                                           long long nb, long long n_blocks,
                                           int block, int R, void* stream) {
  return outer_sums_launch(W, blks, out, nb, n_blocks, block, R, stream);
}
