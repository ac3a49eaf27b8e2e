// block_outer_sums and gathered_block_grams: leaf Grams of the flat
// sample tree on Hopper.
//
// block_outer_sums replaces the TPU kernel repro/kernels/tree_sum/
// tree_sum.py::block_outer_sums_pallas (_tree_sum_kernel): for every leaf
// block n of `block` consecutive rows of W (n_blocks*block, R),
// Sigma_n = W_n^T W_n.
//
// Bound on the H100: bytes.  Sigma_n is symmetric, so the work is
// n_blocks * block * R(R+1) FLOP against (n_blocks*block*R +
// n_blocks*R^2) * 4 bytes; at the main path's shape (16,384 blocks of 64
// rows, R = 200) that is 42 GFLOP, 0.63 ms at the 67 TFLOP/s fp32 peak,
// against 3.46 GB, 1.03 ms at 3.35 TB/s.  The output (2.6 GB) is larger
// than the input (0.84 GB).
//
// Design: one CTA per (leaf block, 32 x 32 output tile), tiles of a block
// adjacent in the 1-D grid so the block's rows are fetched from HBM once
// and re-read from L2 by its other tiles.  Each thread sums 4 entries over
// the block's rows in a fixed order with float32 FMA (block_gram_tile in
// gram.cuh, shared with gathered_block_grams below so that a
// rebuilt block is bit-equal to the full build).  No tensor cores: TF32
// would break the float32 contract, and a faster design (register tiling,
// wgmma in 3xTF32, writing only one triangle) is later work.
//
// gathered_block_grams replaces gathered_block_grams_pallas
// (_gathered_gram_kernel): the Grams of only the blocks named by an index
// vector, the dynamic catalog's row update.  The TPU kernel gathers its
// block by scalar prefetch; here each CTA loads its own block id.  Each
// CTA owns one (index i, 32 x 32 tile) and runs the very same
// block_gram_tile on block blks[i], so a recomputed block is bit-equal to
// the same block of block_outer_sums (the catalog's tree stays bit-equal
// to a rebuild).  Bound: bytes, nb * (block*R + R^2) * 4 (216 MB, 65 us
// at 3.35 TB/s for 1,024 blocks of 64 rows at R = 200), against
// nb * block * R(R+1) FLOP (2.6 GFLOP, 39 us).
#include <cuda_runtime.h>

#include <math.h>

#include "gram.cuh"

namespace {

__global__ void __launch_bounds__(repro_torch::kGramTile * repro_torch::kGramRowsY)
block_outer_sums_kernel(const float* __restrict__ W, float* __restrict__ out,
                        int block, int R, int tiles) {
  const long long cta = blockIdx.x;
  const long long n = cta / (tiles * tiles);
  const int t = (int)(cta % (tiles * tiles));
  const int i0 = (t / tiles) * repro_torch::kGramTile;
  const int j0 = (t % tiles) * repro_torch::kGramTile;
  repro_torch::block_gram_tile(W + n * block * R, block, R, i0, j0,
                               out + n * R * R);
}

__global__ void __launch_bounds__(repro_torch::kGramTile * repro_torch::kGramRowsY)
gathered_block_grams_kernel(const float* __restrict__ W,
                            const long long* __restrict__ blks,
                            float* __restrict__ out, long long n_blocks,
                            int block, int R, int tiles) {
  const long long cta = blockIdx.x;
  const long long i = cta / (tiles * tiles);
  const int t = (int)(cta % (tiles * tiles));
  const int i0 = (t / tiles) * repro_torch::kGramTile;
  const int j0 = (t % tiles) * repro_torch::kGramTile;
  const long long b = blks[i];
  float* o = out + i * R * R;
  if (b < 0 || b >= n_blocks) {  // never read outside W: a visible NaN Gram
    for (int r = threadIdx.y; r < repro_torch::kGramTile; r += repro_torch::kGramRowsY) {
      const int ii = i0 + r, jj = j0 + threadIdx.x;
      if (ii < R && jj < R) o[(long long)ii * R + jj] = nanf("");
    }
    return;
  }
  repro_torch::block_gram_tile(W + b * block * R, block, R, i0, j0, o);
}

}  // namespace

// W: (n_blocks * block, R) float32, out: (n_blocks, R, R) float32, both
// contiguous on the current device.  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int block_outer_sums_launch(const float* W, float* out,
                                       long long n_blocks, int block, int R,
                                       void* stream) {
  if (n_blocks <= 0) return cudaSuccess;
  if (block <= 0 || R <= 0) return cudaErrorInvalidValue;
  const int tiles = (R + repro_torch::kGramTile - 1) / repro_torch::kGramTile;
  const long long grid = n_blocks * tiles * tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 threads(repro_torch::kGramTile, repro_torch::kGramRowsY);
  block_outer_sums_kernel<<<(unsigned)grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      W, out, block, R, tiles);
  return cudaGetLastError();
}

// W: (n_blocks * block, R) float32, blks: (nb,) int64 block ids, out:
// (nb, R, R) float32, all contiguous on the current device.  Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int gathered_block_grams_launch(const float* W,
                                           const long long* blks, float* out,
                                           long long nb, long long n_blocks,
                                           int block, int R, void* stream) {
  if (nb <= 0) return cudaSuccess;
  if (block <= 0 || R <= 0) return cudaErrorInvalidValue;
  const int tiles = (R + repro_torch::kGramTile - 1) / repro_torch::kGramTile;
  const long long grid = nb * tiles * tiles;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 threads(repro_torch::kGramTile, repro_torch::kGramRowsY);
  gathered_block_grams_kernel<<<(unsigned)grid, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      W, blks, out, n_blocks, block, R, tiles);
  return cudaGetLastError();
}
