// score_all: the MCMC all-candidate move scorer on Hopper.
//
// Replaces the TPU kernel repro/kernels/mcmc_score/mcmc_score.py::
// score_all_pallas (_score_all_kernel): s[c, m] = z_m^T A_c z_m for every
// row z_m of Z (M, R) and every chain's score matrix A_c (C, R, R).  The
// greedy start of the fixed-size MCMC chain (core/mcmc.py::_greedy_round)
// calls it once per round over the whole catalog, at C = 1.
//
// Bound on the H100: operations, C M R(R+1) + C R^2 FLOP on the symmetric
// part of each A_c (42.2 GFLOP at C = 1, M = 2^20, R = 200: 0.63 ms at
// the 67 TFLOP/s fp32 peak) against (M R + C R^2 + C M) * 4 bytes
// (0.84 GB, 0.25 ms at 3.35 TB/s).
//
// Design: quad_form.cuh (shared with bilinear).  Up to R = 224 the
// resident route: the TPU kernel keeps A_c resident and streams Z tiles,
// and so does this one, holding the upper triangle of A_c + A_c^T in
// shared memory (half of A's FMAs) in persistent CTAs that stream 64-row
// tiles of Z; above it the panel route.  Each row's arithmetic is
// independent of M and of the row's place, so score_all_sharded's slices
// are bit-equal to one call over all rows.
#include <cuda_runtime.h>

#include "quad_form.cuh"

// Z: (M, R) float32, A: (C, R, R) float32, out: (C, M) float32, all
// contiguous on the current device.  Launches on `stream` on the route
// score_all_route(R) gives; returns the cudaError_t of the set-up or the
// launch.
extern "C" int score_all_launch(const float* Z, const float* A, float* out,
                                long long M, int C, int R, void* stream) {
  return repro_torch::quad_form_launch<float>(Z, A, out, M, C, R, stream);
}

// The route score_all_launch takes at width R: 1 "resident", 0 "panel".
extern "C" int score_all_route(int R) {
  return repro_torch::quad_form_route(R);
}
