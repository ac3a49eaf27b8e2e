// What an SM's shared-memory pipe and FMA units give a register-tiled
// float32 loop, the shape of the quadratic form's resident route
// (src/repro_torch/csrc/quad_form.cuh).  Build and run on the card, from
// the root of the checkout (_ab/ is git-ignored):
//
//     mkdir -p _ab && nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//         -o _ab/smem_fma_bench tools/smem_fma_bench.cu && _ab/smem_fma_bench
//
// Part 1: SM-cycles per warp-wide shared load (LDS.32 / .64 / .128) for
// access patterns a kernel can choose: every lane one address; 8 distinct
// addresses a quarter-warp; 32 distinct; one address a quarter-warp; and
// so on (8 blocks of 256 threads an SM, 8 loads in flight a thread).
// Part 2: the share of the FFMA issue peak (4 warp-FFMAs a cycle an SM)
// that an 8 x 8 register tile (256 FFMAs an iteration) reaches with its
// operands in registers, reloaded from shared memory in a burst (8 z and
// 8 U 16-byte loads an iteration, quarter-warps as in the quadratic form),
// or reloaded interleaved with the FMAs one iteration ahead; and an
// 8 x 16 tile (512 FFMAs for 8 z and 16 U loads).  Cycles are counted at
// the 1.98 GHz boost clock.  Prints one line a case; needs a CUDA device.
#include <cuda_runtime.h>
#include <stdio.h>

// ------------------------------------------------------ part 1: loads
template <int W>  // floats a lane loads: 1, 2 or 4
__global__ void __launch_bounds__(256) lds_bench(float* out, int iters,
                                                 int pattern) {
  __shared__ float4 s4[2048];
  float* s = reinterpret_cast<float*>(s4);
  for (int i = threadIdx.x; i < 4 * 2048; i += blockDim.x) s[i] = i * 1e-3f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int idx;  // in units of W floats
  switch (pattern) {
    case 0: idx = 0; break;                                    // one address
    case 1: idx = lane & 7; break;                             // 8 a quarter, quarters alike
    case 2: idx = lane; break;                                 // 32 distinct
    case 3: idx = (lane >> 3) * 37; break;                     // one a quarter
    default: idx = (lane & 7) + ((lane >> 3) & 1) * 64; break; // 8 a quarter, two sets
  }
  float acc[W];
  for (int w = 0; w < W; ++w) acc[w] = 0.f;
  const int step = 128 / W;  // moves the address, keeps the banks
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int a = (idx + (it * 8 + u) * step) & (4 * 2048 / W - 1);
      if (W == 4) {
        const float4 v = s4[a];
        acc[0] += v.x;
        acc[1 % W] += v.y;
        acc[2 % W] += v.z;
        acc[3 % W] += v.w;
      } else if (W == 2) {
        const float2 v = reinterpret_cast<float2*>(s)[a];
        acc[0] += v.x;
        acc[1 % W] += v.y;
      } else {
        acc[0] += s[a];
      }
    }
  }
  float t = 0.f;
  for (int w = 0; w < W; ++w) t += acc[w];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

// ------------------------------------------------- part 2: FMA loops
__device__ __forceinline__ void row_fma(const float4 (&z)[8], int ii,
                                        float4 a, float4 b,
                                        float (&acc)[8][8]) {
  const float u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float zz = ii == 0 ? z[r].x : ii == 1 ? z[r].y
                   : ii == 2 ? z[r].z : z[r].w;
#pragma unroll
    for (int x = 0; x < 8; ++x) acc[r][x] = fmaf(zz, u[x], acc[r][x]);
  }
}

// MODE 0: operands in registers; 1: burst reload; 2: interleaved, one
// iteration ahead.  Lane = 8 slot + g: a quarter-warp is one slot's 8 row
// groups (z: 8 distinct 16-byte pieces; U: one address).
template <int MODE>
__global__ void fma_bench(float* out, int iters) {
  extern __shared__ float4 sm[];
  float* s = reinterpret_cast<float*>(sm);
  for (int i = threadIdx.x; i < 16384; i += blockDim.x)
    s[i] = 1e-3f * (i & 1023);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane & 7, slot = lane >> 3;
  const float* zg = s + 4 * g;                 // row r at + 32 r
  const float* ug = s + 8192 + 64 * slot * 3;  // the slot's U rows
  float acc[8][8];
  for (int r = 0; r < 8; ++r)
    for (int x = 0; x < 8; ++x) acc[r][x] = 0.f;
  float4 z[8], zn[8], u[8];
  for (int r = 0; r < 8; ++r)
    z[r] = *reinterpret_cast<const float4*>(zg + 32 * r);
  for (int x = 0; x < 8; ++x) u[x] = reinterpret_cast<const float4*>(ug)[x];
  int off = 0;
  if (MODE == 0) {
    for (int it = 0; it < iters; ++it) {
      row_fma(z, 0, u[0], u[1], acc);
      row_fma(z, 1, u[2], u[3], acc);
      row_fma(z, 2, u[4], u[5], acc);
      row_fma(z, 3, u[6], u[7], acc);
    }
  } else if (MODE == 1) {
    for (int it = 0; it < iters; ++it) {
      off = (off + 256) & 4095;
      const float4* zp = reinterpret_cast<const float4*>(zg + off);
#pragma unroll
      for (int r = 0; r < 8; ++r) z[r] = zp[8 * r];
      const float4* up = reinterpret_cast<const float4*>(ug + (off >> 3));
#pragma unroll
      for (int x = 0; x < 8; ++x) u[x] = up[x];
      row_fma(z, 0, u[0], u[1], acc);
      row_fma(z, 1, u[2], u[3], acc);
      row_fma(z, 2, u[4], u[5], acc);
      row_fma(z, 3, u[6], u[7], acc);
    }
  } else {
    float4 a0 = u[0], a1 = u[1];
    for (int it = 0; it < iters; it += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 (&zc)[8] = h ? zn : z;
        float4 (&zx)[8] = h ? z : zn;
        const float4* up = reinterpret_cast<const float4*>(ug + (off >> 3));
        off = (off + 256) & 4095;
        const float4* zp = reinterpret_cast<const float4*>(zg + off);
        const float4* upn = reinterpret_cast<const float4*>(ug + (off >> 3));
        float4 b0 = up[2], b1 = up[3];
        zx[0] = zp[0];
        zx[1] = zp[8];
        row_fma(zc, 0, a0, a1, acc);
        a0 = up[4];
        a1 = up[5];
        zx[2] = zp[16];
        zx[3] = zp[24];
        row_fma(zc, 1, b0, b1, acc);
        b0 = up[6];
        b1 = up[7];
        zx[4] = zp[32];
        zx[5] = zp[40];
        row_fma(zc, 2, a0, a1, acc);
        a0 = upn[0];
        a1 = upn[1];
        zx[6] = zp[48];
        zx[7] = zp[56];
        row_fma(zc, 3, b0, b1, acc);
      }
    }
  }
  float t = 0.f;
  for (int r = 0; r < 8; ++r)
    for (int x = 0; x < 8; ++x) t += acc[r][x];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

// 8 rows x 16 columns, burst reload: 8 z loads and 16 U loads (4 a row of
// U, one address a quarter-warp) for 512 FFMAs.
__global__ void __launch_bounds__(256, 1) fma16_bench(float* out, int iters) {
  extern __shared__ float4 sm[];
  float* s = reinterpret_cast<float*>(sm);
  for (int i = threadIdx.x; i < 16384; i += blockDim.x)
    s[i] = 1e-3f * (i & 1023);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane & 7, slot = lane >> 3;
  const float* zg = s + 4 * g;
  const float* ug = s + 8192 + 64 * slot * 5;
  float acc[8][16];
  for (int r = 0; r < 8; ++r)
    for (int x = 0; x < 16; ++x) acc[r][x] = 0.f;
  int off = 0;
  for (int it = 0; it < iters; ++it) {
    off = (off + 256) & 4095;
    const float4* zp = reinterpret_cast<const float4*>(zg + off);
    float4 z[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) z[r] = zp[8 * r];
    const float4* up = reinterpret_cast<const float4*>(ug + (off >> 3));
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const float4 a = up[4 * ii], b = up[4 * ii + 1], c = up[4 * ii + 2],
                   d = up[4 * ii + 3];
      const float u[16] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                           c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float zz = ii == 0 ? z[r].x : ii == 1 ? z[r].y
                       : ii == 2 ? z[r].z : z[r].w;
#pragma unroll
        for (int x = 0; x < 16; ++x) acc[r][x] = fmaf(zz, u[x], acc[r][x]);
      }
    }
  }
  float t = 0.f;
  for (int r = 0; r < 8; ++r)
    for (int x = 0; x < 16; ++x) t += acc[r][x];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

static float time_ms(cudaEvent_t a, cudaEvent_t b) {
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "smem_fma_bench: no CUDA device\n");
    return 1;
  }
  const int sms = prop.multiProcessorCount;
  const double hz = 1.98e9;
  printf("device: %s, %d SMs\n", prop.name, sms);
  float* out;
  cudaMalloc(&out, (size_t)sms * 8 * 1024 * sizeof(float));
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);

  const char* names[] = {"one address", "8 a quarter, quarters alike",
                         "32 distinct", "one a quarter", "8 a quarter, 2 sets"};
  const int iters = 4096, blocks = sms * 8;
  for (int W = 1; W <= 4; W *= 2)
    for (int p = 0; p < 5; ++p)
      for (int rep = 0; rep < 2; ++rep) {  // the first is a warm-up
        cudaEventRecord(a);
        if (W == 1) lds_bench<1><<<blocks, 256>>>(out, iters, p);
        if (W == 2) lds_bench<2><<<blocks, 256>>>(out, iters, p);
        if (W == 4) lds_bench<4><<<blocks, 256>>>(out, iters, p);
        cudaEventRecord(b);
        const float ms = time_ms(a, b);
        const double loads = (double)blocks / sms * 8 * iters * 8;  // an SM
        if (rep)
          printf("LDS.%-3d %-28s %.3f ms, %.2f SM-cycles a warp load\n",
                 32 * W, names[p], ms, ms * 1e-3 * hz / loads);
      }

  const int fiters = 20000;
  void (*ks[3])(float*, int) = {fma_bench<0>, fma_bench<1>, fma_bench<2>};
  const char* modes[3] = {"8x8, operands in registers", "8x8, burst reload",
                          "8x8, interleaved, one ahead"};
  for (int m = 0; m < 3; ++m) {
    cudaFuncSetAttribute(ks[m], cudaFuncAttributeMaxDynamicSharedMemorySize,
                         150000);
    for (int warps = 4; warps <= 12; warps += 4)
      for (int rep = 0; rep < 2; ++rep) {
        cudaEventRecord(a);
        ks[m]<<<sms, 32 * warps, 150000>>>(out, fiters);
        cudaEventRecord(b);
        const float ms = time_ms(a, b);
        const double ffma = (double)sms * warps * fiters * 256;
        if (rep)
          printf("%-30s warps/SM %2d: %.3f ms, %.1f%% of the FFMA issue peak "
                 "(%s)\n", modes[m], warps, ms,
                 100.0 * ffma / (sms * 4 * hz * ms * 1e-3),
                 cudaGetErrorString(cudaGetLastError()));
      }
  }
  cudaFuncSetAttribute(fma16_bench,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, 150000);
  for (int warps = 4; warps <= 8; warps += 4)
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(a);
      fma16_bench<<<sms, 32 * warps, 150000>>>(out, fiters / 2);
      cudaEventRecord(b);
      const float ms = time_ms(a, b);
      const double ffma = (double)sms * warps * (fiters / 2) * 512;
      if (rep)
        printf("%-30s warps/SM %2d: %.3f ms, %.1f%% of the FFMA issue peak "
               "(%s)\n", "8x16, burst reload", warps, ms,
               100.0 * ffma / (sms * 4 * hz * ms * 1e-3),
               cudaGetErrorString(cudaGetLastError()));
    }
  cudaFree(out);
  return 0;
}
