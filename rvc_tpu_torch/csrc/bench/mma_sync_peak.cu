// The rate of mma.sync on the card, with no memory traffic: each warp issues
// 16 independent products per step into its own accumulators, for TF32
// m16n8k8 and bf16 m16n8k16 (the instructions of kernels 1 and 3,
// rvc_tpu_torch/csrc/mma.cuh), one block per SM of 4, 8 or 16 warps.
//
// Not part of the library (ops/_cuda.py builds only csrc/*.cu). From the
// root of the repository, into the git-ignored build directory:
//
//   mkdir -p rvc_tpu_torch/_build && nvcc -gencode arch=compute_90a,code=sm_90a \
//       -O3 -std=c++17 -o rvc_tpu_torch/_build/mma_sync_peak \
//       rvc_tpu_torch/csrc/bench/mma_sync_peak.cu && rvc_tpu_torch/_build/mma_sync_peak
//
// Prints TFLOP/s per configuration: the ceiling of a kernel built on
// mma.sync, below the card's dense peaks for wgmma (495 TF32, 989 bf16).
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

#include "../mma.cuh"

template <bool BF16>
__global__ void products(float* out, int iters) {
  float acc[16][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b0 = threadIdx.x * 5u, b1 = 11u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if constexpr (BF16) mma::bf16_16816(acc[i], a, b0, b1);
      else mma::tf32_1688(acc[i], a, b0, b1);
    }
  }
  float s = 0.f;
  for (int i = 0; i < 16; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the products live
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  if (cudaMalloc(&out, sms * 16 * 32 * sizeof(float)) != cudaSuccess) return 1;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 16384;
  for (int bf = 0; bf < 2; ++bf)
    for (int warps : {4, 8, 16}) {
      auto run = [&] {
        if (bf) products<true><<<sms, warps * 32>>>(out, iters);
        else products<false><<<sms, warps * 32>>>(out, iters);
      };
      run();  // warm-up
      cudaEventRecord(e0);
      run();
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      if (cudaGetLastError() != cudaSuccess) return 1;
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      const double flops = (double)sms * warps * iters * 16 * (bf ? 4096.0 : 2048.0);
      printf("%s, %d warps per SM: %.1f TFLOP/s\n", bf ? "bf16 m16n8k16" : "tf32 m16n8k8",
             warps, flops / ms / 1e9);
    }
  return 0;
}
