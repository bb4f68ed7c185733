// wgmma on the card: its rate at the shapes the port uses, and how it adds
// into its sums.
//
// 1. Sums: one warpgroup computes D (64 x 64) = A (64 x K) . B (64 x K)^T
//    in bf16 with float32 sums, K = 4096, A from registers and B through the
//    128-byte-swizzled descriptor of csrc/hopper.cuh (the bf16 unit kernel's
//    operands), in three ways: "wgmma, one running sum" (every k16 step into
//    the same registers), "wgmma, a sum per 64 of K" (each 64 of K from zero,
//    scale-d = 0, added into float32 registers: the unit kernel's way) and
//    "mma.sync, one running sum" (m16n8k16 fragments); and the same three in
//    TF32 (m64n64k8 with A from registers in mma.m16n8k8's TF32 layout, a sum
//    per 32 of K: kernel 4's way; mma.sync m16n8k8). Each D is held against
//    the exact sum (float64 on the host): the largest error and the mean
//    signed error, in units of the float32 spacing at the sum of the
//    products' magnitudes (the exact sum itself for positive data). With all
//    products positive, a sum that truncates as it adds shows a negative mean
//    of many units; one that rounds, a mean near 0. The largest error also
//    checks the operand layouts: a wrong one is off by O(1).
// 2. Rates (TFLOP/s), one block an SM with no memory traffic: bf16
//    m64nNk16 with A from registers for N = 64, 128, 256 (groups of 8
//    products into one sum), with 2 and 3 warpgroups a block; the unit
//    kernel's pattern (2 warpgroups; a group of 4 m64n64k16 products from
//    zero, waited for and added into float32 registers, 4 such a step); and
//    TF32 m64nNk8 with A and B from shared memory for N = 64, 128, and with A
//    from registers for N = 32, 64 (kernel 4's products).
//
// Not part of the library (ops/_cuda.py builds only csrc/*.cu). From the
// root of the repository, into the git-ignored build directory:
//
//   mkdir -p rvc_tpu_torch/_build && nvcc -gencode arch=compute_90a,code=sm_90a \
//       -O3 -std=c++17 -o rvc_tpu_torch/_build/wgmma_peak \
//       rvc_tpu_torch/csrc/bench/wgmma_peak.cu && rvc_tpu_torch/_build/wgmma_peak
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

#include "../hopper.cuh"
#include "../mma.cuh"

template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    hop::Wgmma<64>::mma(d, a, b, scale_d);
  }
};

template <>
struct WgmmaRS<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    hop::Wgmma<128>::mma(d, a, b, scale_d);
  }
};

template <>
struct WgmmaRS<256> {
  __device__ __forceinline__ static void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
        "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127},"
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
          "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
          "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
          "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <int N>
struct WgmmaTF32;

template <>
struct WgmmaTF32<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, "
        "p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaTF32<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, "
        "p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hop::smem_addr(p) & 1023)) & 1023);
}

// ---- 1. sums ----

constexpr int SUM_K = 4096;

// MODE 0: wgmma, one running sum; 1: wgmma, a sum per 64 of K; 2: mma.sync
template <int MODE>
__global__ void sum_test(const __nv_bfloat16* A, const __nv_bfloat16* B, float* D, int K) {
  extern __shared__ __align__(1024) uint8_t sm_sum[];
  uint8_t* bs = align1024(sm_sum);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float acc[32], part[32];
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 64) {
    if (MODE < 2) {
      __syncthreads();
      // B's rows n, K k0 .. k0 + 63, into the swizzled image
      for (int e = tid; e < 64 * 8; e += 128) {
        const int n = e / 8, c = e % 8;
        *reinterpret_cast<uint4*>(bs + (n / 8) * 1024 + (n % 8) * 128 + (c ^ (n % 8)) * 16) =
            *reinterpret_cast<const uint4*>(B + (size_t)n * K + k0 + 8 * c);
      }
      fence_async_smem();
      __syncthreads();
      uint32_t a[4][4];
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* ar = A + (size_t)(16 * warp + g) * K + k0 + 16 * kk + 2 * t;
        a[kk][0] = *reinterpret_cast<const uint32_t*>(ar);              // row g,     k 2t..
        a[kk][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * K);      // row g + 8, k 2t..
        a[kk][2] = *reinterpret_cast<const uint32_t*>(ar + 8);          // row g,     k 2t + 8..
        a[kk][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * K + 8);  // row g + 8, k 2t + 8..
      }
      const uint64_t desc = hop::desc_sw128(bs);
      hop::wgmma_fence();
      for (int kk = 0; kk < 4; ++kk) {
        if (MODE == 0) hop::Wgmma<64>::mma(acc, a[kk], desc + 2 * kk, k0 + kk > 0);
        else hop::Wgmma<64>::mma(part, a[kk], desc + 2 * kk, kk);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(part);
      if (MODE == 1)
        for (int i = 0; i < 32; ++i) acc[i] += part[i];
    } else {
      // warp w: rows 16w.., 8 n8 tiles; acc[4 nt + c] as the wgmma layout
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* ar = A + (size_t)(16 * warp + g) * K + k0 + 16 * kk + 2 * t;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ar),
                               *reinterpret_cast<const uint32_t*>(ar + 8 * K),
                               *reinterpret_cast<const uint32_t*>(ar + 8),
                               *reinterpret_cast<const uint32_t*>(ar + 8 * K + 8)};
        for (int nt = 0; nt < 8; ++nt) {
          const __nv_bfloat16* br = B + (size_t)(8 * nt + g) * K + k0 + 16 * kk + 2 * t;
          float(&d)[4] = *reinterpret_cast<float(*)[4]>(acc + 4 * nt);
          mma::bf16_16816(d, a, *reinterpret_cast<const uint32_t*>(br),
                          *reinterpret_cast<const uint32_t*>(br + 8));
        }
      }
    }
  }
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * warp + g + 8 * ((i % 4) / 2), col = 8 * (i / 4) + 2 * t + i % 2;
    D[row * 64 + col] = acc[i];
  }
}

// The same in TF32: A, B (64 x K) float32 with TF32 values (low 13 bits 0).
// MODE 0: wgmma with A from registers, one running sum; 1: a sum per 32 of K
// (kernel 4's way); 2: mma.sync m16n8k8, one running sum
template <int MODE>
__global__ void sum_test_tf32(const float* A, const float* B, float* D, int K) {
  extern __shared__ __align__(1024) uint8_t sm_sum32[];
  uint8_t* bs = align1024(sm_sum32);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  float acc[32], part[32];
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    if (MODE < 2) {
      __syncthreads();
      // B's rows n, K k0 .. k0 + 31, into the swizzled image (4 floats a chunk)
      for (int e = tid; e < 64 * 8; e += 128) {
        const int n = e / 8, c = e % 8;
        *reinterpret_cast<float4*>(bs + (n / 8) * 1024 + (n % 8) * 128 + (c ^ (n % 8)) * 16) =
            *reinterpret_cast<const float4*>(B + (size_t)n * K + k0 + 4 * c);
      }
      fence_async_smem();
      __syncthreads();
      uint32_t a[4][4];
      for (int kk = 0; kk < 4; ++kk) {
        const float* ar = A + (size_t)(16 * warp + g) * K + k0 + 8 * kk + t;
        a[kk][0] = __float_as_uint(ar[0]);          // row g,     k t
        a[kk][1] = __float_as_uint(ar[8 * K]);      // row g + 8, k t
        a[kk][2] = __float_as_uint(ar[4]);          // row g,     k t + 4
        a[kk][3] = __float_as_uint(ar[8 * K + 4]);  // row g + 8, k t + 4
      }
      const uint64_t desc = hop::desc_sw128(bs);
      hop::wgmma_fence();
      for (int kk = 0; kk < 4; ++kk) {
        if (MODE == 0) hop::WgmmaTf32<64>::mma(acc, a[kk], desc + 2 * kk, k0 + kk > 0);
        else hop::WgmmaTf32<64>::mma(part, a[kk], desc + 2 * kk, kk);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(part);
      if (MODE == 1)
        for (int i = 0; i < 32; ++i) acc[i] += part[i];
    } else {
      for (int kk = 0; kk < 4; ++kk) {
        const float* ar = A + (size_t)(16 * warp + g) * K + k0 + 8 * kk + t;
        const uint32_t a[4] = {__float_as_uint(ar[0]), __float_as_uint(ar[8 * K]),
                               __float_as_uint(ar[4]), __float_as_uint(ar[8 * K + 4])};
        for (int nt = 0; nt < 8; ++nt) {
          const float* br = B + (size_t)(8 * nt + g) * K + k0 + 8 * kk + t;
          float(&d)[4] = *reinterpret_cast<float(*)[4]>(acc + 4 * nt);
          mma::tf32_1688(d, a, __float_as_uint(br[0]), __float_as_uint(br[4]));
        }
      }
    }
  }
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * warp + g + 8 * ((i % 4) / 2), col = 8 * (i / 4) + 2 * t + i % 2;
    D[row * 64 + col] = acc[i];
  }
}

// ---- 2. rates ----

// bf16 B image of N rows, values 0.5 .. 0.875
__device__ void fill_bf16(uint8_t* b, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    reinterpret_cast<__nv_bfloat16*>(b)[i] = __float2bfloat16(0.5f + (i % 7) * 0.0625f);
}

template <int N>
__global__ void __launch_bounds__(384, 1) rate_bf16(float* sink, int iters) {
  extern __shared__ __align__(1024) uint8_t sm_rate[];
  uint8_t* b = align1024(sm_rate);
  fill_bf16(b, N * 64);
  __syncthreads();
  fence_async_smem();
  const uint64_t desc = hop::desc_sw128(b);
  const uint32_t a[4] = {0x3F003F00u, 0x3F003F00u, 0x3F003F00u, 0x3F003F00u};  // bf16 0.5
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    hop::wgmma_fence();
#pragma unroll
    for (int i = 0; i < 8; ++i) WgmmaRS<N>::mma(d, a, desc + 2 * (i % 4), 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
  }
  hop::fence_regs(d);
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += d[i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// the unit kernel's inner pattern at C = 256: per step 4 chunks of 64
// outputs, each 4 products from zero, waited for, added into float32 registers
__global__ void __launch_bounds__(256, 1) rate_unit_pattern(float* sink, int iters) {
  extern __shared__ __align__(1024) uint8_t sm_unit[];
  uint8_t* b = align1024(sm_unit);
  fill_bf16(b, 256 * 64);
  __syncthreads();
  fence_async_smem();
  const uint64_t desc = hop::desc_sw128(b);
  const uint32_t a[4] = {0x3F003F00u, 0x3F003F00u, 0x3F003F00u, 0x3F003F00u};
  float acc[4][32], part[32];
  for (int i = 0; i < 32; ++i) {
    part[i] = 0.f;
    for (int nc = 0; nc < 4; ++nc) acc[nc][i] = 0.f;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int nc = 0; nc < 4; ++nc) {
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::Wgmma<64>::mma(part, a, desc + nc * 512 + 2 * kk, kk);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nc][i] += part[i];
    }
  }
  float s = 0.f;
  for (int nc = 0; nc < 4; ++nc)
    for (int i = 0; i < 32; ++i) s += acc[nc][i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int N>
__global__ void __launch_bounds__(256, 1) rate_tf32(float* sink, int iters) {
  extern __shared__ __align__(1024) uint8_t sm_tf[];
  uint8_t* a = align1024(sm_tf);  // 64 rows x 32 tf32
  uint8_t* b = a + 64 * 128;      // N rows x 32 tf32
  for (int i = threadIdx.x; i < (64 + N) * 32; i += blockDim.x)
    reinterpret_cast<float*>(a)[i] = 0.5f + (i % 7) * 0.0625f;
  __syncthreads();
  fence_async_smem();
  const uint64_t da = hop::desc_sw128(a), db = hop::desc_sw128(b);
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    hop::wgmma_fence();
#pragma unroll
    for (int i = 0; i < 8; ++i) WgmmaTF32<N>::mma(d, da + 2 * (i % 4), db + 2 * (i % 4), 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
  }
  hop::fence_regs(d);
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += d[i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// TF32 m64nNk8 with A from registers (kernel 4's products): groups of 8
// products into one sum
template <int N>
__global__ void __launch_bounds__(256, 1) rate_tf32_rs(float* sink, int iters) {
  extern __shared__ __align__(1024) uint8_t sm_tr[];
  uint8_t* b = align1024(sm_tr);  // N rows x 32 tf32
  for (int i = threadIdx.x; i < N * 32; i += blockDim.x)
    reinterpret_cast<float*>(b)[i] = 0.5f + (i % 7) * 0.0625f;
  __syncthreads();
  fence_async_smem();
  const uint64_t db = hop::desc_sw128(b);
  const uint32_t a[4] = {0x3F000000u, 0x3F000000u, 0x3F000000u, 0x3F000000u};  // 0.5
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    hop::wgmma_fence();
#pragma unroll
    for (int i = 0; i < 8; ++i) hop::WgmmaTf32<N>::mma(d, a, db + 2 * (i % 4), 1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
  }
  hop::fence_regs(d);
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += d[i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

#define CHECK(x)                                                                   \
  do {                                                                             \
    cudaError_t e_ = (x);                                                          \
    if (e_ != cudaSuccess) {                                                       \
      printf("CUDA error %s at %s:%d\n", cudaGetErrorString(e_), __FILE__, __LINE__); \
      return 1;                                                                    \
    }                                                                              \
  } while (0)

template <typename F>
float time_ms(F launch) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  launch();  // warm-up
  cudaEventRecord(e0);
  launch();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}

int sums() {
  const int K = SUM_K;
  std::mt19937 rng(7);
  for (int signed_data = 0; signed_data < 2; ++signed_data) {
    std::uniform_real_distribution<float> u(signed_data ? -1.f : 0.5f, 1.f);
    std::vector<__nv_bfloat16> A(64 * K), B(64 * K);
    std::vector<double> Af(64 * K), Bf(64 * K);
    for (int i = 0; i < 64 * K; ++i) {
      A[i] = __float2bfloat16(u(rng));
      B[i] = __float2bfloat16(u(rng));
      Af[i] = __bfloat162float(A[i]);
      Bf[i] = __bfloat162float(B[i]);
    }
    std::vector<double> exact(64 * 64, 0.0), mag(64 * 64, 0.0);
    for (int r = 0; r < 64; ++r)
      for (int n = 0; n < 64; ++n) {
        double s = 0.0, m = 0.0;
        for (int k = 0; k < K; ++k) {
          const double pr = Af[(size_t)r * K + k] * Bf[(size_t)n * K + k];
          s += pr;
          m += std::fabs(pr);
        }
        exact[r * 64 + n] = s;
        mag[r * 64 + n] = m;
      }
    __nv_bfloat16 *dA, *dB;
    float* dD;
    CHECK(cudaMalloc(&dA, A.size() * 2));
    CHECK(cudaMalloc(&dB, B.size() * 2));
    CHECK(cudaMalloc(&dD, 64 * 64 * 4));
    CHECK(cudaMemcpy(dA, A.data(), A.size() * 2, cudaMemcpyHostToDevice));
    CHECK(cudaMemcpy(dB, B.data(), B.size() * 2, cudaMemcpyHostToDevice));
    const char* names[3] = {"wgmma, one running sum", "wgmma, a sum per 64 of K",
                            "mma.sync, one running sum"};
    for (int mode = 0; mode < 3; ++mode) {
      CHECK(cudaMemset(dD, 0, 64 * 64 * 4));
      const int smem = 64 * 128 + 1024;
      if (mode == 0) sum_test<0><<<1, 128, smem>>>(dA, dB, dD, K);
      if (mode == 1) sum_test<1><<<1, 128, smem>>>(dA, dB, dD, K);
      if (mode == 2) sum_test<2><<<1, 128, smem>>>(dA, dB, dD, K);
      CHECK(cudaGetLastError());
      CHECK(cudaDeviceSynchronize());
      std::vector<float> D(64 * 64);
      CHECK(cudaMemcpy(D.data(), dD, D.size() * 4, cudaMemcpyDeviceToHost));
      double worst = 0.0, mean = 0.0, worst_rel = 0.0;
      for (int i = 0; i < 64 * 64; ++i) {
        const double e = exact[i];
        const double ulp = std::ldexp(1.0, std::ilogb(mag[i]) - 23);
        const double err = ((double)D[i] - e) / ulp * (e < 0 ? -1.0 : 1.0);  // + away from 0
        worst = std::fmax(worst, std::fabs(err));
        worst_rel = std::fmax(worst_rel, std::fabs((double)D[i] - e) / mag[i]);
        mean += err / (64 * 64);
      }
      printf("sum K=%d, %s data, %s: largest error %.1f float32 ulps of the sum of the "
             "products' magnitudes (relative %.3g), mean signed error %+.2f ulps (negative: "
             "toward zero)\n",
             K, signed_data ? "mixed-sign" : "positive", names[mode], worst, worst_rel, mean);
    }
    cudaFree(dA);
    cudaFree(dB);
    cudaFree(dD);
  }
  // TF32: values with 11 significant bits (low 13 bits zero)
  for (int signed_data = 0; signed_data < 2; ++signed_data) {
    std::uniform_real_distribution<float> u(signed_data ? -1.f : 0.5f, 1.f);
    auto tf32 = [](float v) {
      uint32_t b;
      std::memcpy(&b, &v, 4);
      b &= 0xFFFFE000u;
      std::memcpy(&v, &b, 4);
      return v;
    };
    std::vector<float> A(64 * K), B(64 * K);
    for (int i = 0; i < 64 * K; ++i) {
      A[i] = tf32(u(rng));
      B[i] = tf32(u(rng));
    }
    std::vector<double> exact(64 * 64, 0.0), mag(64 * 64, 0.0);
    for (int r = 0; r < 64; ++r)
      for (int n = 0; n < 64; ++n) {
        double sm = 0.0, m = 0.0;
        for (int k = 0; k < K; ++k) {
          const double pr = (double)A[(size_t)r * K + k] * B[(size_t)n * K + k];
          sm += pr;
          m += std::fabs(pr);
        }
        exact[r * 64 + n] = sm;
        mag[r * 64 + n] = m;
      }
    float *dA, *dB, *dD;
    CHECK(cudaMalloc(&dA, A.size() * 4));
    CHECK(cudaMalloc(&dB, B.size() * 4));
    CHECK(cudaMalloc(&dD, 64 * 64 * 4));
    CHECK(cudaMemcpy(dA, A.data(), A.size() * 4, cudaMemcpyHostToDevice));
    CHECK(cudaMemcpy(dB, B.data(), B.size() * 4, cudaMemcpyHostToDevice));
    const char* names[3] = {"tf32 wgmma (A from registers), one running sum",
                            "tf32 wgmma (A from registers), a sum per 32 of K",
                            "tf32 mma.sync, one running sum"};
    for (int mode = 0; mode < 3; ++mode) {
      CHECK(cudaMemset(dD, 0, 64 * 64 * 4));
      const int smem = 64 * 128 + 1024;
      if (mode == 0) sum_test_tf32<0><<<1, 128, smem>>>(dA, dB, dD, K);
      if (mode == 1) sum_test_tf32<1><<<1, 128, smem>>>(dA, dB, dD, K);
      if (mode == 2) sum_test_tf32<2><<<1, 128, smem>>>(dA, dB, dD, K);
      CHECK(cudaGetLastError());
      CHECK(cudaDeviceSynchronize());
      std::vector<float> D(64 * 64);
      CHECK(cudaMemcpy(D.data(), dD, D.size() * 4, cudaMemcpyDeviceToHost));
      double worst = 0.0, mean = 0.0, worst_rel = 0.0;
      for (int i = 0; i < 64 * 64; ++i) {
        const double e = exact[i];
        const double ulp = std::ldexp(1.0, std::ilogb(mag[i]) - 23);
        const double err = ((double)D[i] - e) / ulp * (e < 0 ? -1.0 : 1.0);  // + away from 0
        worst = std::fmax(worst, std::fabs(err));
        worst_rel = std::fmax(worst_rel, std::fabs((double)D[i] - e) / mag[i]);
        mean += err / (64 * 64);
      }
      printf("sum K=%d, %s data, %s: largest error %.1f float32 ulps of the sum of the "
             "products' magnitudes (relative %.3g), mean signed error %+.2f ulps (negative: "
             "toward zero)\n",
             K, signed_data ? "mixed-sign" : "positive", names[mode], worst, worst_rel, mean);
    }
    cudaFree(dA);
    cudaFree(dB);
    cudaFree(dD);
  }
  return 0;
}

int main() {
  int sms = 0;
  CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  if (sums()) return 1;
  float* sink;
  CHECK(cudaMalloc(&sink, sms * 384 * sizeof(float)));
  const int iters = 8192;
  auto report = [&](const char* what, int wgs, float ms, double flops_per_wg_iter) {
    const double flops = (double)sms * wgs * iters * flops_per_wg_iter;
    printf("%s, %d warpgroups a block, one block an SM: %.1f TFLOP/s\n", what, wgs,
           flops / ms / 1e9);
  };
  for (int wgs : {2, 3}) {
    const dim3 grid(sms), block(128 * wgs);
    float ms = time_ms([&] { rate_bf16<64><<<grid, block, 64 * 128 + 1024>>>(sink, iters); });
    CHECK(cudaGetLastError());
    report("bf16 m64n64k16, A from registers", wgs, ms, 8.0 * 64 * 64 * 16 * 2);
    ms = time_ms([&] { rate_bf16<128><<<grid, block, 128 * 128 + 1024>>>(sink, iters); });
    CHECK(cudaGetLastError());
    report("bf16 m64n128k16, A from registers", wgs, ms, 8.0 * 64 * 128 * 16 * 2);
    ms = time_ms([&] { rate_bf16<256><<<grid, block, 256 * 128 + 1024>>>(sink, iters); });
    CHECK(cudaGetLastError());
    report("bf16 m64n256k16, A from registers", wgs, ms, 8.0 * 64 * 256 * 16 * 2);
  }
  {
    const float ms = time_ms(
        [&] { rate_unit_pattern<<<sms, 256, 256 * 128 + 1024>>>(sink, iters / 2); });
    CHECK(cudaGetLastError());
    const double flops = (double)sms * 2 * (iters / 2) * 16.0 * 64 * 64 * 16 * 2;
    printf("the unit kernel's pattern (4 x m64n64k16 from zero, waited, added; C = 256), "
           "2 warpgroups a block: %.1f TFLOP/s\n", flops / ms / 1e9);
  }
  {
    const dim3 grid(sms), block(256);
    float ms = time_ms([&] { rate_tf32<64><<<grid, block, 128 * 128 + 1024>>>(sink, iters); });
    CHECK(cudaGetLastError());
    report("tf32 m64n64k8, A and B from shared memory", 2, ms, 8.0 * 64 * 64 * 8 * 2);
    ms = time_ms([&] { rate_tf32<128><<<grid, block, 192 * 128 + 1024>>>(sink, iters); });
    CHECK(cudaGetLastError());
    report("tf32 m64n128k8, A and B from shared memory", 2, ms, 8.0 * 64 * 128 * 8 * 2);
    ms = time_ms([&] { rate_tf32_rs<32><<<grid, block, 32 * 128 + 1024>>>(sink, iters); });
    CHECK(cudaGetLastError());
    report("tf32 m64n32k8, A from registers", 2, ms, 8.0 * 64 * 32 * 8 * 2);
    ms = time_ms([&] { rate_tf32_rs<64><<<grid, block, 64 * 128 + 1024>>>(sink, iters); });
    CHECK(cudaGetLastError());
    report("tf32 m64n64k8, A from registers", 2, ms, 8.0 * 64 * 64 * 8 * 2);
  }
  CHECK(cudaDeviceSynchronize());
  return 0;
}
