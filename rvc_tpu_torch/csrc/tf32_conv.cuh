// The float32 conv core on wgmma in 3xTF32, shared by kernel 4 (the
// ResBlock1 chain forward, resblock_chain.cu) and kernel 6 (the WaveNet
// stack forward, wavenet.cu), for sm_90a.
//
// One launch computes out[r, n] = epi(sum_{j, i} xf(in[r + j d - p, i]) w[n, i, j])
// for rows r of a (rows, C) float32 input and outputs n of a conv packed by
// ops/resblock.py::pack_tf32_wgmma_weights ((O, I, k) weights as two
// 128-byte-swizzled images, w_big = tf32(w) and w_small = tf32(w - w_big),
// in slices of 32 of K = (tap, input)). The caller gives, as template
// arguments, the transform xf applied to the input as it is loaded (the
// leaky ReLU of kernel 4, none for kernel 6) and the epilogue, which gets
// each thread's float32 sums of a row (wgmma's layout: output pairs n, n + 1
// of each n8 tile).
//
// A block owns M = 128 rows and NB of the outputs:
// - a producer warp streams each slice's NB rows of both images with
//   cp.async.bulk into a ring of up to 8 slots (as many as the shared memory
//   beside the input tile holds) that complete on mbarriers; the consumers
//   free a slot once their products on it are done;
// - two consumer warpgroups of 64 rows each share every weight slice (the
//   weight stream halves with each doubling of the rows that share it);
// - A, the activations, from registers: the block's input rows with their
//   halo come into shared memory by cp.async; each k8 step a thread loads
//   two float2 (mma.cuh's relabelling of k: k t <-> input 2t, k t + 4 <->
//   input 2t + 1), applies xf and splits them into TF32 big and small
//   pieces, the next slice's while this slice's products run (at one block
//   an SM);
// - the products on wgmma m64nNBk8, three a k8 step (a_big.w_small,
//   a_small.w_big, a_big.w_big, mma.cuh): each slice's 12 start from zero
//   in the wgmma registers and are added into float32 registers, since
//   wgmma adds into its sum with truncation (bench/wgmma_peak.cu: over K =
//   4096 one TF32 sum is off by up to 294 float32 ulps, a sum per 32 of K
//   by 7). One set of sum registers: two sets, alternating, made ptxas
//   serialize the products (C7515) and ran slower.
//
// Rows. The input is `span`-row slabs (gridDim.z of them, blockIdx.z the
// slab), each tiled by M-row blocks from its first row; the tile is zero
// outside its slab, so no tap reaches into another slab. Kernel 4 takes a
// sample a slab. Kernel 6 flattens its samples into one slab of B T rows,
// so that the blocks' rows are not padded up to 128 per sample; there a
// tap must not reach across a sample's edge either (SEG): a thread zeroes
// the A values of a tap whose row lies outside its own row's `seg`-row
// sample.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace tfc {

constexpr int CONSUMERS = 2;              // consumer warpgroups, 64 rows each
constexpr int M = 64 * CONSUMERS;         // conv rows a block
constexpr int CTHREADS = 128 * CONSUMERS; // consumer threads
constexpr int THREADS = CTHREADS + 32;    // and one producer warp
constexpr int KSTEPS = 4;                 // k8 steps of a weight slice: 32 of K
constexpr int ROW_BYTES = 128;            // one output's 32 TF32 values of a slice
constexpr int MAX_STAGES = 8;             // ring slots, where shared memory allows
constexpr int SMEM_SM = 233472;           // shared memory of an SM
constexpr int SMEM_MAX = 232448;          // of it, what one block may use

struct Identity {
  __device__ __forceinline__ static float apply(float v) { return v; }
};
struct LeakyRelu {
  __device__ __forceinline__ static float apply(float v) { return fmaxf(v, v * 0.1f); }
};

// One conv launch. in: rows of C floats; w: the packed images (2, n_slices,
// O, 32) float32, big then small, O the conv's outputs; rows r + j d - p for
// p = (k - 1) d / 2; blockIdx.z * span + blockIdx.x * M is a block's first
// row; stages: ring slots, div_c8: ceil(2^32 / (C / 8)), u / (C / 8) as
// __umulhi(u, div_c8) for the k8 steps u < 2^21 (both set by launch).
struct Conv {
  const float* in;
  const uint8_t* w;
  int O, C, k, d, span, seg, stages;
  unsigned div_c8;
};

// The body of a conv kernel (the __global__ wrappers carry the launch
// bounds and the names). MINB: blocks an SM.
template <int NB, int MINB, bool SEG, class Xf, class Epi>
__device__ __forceinline__ void conv_core(const Conv& cv, const Epi& epi) {
  constexpr int SLOT = 2 * NB * ROW_BYTES;  // a slice's NB rows of both images
  extern __shared__ __align__(1024) uint8_t smem_tc[];
  const int stages = cv.stages, C = cv.C, k = cv.k, d = cv.d;
  // the ring's slots on 1024-byte boundaries (the swizzle's atoms), then the
  // barriers, then the input tile
  uint8_t* ring = smem_tc + ((1024 - (hop::smem_addr(smem_tc) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * SLOT);
  uint64_t* empty = full + stages;
  float* tile = reinterpret_cast<float*>(empty + stages);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int steps = k * (C / 8), n_slices = (steps + KSTEPS - 1) / KSTEPS;
  const int n0 = blockIdx.y * NB;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], CTHREADS / 32);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  // launched as a programmatic dependent of the previous kernel on the stream
  // (launch): this block's set-up ran beside that kernel's last blocks; its
  // input and weights are read only once that kernel has completed. The next
  // kernel may be scheduled onto SMs that free up from now on.
  hop::grid_dependency_wait();
  hop::launch_dependents();

  if (warp == CTHREADS / 32) {  // the producer warp: one lane starts every copy
    if (lane == 0) {
      const size_t image = (size_t)n_slices * cv.O * ROW_BYTES;  // bytes of one image
      for (int q = 0; q < n_slices; ++q) {
        const int slot = q % stages;
        if (q >= stages) hop::mbar_wait(&empty[slot], (q / stages - 1) & 1);
        hop::mbar_arrive_expect_tx(&full[slot], SLOT);
        const uint8_t* src = cv.w + ((size_t)q * cv.O + n0) * ROW_BYTES;
        uint8_t* dst = ring + (size_t)slot * SLOT;
        hop::bulk_copy(dst, src, NB * ROW_BYTES, &full[slot]);
        hop::bulk_copy(dst + NB * ROW_BYTES, src + image, NB * ROW_BYTES, &full[slot]);
      }
    }
    return;
  }

  const int S = C + 8;  // tile row pitch in floats: a half warp's float2 loads on distinct banks
  const int slab = blockIdx.z * cv.span, end = slab + cv.span, g0 = slab + blockIdx.x * M;
  const int rows = M + (k - 1) * d, p = (k - 1) * d / 2;
  // input rows g0 - p .. g0 - p + rows - 1, zero outside the slab, all in flight
  for (int e = tid; e < rows * (C / 4); e += CTHREADS) {
    const int r = e / (C / 4), c4 = e % (C / 4), gr = g0 - p + r;
    const bool inside = gr >= slab && gr < end;
    mma::cp_async16(tile + (size_t)r * S + 4 * c4,
                    cv.in + (size_t)(inside ? gr : slab) * C + 4 * c4, inside ? 16 : 0);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  hop::bar_sync(1, CTHREADS);

  const int wq = warp % 4, g = lane / 4, t = lane % 4;
  const int r0 = (warp / 4) * 64 + wq * 16 + g;  // this thread's first row in the block
  // with SEG, the positions of this thread's two rows in their samples
  const int s_lo = SEG ? (g0 + r0) % cv.seg : 0, s_hi = SEG ? (g0 + r0 + 8) % cv.seg : 0;
  using Frag = uint32_t[KSTEPS][4];
  const float* a_thread = tile + r0 * S + 2 * t;
  // A of slice s's k8 steps, split: step u is tap u / (C / 8), inputs 8 (u % (C / 8)) ..;
  // no branches, so that the steps' loads issue together: a step past the last
  // (the weights' zero padding of K) reloads the last, which adds 0
  auto load_a = [&](int s, Frag& ab, Frag& as) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int u = min(s * KSTEPS + kk, steps - 1), tap = __umulhi(u, cv.div_c8);
      const float* a = a_thread + (tap * d) * S + 8 * (u - tap * (C / 8));
      float2 lo = *reinterpret_cast<const float2*>(a);
      float2 hi = *reinterpret_cast<const float2*>(a + 8 * S);
      if constexpr (SEG) {  // a tap past either edge of the row's own sample reads zero
        const int o = tap * d - p;
        if ((unsigned)(s_lo + o) >= (unsigned)cv.seg) lo = make_float2(0.f, 0.f);
        if ((unsigned)(s_hi + o) >= (unsigned)cv.seg) hi = make_float2(0.f, 0.f);
      }
      mma::split_tf32(Xf::apply(lo.x), ab[kk][0], as[kk][0]);  // (row g,     k t)
      mma::split_tf32(Xf::apply(hi.x), ab[kk][1], as[kk][1]);  // (row g + 8, k t)
      mma::split_tf32(Xf::apply(lo.y), ab[kk][2], as[kk][2]);  // (row g,     k t + 4)
      mma::split_tf32(Xf::apply(hi.y), ab[kk][3], as[kk][3]);  // (row g + 8, k t + 4)
    }
  };
  float acc[NB / 2], part[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  // slice s's 12 products into part from zero, small ones first
  auto issue = [&](int s, const Frag& ab, const Frag& as) {
    const int slot = s % stages;
    hop::mbar_wait(&full[slot], (s / stages) & 1);
    const uint64_t big = hop::desc_sw128(ring + (size_t)slot * SLOT);
    const uint64_t small = hop::desc_sw128(ring + (size_t)slot * SLOT + NB * ROW_BYTES);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      hop::WgmmaTf32<NB>::mma(part, ab[kk], small + 2 * kk, kk);
      hop::WgmmaTf32<NB>::mma(part, as[kk], big + 2 * kk, 1);
      hop::WgmmaTf32<NB>::mma(part, ab[kk], big + 2 * kk, 1);
    }
    hop::wgmma_commit();
  };
  // once slice s's products are done: free its slot, add its sum into float32
  auto retire = [&](int s) {
    hop::wgmma_wait<0>();
    hop::fence_regs(part);
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[s % stages]);
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[i] += part[i];
  };
  Frag ab0, as0;
  if constexpr (MINB == 1) {
    // while slice s's products run, the next slice's A is loaded and split
    // into the other set of registers
    Frag ab1, as1;
    load_a(0, ab0, as0);
    for (int s = 0; s < n_slices; s += 2) {
      issue(s, ab0, as0);
      if (s + 1 < n_slices) load_a(s + 1, ab1, as1);
      retire(s);
      if (s + 1 == n_slices) break;
      issue(s + 1, ab1, as1);
      if (s + 2 < n_slices) load_a(s + 2, ab0, as0);
      retire(s + 1);
    }
  } else {
    // two blocks an SM hide each other's loads, in half the registers
    for (int s = 0; s < n_slices; ++s) {
      load_a(s, ab0, as0);
      issue(s, ab0, as0);
      retire(s);
    }
  }

  // acc[4 j + 2 h + e] is row r0 + 8 h, output n0 + 8 j + 2 t + e: the
  // epilogue gets each of the thread's rows in [slab, end) with its h
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g0 + r0 + 8 * h;
    if (r < end) epi(r, h, n0, t, acc);
  }
}

// One conv's launch of `kernel` (a __global__ wrapper of conv_core<NB, MINB,
// ...>) over `slabs` slabs and N outputs: as many ring slots (up to
// MAX_STAGES) as the shared memory that MINB blocks an SM leave beside the
// input tile. A programmatic dependent launch: its blocks may start before
// the previous kernel on the stream has ended, and wait for it before
// reading anything (conv_core).
template <int NB, int MINB, class Epi>
int launch(void (*kernel)(Conv, Epi), Conv cv, const Epi& epi, int slabs, int N,
           cudaStream_t stream) {
  constexpr int SLOT = 2 * NB * ROW_BYTES + 16;  // and its two barriers
  const int budget = MINB == 1 ? SMEM_MAX : SMEM_SM / MINB - 1024;
  const int fixed = 1024 + (M + (cv.k - 1) * cv.d) * (cv.C + 8) * 4;
  cv.stages = min(MAX_STAGES, (budget - fixed) / SLOT);
  cv.div_c8 = (unsigned)((0x100000000ull + cv.C / 8 - 1) / (cv.C / 8));
  if (cv.stages < 2 || N % NB) return (int)cudaErrorInvalidValue;
  const int smem = fixed + cv.stages * SLOT;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((cv.span + M - 1) / M, N / NB, slabs);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = pdl;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, kernel, cv, epi);
}

}  // namespace tfc
