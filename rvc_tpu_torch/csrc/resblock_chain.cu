// Kernel 4: one ResBlock1 chain forward in float32 (the forward of
// fused_resblock1_train), for sm_90a, on wgmma in 3xTF32.
//
// Replaces rvc_tpu/ops/pallas_resblock.py::_fused_call (its pallas_call at
// :171), the primal of fused_resblock1_train: for each of the chain's n units
//     h' = h + conv_b(lrelu(conv_a(lrelu(h)))),
// conv_a of kernel k and dilation d, conv_b of kernel k and dilation 1, rows
// outside [0, T) zero at every conv (torch's same padding), each unit's output
// kept for the backward (kernel 5, resblock_bwd.cu).
//
// What bounds it: operations. A conv does k C^2 multiply-adds a row, three
// TF32 passes of them on the tensor cores (a . w ~ a_big.w_big + a_big.w_small
// + a_small.w_big, float32-level error: mma.cuh); at the training run's shapes
// (batch 4, (T, C) from (432, 256) to (17280, 32)) that is 0.93 ms a step at
// the card's TF32 rate. The SIMT unit kernel that ran it before
// (resblock_group.cu, rvc_resblock1_fwd_simt, chip_smoke.py's yardstick) ran
// them on the float32 pipes at 11.7 times the bound. The design:
// - one launch per conv, not per unit: a block owns M = 128 rows and NB of the
//   C output channels, so a stage's grid has (T / 128) x (C / NB) x batch
//   blocks. At the first stage (T = 432, C = 256) a unit a launch gave 16
//   blocks for 132 SMs; with NB = 32 it is 128. conv_a writes t = conv_a +
//   bias (rows in [0, T)) to a scratch buffer, conv_b reads it back with its
//   halo (zero outside [0, T)) and adds the unit's input: one extra write and
//   read of the activations a unit, from L2;
// - the products on wgmma m64nNBk8 (TF32, float32 sums), two consumer
//   warpgroups of 64 rows each sharing every weight slice: the weight stream
//   a block needs is independent of NB and halves with each doubling of the
//   rows that share it (at 128 rows, 5 GB/s a TFLOP/s, within L2's rate);
// - A, the activations, from registers: the block's input rows with their
//   halo come into shared memory by cp.async (zero-filled outside [0, T));
//   each k8 step a thread loads two float2 (mma.cuh's relabelling of k:
//   k t <-> input 2t, k t + 4 <-> input 2t + 1), applies the leaky ReLU and
//   splits them into TF32 big and small pieces in registers, the next slice's
//   while this slice's products run;
// - B, the weights, from shared memory: ops/resblock.py::
//   pack_tf32_wgmma_weights splits each conv's weights once per set of
//   weights (a chain in one batch) into w_big = tf32(w) and w_small =
//   tf32(w - w_big), in K = (tap, input) order with k relabelled alike, cut
//   into slices of 32 of K (128 bytes a row) with the 128-byte swizzle
//   (hopper.cuh). A producer warp streams each slice's NB rows of both images
//   with cp.async.bulk into a ring of up to 8 slots (as many as the shared
//   memory beside the tile holds) that complete on mbarriers; the consumers
//   free a slot once their products on it are done;
// - float32 sums: each slice's 12 products (4 k8 steps, 3 pieces) start from
//   zero in the wgmma registers and are added into float32 registers, since
//   wgmma adds into its sum with truncation (bench/wgmma_peak.cu: over K =
//   4096 one TF32 sum is off by up to 294 float32 ulps, a sum per 32 of K by
//   7). One set of sum registers: two sets, alternating, made ptxas serialize
//   the products (C7515) and ran slower, as did a sum per 64 of K;
// - at C <= 64 with NB <= 32 two blocks an SM, so that one block's tile load
//   and epilogue run under the other's products (in half the registers, so
//   without the A prefetch);
// - bias and the residual in the epilogue, float2 stores straight from the
//   wgmma registers.
// What holds it back now (chip_smoke, H100 SXM): 4.6 times its bound over a
// step. The first stage's 128 blocks load a 180 KB tile each for 32 outputs
// and keep only 5 ring slots beside it; the second stage's 272 blocks are
// 2.06 waves at one block an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int CONSUMERS = 2;              // consumer warpgroups, 64 rows each
constexpr int M = 64 * CONSUMERS;         // conv rows a block
constexpr int CTHREADS = 128 * CONSUMERS; // consumer threads
constexpr int THREADS = CTHREADS + 32;    // and one producer warp
constexpr int KSTEPS = 4;                 // k8 steps of a weight slice: 32 of K
constexpr int ROW_BYTES = 128;            // one output's 32 TF32 values of a slice
constexpr int MAX_STAGES = 8;             // ring slots, where shared memory allows
constexpr int SMEM_SM = 233472;           // shared memory of an SM
constexpr int SMEM_MAX = 232448;          // of it, what one block may use

__device__ __forceinline__ float lrelu(float v) { return fmaxf(v, v * 0.1f); }

// out[b, r, n0 + c] = bias + (res) + sum_{j, i} lrelu(in[b, r + j d - p, i]) w[n0 + c, i, j]
// for the block's M rows and NB outputs; in zero outside [0, T). w: the packed
// images (2, n_slices, C, 32) float32, big then small; `stages` ring slots.
// MINB: blocks an SM.
template <int NB, int MINB>
__global__ void __launch_bounds__(THREADS, MINB) chain_conv_kernel(
    const float* __restrict__ in, const float* __restrict__ res, float* __restrict__ out,
    const uint8_t* __restrict__ w, const float* __restrict__ bias, int T, int C, int k, int d,
    int stages) {
  constexpr int SLOT = 2 * NB * ROW_BYTES;  // a slice's NB rows of both images
  extern __shared__ __align__(1024) uint8_t smem_cw[];
  // the ring's slots on 1024-byte boundaries (the swizzle's atoms), then the
  // barriers, then the input tile
  uint8_t* ring = smem_cw + ((1024 - (hop::smem_addr(smem_cw) & 1023)) & 1023);
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

  if (warp == CTHREADS / 32) {  // the producer warp: one lane starts every copy
    if (lane == 0) {
      const size_t image = (size_t)n_slices * C * ROW_BYTES;  // bytes of one image
      for (int q = 0; q < n_slices; ++q) {
        const int slot = q % stages;
        if (q >= stages) hop::mbar_wait(&empty[slot], (q / stages - 1) & 1);
        hop::mbar_arrive_expect_tx(&full[slot], SLOT);
        const uint8_t* src = w + ((size_t)q * C + n0) * ROW_BYTES;
        uint8_t* dst = ring + (size_t)slot * SLOT;
        hop::bulk_copy(dst, src, NB * ROW_BYTES, &full[slot]);
        hop::bulk_copy(dst + NB * ROW_BYTES, src + image, NB * ROW_BYTES, &full[slot]);
      }
    }
    return;
  }

  const int S = C + 8;  // tile row pitch in floats: a half warp's float2 loads on distinct banks
  const int b = blockIdx.z, t0 = blockIdx.x * M;
  const int rows = M + (k - 1) * d, p = (k - 1) * d / 2;
  const float* ib = in + (size_t)b * T * C;
  // input rows t0 - p .. t0 - p + rows - 1, zero outside [0, T), all in flight
  for (int e = tid; e < rows * (C / 4); e += CTHREADS) {
    const int r = e / (C / 4), c4 = e % (C / 4), gr = t0 - p + r;
    const bool inside = gr >= 0 && gr < T;
    mma::cp_async16(tile + (size_t)r * S + 4 * c4, ib + (size_t)(inside ? gr : 0) * C + 4 * c4,
                    inside ? 16 : 0);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  hop::bar_sync(1, CTHREADS);

  const int wq = warp % 4, g = lane / 4, t = lane % 4;
  const int r0 = (warp / 4) * 64 + wq * 16 + g;  // this thread's first row in the block
  using Frag = uint32_t[KSTEPS][4];
  // A of slice s's k8 steps, split: step u is tap u / (C / 8), inputs 8 (u % (C / 8)) ..
  auto load_a = [&](int s, Frag& ab, Frag& as) {
    const int nk = min(KSTEPS, steps - s * KSTEPS);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if (kk >= nk) break;
      const int u = s * KSTEPS + kk, tap = u / (C / 8), c8 = u % (C / 8);
      const float* a = tile + (size_t)(r0 + tap * d) * S + 8 * c8 + 2 * t;
      const float2 lo = *reinterpret_cast<const float2*>(a);
      const float2 hi = *reinterpret_cast<const float2*>(a + 8 * S);
      mma::split_tf32(lrelu(lo.x), ab[kk][0], as[kk][0]);  // (row g,     k t)
      mma::split_tf32(lrelu(hi.x), ab[kk][1], as[kk][1]);  // (row g + 8, k t)
      mma::split_tf32(lrelu(lo.y), ab[kk][2], as[kk][2]);  // (row g,     k t + 4)
      mma::split_tf32(lrelu(hi.y), ab[kk][3], as[kk][3]);  // (row g + 8, k t + 4)
    }
  };
  float acc[NB / 2], part[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  // slice s's 12 products into part from zero, small ones first
  auto issue = [&](int s, const Frag& ab, const Frag& as) {
    const int slot = s % stages, nk = min(KSTEPS, steps - s * KSTEPS);
    hop::mbar_wait(&full[slot], (s / stages) & 1);
    const uint64_t big = hop::desc_sw128(ring + (size_t)slot * SLOT);
    const uint64_t small = hop::desc_sw128(ring + (size_t)slot * SLOT + NB * ROW_BYTES);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if (kk >= nk) break;
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

  // acc[4 j + c] is row r0 + 8 (c / 2), output n0 + 8 j + 2 t + (c % 2)
  float* ob = out + (size_t)b * T * C;
  const float* rb = res ? res + (size_t)b * T * C : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = t0 + r0 + 8 * h;
    if (r >= T) continue;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + c));
      float2 v = make_float2(acc[4 * j + 2 * h] + bv.x, acc[4 * j + 2 * h + 1] + bv.y);
      if (rb) {
        const float2 hv = __ldg(reinterpret_cast<const float2*>(rb + (size_t)r * C + c));
        v = make_float2(hv.x + v.x, hv.y + v.y);
      }
      *reinterpret_cast<float2*>(ob + (size_t)r * C + c) = v;
    }
  }
}

// One conv's launch: as many ring slots (up to MAX_STAGES) as the shared
// memory that MINB blocks an SM leave beside the input tile.
template <int NB, int MINB>
int launch_conv(const float* in, const float* res, float* out, const void* w, const float* bias,
                int B, int T, int C, int k, int d, cudaStream_t stream) {
  constexpr int SLOT = 2 * NB * ROW_BYTES + 16;  // and its two barriers
  const int budget = MINB == 1 ? SMEM_MAX : SMEM_SM / MINB - 1024;
  const int fixed = 1024 + (M + (k - 1) * d) * (C + 8) * 4;
  const int stages = min(MAX_STAGES, (budget - fixed) / SLOT);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = fixed + stages * SLOT;
  cudaError_t err = cudaFuncSetAttribute(chain_conv_kernel<NB, MINB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + M - 1) / M, C / NB, B);
  chain_conv_kernel<NB, MINB><<<grid, THREADS, smem, stream>>>(
      in, res, out, (const uint8_t*)w, bias, T, C, k, d, stages);
  return (int)cudaGetLastError();
}

// The block's outputs: 32 at C = 256, so that the first stage's grid fills
// the card and its tile and ring fit; else the widest of 64, 32, 16 that
// divides C. Two blocks an SM at C <= 64 (with 32 or 16 outputs: their sums
// fit in half the registers), so that one block's tile load and epilogue run
// under the other's products; one where the tile is wider.
int conv(const float* in, const float* res, float* out, const void* w, const float* bias, int B,
         int T, int C, int k, int d, cudaStream_t stream) {
  if (C % 64 == 0 && C != 256)
    return launch_conv<64, 1>(in, res, out, w, bias, B, T, C, k, d, stream);
  if (C % 32 == 0)
    return C <= 64 ? launch_conv<32, 2>(in, res, out, w, bias, B, T, C, k, d, stream)
                   : launch_conv<32, 1>(in, res, out, w, bias, B, T, C, k, d, stream);
  return C <= 64 ? launch_conv<16, 2>(in, res, out, w, bias, B, T, C, k, d, stream)
                 : launch_conv<16, 1>(in, res, out, w, bias, B, T, C, k, d, stream);
}

}  // namespace

// Kernel 4. x, out: (B, T, C) float32; hs: (n_units - 1, B, T, C), unit u's
// output for u < n_units - 1 (the input of unit u + 1, kept for kernel 5);
// t: (B, T, C) scratch; w[c]: conv c's weights as pack_tf32_wgmma_weights lays
// them out (2n convs in chain order); bias: (2n, C); dil[u]: the dilation of
// unit u's first conv (the second has dilation 1). C a multiple of 16 up to
// 256 (the wrapper checks). Two launches a unit on `stream`.
extern "C" int rvc_resblock1_fwd(const void* x, void* hs, void* out, void* t,
                                 const void* const* w, const void* bias, int B, int T, int C,
                                 int k, int n_units, const int* dil, void* stream) {
  const size_t btc = (size_t)B * T * C;
  const float* bf = (const float*)bias;
  const float* h = (const float*)x;
  float* tf = (float*)t;
  cudaStream_t s = (cudaStream_t)stream;
  for (int u = 0; u < n_units; ++u) {
    float* dst = u == n_units - 1 ? (float*)out : (float*)hs + (size_t)u * btc;
    int err = conv(h, nullptr, tf, w[2 * u], bf + 2 * u * C, B, T, C, k, dil[u], s);
    if (!err)
      err = conv(tf, h, dst, w[2 * u + 1], bf + (2 * u + 1) * C, B, T, C, k, 1, s);
    if (err) return err;
    h = dst;
  }
  return 0;
}
