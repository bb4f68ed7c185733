// One residual unit of a HiFiGAN ResBlock1 chain, for sm_90a: in float32 a
// tensor-core kernel (kernel 1, rvc_resblock_unit) and the SIMT kernel it
// replaced (rvc_resblock_unit_simt), which kernel 4's yardstick
// (rvc_resblock1_fwd_simt) still runs; in bfloat16 the wgmma kernel of
// kernels 1 and 8 (rvc_resblock_unit_bf16, at the end of the file) and the
// mma.sync kernel it replaced (rvc_resblock_unit_bf16_sync). Kernel 4 itself,
// on wgmma in 3xTF32, is in resblock_chain.cu.
//
// Kernel 1 replaces rvc_tpu/ops/pallas_resblock.py::_fused_group_call
// (reached from fused_resblock_group), which runs a whole decoder stage - the
// mean of its ResBlock1 chains - in one TPU launch. Here one launch computes
// one unit
//     h' = h + conv_b(lrelu(conv_a(lrelu(h))))
// with conv_a of kernel k and dilation d and conv_b of kernel k, dilation 1.
// Rows outside [0, T) read as zero for both convs (the unit's input is
// zero-padded on load, and conv_a's output is zeroed outside [0, T) before
// conv_b reads it), which is torch's same-padding semantics at every conv.
// The last unit of chain c adds its result into the stage output; the last
// chain divides by the number of chains, so the sum runs in the
// reference's order: ((r0 + r1) + r2) / 3.
//
// What bounds it: operations. A stage does 2*k*C*C multiply-adds per row per
// conv; at C = 256 that is ~100 flops per byte moved even before any reuse.
//
// Kernel 1's design: each conv is an implicit GEMM on the tensor cores, M =
// the block's rows, N = C_out, K = (tap, C_in), in 3xTF32 (mma.cuh):
// a.w ~ a_big.w_big + a_big.w_small + a_small.w_big, three m16n8k8 TF32
// products accumulated in float32. This is not TF32 arithmetic: the dropped
// a_small.w_small and the splits' residuals are each about 2^-22 of the
// product, so the sums keep float32-level error (cuDNN and cuBLAS stay in
// full float32, device.py). Hopper's mma.sync truncates as it accumulates,
// so each weight slice's sum starts from zero in its fragments and is added
// into float32 registers. The weights are split once per set of weights by
// the wrapper (ops/resblock.py::pack_tf32_weights) into w_big and the exact
// residual w - w_big, laid out in the order the B fragments read them: for
// each k8 step (tap, 8 inputs) and each n8 tile of outputs, one float4 per
// lane (big pair, residual pair), so a warp reads 512 contiguous bytes. The
// activations are split in registers after they are read (splitting the
// weights there instead halved their bytes but measured slower). A block
// owns M rows (64 at C = 256 up to 512 at C <= 32) and all C channels: its
// input tile with the halo,
// lrelu'd, sits in shared memory; conv_a's output, zeroed outside [0, T) and
// lrelu'd, overwrites it once every warp has read it (so C = 256 with
// k = 11, d = 5 fits one launch: 114 rows x 1 KB plus the weight ring);
// at C <= 64 weight slices of 32 KB stream through a cp.async ring of 4
// slices, at C >= 128 the warps read them through L1 (Tile::RING). Each of
// 16 warps owns 2 m16 x (4 or 2) n8 tiles of sums. What holds it back is
// feeding the fragments (loads and splits), not the tensor cores: mma.sync
// alone runs several times faster (csrc/bench/mma_sync_peak.cu).
//
// The SIMT kernel (kernel 1's first version): the same unit in float32 FMAs, each
// thread keeping a 16-row x 4-channel block of sums and reading the weights,
// laid out [tap][in][out], from a 16-channel slice in shared memory. Kernel
// 4's first version ran it a launch per unit (rvc_resblock1_fwd_simt below):
// only chip_smoke.py launches that now, as the yardstick (previous_ms) of
// kernel 4's wgmma chain (resblock_chain.cu), which it ran at 11.7 times its
// bound. Kernel 5 (resblock_bwd.cu) recomputes each unit's pre-activations in
// 3xTF32 in another order than kernel 4's sums; its gradient check
// (ops/resblock.py::check_chain_grads) allows for the leaky-ReLU slopes that
// this may flip.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RM = 16;        // rows per thread
constexpr int KC = 16;        // input channels per staged weight slice
constexpr int PF_MAX = 4;     // float4 per thread per slice (KC*C/4/THREADS)

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * 0.1f; }

__device__ __forceinline__ float4 lrelu4(float4 v) {
  return make_float4(lrelu(v.x), lrelu(v.y), lrelu(v.z), lrelu(v.w));
}

// acc[m][:] += sum_j sum_i in_s[(row_m + j*d) * S + i] * w[j][i][4*tx .. 4*tx+3]
// w is (k, C, C) laid out [tap][in][out]. All threads of the block call it.
__device__ __forceinline__ void conv_tile(
    const float* in_s, int S, const float* __restrict__ w, int k, int d,
    int C, float* ws, float (&acc)[RM][4], int tx, int ty, int NR,
    int tid) {
  const int per_tap = C / KC;
  const int nq = k * per_tap;
  const int n4 = KC * C / 4;  // float4 in one slice
  float4 pf[PF_MAX];
  auto fetch = [&](int q) {
    const float4* src = reinterpret_cast<const float4*>(w + (size_t)q * KC * C);
#pragma unroll
    for (int p = 0; p < PF_MAX; ++p) {
      int e = tid + p * THREADS;
      if (e < n4) pf[p] = __ldg(src + e);
    }
  };
  fetch(0);
  for (int q = 0; q < nq; ++q) {
    __syncthreads();  // the previous slice is no longer read
#pragma unroll
    for (int p = 0; p < PF_MAX; ++p) {
      int e = tid + p * THREADS;
      if (e < n4) reinterpret_cast<float4*>(ws)[e] = pf[p];
    }
    __syncthreads();
    if (q + 1 < nq) fetch(q + 1);
    const int j = q / per_tap;
    const int i0 = (q % per_tap) * KC;
    const float* a_base = in_s + (size_t)(ty + j * d) * S + i0;
#pragma unroll
    for (int ii = 0; ii < KC; ii += 4) {
      const float4 w0 = reinterpret_cast<const float4*>(ws + (ii + 0) * C)[tx];
      const float4 w1 = reinterpret_cast<const float4*>(ws + (ii + 1) * C)[tx];
      const float4 w2 = reinterpret_cast<const float4*>(ws + (ii + 2) * C)[tx];
      const float4 w3 = reinterpret_cast<const float4*>(ws + (ii + 3) * C)[tx];
#pragma unroll
      for (int m = 0; m < RM; ++m) {
        const float4 a = *reinterpret_cast<const float4*>(
            a_base + (size_t)m * NR * S + ii);
        acc[m][0] = fmaf(a.x, w0.x, acc[m][0]);
        acc[m][1] = fmaf(a.x, w0.y, acc[m][1]);
        acc[m][2] = fmaf(a.x, w0.z, acc[m][2]);
        acc[m][3] = fmaf(a.x, w0.w, acc[m][3]);
        acc[m][0] = fmaf(a.y, w1.x, acc[m][0]);
        acc[m][1] = fmaf(a.y, w1.y, acc[m][1]);
        acc[m][2] = fmaf(a.y, w1.z, acc[m][2]);
        acc[m][3] = fmaf(a.y, w1.w, acc[m][3]);
        acc[m][0] = fmaf(a.z, w2.x, acc[m][0]);
        acc[m][1] = fmaf(a.z, w2.y, acc[m][1]);
        acc[m][2] = fmaf(a.z, w2.z, acc[m][2]);
        acc[m][3] = fmaf(a.z, w2.w, acc[m][3]);
        acc[m][0] = fmaf(a.w, w3.x, acc[m][0]);
        acc[m][1] = fmaf(a.w, w3.y, acc[m][1]);
        acc[m][2] = fmaf(a.w, w3.z, acc[m][2]);
        acc[m][3] = fmaf(a.w, w3.w, acc[m][3]);
      }
    }
  }
}

// x, out: (B, T, C); wa, wb: (k, C, C) [tap][in][out]; ba, bb: (C,).
// mode 0: out = h'; 1: out += h'. If divide: out /= n_chains afterwards.
__global__ void __launch_bounds__(THREADS, 1) resblock_unit_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    const float* __restrict__ wa, const float* __restrict__ ba,
    const float* __restrict__ wb, const float* __restrict__ bb, int T, int C,
    int ka, int da, int kb, int db, int TT, int mode, int n_div) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int NC = C / 4, NR = THREADS / NC, M = NR * RM;
  const int tx = tid % NC, ty = tid / NC;
  const int S = C + 4;
  const int pa = (ka - 1) * da / 2, pb = (kb - 1) * db / 2;
  const int rows_h = M + (ka - 1) * da;
  const int rows_t = M + (kb - 1) * db;
  float* hs = smem;
  float* ts = hs + (size_t)rows_h * S;
  float* ws = ts + (size_t)rows_t * S;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const float* xb = x + (size_t)b * T * C;

  // lrelu(h) with its halo; rows outside [0, T) are zero
  const int g0 = t0 - pb - pa;
  for (int e = tid; e < rows_h * NC; e += THREADS) {
    const int r = e / NC, c4 = e % NC, g = g0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g >= 0 && g < T)
      v = lrelu4(__ldg(reinterpret_cast<const float4*>(xb + (size_t)g * C) + c4));
    *reinterpret_cast<float4*>(hs + (size_t)r * S + 4 * c4) = v;
  }
  // rows of ts past M only feed discarded rows of conv_b
  for (int e = tid; e < (rows_t - M) * NC; e += THREADS) {
    const int r = M + e / NC, c4 = e % NC;
    *reinterpret_cast<float4*>(ts + (size_t)r * S + 4 * c4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float acc[RM][4];
  const float4 bias_a = reinterpret_cast<const float4*>(ba)[tx];
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    acc[m][0] = bias_a.x; acc[m][1] = bias_a.y;
    acc[m][2] = bias_a.z; acc[m][3] = bias_a.w;
  }
  conv_tile(hs, S, wa, ka, da, C, ws, acc, tx, ty, NR, tid);
  // conv_a rows cover [t0 - pb, t0 - pb + M); zero outside [0, T), then lrelu
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int row = ty + m * NR;
    const int g = t0 - pb + row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g >= 0 && g < T)
      v = lrelu4(make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]));
    *reinterpret_cast<float4*>(ts + (size_t)row * S + 4 * tx) = v;
  }

  const float4 bias_b = reinterpret_cast<const float4*>(bb)[tx];
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    acc[m][0] = bias_b.x; acc[m][1] = bias_b.y;
    acc[m][2] = bias_b.z; acc[m][3] = bias_b.w;
  }
  conv_tile(ts, S, wb, kb, db, C, ws, acc, tx, ty, NR, tid);

  float* ob = out + (size_t)b * T * C;
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int row = ty + m * NR;
    const int g = t0 + row;
    if (row >= TT || g >= T) continue;
    const float4 h = __ldg(reinterpret_cast<const float4*>(xb + (size_t)g * C) + tx);
    float4 v = make_float4(h.x + acc[m][0], h.y + acc[m][1], h.z + acc[m][2],
                           h.w + acc[m][3]);
    float4* dst = reinterpret_cast<float4*>(ob + (size_t)g * C) + tx;
    if (mode == 1) {
      const float4 o = *dst;
      v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
    }
    if (n_div > 1) {
      const float n = (float)n_div;
      v = make_float4(v.x / n, v.y / n, v.z / n, v.w / n);
    }
    *dst = v;
  }
}

// ---- kernel 1: the unit on the tensor cores, 3xTF32 ----

namespace tc {

constexpr int WARPS = 16;
constexpr int MT = 2;  // m16 tiles per warp

template <int C>
struct Tile {
  static constexpr int NT = C >= 32 ? 4 : 2;   // n8 tiles per warp
  static constexpr int WN = C / (8 * NT);      // warps along the channels
  static constexpr int WM = WARPS / WN;        // warps along the rows
  static constexpr int M = WM * MT * 16;       // conv rows per block
  static constexpr int S = C + 8;              // row pitch in floats: the 4 rows a
                                               // half-warp reads sit on distinct banks
  static constexpr int STEPS = C / 8;          // k8 steps per tap
  static constexpr int STEP_F4 = STEPS * 32;   // float4 of packed weights per k8 step
  static constexpr int KS = 512 / C;           // k8 steps per 32 KB weight slice
  static constexpr int SLICE_F4 = KS * STEP_F4;
  // At C <= 64 a k8 step's weights (C x 8, 4 KB or less) feed 8 or 16 warps
  // along the rows, so they stream through a shared-memory ring of STAGES
  // slices; at C >= 128 they feed 4 or 2 warps and are read straight from
  // global memory through L1, which measured faster (no ring, no barrier
  // per slice).
  static constexpr bool RING = C <= 64;
  static constexpr int STAGES = 4;             // slices in the ring, if any
  static constexpr int RING_F4 = RING ? STAGES * SLICE_F4 : 0;
};

// Issue the cp.async copies of slice sl of a conv's packed weights into its
// ring slot, and commit them as one group (an empty one past the last slice,
// so that every slice is STAGES - 1 groups behind the newest).
template <int C>
__device__ __forceinline__ void issue_slice(float4* ring, const float4* __restrict__ w, int sl,
                                            int n_steps, int tid) {
  using L = Tile<C>;
  const int n = max(0, min(L::KS, n_steps - sl * L::KS)) * L::STEP_F4;
  float4* dst = ring + (sl % L::STAGES) * L::SLICE_F4;
  const float4* src = w + (size_t)sl * L::SLICE_F4;
  for (int e = tid; e < n; e += WARPS * 32) mma::cp_async16(dst + e, src + e);
  mma::cp_async_commit();
}

// The first STAGES - 1 slices of a conv, issued before its inputs are ready.
template <int C>
__device__ __forceinline__ void prefetch(float4* ring, const float4* __restrict__ w, int k,
                                         int tid) {
  if constexpr (Tile<C>::RING) {
#pragma unroll
    for (int sl = 0; sl < Tile<C>::STAGES - 1; ++sl)
      issue_slice<C>(ring, w, sl, k * Tile<C>::STEPS, tid);
  }
}

// acc += conv(in_s) over the block's rows: out row r reads in rows r + j*d,
// j < k. Rows of m16 tiles at or past `rows` are skipped. The caller has
// issued prefetch(); with a ring the weights stream through STAGES slices,
// STAGES - 1 ahead of the one being multiplied. A slice is also the span
// whose sum is added into acc in float32.
template <int C>
__device__ __forceinline__ void conv(const float* in_s, const float4* __restrict__ w, int k,
                                     int d, float4* ring, float (&acc)[MT][Tile<C>::NT][4],
                                     int rows, int wm, int wn, int g, int t, int lane,
                                     int tid) {
  using L = Tile<C>;
  const int n_steps = k * L::STEPS;
  const int n_slices = (n_steps + L::KS - 1) / L::KS;
  for (int sl = 0; sl < n_slices; ++sl) {
    const float4* ws;
    if constexpr (L::RING) {
      mma::cp_async_wait<L::STAGES - 2>();
      __syncthreads();  // slice sl landed for all; the slot of slice sl - 1 is free
      issue_slice<C>(ring, w, sl + L::STAGES - 1, n_steps, tid);
      ws = ring + (sl % L::STAGES) * L::SLICE_F4;
    } else {
      if (sl == 0) __syncthreads();  // the input tile is written
      ws = w + (size_t)sl * L::SLICE_F4;
    }
    const int n_ks = min(L::KS, n_steps - sl * L::KS);
    // the slice's sum starts from zero in mma fragments and is added into
    // acc in float32, so no mma adds into a long running sum (mma.cuh)
    float part[MT][L::NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < L::KS; ++ks) {
      if (ks >= n_ks) break;
      const int step = sl * L::KS + ks;
      const int tap = step / L::STEPS, i0 = (step % L::STEPS) * 8;
      const float* a_base = in_s + (size_t)(tap * d) * L::S + i0 + 2 * t;
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = (wm * MT + mt) * 16 + g;
        if ((wm * MT + mt) * 16 >= rows) continue;
        const float2 lo = *reinterpret_cast<const float2*>(a_base + (size_t)r * L::S);
        const float2 hi = *reinterpret_cast<const float2*>(a_base + (size_t)(r + 8) * L::S);
        mma::split_tf32(lo.x, ab[mt][0], as[mt][0]);  // (row g,   k t)
        mma::split_tf32(hi.x, ab[mt][1], as[mt][1]);  // (row g+8, k t)
        mma::split_tf32(lo.y, ab[mt][2], as[mt][2]);  // (row g,   k t+4)
        mma::split_tf32(hi.y, ab[mt][3], as[mt][3]);  // (row g+8, k t+4)
      }
      uint32_t wb[L::NT][2], wsm[L::NT][2];  // the weights' big and small parts
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        const float4* src = ws + ks * L::STEP_F4 + (wn * L::NT + nt) * 32 + lane;
        float4 wv;
        if constexpr (L::RING) wv = *src;
        else wv = __ldg(src);
        wb[nt][0] = __float_as_uint(wv.x);   // big parts of (k t, col g), (k t+4, col g)
        wb[nt][1] = __float_as_uint(wv.y);
        wsm[nt][0] = mma::tf32_round(wv.z);  // the residuals, rounded as split_tf32 does
        wsm[nt][1] = mma::tf32_round(wv.w);
      }
      // small products first; consecutive products update different sums
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
          if ((wm * MT + mt) * 16 < rows) mma::tf32_1688(part[mt][nt], ab[mt], wsm[nt][0], wsm[nt][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
          if ((wm * MT + mt) * 16 < rows) mma::tf32_1688(part[mt][nt], as[mt], wb[nt][0], wb[nt][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
          if ((wm * MT + mt) * 16 < rows) mma::tf32_1688(part[mt][nt], ab[mt], wb[nt][0], wb[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[mt][nt][c];
  }
}

template <int C>
__device__ __forceinline__ void init_bias(float (&acc)[MT][Tile<C>::NT][4],
                                          const float* __restrict__ bias, int wn, int t) {
  using L = Tile<C>;
#pragma unroll
  for (int nt = 0; nt < L::NT; ++nt) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + (wn * L::NT + nt) * 8 + 2 * t));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][nt][0] = b.x; acc[mt][nt][1] = b.y;
      acc[mt][nt][2] = b.x; acc[mt][nt][3] = b.y;
    }
  }
}

// x, out: (B, T, C); pa, pb: packed weights (pack_tf32_weights); ba, bb: (C,).
// mode 0: out = h'; 1: out += h'. If n_div > 1: out /= n_div afterwards.
template <int C>
__global__ void __launch_bounds__(WARPS * 32, 1) resblock_unit_mma_kernel(
    const float* __restrict__ x, float* __restrict__ out, const float4* __restrict__ pa,
    const float* __restrict__ ba, const float4* __restrict__ pb,
    const float* __restrict__ bb, int T, int ka, int da, int kb, int db, int mode,
    int n_div) {
  using L = Tile<C>;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int pa_rows = (ka - 1) * da / 2, pb_rows = (kb - 1) * db / 2;
  const int rows_h = L::M + (ka - 1) * da, rows_t = L::M + (kb - 1) * db;
  const int TT = L::M - (kb - 1) * db;  // output rows of this block
  float* tile = reinterpret_cast<float*>(smem4);  // lrelu(h), then lrelu(conv_a)
  float4* ring = smem4 + (size_t)max(rows_h, rows_t) * L::S / 4;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const float* xb = x + (size_t)b * T * C;

  prefetch<C>(ring, pa, ka, tid);
  // lrelu(h) with its halo; rows outside [0, T) are zero
  const int g0 = t0 - pb_rows - pa_rows;
  for (int e = tid; e < rows_h * (C / 4); e += WARPS * 32) {
    const int r = e / (C / 4), c4 = e % (C / 4), gr = g0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr >= 0 && gr < T)
      v = lrelu4(__ldg(reinterpret_cast<const float4*>(xb + (size_t)gr * C) + c4));
    *reinterpret_cast<float4*>(tile + (size_t)r * L::S + 4 * c4) = v;
  }

  float acc[MT][L::NT][4];
  init_bias<C>(acc, ba, wn, t);
  conv<C>(tile, pa, ka, da, ring, acc, L::M, wm, wn, g, t, lane, tid);
  mma::cp_async_wait<0>();  // conv_a's trailing groups are empty
  __syncthreads();  // every warp is done reading the input tile and the ring
  prefetch<C>(ring, pb, kb, tid);

  // conv_a rows cover [t0 - pb, t0 - pb + M); zero outside [0, T), lrelu
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT + mt) * 16 + g + 8 * h;
      const int gr = t0 - pb_rows + r;
      const bool in = gr >= 0 && gr < T;
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        const float2 v = in ? make_float2(lrelu(acc[mt][nt][2 * h]), lrelu(acc[mt][nt][2 * h + 1]))
                            : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(tile + (size_t)r * L::S + (wn * L::NT + nt) * 8 + 2 * t) = v;
      }
    }
  // rows past M only feed discarded rows of conv_b
  for (int e = tid; e < (rows_t - L::M) * (C / 4); e += WARPS * 32) {
    const int r = L::M + e / (C / 4), c4 = e % (C / 4);
    *reinterpret_cast<float4*>(tile + (size_t)r * L::S + 4 * c4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  init_bias<C>(acc, bb, wn, t);
  conv<C>(tile, pb, kb, db, ring, acc, TT, wm, wn, g, t, lane, tid);

  float* ob = out + (size_t)b * T * C;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT + mt) * 16 + g + 8 * h;
      const int gr = t0 + r;
      if (r >= TT || gr >= T) continue;
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        const int c = (wn * L::NT + nt) * 8 + 2 * t;
        const float2 hv = __ldg(reinterpret_cast<const float2*>(xb + (size_t)gr * C + c));
        float2 v = make_float2(hv.x + acc[mt][nt][2 * h], hv.y + acc[mt][nt][2 * h + 1]);
        float2* dst = reinterpret_cast<float2*>(ob + (size_t)gr * C + c);
        if (mode == 1) {
          const float2 o = *dst;
          v = make_float2(o.x + v.x, o.y + v.y);
        }
        if (n_div > 1) {
          const float n = (float)n_div;
          v = make_float2(v.x / n, v.y / n);
        }
        *dst = v;
      }
    }
}

template <int C>
int launch_unit(const float* x, float* out, const float4* pa, const float* ba,
                const float4* pb, const float* bb, int B, int T, int ka, int da, int kb,
                int db, int mode, int n_div, cudaStream_t stream) {
  using L = Tile<C>;
  const int TT = L::M - (kb - 1) * db;
  if (TT <= 0) return (int)cudaErrorInvalidValue;
  const int halo = (ka - 1) * da > (kb - 1) * db ? (ka - 1) * da : (kb - 1) * db;
  const int rows = L::M + halo;
  const int smem = rows * L::S * 4 + L::RING_F4 * 16;
  cudaError_t err = cudaFuncSetAttribute(resblock_unit_mma_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  resblock_unit_mma_kernel<C><<<grid, WARPS * 32, smem, stream>>>(
      x, out, pa, ba, pb, bb, T, ka, da, kb, db, mode, n_div);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---- the first bf16 unit, on mma.sync: the yardstick of kernels 1 (bf16) and 8 ----
//
// The first port of _fused_group_call (kernel 1) and scripts/bench_resblock_v2.py::
// _fused_call_v2 (kernel 8, one chain) as they run in bfloat16, kept as
// rvc_resblock_unit_bf16_sync: chip_smoke.py times it beside the wgmma unit
// below (its previous_ms); no path of the port launches it. Activations carry
// in bf16 and every conv is one bf16 pass on mma.sync m16n8k16 with
// float32 sums (the products of bf16 operands are exact), rounded once:
//   t  = bf16(sum_taps conv_a + bias_a), zeroed outside [0, T)
//   u  = bf16(sum_taps conv_b(lrelu(t)) + bias_b)
//   h' = bf16(h + u)
// with lrelu(v) = max(v, bf16(v * bf16(0.1))), the biases float32, and a
// stage's chains added in order in bf16 and divided once (mode, n_div as the
// float32 unit). This is the rounding of pallas_resblock.py:601-656 and of
// bench_resblock_v2.py:56-70. Geometry as the 3xTF32 unit (16 warps, a
// block's rows x all C channels, conv_a's output over the input tile), in
// half the shared memory. Weights: bf16, laid out so that a lane's B fragment
// of one (k16 step, n8 tile) is one 8-byte load (chip_smoke.py::
// pack_bf16_sync_weights); read through L1 with no staging. Each (tap, 64
// input channels) sums from zero in its fragments and is added into float32
// registers, as mma.sync truncates as it accumulates (mma.cuh).

namespace bf {

constexpr int WARPS = 16;
constexpr int MT = 2;     // m16 tiles per warp
constexpr int KS = 4;     // k16 steps (64 input channels) per float32 partial sum
constexpr float SLOPE = 0.10009765625f;  // bf16(0.1)

template <int C>
struct Tile {
  static constexpr int NT = C >= 32 ? 4 : 2;   // n8 tiles per warp
  static constexpr int WN = C / (8 * NT);      // warps along the channels
  static constexpr int WM = WARPS / WN;        // warps along the rows
  static constexpr int M = WM * MT * 16;       // conv rows per block
  static constexpr int S = C + 8;              // row pitch in bf16
  static constexpr int STEPS = C / 16;         // k16 steps per tap
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v a bf16 value: max(v, bf16(v * bf16(0.1)))
__device__ __forceinline__ float lrelu_bf16(float v) {
  return v >= 0.f ? v : round_bf16(v * SLOPE);
}

// acc += conv(in_s) over the block's rows: out row r reads in rows r + j*d.
// w: packed bf16 weights as uint2, ((tap * STEPS + step) * C/8 + n8) * 32 + lane.
template <int C>
__device__ __forceinline__ void conv(const __nv_bfloat16* in_s, const uint2* __restrict__ w,
                                     int k, int d, float (&acc)[MT][Tile<C>::NT][4], int rows,
                                     int wm, int wn, int g, int t, int lane) {
  using L = Tile<C>;
  __syncthreads();  // the tile is written
  for (int j = 0; j < k; ++j) {
    for (int s0 = 0; s0 < L::STEPS; s0 += KS) {
      float part[MT][L::NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int step = s0 + ks;
        if (step >= L::STEPS) break;
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if ((wm * MT + mt) * 16 >= rows) continue;
          const int r = (wm * MT + mt) * 16 + g;
          const __nv_bfloat16* base = in_s + (size_t)(r + j * d) * L::S + step * 16 + 4 * t;
          const uint2 lo = *reinterpret_cast<const uint2*>(base);
          const uint2 hi = *reinterpret_cast<const uint2*>(base + 8 * L::S);
          a[mt][0] = lo.x;  // (row g,   k 2t..2t+1)
          a[mt][1] = hi.x;  // (row g+8, k 2t..2t+1)
          a[mt][2] = lo.y;  // (row g,   k 2t+8..2t+9)
          a[mt][3] = hi.y;  // (row g+8, k 2t+8..2t+9)
        }
        uint2 b[L::NT];
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
          b[nt] = __ldg(w + ((size_t)(j * L::STEPS + step) * (C / 8) + wn * L::NT + nt) * 32 +
                        lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < L::NT; ++nt)
            if ((wm * MT + mt) * 16 < rows) mma::bf16_16816(part[mt][nt], a[mt], b[nt].x, b[nt].y);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[mt][nt][c];
    }
  }
}

template <int C>
__device__ __forceinline__ void zero(float (&acc)[MT][Tile<C>::NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Tile<C>::NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
}

// x, out: (B, T, C) bf16; pa, pb: packed bf16 weights; ba, bb: (C,) float32.
// mode 0: out = h'; 1: out = bf16(out + h'). If n_div > 1: out = bf16(out / n_div).
template <int C>
__global__ void __launch_bounds__(WARPS * 32, 1) resblock_unit_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
    const uint2* __restrict__ pa, const float* __restrict__ ba, const uint2* __restrict__ pb,
    const float* __restrict__ bb, int T, int ka, int da, int kb, int db, int mode, int n_div) {
  using L = Tile<C>;
  extern __shared__ uint4 smem_bf[];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem_bf);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int pa_rows = (ka - 1) * da / 2, pb_rows = (kb - 1) * db / 2;
  const int rows_h = L::M + (ka - 1) * da, rows_t = L::M + (kb - 1) * db;
  const int TT = L::M - (kb - 1) * db;  // output rows of this block
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const __nv_bfloat16* xb = x + (size_t)b * T * C;

  // lrelu(h) with its halo; rows outside [0, T) are zero
  const int g0 = t0 - pb_rows - pa_rows;
  for (int e = tid; e < rows_h * (C / 8); e += WARPS * 32) {
    const int r = e / (C / 8), c8 = e % (C / 8), gr = g0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < T) {
      v = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)gr * C) + c8);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        h2[q] = __floats2bfloat162_rn(lrelu_bf16(__low2float(h2[q])),
                                      lrelu_bf16(__high2float(h2[q])));
    }
    *reinterpret_cast<uint4*>(tile + (size_t)r * L::S + 8 * c8) = v;
  }

  float acc[MT][L::NT][4];
  zero<C>(acc);
  conv<C>(tile, pa, ka, da, acc, L::M, wm, wn, g, t, lane);
  __syncthreads();  // every warp is done reading the input tile

  // conv_a rows cover [t0 - pb, t0 - pb + M): bf16(sum + bias), zero outside
  // [0, T), lrelu
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT + mt) * 16 + g + 8 * h;
      const int gr = t0 - pb_rows + r;
      const bool in = gr >= 0 && gr < T;
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        const int c = (wn * L::NT + nt) * 8 + 2 * t;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(ba + c));
        __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
        if (in)
          v = __floats2bfloat162_rn(
              lrelu_bf16(round_bf16(acc[mt][nt][2 * h] + bias.x)),
              lrelu_bf16(round_bf16(acc[mt][nt][2 * h + 1] + bias.y)));
        *reinterpret_cast<__nv_bfloat162*>(tile + (size_t)r * L::S + c) = v;
      }
    }
  // rows past M only feed discarded rows of conv_b
  for (int e = tid; e < (rows_t - L::M) * (C / 8); e += WARPS * 32) {
    const int r = L::M + e / (C / 8), c8 = e % (C / 8);
    *reinterpret_cast<uint4*>(tile + (size_t)r * L::S + 8 * c8) = make_uint4(0u, 0u, 0u, 0u);
  }

  zero<C>(acc);
  conv<C>(tile, pb, kb, db, acc, TT, wm, wn, g, t, lane);

  __nv_bfloat16* ob = out + (size_t)b * T * C;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm * MT + mt) * 16 + g + 8 * h;
      const int gr = t0 + r;
      if (r >= TT || gr >= T) continue;
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt) {
        const int c = (wn * L::NT + nt) * 8 + 2 * t;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(bb + c));
        const __nv_bfloat162 hv =
            *reinterpret_cast<const __nv_bfloat162*>(xb + (size_t)gr * C + c);
        float v0 = round_bf16(__low2float(hv) + round_bf16(acc[mt][nt][2 * h] + bias.x));
        float v1 = round_bf16(__high2float(hv) + round_bf16(acc[mt][nt][2 * h + 1] + bias.y));
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(ob + (size_t)gr * C + c);
        if (mode == 1) {
          const __nv_bfloat162 o = *dst;
          v0 = round_bf16(__low2float(o) + v0);
          v1 = round_bf16(__high2float(o) + v1);
        }
        if (n_div > 1) {
          v0 = __fdiv_rn(v0, (float)n_div);
          v1 = __fdiv_rn(v1, (float)n_div);
        }
        *dst = __floats2bfloat162_rn(v0, v1);
      }
    }
}

template <int C>
int launch_unit(const __nv_bfloat16* x, __nv_bfloat16* out, const uint2* pa, const float* ba,
                const uint2* pb, const float* bb, int B, int T, int ka, int da, int kb, int db,
                int mode, int n_div, cudaStream_t stream) {
  using L = Tile<C>;
  const int TT = L::M - (kb - 1) * db;
  if (TT <= 0) return (int)cudaErrorInvalidValue;
  const int halo = (ka - 1) * da > (kb - 1) * db ? (ka - 1) * da : (kb - 1) * db;
  const int smem = (L::M + halo) * L::S * 2;
  cudaError_t err = cudaFuncSetAttribute(resblock_unit_bf16_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  resblock_unit_bf16_kernel<C><<<grid, WARPS * 32, smem, stream>>>(
      x, out, pa, ba, pb, bb, T, ka, da, kb, db, mode, n_div);
  return (int)cudaGetLastError();
}

}  // namespace bf

// ---- kernels 1 (bf16) and 8: the bf16 unit on wgmma ----
//
// Replaces _fused_group_call (kernel 1) and scripts/bench_resblock_v2.py::
// _fused_call_v2 (kernel 8) as they run in bfloat16, with the yardstick's
// rounding above, unchanged. What bounds it: operations, 2 k C^2 flops per
// row and conv in one bf16 pass, then the bytes of a unit's input and
// output (a unit a launch). The mma.sync unit (the yardstick) was held back
// by its weights, read through L1 inside the innermost loop with no
// staging, 64 rows per weight byte at C = 256 (2.9 MB of weights a unit at
// k = 11) and one block of 16 warps an SM to hide the wait, and by mma.sync
// itself (about 65% of wgmma's rate). The design:
// - the products on wgmma m64nNk16 (bf16, float32 sums). A, the
//   activations, comes from registers, loaded with ldmatrix from the padded
//   tile in shared memory: tap j of a dilated conv reads rows shifted by j d,
//   which a swizzled shared-memory descriptor for A could not follow. B, the
//   weights, comes from shared memory through a descriptor (hopper.cuh);
// - the weights are packed once per set of weights by the wrapper
//   (ops/resblock.py::pack_bf16_weights) into the exact image B's descriptor
//   reads: K = (tap, input channel) in that order cut into slices of 64, each
//   slice C rows of 128 bytes with the 128-byte swizzle. A producer
//   warpgroup (one lane) streams conv_a's slices and then conv_b's with 1-D
//   bulk copies (cp.async.bulk, no tensor map) into a ring of STAGES slots
//   that complete on mbarriers; the consumers free a slot once their
//   products on it are done, so conv_b's first slices arrive during conv_a's
//   epilogue;
// - more rows per weight byte where the weights are largest: at C = 256 and
//   128 two consumer warpgroups own 256 / C m64 tiles each and every slice
//   feeds M = 128 and 256 rows (the mma.sync unit: 64 and 128), one block
//   an SM; at C <= 64 one consumer warpgroup owns 4 or 8 m64 tiles, M = 256
//   and 512 rows (as the mma.sync unit), and two such blocks share an SM, so
//   that one block's loads and element-wise passes run under the other's
//   products (setmaxnreg gives each consumer thread 232 registers and each
//   producer thread 40, or 24 where two blocks share the SM's registers);
// - float32 sums as before: each slice's sum (its 4 k16 steps) starts in the
//   wgmma registers with scale-d = 0 and is added into float32 registers,
//   one chunk of 128 outputs (64 or C at C <= 64) at a time, since wgmma
//   truncates as it accumulates, as mma.sync does (bench/wgmma_peak.cu
//   measured both);
// - the input tile comes in by cp.async, all rows in flight at once, and the
//   element-wise work (lrelu, the residual add, the stage's sum) runs on
//   packed bf16 pairs: a product or sum of two bf16 values is exact in
//   float32, so __hmul2's and __hadd2's one rounding is the scalar path's;
// - the epilogues as before: conv_a's output, rounded, zeroed outside
//   [0, T) and lrelu'd, overwrites the input tile, so C = 256 with k = 11,
//   d = 5 fits one launch; conv_b's rounded sums go through the tile too, and
//   the output rows leave in 16-byte pieces with their loads batched. One
//   launch computes one residual unit.

namespace wg {

constexpr int KSTEPS = 4;  // k16 steps of one weight slice (64 of K)

template <int C>
struct Geo {
  // C >= 128: two consumer warpgroups, one block an SM; C <= 64: one, and
  // two blocks an SM, so that one block's loads and element-wise passes run
  // under the other's products
  static constexpr bool WIDE = C >= 128;
  static constexpr int CONSUMERS = WIDE ? 2 : 1;      // consumer warpgroups
  static constexpr int BLOCKS = WIDE ? 1 : 2;         // blocks an SM
  static constexpr int CTHREADS = CONSUMERS * 128;    // consumer threads
  static constexpr int THREADS = CTHREADS + 128;      // and the producer warpgroup
  // registers a thread after setmaxnreg: the producer's and the consumers'
  static constexpr int PRODUCER_REGS = WIDE ? 40 : 24;
  static constexpr int REGS = 232;
  static constexpr int NCH = WIDE ? 128 : (C < 64 ? C : 64);  // outputs of one partial
                                                              // sum (wgmma's N)
  static constexpr int NC = C / NCH;                  // partial sums per m64 tile and slice
  static constexpr int ACC = NCH / 2;                 // floats of one partial sum a thread
  static constexpr int MT = C >= 64 ? 256 / C : 8;    // m64 tiles per consumer warpgroup
  static constexpr int M = CONSUMERS * MT * 64;       // conv rows per block
  static constexpr int S = C + 8;                     // tile row pitch in bf16: the 8 rows of
                                                      // an ldmatrix phase on distinct banks
  static constexpr int STEPS = C / 16;                // k16 steps per tap
  static constexpr int SLICE = C * 128;               // bytes of one weight slice
  static constexpr int STAGES = C == 256 ? 4 : 8;     // ring slots
};

// lrelu of two bf16 values, max(v, bf16(v bf16(0.1))): the product of two
// bf16 values is exact in float32, so __hmul2's one rounding is the scalar
// path's (bf::lrelu_bf16)
__device__ __forceinline__ __nv_bfloat162 lrelu2(__nv_bfloat162 v) {
  return __hmax2(v, __hmul2(v, __float2bfloat162_rn(bf::SLOPE)));
}

// lrelu of the 8 bf16 values of a 16-byte piece
__device__ __forceinline__ uint4 lrelu8(uint4 v) {
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h2[i] = lrelu2(h2[i]);
  return v;
}

template <int C>
using Acc = float[Geo<C>::MT][Geo<C>::NC][Geo<C>::ACC];

template <int C>
__device__ __forceinline__ void zero(Acc<C>& acc) {
#pragma unroll
  for (int mt = 0; mt < Geo<C>::MT; ++mt)
#pragma unroll
    for (int nc = 0; nc < Geo<C>::NC; ++nc)
#pragma unroll
      for (int i = 0; i < Geo<C>::ACC; ++i) acc[mt][nc][i] = 0.f;
}

// acc += conv(tile) over the warpgroup's m64 tiles from row0 (those at or
// past `rows` skipped): out row r reads tile rows r + j d. The conv's
// n_steps k16 steps come as slices through the ring; q counts the launch's
// slices (conv_a's, then conv_b's): slice q sits in slot q % STAGES in
// round q / STAGES.
template <int C>
__device__ __forceinline__ void conv(const __nv_bfloat16* tile, int d, int n_steps,
                                     const uint8_t* ring, uint64_t* full, uint64_t* empty, int& q,
                                     Acc<C>& acc, int row0, int rows, int wq, int lane) {
  using G = Geo<C>;
  const int n_slices = (n_steps + KSTEPS - 1) / KSTEPS;
  // this lane's ldmatrix row and column in the warp's 16 rows of an m64 tile
  const __nv_bfloat16* a_lane =
      tile + (size_t)(row0 + wq * 16 + lane % 16) * G::S + (lane / 16) * 8;
  float part[G::ACC];
#pragma unroll
  for (int i = 0; i < G::ACC; ++i) part[i] = 0.f;
  for (int s = 0; s < n_slices; ++s, ++q) {
    const int slot = q % G::STAGES;
    const int nk = min(KSTEPS, n_steps - s * KSTEPS);
    hop::mbar_wait(&full[slot], (q / G::STAGES) & 1);
    const uint64_t desc = hop::desc_sw128(ring + (size_t)slot * G::SLICE);
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      if (row0 + mt * 64 >= rows) break;  // the same for the whole warpgroup
      uint32_t a[KSTEPS][4];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int u = s * KSTEPS + kk;  // tap u / STEPS, inputs 16 (u % STEPS) ..
        if (kk < nk)
          hop::ldmatrix_x4(a[kk], a_lane + (size_t)(mt * 64 + (u / G::STEPS) * d) * G::S +
                                      (u % G::STEPS) * 16);
      }
#pragma unroll
      for (int nc = 0; nc < G::NC; ++nc) {
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          if (kk < nk) hop::Wgmma<G::NCH>::mma(part, a[kk], desc + nc * (G::NCH * 8) + 2 * kk, kk);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(part);
#pragma unroll
        for (int i = 0; i < G::ACC; ++i) acc[mt][nc][i] += part[i];
      }
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&empty[slot]);  // this warp is done with the slot
  }
}

// x, out: (B, T, C) bf16; pa, pb: packed bf16 weights (pack_bf16_weights);
// ba, bb: (C,) float32. mode 0: out = h'; 1: out = bf16(out + h'). If
// n_div > 1: out = bf16(out / n_div).
template <int C>
__global__ void __launch_bounds__(Geo<C>::THREADS, Geo<C>::BLOCKS) resblock_unit_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
    const uint8_t* __restrict__ pa, const float* __restrict__ ba, const uint8_t* __restrict__ pb,
    const float* __restrict__ bb, int T, int ka, int da, int kb, int db, int mode, int n_div) {
  using G = Geo<C>;
  extern __shared__ __align__(1024) uint8_t smem_wg[];
  // the ring's slots on 1024-byte boundaries (the swizzle's atoms), then the
  // barriers, then the activation tile
  uint8_t* ring = smem_wg + ((1024 - (hop::smem_addr(smem_wg) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::STAGES * G::SLICE);
  uint64_t* empty = full + G::STAGES;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(empty + G::STAGES);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int na = ka * G::STEPS, nb = kb * G::STEPS;  // k16 steps of each conv
  if (tid == 0) {
    for (int i = 0; i < G::STAGES; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], G::CTHREADS / 32);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= G::CTHREADS / 32) {  // the producer warpgroup: one lane starts every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::PRODUCER_REGS));
    if (warp == G::CTHREADS / 32 && lane == 0) {
      const int sa = (na + KSTEPS - 1) / KSTEPS, n = sa + (nb + KSTEPS - 1) / KSTEPS;
      for (int q = 0; q < n; ++q) {
        const int slot = q % G::STAGES;
        if (q >= G::STAGES) hop::mbar_wait(&empty[slot], (q / G::STAGES - 1) & 1);
        hop::mbar_arrive_expect_tx(&full[slot], G::SLICE);
        const uint8_t* src = q < sa ? pa + (size_t)q * G::SLICE : pb + (size_t)(q - sa) * G::SLICE;
        hop::bulk_copy(ring + (size_t)slot * G::SLICE, src, G::SLICE, &full[slot]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::REGS));

  const int wq = warp % 4, g = lane / 4, t = lane % 4;
  const int row0 = (warp / 4) * G::MT * 64;  // the warpgroup's first row
  const int pa_rows = (ka - 1) * da / 2, pb_rows = (kb - 1) * db / 2;
  const int rows_h = G::M + (ka - 1) * da, rows_t = G::M + (kb - 1) * db;
  const int TT = G::M - (kb - 1) * db;  // output rows of this block
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const __nv_bfloat16* xb = x + (size_t)b * T * C;

  // h with its halo by cp.async, all rows in flight at once (rows outside
  // [0, T) are zero-filled), then lrelu in place
  const int g0 = t0 - pb_rows - pa_rows;
  for (int e = tid; e < rows_h * (C / 8); e += G::CTHREADS) {
    const int r = e / (C / 8), c8 = e % (C / 8), gr = g0 + r;
    const bool in = gr >= 0 && gr < T;
    mma::cp_async16(tile + (size_t)r * G::S + 8 * c8, xb + (size_t)(in ? gr : 0) * C + 8 * c8,
                    in ? 16 : 0);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  hop::bar_sync(1, G::CTHREADS);
  for (int e = tid; e < rows_h * (C / 8); e += G::CTHREADS) {
    uint4* p = reinterpret_cast<uint4*>(tile + (size_t)(e / (C / 8)) * G::S + 8 * (e % (C / 8)));
    *p = lrelu8(*p);
  }
  hop::bar_sync(1, G::CTHREADS);

  Acc<C> acc;
  zero<C>(acc);
  int q = 0;
  conv<C>(tile, da, na, ring, full, empty, q, acc, row0, G::M, wq, lane);
  hop::bar_sync(1, G::CTHREADS);  // every consumer is done reading the input tile

  // conv_a's rows cover [t0 - pb, t0 - pb + M): bf16(sum + bias), zero
  // outside [0, T), lrelu. acc[mt][nc][4 j + c] is row 16 wq + g + 8 (c / 2)
  // of m64 tile mt, column nc NCH + 8 j + 2 t + (c % 2).
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nc = 0; nc < G::NC; ++nc)
#pragma unroll
      for (int j = 0; j < G::NCH / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + mt * 64 + wq * 16 + g + 8 * h;
          const int gr = t0 - pb_rows + r;
          const int c = nc * G::NCH + 8 * j + 2 * t;
          const float2 bias = __ldg(reinterpret_cast<const float2*>(ba + c));
          __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
          if (gr >= 0 && gr < T)
            v = lrelu2(__floats2bfloat162_rn(acc[mt][nc][4 * j + 2 * h] + bias.x,
                                             acc[mt][nc][4 * j + 2 * h + 1] + bias.y));
          *reinterpret_cast<__nv_bfloat162*>(tile + (size_t)r * G::S + c) = v;
        }
  // rows past M only feed discarded rows of conv_b
  for (int e = tid; e < (rows_t - G::M) * (C / 8); e += G::CTHREADS) {
    const int r = G::M + e / (C / 8), c8 = e % (C / 8);
    *reinterpret_cast<uint4*>(tile + (size_t)r * G::S + 8 * c8) = make_uint4(0u, 0u, 0u, 0u);
  }
  hop::bar_sync(1, G::CTHREADS);

  zero<C>(acc);
  conv<C>(tile, db, nb, ring, full, empty, q, acc, row0, TT, wq, lane);
  hop::bar_sync(1, G::CTHREADS);  // every consumer is done reading conv_b's input

  // u = bf16(sum + bias) of the output rows into the tile, then the rows out
  // in 16-byte pieces: h' = bf16(h + u), added into out and divided as asked
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nc = 0; nc < G::NC; ++nc)
#pragma unroll
      for (int j = 0; j < G::NCH / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + mt * 64 + wq * 16 + g + 8 * h;
          if (r >= TT) continue;
          const int c = nc * G::NCH + 8 * j + 2 * t;
          const float2 bias = __ldg(reinterpret_cast<const float2*>(bb + c));
          *reinterpret_cast<__nv_bfloat162*>(tile + (size_t)r * G::S + c) = __floats2bfloat162_rn(
              acc[mt][nc][4 * j + 2 * h] + bias.x, acc[mt][nc][4 * j + 2 * h + 1] + bias.y);
        }
  hop::bar_sync(1, G::CTHREADS);
  // in batches of UB pieces a thread, their loads made before any store
  constexpr int UB = 8;
  __nv_bfloat16* ob = out + (size_t)b * T * C;
  const int n8 = min(TT, T - t0) * (C / 8);
  for (int e0 = tid; e0 < n8; e0 += UB * G::CTHREADS) {
    uint4 hv[UB], ov[UB];
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      const int e = e0 + i * G::CTHREADS;
      if (e >= n8) break;
      const size_t at = (size_t)(t0 + e / (C / 8)) * C + 8 * (e % (C / 8));
      hv[i] = __ldg(reinterpret_cast<const uint4*>(xb + at));
      if (mode == 1) ov[i] = *reinterpret_cast<const uint4*>(ob + at);
    }
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      const int e = e0 + i * G::CTHREADS;
      if (e >= n8) break;
      const int r = e / (C / 8), c8 = e % (C / 8);
      uint4 u = *reinterpret_cast<const uint4*>(tile + (size_t)r * G::S + 8 * c8);
      __nv_bfloat162* u2 = reinterpret_cast<__nv_bfloat162*>(&u);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hv[i]);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov[i]);
      // the sum of two bf16 values rounds once in __hadd2, as in float32
      // and then to bf16
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        u2[c] = __hadd2(h2[c], u2[c]);
        if (mode == 1) u2[c] = __hadd2(o2[c], u2[c]);
        if (n_div > 1)
          u2[c] = __floats2bfloat162_rn(__fdiv_rn(__low2float(u2[c]), (float)n_div),
                                        __fdiv_rn(__high2float(u2[c]), (float)n_div));
      }
      *reinterpret_cast<uint4*>(ob + (size_t)(t0 + r) * C + 8 * c8) = u;
    }
  }
}

template <int C>
int launch_unit(const __nv_bfloat16* x, __nv_bfloat16* out, const uint8_t* pa, const float* ba,
                const uint8_t* pb, const float* bb, int B, int T, int ka, int da, int kb, int db,
                int mode, int n_div, cudaStream_t stream) {
  using G = Geo<C>;
  const int TT = G::M - (kb - 1) * db;
  if (TT <= 0) return (int)cudaErrorInvalidValue;
  const int halo = (ka - 1) * da > (kb - 1) * db ? (ka - 1) * da : (kb - 1) * db;
  const int smem = 1024 + G::STAGES * (G::SLICE + 16) + (G::M + halo) * G::S * 2;
  cudaError_t err = cudaFuncSetAttribute(resblock_unit_wgmma_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(resblock_unit_wgmma_kernel<C>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  resblock_unit_wgmma_kernel<C><<<grid, G::THREADS, smem, stream>>>(x, out, pa, ba, pb, bb, T,
                                                                     ka, da, kb, db, mode, n_div);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// The SIMT unit: weights (k, C, C) [tap][in][out]. C must be a multiple of
// 16 and at most 256 (the wrapper checks).
extern "C" int rvc_resblock_unit_simt(const void* x, void* out, const void* wa,
                                 const void* ba, const void* wb, const void* bb,
                                 int B, int T, int C, int ka, int da, int kb,
                                 int db, int mode, int n_div, void* stream) {
  const int NC = C / 4, NR = THREADS / NC, M = NR * RM;
  const int TT = M - (kb - 1) * db;  // output rows per block
  const int smem =
      ((M + (ka - 1) * da) + (M + (kb - 1) * db)) * (C + 4) * 4 + KC * C * 4;
  cudaError_t err = cudaFuncSetAttribute(
      resblock_unit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  resblock_unit_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (const float*)wa, (const float*)ba,
      (const float*)wb, (const float*)bb, T, C, ka, da, kb, db, TT, mode, n_div);
  return (int)cudaGetLastError();
}

// Kernel 1: the tensor-core unit. pa, pb: conv_a's and conv_b's weights as
// pack_tf32_weights lays them out ((k * C/8) k8 steps x (C/8) n8 tiles x 32
// lanes x 4 floats). C must be 16, 32, 64, 128 or 256 (the wrapper checks).
extern "C" int rvc_resblock_unit(const void* x, void* out, const void* pa,
                                 const void* ba, const void* pb, const void* bb,
                                 int B, int T, int C, int ka, int da, int kb,
                                 int db, int mode, int n_div, void* stream) {
  const float* xf = (const float*)x;
  const float4* a4 = (const float4*)pa;
  const float4* b4 = (const float4*)pb;
  cudaStream_t s = (cudaStream_t)stream;
#define RVC_UNIT(CC)                                                                     \
  case CC:                                                                               \
    return tc::launch_unit<CC>(xf, (float*)out, a4, (const float*)ba, b4, (const float*)bb, \
                               B, T, ka, da, kb, db, mode, n_div, s);
  switch (C) {
    RVC_UNIT(16) RVC_UNIT(32) RVC_UNIT(64) RVC_UNIT(128) RVC_UNIT(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RVC_UNIT
}

// Kernel 4's first version, kept as the yardstick of the wgmma chain
// (resblock_chain.cu, rvc_resblock1_fwd) and launched only by chip_smoke.py:
// one ResBlock1 chain as the SIMT unit kernel above a launch per unit (mode 0,
// no division), unit u writing its output to hs[u] and the last unit to out.
// w (2n, k, C, C) [conv][tap][in][out]; b (2n, C); dil[u] the dilation of
// unit u's first conv (the second has dilation 1).
extern "C" int rvc_resblock1_fwd_simt(const void* x, void* hs, void* out, const void* w,
                                      const void* b, int B, int T, int C, int k, int n_units,
                                      const int* dil, void* stream) {
  const size_t btc = (size_t)B * T * C, wsz = (size_t)k * C * C;
  const float* wf = (const float*)w;
  const float* bf = (const float*)b;
  const float* h = (const float*)x;
  for (int u = 0; u < n_units; ++u) {
    float* dst = u == n_units - 1 ? (float*)out : (float*)hs + (size_t)u * btc;
    const int err = rvc_resblock_unit_simt(h, dst, wf + 2 * u * wsz, bf + 2 * u * C,
                                           wf + (2 * u + 1) * wsz, bf + (2 * u + 1) * C, B, T,
                                           C, k, dil[u], k, 1, 0, 1, stream);
    if (err) return err;
    h = dst;
  }
  return 0;
}


// The mma.sync bf16 unit (the yardstick). x, out: (B, T, C) bf16; pa, pb: conv_a's
// and conv_b's weights as chip_smoke.py::pack_bf16_sync_weights lays them out
// (k x C/16 k16 steps x C/8 n8 tiles x 32 lanes x 4 bf16); ba, bb: (C,)
// float32. C must be 16, 32, 64, 128 or 256.
extern "C" int rvc_resblock_unit_bf16_sync(const void* x, void* out, const void* pa,
                                           const void* ba, const void* pb, const void* bb,
                                           int B, int T, int C, int ka, int da, int kb,
                                           int db, int mode, int n_div, void* stream) {
  const __nv_bfloat16* xh = (const __nv_bfloat16*)x;
  __nv_bfloat16* oh = (__nv_bfloat16*)out;
  const uint2* a2 = (const uint2*)pa;
  const uint2* b2 = (const uint2*)pb;
  cudaStream_t s = (cudaStream_t)stream;
#define RVC_UNIT_BF16(CC)                                                                  \
  case CC:                                                                                 \
    return bf::launch_unit<CC>(xh, oh, a2, (const float*)ba, b2, (const float*)bb, B, T,   \
                               ka, da, kb, db, mode, n_div, s);
  switch (C) {
    RVC_UNIT_BF16(16) RVC_UNIT_BF16(32) RVC_UNIT_BF16(64) RVC_UNIT_BF16(128) RVC_UNIT_BF16(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RVC_UNIT_BF16
}

// Kernels 1 (bf16) and 8: the bf16 unit on wgmma. x, out: (B, T, C) bf16;
// pa, pb: conv_a's and conv_b's weights as pack_bf16_weights lays them out
// (ceil(k C / 64) slices of C rows x 64 bf16, 128-byte swizzled); ba, bb:
// (C,) float32. C must be 16, 32, 64, 128 or 256 (the wrapper checks).
extern "C" int rvc_resblock_unit_bf16(const void* x, void* out, const void* pa,
                                      const void* ba, const void* pb, const void* bb,
                                      int B, int T, int C, int ka, int da, int kb,
                                      int db, int mode, int n_div, void* stream) {
  const __nv_bfloat16* xh = (const __nv_bfloat16*)x;
  __nv_bfloat16* oh = (__nv_bfloat16*)out;
  const uint8_t* a8 = (const uint8_t*)pa;
  const uint8_t* b8 = (const uint8_t*)pb;
  cudaStream_t s = (cudaStream_t)stream;
#define RVC_UNIT_WG(CC)                                                                    \
  case CC:                                                                                 \
    return wg::launch_unit<CC>(xh, oh, a8, (const float*)ba, b8, (const float*)bb, B, T,   \
                               ka, da, kb, db, mode, n_div, s);
  switch (C) {
    RVC_UNIT_WG(16) RVC_UNIT_WG(32) RVC_UNIT_WG(64) RVC_UNIT_WG(128) RVC_UNIT_WG(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RVC_UNIT_WG
}
