// One residual unit of a HiFiGAN ResBlock1 chain, float32, for sm_90a.
//
// Replaces rvc_tpu/ops/pallas_resblock.py::_fused_group_call (reached from
// fused_resblock_group), which runs a whole decoder stage - the mean of its
// ResBlock1 chains - in one TPU launch. Here one launch computes one unit
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
// The card's float32 rate outside the tensor cores (67 TFLOP/s) is the
// ceiling. Design: a block owns TT output rows and all C channels. The
// input tile with its halo (TT + 2*(p_a + p_b) rows) and conv_a's output
// (TT + 2*p_b rows) stay in shared memory, so the unit reads h once and
// writes h' once. Each conv is a small GEMM over (tap, input channel): each
// thread keeps a 16-row x 4-channel block of sums in registers, reads its
// inputs as float4 from shared memory and the weights from a 16-channel
// slice staged in shared memory, prefetched into registers one slice ahead.

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// C must be a multiple of 16 and at most 256 (the wrapper checks).
extern "C" int rvc_resblock_unit(const void* x, void* out, const void* wa,
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

// Kernel 4: one ResBlock1 chain (the forward of fused_resblock1_train), which
// replaces rvc_tpu/ops/pallas_resblock.py::_fused_call. Its n units run as
// the unit kernel above (mode 0, no division), unit u writing its output to
// hs[u] (kept for the backward, kernel 5) and the last unit to out.
// w (2n, k, C, C) [conv][tap][in][out]; b (2n, C); dil[u] the dilation of
// unit u's first conv (the second has dilation 1).
extern "C" int rvc_resblock1_fwd(const void* x, void* hs, void* out, const void* w,
                                 const void* b, int B, int T, int C, int k, int n_units,
                                 const int* dil, void* stream) {
  const size_t btc = (size_t)B * T * C, wsz = (size_t)k * C * C;
  const float* wf = (const float*)w;
  const float* bf = (const float*)b;
  const float* h = (const float*)x;
  for (int u = 0; u < n_units; ++u) {
    float* dst = u == n_units - 1 ? (float*)out : (float*)hs + (size_t)u * btc;
    const int err = rvc_resblock_unit(h, dst, wf + 2 * u * wsz, bf + 2 * u * C,
                                      wf + (2 * u + 1) * wsz, bf + (2 * u + 1) * C, B, T, C,
                                      k, dil[u], k, 1, 0, 1, stream);
    if (err) return err;
    h = dst;
  }
  return 0;
}
