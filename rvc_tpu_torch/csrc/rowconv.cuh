// Float32 SIMT device code of the training kernels, for sm_90a: the row
// tile of kernel 6 (the WaveNet forward, wavenet.cu) and of the PR 5
// backward kernels kept as chip_smoke's yardsticks (rvc_resblock1_bwd_simt,
// rvc_wn_bwd_simt). Activations are (B, T, C) row-major: a row is one time
// step's C channels.
//
// What bounds it on this card: it runs on the float32 pipes (67 TFLOP/s),
// and measured about a fifth of that (kernel 5) down to a tenth (kernel 7's
// gate and dx at (4, 400, 192), whose 40 blocks left most of the 132 SMs
// idle). Kernels 5 and 7 now run on the tensor cores instead, through
// tc_rowconv.cuh, which keeps this header's weight-gradient workspace layout
// and its fixed-order second pass (wgrad_reduce_kernel); kernel 6 moves
// there when it is redesigned.
//
// rowconv: a block owns M consecutive output rows and all Cout output
// channels of a 1-D convolution (or several convolutions over the same
// input). Its input rows, with the conv's halo, sit in shared memory; thread
// (tx, ty) keeps RM rows (ty, ty + NR, ...) x 4 channels (4 tx .. 4 tx + 3)
// of sums in registers and reads the weights, laid out [tap][in][out], as
// float4 through the read-only cache (every row group of the block reads the
// same weights, so they are served from L1 after the first).
//
// wgrad: the weight gradient of a conv, dW[j][i][o] = sum over (b, t) of
// X[b, t + j d - p][i] G[b, t][o] (X zero outside [0, T)), and the bias
// gradient sum G[b, t][o], plus its per-sample sums where a caller wants
// them. These reduce over B*T rows (up to 69120 in a decoder stage). Pass 1
// gives every block one tap, one TS x TS tile of (i, o) and one chunk of R
// rows of one sample, and writes its partial sum; pass 2 adds the chunks in
// a fixed order, so the result does not depend on block order (no atomics).
// The chunk length is picked per call so that pass 1 fills the card: at
// C = 32 a tap is one 32 x 32 tile and the rows are split finely; at C = 256
// a tap has 16 tiles of 64 x 64 and each sample is one chunk.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {  // every file that includes this gets its own copy of the kernels
namespace rowk {

constexpr int MAX_THREADS = 256;
constexpr int RM = 8;  // rows per thread
constexpr float SLOPE = 0.1f;

struct Layout {
  int NC, NR, M, threads;
};

// Cout a multiple of 4, at most 1024: NC column threads of 4 channels, NR
// row threads, M = NR * RM rows per block.
inline __host__ __device__ Layout layout(int Cout) {
  Layout l;
  l.NC = Cout / 4;
  l.NR = MAX_THREADS / l.NC;
  if (l.NR < 1) l.NR = 1;
  l.M = l.NR * RM;
  l.threads = l.NC * l.NR;
  return l;
}

// the leaky ReLU and its derivative, at SLOPE unless a slope is given (the
// bf16 training route's backward runs at bf16(0.1))
__device__ __forceinline__ float lrelu(float v, float s = SLOPE) { return v >= 0.f ? v : v * s; }
__device__ __forceinline__ float lrelu_grad(float v, float s = SLOPE) { return v > 0.f ? 1.f : s; }
__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + __expf(-v)); }

__device__ __forceinline__ float4 f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// dst[r * S + c] = op(src[(g0 + r) * C + c]) for r < rows, c < C; zero where
// g0 + r lies outside [0, valid_end). op is leaky_relu when lrelu_on.
__device__ __forceinline__ void load_rows(float* dst, int S, const float* __restrict__ src,
                                          int C, int g0, int rows, int valid_end,
                                          bool lrelu_on) {
  const int nc4 = C / 4;
  for (int e = threadIdx.x; e < rows * nc4; e += blockDim.x) {
    const int r = e / nc4, c4 = e % nc4, g = g0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g >= 0 && g < valid_end) {
      v = ldg4(src + (size_t)g * C + 4 * c4);
      if (lrelu_on) v = make_float4(lrelu(v.x), lrelu(v.y), lrelu(v.z), lrelu(v.w));
    }
    *reinterpret_cast<float4*>(dst + (size_t)r * S + 4 * c4) = v;
  }
}

// acc[n][m][q] += sum_{j<k} sum_{i<Cin} in_s[(ty + m NR + j d) S + i]
//                                      * w[n][(j Cin + i) Cout + 4 tx + q]
template <int NW>
__device__ __forceinline__ void rowconv(const float* in_s, int S, int Cin,
                                        const float* const (&w)[NW], int Cout, int k,
                                        int d, float (&acc)[NW][RM][4], int tx, int ty,
                                        int NR) {
  for (int j = 0; j < k; ++j) {
    const float* a_base = in_s + (size_t)(ty + j * d) * S;
    for (int i = 0; i < Cin; i += 4) {
      float4 wv[NW][4];
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[n][q] = ldg4(w[n] + ((size_t)(j * Cin + i + q)) * Cout + 4 * tx);
#pragma unroll
      for (int m = 0; m < RM; ++m) {
        const float4 a = f4(a_base + (size_t)m * NR * S + i);
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          float* o = acc[n][m];
          o[0] = fmaf(a.x, wv[n][0].x, o[0]);
          o[1] = fmaf(a.x, wv[n][0].y, o[1]);
          o[2] = fmaf(a.x, wv[n][0].z, o[2]);
          o[3] = fmaf(a.x, wv[n][0].w, o[3]);
          o[0] = fmaf(a.y, wv[n][1].x, o[0]);
          o[1] = fmaf(a.y, wv[n][1].y, o[1]);
          o[2] = fmaf(a.y, wv[n][1].z, o[2]);
          o[3] = fmaf(a.y, wv[n][1].w, o[3]);
          o[0] = fmaf(a.z, wv[n][2].x, o[0]);
          o[1] = fmaf(a.z, wv[n][2].y, o[1]);
          o[2] = fmaf(a.z, wv[n][2].z, o[2]);
          o[3] = fmaf(a.z, wv[n][2].w, o[3]);
          o[0] = fmaf(a.w, wv[n][3].x, o[0]);
          o[1] = fmaf(a.w, wv[n][3].y, o[1]);
          o[2] = fmaf(a.w, wv[n][3].z, o[2]);
          o[3] = fmaf(a.w, wv[n][3].w, o[3]);
        }
      }
    }
  }
}

template <int NW>
__device__ __forceinline__ void zero_acc(float (&acc)[NW][RM][4]) {
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int m = 0; m < RM; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][m][q] = 0.f;
}

// ---------------------------------------------------------------------------
// weight gradients

constexpr int MAX_JOBS = 4;
constexpr int WG_ROWS = 32;   // rows staged in shared memory per step
constexpr int WG_TARGET = 528;  // pass-1 blocks wanted: 4 per SM of an H100

struct WgJob {
  const float* X;  // (B, T, C) the conv's input
  const float* G;  // (B, T, C) the cotangent of its output
  float* dW;       // (k, C, C) [tap][in][out]
  float* db;       // (C,) sum of G, or null
  float* dgb;      // per-sample sums of G at dgb + b * dgb_stride, or null
  int k, d, p, lrelu, dgb_stride;
  float slope;  // of the leaky ReLU applied to X, where lrelu
};

struct WgPlan {
  WgJob job[MAX_JOBS];
  size_t off[MAX_JOBS];  // each job's partial sums in part: (chunks, k, C, C) then (chunks, C)
  float* part;
  int n_jobs, B, T, C, TS, R, ncb, kmax;
};

// Chunking and workspace of a set of jobs (the jobs' k given in ks).
inline WgPlan wgrad_plan(int B, int T, int C, int n_jobs, const int* ks) {
  WgPlan P = {};
  P.n_jobs = n_jobs;
  P.B = B;
  P.T = T;
  P.C = C;
  P.TS = C % 64 == 0 ? 64 : (C % 32 == 0 ? 32 : 16);
  P.kmax = 1;
  for (int q = 0; q < n_jobs; ++q) P.kmax = ks[q] > P.kmax ? ks[q] : P.kmax;
  const int tiles = C / P.TS;
  const int per_chunk = n_jobs * P.kmax * tiles * tiles;
  int ncb = (WG_TARGET + B * per_chunk - 1) / (B * per_chunk);
  const int max_ncb = (T + WG_ROWS - 1) / WG_ROWS;
  ncb = ncb < 1 ? 1 : (ncb > max_ncb ? max_ncb : ncb);
  int R = (T + ncb - 1) / ncb;
  R = (R + WG_ROWS - 1) / WG_ROWS * WG_ROWS;
  P.R = R;
  P.ncb = (T + R - 1) / R;
  size_t off = 0;
  const size_t chunks = (size_t)B * P.ncb;
  for (int q = 0; q < n_jobs; ++q) {
    P.off[q] = off;
    off += chunks * ((size_t)ks[q] * C * C + C);
  }
  return P;
}

inline size_t wgrad_floats(int B, int T, int C, int n_jobs, const int* ks) {
  WgPlan P = wgrad_plan(B, T, C, n_jobs, ks);
  size_t total = 0;
  const size_t chunks = (size_t)B * P.ncb;
  for (int q = 0; q < n_jobs; ++q) total += chunks * ((size_t)ks[q] * C * C + C);
  return total;
}

template <int TS>
__global__ void __launch_bounds__((TS / 4) * (TS / 4)) wgrad_kernel(WgPlan P) {
  constexpr int NT = TS / 4;
  __shared__ float4 xs[WG_ROWS][TS / 4];
  __shared__ float4 gs[WG_ROWS][TS / 4];
  const int C = P.C, T = P.T;
  const int tiles = C / TS;
  const int q = blockIdx.z / (tiles * tiles), tile = blockIdx.z % (tiles * tiles);
  const WgJob J = P.job[q];
  const int j = blockIdx.y;
  if (j >= J.k) return;
  const int chunk = blockIdx.x;
  const int i0 = (tile / tiles) * TS, o0 = (tile % tiles) * TS;
  const int b = chunk / P.ncb;
  const int r0 = (chunk % P.ncb) * P.R;
  const int r1 = min(r0 + P.R, T);
  const int ti = threadIdx.x / NT, to = threadIdx.x % NT;
  const float* Xb = J.X + (size_t)b * T * C;
  const float* Gb = J.G + (size_t)b * T * C;
  const int shift = j * J.d - J.p;
  const bool colsum = j == 0 && i0 == 0 && ti == 0;
  float acc[4][4] = {};
  float gsum[4] = {};
  for (int rs = r0; rs < r1; rs += WG_ROWS) {
    for (int e = threadIdx.x; e < WG_ROWS * (TS / 4); e += NT * NT) {
      const int rr = e / (TS / 4), c4 = e % (TS / 4), r = rs + rr;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), g = x;
      if (r < r1) {
        g = ldg4(Gb + (size_t)r * C + o0 + 4 * c4);
        const int rx = r + shift;
        if (rx >= 0 && rx < T) {
          x = ldg4(Xb + (size_t)rx * C + i0 + 4 * c4);
          if (J.lrelu)
            x = make_float4(lrelu(x.x, J.slope), lrelu(x.y, J.slope), lrelu(x.z, J.slope),
                            lrelu(x.w, J.slope));
        }
      }
      xs[rr][c4] = x;
      gs[rr][c4] = g;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < WG_ROWS; ++rr) {
      const float4 x = xs[rr][ti], g = gs[rr][to];
      const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc[a][0] = fmaf(xv[a], g.x, acc[a][0]);
        acc[a][1] = fmaf(xv[a], g.y, acc[a][1]);
        acc[a][2] = fmaf(xv[a], g.z, acc[a][2]);
        acc[a][3] = fmaf(xv[a], g.w, acc[a][3]);
      }
      if (colsum) {
        gsum[0] += g.x;
        gsum[1] += g.y;
        gsum[2] += g.z;
        gsum[3] += g.w;
      }
    }
    __syncthreads();
  }
  float* pw = P.part + P.off[q] + ((size_t)chunk * J.k + j) * C * C;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    st4(pw + (size_t)(i0 + 4 * ti + a) * C + o0 + 4 * to, acc[a][0], acc[a][1], acc[a][2],
        acc[a][3]);
  if (colsum) {
    const size_t chunks = (size_t)P.B * P.ncb;
    float* pb = P.part + P.off[q] + chunks * J.k * C * C + (size_t)chunk * C;
    st4(pb + o0 + 4 * to, gsum[0], gsum[1], gsum[2], gsum[3]);
  }
}

// Pass 2: blockIdx.y picks the job; each thread owns one output element.
__global__ void wgrad_reduce_kernel(WgPlan P) {
  const WgJob J = P.job[blockIdx.y];
  const int C = P.C, nch = P.B * P.ncb;
  const size_t nW = (size_t)J.k * C * C;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const float* base = P.part + P.off[blockIdx.y];
  const float* bsum = base + (size_t)nch * nW;
  if (idx < nW) {
    float s = 0.f;
    for (int c = 0; c < nch; ++c) s += base[(size_t)c * nW + idx];
    J.dW[idx] = s;
  } else if (idx < nW + C) {
    const int o = (int)(idx - nW);
    if (J.db) {
      float s = 0.f;
      for (int c = 0; c < nch; ++c) s += bsum[(size_t)c * C + o];
      J.db[o] = s;
    }
  } else if (idx < nW + C + (size_t)P.B * C) {
    const int e = (int)(idx - nW - C), b = e / C, o = e % C;
    if (J.dgb) {
      float s = 0.f;
      for (int c = b * P.ncb; c < (b + 1) * P.ncb; ++c) s += bsum[(size_t)c * C + o];
      J.dgb[(size_t)b * J.dgb_stride + o] = s;
    }
  }
}

// Both passes, in stream order. part must hold wgrad_floats(...) floats.
inline cudaError_t wgrad_launch(WgPlan P, float* part, cudaStream_t stream) {
  P.part = part;
  const int tiles = P.C / P.TS;
  dim3 grid(P.B * P.ncb, P.kmax, P.n_jobs * tiles * tiles);
  const int threads = (P.TS / 4) * (P.TS / 4);
  if (P.TS == 64)
    wgrad_kernel<64><<<grid, threads, 0, stream>>>(P);
  else if (P.TS == 32)
    wgrad_kernel<32><<<grid, threads, 0, stream>>>(P);
  else
    wgrad_kernel<16><<<grid, threads, 0, stream>>>(P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  size_t most = 0;
  for (int q = 0; q < P.n_jobs; ++q) {
    const size_t n = (size_t)P.job[q].k * P.C * P.C + P.C + (size_t)P.B * P.C;
    most = n > most ? n : most;
  }
  dim3 rgrid((unsigned)((most + 255) / 256), P.n_jobs);
  wgrad_reduce_kernel<<<rgrid, 256, 0, stream>>>(P);
  return cudaGetLastError();
}

inline cudaError_t allow_smem(const void* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace rowk
}  // namespace
