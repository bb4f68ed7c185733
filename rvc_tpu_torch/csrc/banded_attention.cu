// Self-attention with a banded relative-position bias, float32, for sm_90a.
//
// Replaces rvc_tpu/ops/pallas_attention.py::banded_rel_attention (its body
// _kernel), the attention of the VITS text encoder. For each (batch, head)
// and query row t, over keys j < T:
//     s[t, j] = qs_t . k_j + (|j - t| <= w ? qs_t . ek[j - t + w] : 0),
//               qs = q * scale
//     s[t, j] = -1e4 where t >= len or j >= len (the reference's mask value:
//               a row past its length gets a uniform softmax over T keys)
//     p = softmax_j(s)           (full row, float32)
//     out_t = sum_j p[t, j] v_j + sum_m p[t, t + m - w] ev[m]
// The relative tables ek, ev are (2w+1, D), shared by all heads.
//
// What bounds it: operations at the text encoder's shapes (T up to ~2k
// frames, D = 96): 4*T*T*D flops per (batch, head) against 4*T*D*4 bytes of
// q, k, v and out. Two kernels compute it in float32: the tensor-core kernel
// (rvc_banded_attention, namespace tfa below) and the SIMT kernel that it
// replaced (rvc_banded_attention_simt, this first one), which only
// chip_smoke.py launches, as its yardstick. The SIMT kernel's design: one
// block per 32 query rows of one (batch, head),
// an online softmax over key tiles of 64 rows held in shared memory, so the
// T x T scores never reach device memory. Masked entries are the finite
// -1e4 of the reference, never -inf, and no tile is skipped, so rows past
// their length come out uniform as in the reference. The raw scores on the
// 2w+1 diagonals are kept per row; after the last tile they are normalised
// with the row's final max and sum, which gives the value-side band term
// exactly, with no rescaling in flight.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 32;   // query rows per block
constexpr int BK = 64;   // key rows per tile
constexpr int WMAX = 16; // largest window

// DG = D / 32: float4 column groups per thread in the p.v product
template <int DG>
__global__ void __launch_bounds__(THREADS) banded_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ ek,
    const float* __restrict__ ev, const int* __restrict__ lengths,
    float* __restrict__ out, int H, int T, int w, float scale) {
  constexpr int D = DG * 32;
  constexpr int SD = D + 4;      // row stride of q and k tiles
  constexpr int SS = BK + 1;     // row stride of the score tile
  const int W = 2 * w + 1;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // BQ x SD
  float* ks = qs + BQ * SD;                      // BK x SD
  float* vs = ks + BK * SD;                      // BK x D
  float* ss = vs + BK * D;                       // BQ x SS
  float* eks = ss + BQ * SS;                     // W x D
  float* evs = eks + (2 * WMAX + 1) * D;         // W x D
  float* qe = evs + (2 * WMAX + 1) * D;          // BQ x W: qs . ek
  float* band = qe + BQ * (2 * WMAX + 1);        // BQ x W: raw band scores
  float* row_m = band + BQ * (2 * WMAX + 1);     // BQ
  float* row_l = row_m + BQ;                     // BQ
  float* row_a = row_l + BQ;                     // BQ: rescale of this tile

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int t0 = blockIdx.x * BQ;
  const int len = lengths[b];
  const size_t base = (size_t)bh * T * D;
  const int D4 = D / 4;

  for (int e = tid; e < BQ * D4; e += THREADS) {
    const int r = e / D4, c4 = e % D4, t = t0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) {
      x = __ldg(reinterpret_cast<const float4*>(q + base + (size_t)t * D) + c4);
      x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
    *reinterpret_cast<float4*>(qs + r * SD + 4 * c4) = x;
  }
  for (int e = tid; e < W * D; e += THREADS) {
    eks[e] = ek[e];
    evs[e] = ev[e];
  }
  for (int e = tid; e < BQ; e += THREADS) {
    row_m[e] = -INFINITY;
    row_l[e] = 0.f;
  }
  for (int e = tid; e < BQ * W; e += THREADS) band[(e / W) * (2 * WMAX + 1) + e % W] = -INFINITY;
  __syncthreads();
  for (int e = tid; e < BQ * W; e += THREADS) {
    const int r = e / W, m = e % W;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qs[r * SD + d], eks[m * D + d], s);
    qe[r * (2 * WMAX + 1) + m] = s;
  }

  // score mapping: rows 2*sr, 2*sr+1; key columns sc + 16*c
  const int sr = tid / 16, sc = tid % 16;
  // softmax mapping: 8 threads per row, 8 columns each
  const int mr = tid / 8, mp = tid % 8;
  // p.v mapping: one row, float4 groups og + 8*g
  const int orow = tid / 8, og = tid % 8;
  float acc[DG][4];
#pragma unroll
  for (int g = 0; g < DG; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < BK * D4; e += THREADS) {
      const int r = e / D4, c4 = e % D4, j = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (j < T) {
        kx = __ldg(reinterpret_cast<const float4*>(k + base + (size_t)j * D) + c4);
        vx = __ldg(reinterpret_cast<const float4*>(v + base + (size_t)j * D) + c4);
      }
      *reinterpret_cast<float4*>(ks + r * SD + 4 * c4) = kx;
      *reinterpret_cast<float4*>(vs + r * D + 4 * c4) = vx;
    }
    __syncthreads();

    // scores of this tile
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(qs + (2 * sr) * SD + d);
      const float4 a1 = *reinterpret_cast<const float4*>(qs + (2 * sr + 1) * SD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + (sc + 16 * c) * SD + d);
        s[0][c] = fmaf(a0.x, kk.x, s[0][c]); s[0][c] = fmaf(a0.y, kk.y, s[0][c]);
        s[0][c] = fmaf(a0.z, kk.z, s[0][c]); s[0][c] = fmaf(a0.w, kk.w, s[0][c]);
        s[1][c] = fmaf(a1.x, kk.x, s[1][c]); s[1][c] = fmaf(a1.y, kk.y, s[1][c]);
        s[1][c] = fmaf(a1.z, kk.z, s[1][c]); s[1][c] = fmaf(a1.w, kk.w, s[1][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * sr + i, t = t0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = sc + 16 * c, j = k0 + col;
        float x = s[i][c];
        const int rel = j - t + w;
        const bool in_band = rel >= 0 && rel < W;
        if (in_band) x += qe[r * (2 * WMAX + 1) + rel];
        if (t >= len || j >= len) x = -1e4f;
        if (j >= T) x = -INFINITY;  // past the sequence: not a key at all
        else if (in_band) band[r * (2 * WMAX + 1) + rel] = x;
        ss[r * SS + col] = x;
      }
    }
    __syncthreads();

    // online softmax: new max, rescale factor, p = exp(s - max), row sums
    {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, ss[mr * SS + mp * 8 + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_old = row_m[mr];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = expf(ss[mr * SS + mp * 8 + c] - m_new);
        ss[mr * SS + mp * 8 + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      __syncwarp();
      if (mp == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        row_a[mr] = alpha;
        row_l[mr] = row_l[mr] * alpha + sum;
        row_m[mr] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v
    {
      const float alpha = row_a[orow];
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        acc[g][0] *= alpha; acc[g][1] *= alpha; acc[g][2] *= alpha; acc[g][3] *= alpha;
      }
      const int nk = min(BK, T - k0);
      for (int jj = 0; jj < nk; ++jj) {
        const float p = ss[orow * SS + jj];
#pragma unroll
        for (int g = 0; g < DG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + jj * D + 4 * (og + 8 * g));
          acc[g][0] = fmaf(p, vv.x, acc[g][0]);
          acc[g][1] = fmaf(p, vv.y, acc[g][1]);
          acc[g][2] = fmaf(p, vv.z, acc[g][2]);
          acc[g][3] = fmaf(p, vv.w, acc[g][3]);
        }
      }
    }
  }
  __syncthreads();

  // out = acc / l + sum_m p_band[m] ev[m], p_band normalised with the final stats
  const int t = t0 + orow;
  if (t < T) {
    const float m_f = row_m[orow];
    const float inv_l = 1.f / row_l[orow];
#pragma unroll
    for (int g = 0; g < DG; ++g) {
      const int c0 = 4 * (og + 8 * g);
      float o[4] = {acc[g][0] * inv_l, acc[g][1] * inv_l, acc[g][2] * inv_l,
                    acc[g][3] * inv_l};
      for (int m = 0; m < W; ++m) {
        const float pb = expf(band[orow * (2 * WMAX + 1) + m] - m_f) * inv_l;
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = fmaf(pb, evs[m * D + c0 + c], o[c]);
      }
      *reinterpret_cast<float4*>(out + base + (size_t)t * D + c0) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int DG>
int launch(const float* q, const float* k, const float* v, const float* ek,
           const float* ev, const int* lengths, float* out, int B, int H,
           int T, int w, float scale, cudaStream_t stream) {
  constexpr int D = DG * 32;
  const int smem =
      (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 1) +
       2 * (2 * WMAX + 1) * D + 2 * BQ * (2 * WMAX + 1) + 3 * BQ) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      banded_attention_kernel<DG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  banded_attention_kernel<DG><<<grid, THREADS, smem, stream>>>(
      q, k, v, ek, ev, lengths, out, H, T, w, scale);
  return (int)cudaGetLastError();
}

// ---- kernel 2 in bfloat16, its first version: the yardstick ----
//
// rvc_banded_attention_bf16_sync, launched only by chip_smoke.py beside its
// successor (namespace bfs below). The same function as
// banded_rel_attention computes it in bfloat16
// (pallas_attention.py:54-206, the JAX module's XLA path's rounding):
//     qs = bf16(q * bf16(scale))
//     s[t, j] = bf16(qs_t . k_j)                     (float32 sum, rounded)
//     in the band: s[t, j] = bf16(s[t, j] + bf16(qs_t . ek[j - t + w]))
//     masked (t or j >= len): s = bf16(-1e4)
//     p = bf16(softmax_j(s)), the softmax full-row float32, normalised
//         before it is rounded
//     out_t = bf16(bf16(sum_j p v_j) + bf16(sum_m p[t, t + m - w] ev[m]))
// The normalised p must be rounded before P.V, which the float32 kernel's
// online softmax (normalising at the end) does not do. So two passes over
// the keys: the first takes each row's maximum and its sum of exp(s - max)
// (rescaled online as the maximum grows); the second computes s again, the
// same bits, forms p = bf16(exp(s - max) / sum) and multiplies it into V.
// A block owns 64 query rows of one (batch, head), each of its 4 warps 16
// of them; key tiles of 64 rows (and V's, transposed) are staged in shared
// memory for all 4 warps; QK^T and P.V run on mma.sync m16n8k16 in one
// bf16 pass (exact products), each tile's P.V sum added into float32
// registers (mma.sync truncates as it accumulates, mma.cuh); the band and
// the mask on the SIMT pipes, the band's p kept per row for its value
// term. Any T. What bounds it: operations (QK^T twice and P.V: 6 T^2 D
// flops per (batch, head), one bf16 pass).

namespace bfa {

constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int WP = 2 * WMAX + 1;
constexpr float NEG = -9984.f;  // bf16(-1e4)

__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <int D>
struct Smem {
  static constexpr int SD = D + 8;   // row pitch (bf16) of the q and k tiles
  static constexpr int SV = BK + 8;  // row pitch (bf16) of v^T and of the p tiles
  static constexpr int BYTES = (BQ * SD + BK * SD + D * SV + BQ * SV) * 2 + 2 * BQ * WP * 4;
};

// The warp's 16 x 64 scores of key tile k0 (ks: the tile in shared memory),
// rounded, with the band and the mask, in the C fragment layout: sc[nt][c]
// is row g + 8 (c / 2), key k0 + 8 nt + 2 t + (c % 2). Keys past T are -inf.
template <int D>
__device__ __forceinline__ void scores(const __nv_bfloat16* qw, const __nv_bfloat16* ks,
                                       const float* qe, int k0, int t0, int T, int len, int w,
                                       int g, int t4, float (&sc)[BK / 8][4]) {
  constexpr int SD = Smem<D>::SD;
  const int W = 2 * w + 1;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
  for (int st = 0; st < D / 16; ++st) {
    const __nv_bfloat16* ab = qw + g * SD + st * 16 + 4 * t4;
    const uint2 lo = *reinterpret_cast<const uint2*>(ab);
    const uint2 hi = *reinterpret_cast<const uint2*>(ab + 8 * SD);
    const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const uint2 bk = *reinterpret_cast<const uint2*>(ks + (nt * 8 + g) * SD + st * 16 + 4 * t4);
      mma::bf16_16816(sc[nt], a, bk.x, bk.y);
    }
  }
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = g + 8 * (c / 2), t = t0 + r;
      const int j = k0 + nt * 8 + 2 * t4 + (c % 2);
      float x = rb(sc[nt][c]);
      const int rel = j - t + w;
      if (rel >= 0 && rel < W) x = rb(x + qe[r * WP + rel]);
      if (t >= len || j >= len) x = NEG;
      sc[nt][c] = j < T ? x : -INFINITY;
    }
}

template <int D>
__global__ void __launch_bounds__(WARPS * 32) banded_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ ek,
    const __nv_bfloat16* __restrict__ ev, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, int H, int T, int w, float scale) {
  using SM = Smem<D>;
  constexpr int SD = SM::SD, SV = SM::SV;
  const int W = 2 * w + 1;
  extern __shared__ uint4 smem_a[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_a);  // BQ x SD
  __nv_bfloat16* ks = qs + BQ * SD;                              // BK x SD
  __nv_bfloat16* vt = ks + BK * SD;                              // D x SV
  __nv_bfloat16* ps = vt + D * SV;                               // BQ x SV: p of a tile
  float* qe = reinterpret_cast<float*>(ps + BQ * SV);            // BQ x WP: qs . ek
  float* pb = qe + BQ * WP;                                      // BQ x WP: the band's p

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y;
  const int t0 = blockIdx.x * BQ;
  const int tw = t0 + 16 * warp;  // the warp's first row
  const int len = lengths[bh / H];
  const size_t base = (size_t)bh * T * D;

  // qs = bf16(q * bf16(scale)), zero past T
  for (int e = tid; e < BQ * (D / 2); e += WARPS * 32) {
    const int r = e / (D / 2), c = 2 * (e % (D / 2)), t = t0 + r;
    __nv_bfloat162 x = __floats2bfloat162_rn(0.f, 0.f);
    if (t < T) {
      const __nv_bfloat162 qv =
          *reinterpret_cast<const __nv_bfloat162*>(q + base + (size_t)t * D + c);
      x = __floats2bfloat162_rn(__low2float(qv) * scale, __high2float(qv) * scale);
    }
    *reinterpret_cast<__nv_bfloat162*>(qs + r * SD + c) = x;
  }
  __syncthreads();
  // qe[r][m] = bf16(qs_r . ek[m]); pb zero (a band position past the keys)
  for (int e = tid; e < BQ * W; e += WARPS * 32) {
    const int r = e / W, m = e % W;
    float a = 0.f;
    for (int d = 0; d < D; ++d)
      a = fmaf(__bfloat162float(qs[r * SD + d]), __bfloat162float(ek[m * D + d]), a);
    qe[r * WP + m] = rb(a);
    pb[r * WP + m] = 0.f;
  }
  const __nv_bfloat16* qw = qs + 16 * warp * SD;
  const float* qew = qe + 16 * warp * WP;

  auto load_k = [&](int k0) {
    for (int e = tid; e < BK * (D / 8); e += WARPS * 32) {
      const int r = e / (D / 8), c8 = e % (D / 8), j = k0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (j < T) x = __ldg(reinterpret_cast<const uint4*>(k + base + (size_t)j * D) + c8);
      *reinterpret_cast<uint4*>(ks + r * SD + 8 * c8) = x;
    }
  };

  // 1. each row's maximum and sum of exp(s - max), online over the tiles
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // the previous tile is read (and, first, qe is written)
    load_k(k0);
    __syncthreads();
    float sc[BK / 8][4];
    scores<D>(qw, ks, qew, k0, tw, T, len, w, g, t4, sc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = mx[h];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) m = fmaxf(m, fmaxf(sc[nt][2 * h], sc[nt][2 * h + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
        sum += expf(sc[nt][2 * h] - m) + expf(sc[nt][2 * h + 1] - m);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * expf(mx[h] - m) + sum;  // exp(-inf) = 0 on the first tile
      mx[h] = m;
    }
  }

  // 2. p = bf16(exp(s - max) / sum) tile by tile, P.V on the tensor cores
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  __nv_bfloat16* pw = ps + 16 * warp * SV;
  float* pbw = pb + 16 * warp * WP;
  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // the previous tiles are read
    load_k(k0);
    for (int e = tid; e < BK * (D / 4); e += WARPS * 32) {
      const int r = e / (D / 4), c4 = e % (D / 4), j = k0 + r;
      uint2 x = make_uint2(0u, 0u);
      if (j < T) x = __ldg(reinterpret_cast<const uint2*>(v + base + (size_t)j * D) + c4);
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) vt[(4 * c4 + q4) * SV + r] = xv[q4];
    }
    __syncthreads();
    float sc[BK / 8][4];
    scores<D>(qw, ks, qew, k0, tw, T, len, w, g, t4, sc);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h, t = tw + r;
        const int j = k0 + nt * 8 + 2 * t4;
        const float p0 = rb(expf(sc[nt][2 * h] - mx[h]) / l[h]);
        const float p1 = rb(expf(sc[nt][2 * h + 1] - mx[h]) / l[h]);
        *reinterpret_cast<__nv_bfloat162*>(pw + r * SV + nt * 8 + 2 * t4) =
            __floats2bfloat162_rn(p0, p1);
        const int rel = j - t + w;
        if (rel >= 0 && rel < W) pbw[r * WP + rel] = p0;
        if (rel + 1 >= 0 && rel + 1 < W) pbw[r * WP + rel + 1] = p1;
      }
    __syncwarp();  // the warp's p tile is written
    float part[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) part[nt][0] = part[nt][1] = part[nt][2] = part[nt][3] = 0.f;
#pragma unroll
    for (int st = 0; st < BK / 16; ++st) {
      const __nv_bfloat16* ab = pw + g * SV + st * 16 + 4 * t4;
      const uint2 lo = *reinterpret_cast<const uint2*>(ab);
      const uint2 hi = *reinterpret_cast<const uint2*>(ab + 8 * SV);
      const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const uint2 bv = *reinterpret_cast<const uint2*>(vt + (nt * 8 + g) * SV + st * 16 + 4 * t4);
        mma::bf16_16816(part[nt], a, bv.x, bv.y);
      }
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] += part[nt][c];
  }
  __syncwarp();  // the band's p of the warp's rows is written

  // 3. the band's value term and the output
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h, t = tw + r;
      if (t >= T) continue;
      const int c = nt * 8 + 2 * t4;
      float b0 = 0.f, b1 = 0.f;
      for (int m = 0; m < W; ++m) {
        const float pj = pbw[r * WP + m];
        const __nv_bfloat162 e2 = *reinterpret_cast<const __nv_bfloat162*>(ev + m * D + c);
        b0 = fmaf(pj, __low2float(e2), b0);
        b1 = fmaf(pj, __high2float(e2), b1);
      }
      const float y0 = rb(rb(acc[nt][2 * h]) + rb(b0));
      const float y1 = rb(rb(acc[nt][2 * h + 1]) + rb(b1));
      *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)t * D + c) =
          __floats2bfloat162_rn(y0, y1);
    }
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const __nv_bfloat16* ek, const __nv_bfloat16* ev, const int* lengths,
           __nv_bfloat16* out, int B, int H, int T, int w, float scale, cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(banded_attention_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  banded_attention_bf16_kernel<D><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, ek, ev, lengths, out, H, T, w, scale);
  return (int)cudaGetLastError();
}

}  // namespace bfa

// ---- kernel 2 in bfloat16, its keys split over blocks ----
//
// The function of the bf16 kernel above (its rounding unchanged), which is
// kept as rvc_banded_attention_bf16_sync: chip_smoke.py times it beside this
// one (previous_ms), and no path of the port launches it. That kernel ran at
// 58 times its bound: 140 blocks of 4 warps at the 30 s conversion's shapes
// (2, 2, 2178, 96), so a second wave and 4 warps an SM; K and V tiles loaded
// synchronously between barriers; V transposed by 2-byte stores; p through
// shared memory. What bounds it: operations, Q.K^T and P.V, 4 T^2 D flops per
// (batch, head) in one bf16 pass, and the softmax's exponentials. p must be
// rounded after normalisation, so every row's max and sum are needed before
// P.V; given them, P.V over a split of the keys is a plain float32 sum, with
// no rescaling. So three launches:
// 1. stats: a block owns 64 query rows of one (batch, head) and one of S
//    splits of the keys (S chosen so that a launch has about five blocks an
//    SM with at least 4 tiles a split: 700 blocks at these shapes); its 4
//    warps (16 rows each) walk the split's 64-key tiles, K copied by cp.async
//    one tile ahead, and keep each row's running max and sum of e^(s - max);
//    per split and row (m, l);
// 2. P.V: the same grid; a block combines the S splits' (m, l) of its rows
//    in split order (M = max m, L = sum of l e^(m - M)), computes the scores
//    of its split again (the same bits), p = bf16(e^(s - M) / L) (expf and a
//    true division, as the first version and the plain version), keeps the
//    band's p, and adds P.V into float32, each 64-key tile's sum from zero
//    (mma.sync truncates as it accumulates): K and V tiles by cp.async one
//    tile ahead, the B fragments by ldmatrix (V's by ldmatrix.trans, so V is
//    not transposed in memory), p from the score fragments straight into
//    P.V's A fragments in registers. The split's float32 sum goes to scratch;
// 3. combine: out = bf16(bf16(the splits' sums added in split order) +
//    bf16(sum_m p_band[m] ev[m])).
// Q.K^T runs in both of the first two launches: keeping the bf16 scores
// instead would take T^2 x 2 bytes a (batch, head) (9.5 MB at these shapes),
// or in shared memory limit T. The scores are computed as before: q scaled and
// rounded, each product summed in float32 and rounded, the band added and
// rounded, masked entries bf16(-1e4), keys past T no keys; a warp's tile that
// meets no band, mask or key past T only rounds (most tiles), and a block
// whose keys meet no band skips qs . ek. Every sum runs in a fixed order, so
// two calls give the same bits. What holds it back now (chip_smoke, H100 SXM):
// 0.23 ms a layer, 31 times the one-pass bound, at 32 TFLOP/s: 12 warps an
// SM (the P.V launch's 160 registers a thread), and the rounding and the
// expf of every score on the float32 pipes, twice, with a true division in
// P.V (ex2.approx and a reciprocal took 0.20 ms, but round p otherwise).

namespace bfs {

constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;   // query rows a block
constexpr int BK = 64;           // keys a tile
constexpr int WP = 2 * WMAX + 1;
constexpr int TARGET = 5 * 132;  // blocks a launch aims for
constexpr int MIN_TILES = 4;     // key tiles a split takes at least, where T allows
constexpr float NEG = -9984.f;   // bf16(-1e4)

__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// S, the key splits, chosen so that about TARGET blocks run with at least
// MIN_TILES tiles a split, none empty; *per: the key tiles of a split
inline int splits(int BH, int T, int* per) {
  const int n_tiles = (T + BK - 1) / BK, rows = (T + BQ - 1) / BQ;
  int S = (TARGET + rows * BH - 1) / (rows * BH);
  S = S > n_tiles / MIN_TILES ? n_tiles / MIN_TILES : S;
  S = S < 1 ? 1 : S;
  *per = (n_tiles + S - 1) / S;
  return (n_tiles + *per - 1) / *per;
}

// whether keys [k0, k1) meet the band of query rows [t0, t1)
__device__ __forceinline__ bool near_band(int k0, int k1, int t0, int t1, int w) {
  return k0 <= t1 - 1 + w && k1 - 1 >= t0 - w;
}

template <int D>
struct Smem {
  static constexpr int SD = D + 8;  // row pitch (bf16) of the q, k and v tiles: the 8 rows of
                                    // an ldmatrix phase on distinct banks
  static constexpr int TILE = BK * SD;
  // q, qe, then two K tiles (and, for P.V, two V tiles)
  static constexpr int bytes(bool with_v) {
    return BQ * SD * 2 + BQ * WP * 4 + (with_v ? 4 : 2) * TILE * 2;
  }
};

// The block's query rows: qs = bf16(q bf16(scale)) (zero past T) and, if
// `band` (the block's keys meet the rows' band), qe[r][m] = bf16(qs_r . ek[m]);
// by all threads, each followed by the block's barrier.
template <int D>
__device__ __forceinline__ void load_q(const __nv_bfloat16* __restrict__ q,
                                       const __nv_bfloat16* __restrict__ ek, __nv_bfloat16* qs,
                                       float* qe, size_t base, int t0, int T, int W, float scale,
                                       bool band) {
  constexpr int SD = Smem<D>::SD;
  const int tid = threadIdx.x;
  for (int e = tid; e < BQ * (D / 2); e += WARPS * 32) {
    const int r = e / (D / 2), c = 2 * (e % (D / 2)), t = t0 + r;
    __nv_bfloat162 x = __floats2bfloat162_rn(0.f, 0.f);
    if (t < T) {
      const __nv_bfloat162 qv =
          *reinterpret_cast<const __nv_bfloat162*>(q + base + (size_t)t * D + c);
      x = __floats2bfloat162_rn(__low2float(qv) * scale, __high2float(qv) * scale);
    }
    *reinterpret_cast<__nv_bfloat162*>(qs + r * SD + c) = x;
  }
  __syncthreads();
  if (!band) return;
  for (int e = tid; e < BQ * W; e += WARPS * 32) {
    const int r = e / W, m = e % W;
    float a = 0.f;
    for (int d = 0; d < D; d += 2) {
      const float2 x =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qs + r * SD + d));
      const float2 y =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ek + m * D + d));
      a = fmaf(x.x, y.x, a);
      a = fmaf(x.y, y.y, a);
    }
    qe[r * WP + m] = rb(a);
  }
  __syncthreads();
}

// keys k0 .. k0 + BK - 1 of K or V into a tile by cp.async (rows past T zero);
// the caller commits
template <int D>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          __nv_bfloat16* dst, size_t base, int k0, int T) {
  constexpr int SD = Smem<D>::SD;
  for (int e = threadIdx.x; e < BK * (D / 8); e += WARPS * 32) {
    const int r = e / (D / 8), c8 = e % (D / 8), j = k0 + r;
    mma::cp_async16(dst + r * SD + 8 * c8, src + base + (size_t)min(j, T - 1) * D + 8 * c8,
                    j < T ? 16 : 0);
  }
}

// The warp's 16 x BK scores of the key tile at ks (keys k0 ..), rounded, with
// the band and the mask, in the C fragment layout: sc[nt][c] is row g + 8 (c /
// 2), key k0 + 8 nt + 2 t + (c % 2). Keys past T are -inf. qw: the warp's 16
// rows of qs; qew: their qe.
template <int D>
__device__ __forceinline__ void scores(const __nv_bfloat16* qw, const __nv_bfloat16* ks,
                                       const float* qew, int k0, int tw, int T, int len, int w,
                                       int lane, float (&sc)[BK / 8][4]) {
  constexpr int SD = Smem<D>::SD;
  const int g = lane / 4, t4 = lane % 4, W = 2 * w + 1;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
  for (int st = 0; st < D / 16; ++st) {
    uint32_t a[4];
    hop::ldmatrix_x4(a, qw + (lane % 16) * SD + st * 16 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      // keys 16 np + 8 (lane / 16) + lane % 8, d 16 st + 8 ((lane / 8) % 2):
      // the B fragments of n8 tiles 2 np and 2 np + 1
      uint32_t b[4];
      hop::ldmatrix_x4(b, ks + (16 * np + 8 * (lane / 16) + lane % 8) * SD + st * 16 +
                              8 * ((lane / 8) % 2));
      mma::bf16_16816(sc[2 * np], a, b[0], b[1]);
      mma::bf16_16816(sc[2 * np + 1], a, b[2], b[3]);
    }
  }
  if (!near_band(k0, k0 + BK, tw, tw + 16, w) && tw + 16 <= len && k0 + BK <= min(len, T)) {
    // no band, no mask, no key past T in this warp's tile
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[nt][c] = rb(sc[nt][c]);
    return;
  }
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = g + 8 * (c / 2), t = tw + r;
      const int j = k0 + nt * 8 + 2 * t4 + (c % 2);
      float x = rb(sc[nt][c]);
      const int rel = j - t + w;
      if (rel >= 0 && rel < W) x = rb(x + qew[r * WP + rel]);
      if (t >= len || j >= len) x = NEG;
      sc[nt][c] = j < T ? x : -INFINITY;
    }
}

// 1. per split and row, (m, l): the max of the split's scores and the sum of
// e^(s - m)
template <int D>
__global__ void __launch_bounds__(WARPS * 32, 4) attn_stats_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ ek, const int* __restrict__ lengths,
    float2* __restrict__ stats, int H, int T, int w, float scale, int per) {
  using SM = Smem<D>;
  extern __shared__ uint4 smem_s[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_s);
  float* qe = reinterpret_cast<float*>(qs + BQ * SM::SD);
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(qe + BQ * WP);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4;
  const int bh = blockIdx.z, sp = blockIdx.y, S = gridDim.y;
  const int t0 = blockIdx.x * BQ, tw = t0 + 16 * warp;
  const int len = lengths[bh / H];
  const size_t base = (size_t)bh * T * D;
  const int n_tiles = (T + BK - 1) / BK;
  const int it0 = sp * per, it1 = min(n_tiles, it0 + per);
  load_tile<D>(k, kt, base, it0 * BK, T);
  mma::cp_async_commit();
  load_q<D>(q, ek, qs, qe, base, t0, T, 2 * w + 1, scale,
            near_band(it0 * BK, it1 * BK, t0, t0 + BQ, w));
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = it0; it < it1; ++it) {
    const int buf = (it - it0) & 1;
    if (it + 1 < it1) load_tile<D>(k, kt + (buf ^ 1) * SM::TILE, base, (it + 1) * BK, T);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();  // tile it landed for every warp
    float sc[BK / 8][4];
    scores<D>(qs + 16 * warp * SM::SD, kt + buf * SM::TILE, qe + 16 * warp * WP, it * BK, tw, T,
              len, w, lane, sc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = mx[h];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) m = fmaxf(m, fmaxf(sc[nt][2 * h], sc[nt][2 * h + 1]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
        sum += expf(sc[nt][2 * h] - m) + expf(sc[nt][2 * h + 1] - m);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * expf(mx[h] - m) + sum;  // e^-inf = 0 on the first tile
      mx[h] = m;
    }
    __syncthreads();  // every warp is done with tile it before its buffer is refilled
  }
  if (lane % 4 == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = tw + g + 8 * h;
      if (t < T) stats[((size_t)bh * S + sp) * T + t] = make_float2(mx[h], l[h]);
    }
}

// 2. the split's P.V in float32, and the band's p
template <int D>
__global__ void __launch_bounds__(WARPS * 32, 3) attn_pv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ ek,
    const int* __restrict__ lengths, const float2* __restrict__ stats, float* __restrict__ part,
    float* __restrict__ pband, int H, int T, int w, float scale, int per) {
  using SM = Smem<D>;
  constexpr int SD = SM::SD;
  extern __shared__ uint4 smem_p[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_p);
  float* qe = reinterpret_cast<float*>(qs + BQ * SD);
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(qe + BQ * WP);
  __nv_bfloat16* vt = kt + 2 * SM::TILE;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.z, sp = blockIdx.y, S = gridDim.y;
  const int t0 = blockIdx.x * BQ, tw = t0 + 16 * warp;
  const int len = lengths[bh / H], W = 2 * w + 1;
  const size_t base = (size_t)bh * T * D;
  const int n_tiles = (T + BK - 1) / BK;
  const int it0 = sp * per, it1 = min(n_tiles, it0 + per);
  load_tile<D>(k, kt, base, it0 * BK, T);
  load_tile<D>(v, vt, base, it0 * BK, T);
  mma::cp_async_commit();
  load_q<D>(q, ek, qs, qe, base, t0, T, W, scale, near_band(it0 * BK, it1 * BK, t0, t0 + BQ, w));
  // the rows' max and sum over all keys, the splits combined in order
  float M[2], L[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2* st = stats + (size_t)bh * S * T + min(tw + g + 8 * h, T - 1);
    M[h] = -INFINITY;
    for (int s = 0; s < S; ++s) M[h] = fmaxf(M[h], st[(size_t)s * T].x);
    L[h] = 0.f;
    for (int s = 0; s < S; ++s) {
      const float2 ml = st[(size_t)s * T];
      L[h] += ml.y * expf(ml.x - M[h]);
    }
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  for (int it = it0; it < it1; ++it) {
    const int buf = (it - it0) & 1, k0 = it * BK;
    if (it + 1 < it1) {
      load_tile<D>(k, kt + (buf ^ 1) * SM::TILE, base, k0 + BK, T);
      load_tile<D>(v, vt + (buf ^ 1) * SM::TILE, base, k0 + BK, T);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();  // tile it landed for every warp
    float sc[BK / 8][4];
    scores<D>(qs + 16 * warp * SD, kt + buf * SM::TILE, qe + 16 * warp * WP, k0, tw, T, len, w,
              lane, sc);
    // p = bf16(e^(s - M) / L) as P.V's A fragments: pa[kk] covers keys 16 kk ..
    // 16 kk + 15 of the tile (a0a1, a2a3 from n8 tile 2 kk; a4a5, a6a7 from 2 kk + 1)
    uint32_t pa[BK / 16][4];
    const bool band = near_band(k0, k0 + BK, tw, tw + 16, w);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 pp =
            __floats2bfloat162_rn(expf(sc[nt][2 * h] - M[h]) / L[h],
                                  expf(sc[nt][2 * h + 1] - M[h]) / L[h]);
        pa[nt / 2][2 * (nt % 2) + h] = *reinterpret_cast<const uint32_t*>(&pp);
        const int t = tw + g + 8 * h, j = k0 + nt * 8 + 2 * t4, rel = j - t + w;
        if (band && t < T) {
          float* pb = pband + ((size_t)bh * T + t) * WP;
          if (rel >= 0 && rel < W && j < T) pb[rel] = __low2float(pp);
          if (rel + 1 >= 0 && rel + 1 < W && j + 1 < T) pb[rel + 1] = __high2float(pp);
        }
      }
    // P.V of the tile from zero, added into float32
    float pv[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) pv[nd][0] = pv[nd][1] = pv[nd][2] = pv[nd][3] = 0.f;
    const __nv_bfloat16* vb = vt + buf * SM::TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        // keys 16 kk + 8 ((lane / 8) % 2) + lane % 8, d 16 np + 8 (lane / 16),
        // transposed: the B fragments of n8 tiles 2 np and 2 np + 1
        uint32_t b[4];
        hop::ldmatrix_x4_trans(b, vb + (16 * kk + 8 * ((lane / 8) % 2) + lane % 8) * SD +
                                      16 * np + 8 * (lane / 16));
        mma::bf16_16816(pv[2 * np], pa[kk], b[0], b[1]);
        mma::bf16_16816(pv[2 * np + 1], pa[kk], b[2], b[3]);
      }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nd][c] += pv[nd][c];
    __syncthreads();  // every warp is done with tile it before its buffers are refilled
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = tw + g + 8 * h;
    if (t >= T) continue;
    float* dst = part + (((size_t)bh * S + sp) * T + t) * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<float2*>(dst + 8 * nd + 2 * t4) =
          make_float2(acc[nd][2 * h], acc[nd][2 * h + 1]);
  }
}

// 3. out = bf16(bf16(the splits' sums in order) + bf16(sum_m p_band[m] ev[m])),
// a thread per two outputs
template <int D>
__global__ void __launch_bounds__(256) attn_combine_kernel(const float* __restrict__ part,
                                                      const float* __restrict__ pband,
                                                      const __nv_bfloat16* __restrict__ ev,
                                                      __nv_bfloat16* __restrict__ out, int T,
                                                      int w, int S) {
  const int bh = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= T * (D / 2)) return;
  const int t = e / (D / 2), c = 2 * (e % (D / 2)), W = 2 * w + 1;
  float s0 = 0.f, s1 = 0.f;
  for (int s = 0; s < S; ++s) {
    const float2 x = __ldg(
        reinterpret_cast<const float2*>(part + (((size_t)bh * S + s) * T + t) * D + c));
    s0 += x.x;
    s1 += x.y;
  }
  float b0 = 0.f, b1 = 0.f;
  const float* pb = pband + ((size_t)bh * T + t) * WP;
  for (int m = 0; m < W; ++m) {
    const int j = t + m - w;
    if (j < 0 || j >= T) continue;
    const float p = __ldg(pb + m);
    const float2 e2 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ev + m * D + c));
    b0 = fmaf(p, e2.x, b0);
    b1 = fmaf(p, e2.y, b1);
  }
  *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)bh * T + t) * D + c) =
      __floats2bfloat162_rn(rb(rb(s0) + rb(b0)), rb(rb(s1) + rb(b1)));
}

// floats of scratch a call takes: (m, l) and the P.V sums per split and row,
// and the band's p per row
inline long long workspace(int BH, int T, int D) {
  int per;
  const int S = splits(BH, T, &per);
  return (long long)BH * T * (S * (2 + D) + WP);
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const __nv_bfloat16* ek, const __nv_bfloat16* ev, const int* lengths,
           __nv_bfloat16* out, float* work, int B, int H, int T, int w, float scale,
           cudaStream_t stream) {
  if (T == 0 || B * H == 0) return 0;
  int per;
  const int BH = B * H, S = splits(BH, T, &per);
  float2* stats = reinterpret_cast<float2*>(work);
  float* part = work + (size_t)2 * BH * S * T;
  float* pband = part + (size_t)BH * S * T * D;
  constexpr int s_bytes = Smem<D>::bytes(false), p_bytes = Smem<D>::bytes(true);
  cudaError_t err = cudaFuncSetAttribute(attn_stats_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, s_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_pv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_pv_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, S, BH);
  attn_stats_kernel<D><<<grid, WARPS * 32, s_bytes, stream>>>(q, k, ek, lengths, stats, H, T, w,
                                                         scale, per);
  attn_pv_kernel<D><<<grid, WARPS * 32, p_bytes, stream>>>(q, k, v, ek, lengths, stats, part, pband,
                                                      H, T, w, scale, per);
  const dim3 cgrid((T * (D / 2) + 255) / 256, BH);
  attn_combine_kernel<D><<<cgrid, 256, 0, stream>>>(part, pband, ev, out, T, w, S);
  return (int)cudaGetLastError();
}

}  // namespace bfs


// ---- kernel 2 in float32 on the tensor cores (3xTF32) ----
//
// The function of the SIMT kernel above, with QK^T and P.V on mma.sync
// m16n8k8 in 3xTF32 (mma.cuh): each product a_big.b_small + a_small.b_big +
// a_big.b_big, which keeps float32-level error. What bounds it: operations,
// 4 T^2 D multiply-adds per (batch, head), three TF32 passes of them on the
// tensor cores; the SIMT kernel ran them on the float32 pipes at about a
// sixth of even those pipes' rate. Design:
// - 16 query rows a warp; a block is 32 rows (two row groups) and the keys
//   split into two halves, each walked by its own pair of warps: 4 warps a
//   block, 276 blocks at the 30 s conversion's shapes, (2, 2, 2178, 96),
//   where 64 rows a block gave 136 for 132 SMs; with 74 KB of shared memory
//   (D = 96) three blocks fit an SM, so every block runs at once and an SM
//   holds 8 to 12 warps to hide each other's latencies. At the end the
//   second half's running max, sum and P.V sum join the first's in that
//   order (a fixed-order combine in shared memory);
// - K and V tiles of 16 keys, copied by cp.async into shared memory for the
//   half's two warps, double-buffered (the next tile's copies run under this
//   tile's products);
// - one pass with an online softmax per half (float32 need not round p
//   before P.V): the scores stay in the mma C fragments; p is split and fed
//   back as the A fragment of P.V with the keys of a k8 step relabelled
//   (k t <-> key 2t, k t + 4 <-> key 2t + 1), so that a C fragment is an A
//   fragment, and V's B fragment reads the same keys. Q and K are relabelled
//   alike within 8 of D (k t <-> d 2t, k t + 4 <-> d 2t + 1), so each
//   fragment is one 8-byte load;
// - mma.sync truncates as it accumulates (mma.cuh), so each 8 of D of a
//   score and each tile's P.V sum start from zero in fragments and are
//   added into float32 registers;
// - the band and the mask as in the SIMT kernel: the finite -1e4, no tile
//   skipped, the raw band scores kept per row and normalised after the last
//   tile for the value-side band term.
// Not on wgmma: its 64 rows a warpgroup would give a block at least 64
// query rows, 136 blocks for 132 SMs at these shapes, so a second wave of 4
// blocks after a first of one block an SM.

namespace tfa {

constexpr int ROWS = 2;             // warps along the query rows, 16 rows each
constexpr int HALVES = 2;           // key halves, each walked by ROWS warps
constexpr int WARPS = ROWS * HALVES;
constexpr int BQ = 16 * ROWS;       // query rows per block
constexpr int BK = 16;              // keys per tile
constexpr int WP = 2 * WMAX + 1;

template <int D>
struct Smem {
  static constexpr int SQ = D + 8;  // pitch of q and k rows (floats): = 8 mod 32, so the
                                    // 8-byte loads of a half warp hit distinct banks
  static constexpr int SV = D + 4;  // pitch of v rows: = 4 mod 32, so keys 2t (t < 4) of
                                    // columns g (g < 8) hit distinct banks
  static constexpr int KV = 2 * BK * (SQ + SV);  // a key half's two K and V tiles
  static constexpr int BYTES = (BQ * SQ + HALVES * KV + 2 * BQ * WP) * 4;
};

template <int D>
__global__ void __launch_bounds__(WARPS * 32) banded_attention_tc_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ ek, const float* __restrict__ ev, const int* __restrict__ lengths,
    float* __restrict__ out, int H, int T, int w, float scale) {
  using SM = Smem<D>;
  constexpr int SQ = SM::SQ, SV = SM::SV, NT = BK / 8, DT = D / 8;
  const int W = 2 * w + 1;
  extern __shared__ float4 smem_t[];
  float* qs = reinterpret_cast<float*>(smem_t);  // BQ x SQ: q * scale
  float* kv = qs + BQ * SQ;                      // per half: 2 K tiles, 2 V tiles
  float* qe = kv + HALVES * SM::KV;              // BQ x WP: qs . ek
  float* band = qe + BQ * WP;                    // BQ x WP: raw band scores, then their p

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rg = warp % ROWS, hf = warp / ROWS;  // row group, key half
  const int htid = tid % (ROWS * 32);            // thread of the half
  const int bh = blockIdx.y;
  const int t0 = blockIdx.x * BQ;
  const int tw = t0 + 16 * rg;  // the warp's first row
  const int len = lengths[bh / H];
  const size_t base = (size_t)bh * T * D;
  float* ks = kv + hf * SM::KV;  // this half's K tiles, then its V tiles
  float* vs = ks + 2 * BK * SQ;

  auto load_kv = [&](int k0, int buf) {  // by the half's threads; keys past T read as zero
    float* kd = ks + buf * BK * SQ;
    float* vd = vs + buf * BK * SV;
    for (int e = htid; e < BK * (D / 4); e += ROWS * 32) {
      const int r = e / (D / 4), c4 = e % (D / 4), j = k0 + r;
      const size_t src = base + (size_t)min(j, T - 1) * D + 4 * c4;
      mma::cp_async16(kd + r * SQ + 4 * c4, k + src, j < T ? 16 : 0);
      mma::cp_async16(vd + r * SV + 4 * c4, v + src, j < T ? 16 : 0);
    }
    mma::cp_async_commit();
  };

  // the key tiles of this half: the first ceil(n / 2) tiles, or the rest
  const int n_tiles = (T + BK - 1) / BK, per_half = (n_tiles + 1) / 2;
  const int it0 = hf * per_half, it1 = min(n_tiles, it0 + per_half);
  if (it0 < it1) load_kv(it0 * BK, 0);
  for (int e = tid; e < BQ * (D / 4); e += WARPS * 32) {
    const int r = e / (D / 4), c4 = e % (D / 4), t = t0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) {
      x = __ldg(reinterpret_cast<const float4*>(q + base + (size_t)t * D) + c4);
      x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
    *reinterpret_cast<float4*>(qs + r * SQ + 4 * c4) = x;
  }
  __syncthreads();
  for (int e = tid; e < BQ * W; e += WARPS * 32) {
    const int r = e / W, m = e % W;
    float a = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qs + r * SQ + d);
      const float4 y = __ldg(reinterpret_cast<const float4*>(ek + m * D + d));
      a = fmaf(x.x, y.x, a); a = fmaf(x.y, y.y, a);
      a = fmaf(x.z, y.z, a); a = fmaf(x.w, y.w, a);
    }
    qe[r * WP + m] = a;
    band[r * WP + m] = -INFINITY;
  }
  __syncthreads();

  const float* qw = qs + 16 * rg * SQ;
  const float* qew = qe + 16 * rg * WP;
  float* bw = band + 16 * rg * WP;
  float acc[DT][4];
#pragma unroll
  for (int nd = 0; nd < DT; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int it = it0; it < it1; ++it) {
    const int k0 = it * BK, buf = (it - it0) & 1;
    mma::cp_async_wait<0>();
    // tile it landed for the half, and its warps are done with tile it - 1
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + hf), "n"(ROWS * 32) : "memory");
    if (it + 1 < it1) load_kv(k0 + BK, buf ^ 1);
    const float* kt = ks + buf * BK * SQ;
    const float* vt = vs + buf * BK * SV;

    // the warp's 16 x BK scores: sc[nt][c] is row g + 8 (c / 2), key
    // k0 + 8 nt + 2 t4 + (c % 2)
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int s0 = 0; s0 < DT; s0 += 2) {
      // k8 steps s0 and s0 + 1 into two partial sums, so that 2 NT
      // independent sums are in flight
      float part[2][NT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          part[h][nt][0] = part[h][nt][1] = part[h][nt][2] = part[h][nt][3] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int st = s0 + h;
        const float2 lo = *reinterpret_cast<const float2*>(qw + g * SQ + 8 * st + 2 * t4);
        const float2 hi = *reinterpret_cast<const float2*>(qw + (g + 8) * SQ + 8 * st + 2 * t4);
        uint32_t ab[4], as[4];
        mma::split_tf32(lo.x, ab[0], as[0]);  // (row g,     k t)     = d 8 st + 2 t4
        mma::split_tf32(hi.x, ab[1], as[1]);  // (row g + 8, k t)
        mma::split_tf32(lo.y, ab[2], as[2]);  // (row g,     k t + 4) = d 8 st + 2 t4 + 1
        mma::split_tf32(hi.y, ab[3], as[3]);  // (row g + 8, k t + 4)
        uint32_t kb[NT][2], ksm[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 kx =
              *reinterpret_cast<const float2*>(kt + (8 * nt + g) * SQ + 8 * st + 2 * t4);
          mma::split_tf32(kx.x, kb[nt][0], ksm[nt][0]);
          mma::split_tf32(kx.y, kb[nt][1], ksm[nt][1]);
        }
        // small products first; consecutive products update different sums
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma::tf32_1688(part[h][nt], ab, ksm[nt][0], ksm[nt][1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma::tf32_1688(part[h][nt], as, kb[nt][0], kb[nt][1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma::tf32_1688(part[h][nt], ab, kb[nt][0], kb[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[nt][c] = (sc[nt][c] + part[0][nt][c]) + part[1][nt][c];
    }

    // the band, the mask; keys past T are no keys (-inf)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = g + 8 * (c / 2), t = tw + r;
        const int j = k0 + 8 * nt + 2 * t4 + (c % 2);
        float x = sc[nt][c];
        const int rel = j - t + w;
        const bool in_band = rel >= 0 && rel < W;
        if (in_band) x += qew[r * WP + rel];
        if (t >= len || j >= len) x = -1e4f;
        if (j >= T) x = -INFINITY;
        else if (in_band) bw[r * WP + rel] = x;
        sc[nt][c] = x;
      }

    // online softmax: the rows' new maxima, the rescale, p = exp(s - max)
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m_run[h];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * h], sc[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[h] = expf(m_run[h] - mx);  // 0 on the half's first tile
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        sc[nt][2 * h] = expf(sc[nt][2 * h] - mx);
        sc[nt][2 * h + 1] = expf(sc[nt][2 * h + 1] - mx);
        sum += sc[nt][2 * h] + sc[nt][2 * h + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[h] = l_run[h] * alpha[h] + sum;
      m_run[h] = mx;
    }

    // P.V: k8 step s is the keys of score tile s; its C fragment is P's A
    // fragment with k t <-> key 2 t4, k t + 4 <-> key 2 t4 + 1
    float pv[DT][4];
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) pv[nd][0] = pv[nd][1] = pv[nd][2] = pv[nd][3] = 0.f;
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      uint32_t pb[4], ps[4];
      mma::split_tf32(sc[s][0], pb[0], ps[0]);  // (row g,     key 8 s + 2 t4)
      mma::split_tf32(sc[s][2], pb[1], ps[1]);  // (row g + 8, key 8 s + 2 t4)
      mma::split_tf32(sc[s][1], pb[2], ps[2]);  // (row g,     key 8 s + 2 t4 + 1)
      mma::split_tf32(sc[s][3], pb[3], ps[3]);  // (row g + 8, key 8 s + 2 t4 + 1)
      const float* v0 = vt + (8 * s + 2 * t4) * SV + g;
#pragma unroll
      for (int nd = 0; nd < DT; ++nd) {
        uint32_t vb0, vs0, vb1, vs1;
        mma::split_tf32(v0[8 * nd], vb0, vs0);
        mma::split_tf32(v0[SV + 8 * nd], vb1, vs1);
        mma::tf32_1688(pv[nd], pb, vs0, vs1);
        mma::tf32_1688(pv[nd], ps, vb0, vb1);
        mma::tf32_1688(pv[nd], pb, vb0, vb1);
      }
    }
#pragma unroll
    for (int nd = 0; nd < DT; ++nd)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nd][c] = acc[nd][c] * alpha[c / 2] + pv[nd][c];
  }

  // the second half hands its rows' max, sum and P.V sum to the first
  // (through its K and V tiles, free now), which combines them in that
  // order: M = max(m0, m1), l = l0 e^(m0 - M) + l1 e^(m1 - M), likewise acc
  __syncthreads();
  float* xm = kv + SM::KV + rg * 16 * (D + 2);  // rows of the row group: m, l, acc[D]
  if (hf == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = xm + (g + 8 * h) * (D + 2);
      if (t4 == 0) {
        row[0] = m_run[h];
        row[1] = l_run[h];
      }
#pragma unroll
      for (int nd = 0; nd < DT; ++nd)
        *reinterpret_cast<float2*>(row + 2 + 8 * nd + 2 * t4) =
            make_float2(acc[nd][2 * h], acc[nd][2 * h + 1]);
    }
  }
  __syncthreads();
  if (hf == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* row = xm + (g + 8 * h) * (D + 2);
    const float m1 = row[0], l1 = row[1];
    const float mx = fmaxf(m_run[h], m1);
    const float a0 = expf(m_run[h] - mx), a1 = expf(m1 - mx);  // 0 for a half with no keys
    l_run[h] = l_run[h] * a0 + l1 * a1;
    m_run[h] = mx;
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) {
      const float2 o = *reinterpret_cast<const float2*>(row + 2 + 8 * nd + 2 * t4);
      acc[nd][2 * h] = acc[nd][2 * h] * a0 + o.x * a1;
      acc[nd][2 * h + 1] = acc[nd][2 * h + 1] * a0 + o.y * a1;
    }
  }

  // out = acc / l + sum_m p_band[m] ev[m], p_band normalised with the final
  // max and sum; the warp's rows of the band are its own now
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    const float inv_l = 1.f / l_run[h];
    for (int m = t4; m < W; m += 4) bw[r * WP + m] = expf(bw[r * WP + m] - m_run[h]) * inv_l;
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h, t = tw + r;
    if (t >= T) continue;
    const float inv_l = 1.f / l_run[h];
#pragma unroll
    for (int nd = 0; nd < DT; ++nd) {
      const int c = 8 * nd + 2 * t4;
      float o0 = acc[nd][2 * h] * inv_l, o1 = acc[nd][2 * h + 1] * inv_l;
      for (int m = 0; m < W; ++m) {
        const float p = bw[r * WP + m];
        const float2 e2 = __ldg(reinterpret_cast<const float2*>(ev + m * D + c));
        o0 = fmaf(p, e2.x, o0);
        o1 = fmaf(p, e2.y, o1);
      }
      *reinterpret_cast<float2*>(out + base + (size_t)t * D + c) = make_float2(o0, o1);
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* ek, const float* ev,
           const int* lengths, float* out, int B, int H, int T, int w, float scale,
           cudaStream_t stream) {
  constexpr int smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(banded_attention_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  banded_attention_tc_kernel<D><<<grid, WARPS * 32, smem, stream>>>(q, k, v, ek, ev, lengths,
                                                                    out, H, T, w, scale);
  return (int)cudaGetLastError();
}

}  // namespace tfa

}  // namespace

// Kernel 2 in bf16. q, k, v, out: (B, H, T, D) bf16; ek, ev: (2w+1, D) bf16;
// lengths: (B,) int32; scale: bf16(scale); work: the floats that
// rvc_banded_attention_bf16_workspace gives. D must be 32, 64, 96 or 128 and
// w at most 16 (the wrapper checks). Three launches on `stream`.
extern "C" long long rvc_banded_attention_bf16_workspace(int B, int H, int T, int D) {
  return bfs::workspace(B * H, T, D);
}

extern "C" int rvc_banded_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* ek, const void* ev,
                                         const void* lengths, void* out, void* work,
                                         int B, int H, int T, int D, int w, float scale,
                                         void* stream) {
  using bf = __nv_bfloat16;
  const bf* qh = (const bf*)q;
  const bf* kh = (const bf*)k;
  const bf* vh = (const bf*)v;
  const bf* ekh = (const bf*)ek;
  const bf* evh = (const bf*)ev;
  const int* lens = (const int*)lengths;
  bf* o = (bf*)out;
  float* wf = (float*)work;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return bfs::launch<32>(qh, kh, vh, ekh, evh, lens, o, wf, B, H, T, w, scale, s);
    case 64:
      return bfs::launch<64>(qh, kh, vh, ekh, evh, lens, o, wf, B, H, T, w, scale, s);
    case 96:
      return bfs::launch<96>(qh, kh, vh, ekh, evh, lens, o, wf, B, H, T, w, scale, s);
    case 128:
      return bfs::launch<128>(qh, kh, vh, ekh, evh, lens, o, wf, B, H, T, w, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel 2 in bf16's first version (namespace bfa), the yardstick of the
// kernel above; launched only by chip_smoke.py. Arguments as above, without
// the scratch.
extern "C" int rvc_banded_attention_bf16_sync(const void* q, const void* k, const void* v,
                                              const void* ek, const void* ev,
                                              const void* lengths, void* out, int B,
                                              int H, int T, int D, int w, float scale,
                                              void* stream) {
  using bf = __nv_bfloat16;
  const bf* qh = (const bf*)q;
  const bf* kh = (const bf*)k;
  const bf* vh = (const bf*)v;
  const bf* ekh = (const bf*)ek;
  const bf* evh = (const bf*)ev;
  const int* lens = (const int*)lengths;
  bf* o = (bf*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return bfa::launch<32>(qh, kh, vh, ekh, evh, lens, o, B, H, T, w, scale, s);
    case 64: return bfa::launch<64>(qh, kh, vh, ekh, evh, lens, o, B, H, T, w, scale, s);
    case 96: return bfa::launch<96>(qh, kh, vh, ekh, evh, lens, o, B, H, T, w, scale, s);
    case 128: return bfa::launch<128>(qh, kh, vh, ekh, evh, lens, o, B, H, T, w, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel 2 in float32 on the tensor cores. q, k, v, out: (B, H, T, D)
// float32; ek, ev: (2w+1, D); lengths: (B,) int32. D must be 32, 64, 96 or
// 128 and w at most 16 (the wrapper checks).
extern "C" int rvc_banded_attention(const void* q, const void* k, const void* v,
                                    const void* ek, const void* ev,
                                    const void* lengths, void* out, int B,
                                    int H, int T, int D, int w, float scale,
                                    void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* ekf = (const float*)ek;
  const float* evf = (const float*)ev;
  const int* lens = (const int*)lengths;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return tfa::launch<32>(qf, kf, vf, ekf, evf, lens, o, B, H, T, w, scale, s);
    case 64: return tfa::launch<64>(qf, kf, vf, ekf, evf, lens, o, B, H, T, w, scale, s);
    case 96: return tfa::launch<96>(qf, kf, vf, ekf, evf, lens, o, B, H, T, w, scale, s);
    case 128: return tfa::launch<128>(qf, kf, vf, ekf, evf, lens, o, B, H, T, w, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The SIMT kernel 2 (the yardstick): the same arguments and function.
extern "C" int rvc_banded_attention_simt(const void* q, const void* k, const void* v,
                                         const void* ek, const void* ev,
                                         const void* lengths, void* out, int B,
                                         int H, int T, int D, int w, float scale,
                                         void* stream) {
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* ekf = (const float*)ek;
  const float* evf = (const float*)ev;
  const int* lens = (const int*)lengths;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<1>(qf, kf, vf, ekf, evf, lens, o, B, H, T, w, scale, s);
    case 64: return launch<2>(qf, kf, vf, ekf, evf, lens, o, B, H, T, w, scale, s);
    case 96: return launch<3>(qf, kf, vf, ekf, evf, lens, o, B, H, T, w, scale, s);
    case 128: return launch<4>(qf, kf, vf, ekf, evf, lens, o, B, H, T, w, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
