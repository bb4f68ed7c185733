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
// q, k, v and out. Design: one block per 32 query rows of one (batch, head),
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

// ---- kernel 2 in bfloat16 ----
//
// The same function as banded_rel_attention computes it in bfloat16
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

}  // namespace

// Kernel 2 in bf16. q, k, v, out: (B, H, T, D) bf16; ek, ev: (2w+1, D) bf16;
// lengths: (B,) int32; scale: bf16(scale). D must be 32, 64, 96 or 128 and w
// at most 16 (the wrapper checks).
extern "C" int rvc_banded_attention_bf16(const void* q, const void* k, const void* v,
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

// q, k, v, out: (B, H, T, D) float32; ek, ev: (2w+1, D); lengths: (B,) int32.
// D must be 32, 64, 96 or 128 and w at most 16 (the wrapper checks).
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
    case 32: return launch<1>(qf, kf, vf, ekf, evf, lens, o, B, H, T, w, scale, s);
    case 64: return launch<2>(qf, kf, vf, ekf, evf, lens, o, B, H, T, w, scale, s);
    case 96: return launch<3>(qf, kf, vf, ekf, evf, lens, o, B, H, T, w, scale, s);
    case 128: return launch<4>(qf, kf, vf, ekf, evf, lens, o, B, H, T, w, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
