// Nearest bank row for each query (squared L2), float32 arithmetic, sm_90a.
//
// Replaces rvc_tpu/ops/pallas_retrieval.py::_nearest_idx (body
// _argmin_kernel), reached from nearest_rows_q (int8 bank with per-row
// scales) and nearest_rows (float32 bank). For query q and bank row n with
// dequantization scale s_n (1 for a float32 bank):
//     d[q, n] = |b_n|^2 s_n^2 - 2 s_n (q . b_n)
// The winner is the least d, the lowest n on ties; rows past N never win.
// The winning rows are then gathered and dequantized.
//
// What bounds it: operations. 2*NQ*N*D flops against N*D bytes of bank
// (int8) read once: at the main path's 131072 x 768 bank and ~10^3 queries
// that is ~2000 flops per byte. The queries stay float32 and the int8
// values are converted to float32 in shared memory; the product runs on the
// float32 pipes (67 TFLOP/s). Design: a block holds 32 queries in shared
// memory and walks one slice of the bank in tiles of 128 rows x 32 columns,
// each thread keeping a 4 x 4 block of dot products and its best (d, n) for
// its 4 queries. The TPU carried the running minimum along a sequential
// grid; here the bank is split over blocks that run in any order, so each
// block folds its best into a 64-bit atomicMin on (ordered bits of d, n),
// which keeps the least distance and, on ties, the lowest index.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TQ = 32;    // queries per block
constexpr int TN = 128;   // bank rows per tile
constexpr int KCH = 32;   // columns per tile
constexpr int SB = KCH + 4;

__device__ __forceinline__ unsigned int ordered(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// |b_n|^2 s_n^2, one warp per row
template <typename BT>
__global__ void sqnorm_kernel(const BT* __restrict__ bank,
                              const float* __restrict__ scales,
                              float* __restrict__ bsq, int N, int D) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= N) return;
  const BT* row = bank + (size_t)warp * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float x = (float)row[d];
    s = fmaf(x, x, s);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) {
    const float sc = scales ? scales[warp] : 1.f;
    bsq[warp] = s * sc * sc;
  }
}

__global__ void init_keys_kernel(unsigned long long* keys, int NQ) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < NQ) keys[i] = ~0ull;
}

// 16 bank values of one row (columns c0 .. c0+15) as float
__device__ __forceinline__ void load16(const int8_t* p, float* dst) {
  const int4 raw = __ldg(reinterpret_cast<const int4*>(p));
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = (float)b[i];
}
__device__ __forceinline__ void load16(const float* p, float* dst) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    dst[4 * i] = v.x; dst[4 * i + 1] = v.y; dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
  }
}

template <typename BT>
__global__ void __launch_bounds__(THREADS) argmin_kernel(
    const float* __restrict__ q, const BT* __restrict__ bank,
    const float* __restrict__ scales, const float* __restrict__ bsq,
    unsigned long long* __restrict__ keys, int NQ, int N, int D,
    int tiles_per_block) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // TQ x (D + 4)
  float* bs = qs + TQ * (D + 4);                // TN x SB
  const int SQ = D + 4;
  const int tid = threadIdx.x;
  const int ty = tid / 32, tx = tid % 32;  // queries 4*ty..+3; rows tx + 32*c
  const int q0 = blockIdx.x * TQ;
  const int D4 = D / 4;

  for (int e = tid; e < TQ * D4; e += THREADS) {
    const int r = e / D4, c4 = e % D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < NQ) x = __ldg(reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * D) + c4);
    *reinterpret_cast<float4*>(qs + r * SQ + 4 * c4) = x;
  }

  float best_d[4];
  int best_n[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { best_d[i] = 0.f; best_n[i] = -1; }

  const int n_tiles = (N + TN - 1) / TN;
  const int tile_lo = blockIdx.y * tiles_per_block;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_block);
  const int ld_row = tid / 2, ld_half = tid % 2;  // this thread's 16 values
  const int nk = D / KCH;
  float pf[16];

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int n0 = tile * TN;
    const bool ld_ok = n0 + ld_row < N;
    const BT* ld_src = bank + (size_t)(n0 + ld_row) * D + ld_half * 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

    if (ld_ok) load16(ld_src, pf);
    for (int kc = 0; kc < nk; ++kc) {
      __syncthreads();  // previous chunk consumed (and the query tile stored)
      float* dst = bs + ld_row * SB + ld_half * 16;
#pragma unroll
      for (int i = 0; i < 16; i += 4)
        *reinterpret_cast<float4*>(dst + i) =
            ld_ok ? make_float4(pf[i], pf[i + 1], pf[i + 2], pf[i + 3])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();
      if (kc + 1 < nk && ld_ok) load16(ld_src + (kc + 1) * KCH, pf);
      const float* qa = qs + (4 * ty) * SQ + kc * KCH;
#pragma unroll
      for (int kk = 0; kk < KCH; kk += 4) {
        float4 a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(qa + i * SQ + kk);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          bb[c] = *reinterpret_cast<const float4*>(bs + (tx + 32 * c) * SB + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[i][c] = fmaf(a[i].x, bb[c].x, acc[i][c]);
            acc[i][c] = fmaf(a[i].y, bb[c].y, acc[i][c]);
            acc[i][c] = fmaf(a[i].z, bb[c].z, acc[i][c]);
            acc[i][c] = fmaf(a[i].w, bb[c].w, acc[i][c]);
          }
      }
    }
    // rows ascend within a thread, so a strict < keeps the lowest index
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 32 * c;
      if (n >= N) continue;
      const float sc = scales ? __ldg(scales + n) : 1.f;
      const float bq = __ldg(bsq + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = bq - 2.f * (acc[i][c] * sc);
        if (best_n[i] < 0 || d < best_d[i]) { best_d[i] = d; best_n[i] = n; }
      }
    }
  }

  // fold the 32 lanes' bests for each of this warp's 4 queries
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned long long key = best_n[i] < 0
        ? ~0ull
        : ((unsigned long long)ordered(best_d[i]) << 32) | (unsigned int)best_n[i];
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
      key = other < key ? other : key;
    }
    const int qi = q0 + 4 * ty + i;
    if (tx == 0 && qi < NQ && key != ~0ull) atomicMin(keys + qi, key);
  }
}

// out[q, :] = bank[n_q, :] * s_n, with n_q the low 32 bits of keys[q]
template <typename BT>
__global__ void gather_kernel(const unsigned long long* __restrict__ keys,
                              const BT* __restrict__ bank,
                              const float* __restrict__ scales,
                              float* __restrict__ out, int NQ, int D) {
  const int qi = blockIdx.x;
  const unsigned int n = (unsigned int)(keys[qi] & 0xffffffffull);
  const float sc = scales ? scales[n] : 1.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    out[(size_t)qi * D + d] = (float)bank[(size_t)n * D + d] * sc;
}

template <typename BT>
int launch(const float* q, const BT* bank, const float* scales, float* bsq,
           unsigned long long* keys, float* out, int NQ, int N, int D,
           int n_split, cudaStream_t stream) {
  sqnorm_kernel<BT><<<(N * 32 + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      bank, scales, bsq, N, D);
  init_keys_kernel<<<(NQ + THREADS - 1) / THREADS, THREADS, 0, stream>>>(keys, NQ);
  const int n_tiles = (N + TN - 1) / TN;
  const int per = (n_tiles + n_split - 1) / n_split;
  const int smem = (TQ * (D + 4) + TN * SB) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      argmin_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((NQ + TQ - 1) / TQ, (n_tiles + per - 1) / per);
  argmin_kernel<BT><<<grid, THREADS, smem, stream>>>(q, bank, scales, bsq, keys,
                                                     NQ, N, D, per);
  gather_kernel<BT><<<NQ, 256, 0, stream>>>(keys, bank, scales, out, NQ, D);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (NQ, D) float32; bank: (N, D) int8 (with scales (N,)) or float32
// (scales null); bsq: (N,) and keys: (NQ,) uint64 scratch; out: (NQ, D).
// D must be a multiple of 32 (the wrapper checks).
extern "C" int rvc_nearest_rows(const void* q, const void* bank, int bank_int8,
                                const void* scales, void* bsq, void* keys,
                                void* out, int NQ, int N, int D, int n_split,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bank_int8)
    return launch<int8_t>((const float*)q, (const int8_t*)bank,
                          (const float*)scales, (float*)bsq,
                          (unsigned long long*)keys, (float*)out, NQ, N, D,
                          n_split, s);
  return launch<float>((const float*)q, (const float*)bank, nullptr,
                       (float*)bsq, (unsigned long long*)keys, (float*)out, NQ,
                       N, D, n_split, s);
}
