// Nearest bank row for each query (squared L2), on the tensor cores, sm_90a.
//
// Replaces rvc_tpu/ops/pallas_retrieval.py::_nearest_idx (body
// _argmin_kernel), reached from nearest_rows_q (int8 bank with per-row
// scales) and nearest_rows (float32 bank). For query q and bank row n with
// dequantization scale s_n (1 for a float32 bank):
//     d[q, n] = |b_n|^2 s_n^2 - 2 s_n (q . b_n)
// The winner is the least d, the lowest n on ties; rows past N never win.
// The winning rows are then gathered and dequantized.
//
// What bounds it: operations. 2*NQ*N*D multiply-adds against N*D bytes of
// int8 bank read once: at the main path's 131072 x 768 bank and ~2*10^3
// queries, ~4000 operations per byte. The dot products run on the tensor
// cores in bf16 with float32 accumulation, as the TPU kernel ran them on its
// MXU (mma.cuh has the arithmetic):
//   - int8 bank: each query element is split into three bf16 pieces
//     (hi + mid + lo, exact) and each int8 bank value converted to bf16
//     (exact), so the three products q_hi.b + q_mid.b + q_lo.b give every
//     product exactly (the TPU kernel used two pieces). Their sums are not
//     a float32 GEMM's: mma.sync adds into its accumulator with truncation,
//     and the D products of a bank tile chain into one accumulator. At the
//     main path's D = 768 that drift left every row identical to the plain
//     version's (chip_smoke phase 3); promoting each K-chunk's sum into
//     float32 registers, as kernel 1 does, is the remedy if it ever shows.
//     Bound: three bf16 passes, 3 x 2 NQ N D at 989 TFLOP/s.
//   - float32 bank: both operands split into three pieces and six products
//     kept (hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi): every term down to
//     2^-16 of the product, the dropped ones at most ~2^-24 each, float32's
//     own rounding.
// Design: a block owns 128 queries and walks one slice of the bank in tiles
// of 128 rows, 32 columns at a time, through a ring of STAGES cp.async
// stages in shared memory (float32 queries, int8 or float32 bank rows). Its
// eight warps each hold a 32-query x 64-row tile of sums in mma fragments;
// the queries are split into bf16 pieces in registers as they are read
// (once per warp and step, reused against 8 bank fragments). At the end of
// each bank tile every thread folds its distances into a running (d, n) per
// query in registers. The TPU carried the running minimum along a sequential
// grid; here the bank is split over blocks that run in any order, so each
// block ends in a 64-bit atomicMin on (ordered bits of d, n), which keeps the
// least distance and, on ties, the lowest index.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 128;    // queries per block
constexpr int BN = 128;    // bank rows per tile
constexpr int KC = 32;     // columns per stage
constexpr int STAGES = 4;  // cp.async ring depth
constexpr int MT = 2;      // m16 tiles (queries) per warp: warps 4 (queries) x 2 (rows)
constexpr int NT = 8;      // n8 tiles (bank rows) per warp
constexpr int Q_BYTES = BQ * KC * 4;  // a stage's query tile, float32
constexpr int I8_PITCH = KC + 16;     // an int8 bank row in shared memory: 48 bytes
                                      // keeps a warp's 8 rows on distinct banks

template <typename BT>
__host__ __device__ constexpr int bank_stage_bytes() {
  return sizeof(BT) == 1 ? BN * I8_PITCH : BN * KC * 4;
}
template <typename BT>
__host__ __device__ constexpr int stage_bytes() {
  return Q_BYTES + bank_stage_bytes<BT>();
}

__device__ __forceinline__ unsigned int ordered(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A float32 row of KC = 32 values is 8 chunks of 16 bytes; chunk c of row r
// is stored at c ^ (4 (r & 1)), so the two rows that a quarter-warp reads
// together fall on distinct banks.
__device__ __forceinline__ int swz(int r, int c) { return r * (KC / 4) + (c ^ ((r & 1) << 2)); }

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

// One stage: the block's queries and one bank tile, columns kc*KC .. +KC.
template <typename BT>
__device__ __forceinline__ void load_stage(char* stage, const float* __restrict__ q,
                                           const BT* __restrict__ bank, int q0, int n0,
                                           int kc, int NQ, int N, int D, int tid) {
  float4* qs = reinterpret_cast<float4*>(stage);
#pragma unroll
  for (int p = 0; p < BQ * KC / 4 / THREADS; ++p) {
    const int e = tid + p * THREADS, r = e / (KC / 4), c = e % (KC / 4);
    const bool ok = q0 + r < NQ;
    mma::cp_async16(qs + swz(r, c), q + (size_t)(ok ? q0 + r : 0) * D + kc * KC + 4 * c,
                    ok ? 16 : 0);
  }
  char* bs = stage + Q_BYTES;
  if constexpr (sizeof(BT) == 1) {
    // 128 rows x 2 chunks of 16 bytes: one copy a thread
    const int r = tid / 2, c = tid % 2;
    const bool ok = n0 + r < N;
    mma::cp_async16(bs + r * I8_PITCH + 16 * c,
                    bank + (size_t)(ok ? n0 + r : 0) * D + kc * KC + 16 * c, ok ? 16 : 0);
  } else {
    float4* b4 = reinterpret_cast<float4*>(bs);
#pragma unroll
    for (int p = 0; p < BN * KC / 4 / THREADS; ++p) {
      const int e = tid + p * THREADS, r = e / (KC / 4), c = e % (KC / 4);
      const bool ok = n0 + r < N;
      mma::cp_async16(b4 + swz(r, c), bank + (size_t)(ok ? n0 + r : 0) * D + kc * KC + 4 * c,
                      ok ? 16 : 0);
    }
  }
}

template <typename BT>
__global__ void __launch_bounds__(THREADS, 1) argmin_mma_kernel(
    const float* __restrict__ q, const BT* __restrict__ bank,
    const float* __restrict__ scales, const float* __restrict__ bsq,
    unsigned long long* __restrict__ keys, int NQ, int N, int D,
    int tiles_per_block) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;  // queries wm*32.., bank rows wn*64..
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (N + BN - 1) / BN;
  const int tile_lo = blockIdx.y * tiles_per_block;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_block);
  const int nk = D / KC;
  const int iters = max(0, tile_hi - tile_lo) * nk;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  float best_d[2 * MT];
  int best_n[2 * MT];
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) { best_d[i] = 0.f; best_n[i] = -1; }

  auto load = [&](int it) {
    if (it < iters)
      load_stage<BT>(smem + (it % STAGES) * stage_bytes<BT>(), q, bank, q0,
                     (tile_lo + it / nk) * BN, it % nk, NQ, N, D, tid);
    mma::cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);

  for (int it = 0; it < iters; ++it) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it landed for every thread; stage it-1 is free
    load(it + STAGES - 1);
    const char* stage = smem + (it % STAGES) * stage_bytes<BT>();
    const float4* qs = reinterpret_cast<const float4*>(stage);
    const char* bs = stage + Q_BYTES;
#pragma unroll
    for (int s = 0; s < KC / 16; ++s) {  // k16 steps
      // query pieces: a[p][mt] for piece p (hi, mid, lo)
      uint32_t a[3][MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        const float4 x0 = qs[swz(r, 4 * s + t)], x1 = qs[swz(r + 8, 4 * s + t)];
        mma::split_bf16x3(x0.x, x0.y, a[0][mt][0], a[1][mt][0], a[2][mt][0]);
        mma::split_bf16x3(x1.x, x1.y, a[0][mt][1], a[1][mt][1], a[2][mt][1]);
        mma::split_bf16x3(x0.z, x0.w, a[0][mt][2], a[1][mt][2], a[2][mt][2]);
        mma::split_bf16x3(x1.z, x1.w, a[0][mt][3], a[1][mt][3], a[2][mt][3]);
      }
      // bank fragments first, then the products, ordered so that consecutive
      // products update different accumulators
      if constexpr (sizeof(BT) == 1) {
        uint32_t b[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma::int8x4_to_bf16(*reinterpret_cast<const uint32_t*>(
                                  bs + (wn * 64 + 8 * j + g) * I8_PITCH + 16 * s + 4 * t),
                              b[j][0], b[j][1]);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma::bf16_16816(acc[mt][j], a[p][mt], b[j][0], b[j][1]);
      } else {
        uint32_t b[3][NT][2];  // pieces hi, mid, lo
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float4 y = reinterpret_cast<const float4*>(bs)[swz(wn * 64 + 8 * j + g, 4 * s + t)];
          mma::split_bf16x3(y.x, y.y, b[0][j][0], b[1][j][0], b[2][j][0]);
          mma::split_bf16x3(y.z, y.w, b[0][j][1], b[1][j][1], b[2][j][1]);
        }
        // (query piece, bank piece): every pair whose pieces sum to at most lo
        constexpr int PAIRS[6][2] = {{0, 0}, {0, 1}, {1, 0}, {0, 2}, {1, 1}, {2, 0}};
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma::bf16_16816(acc[mt][j], a[PAIRS[p][0]][mt], b[PAIRS[p][1]][j][0],
                              b[PAIRS[p][1]][j][1]);
      }
    }
    if (it % nk == nk - 1) {
      // the tile's distances; a thread's rows ascend, so a strict < keeps the
      // lowest index among its ties
      const int n0 = (tile_lo + it / nk) * BN + wn * 64 + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + 8 * j + c;
          if (n < N) {
            const float sc = scales ? __ldg(scales + n) : 1.f;
            const float bq = __ldg(bsq + n);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float d = bq - 2.f * (acc[mt][j][2 * h + c] * sc);
                const int i = 2 * mt + h;
                if (best_n[i] < 0 || d < best_d[i]) { best_d[i] = d; best_n[i] = n; }
              }
          }
        }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    }
  }
  mma::cp_async_wait<0>();

  // fold the four lanes of each query row, then across blocks
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
    unsigned long long key = best_n[i] < 0
        ? ~0ull
        : ((unsigned long long)ordered(best_d[i]) << 32) | (unsigned int)best_n[i];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
      key = other < key ? other : key;
    }
    const int qi = q0 + wm * 32 + (i / 2) * 16 + (i % 2) * 8 + g;
    if (t == 0 && qi < NQ && key != ~0ull) atomicMin(keys + qi, key);
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
  const int n_tiles = (N + BN - 1) / BN;
  const int per = (n_tiles + n_split - 1) / n_split;
  const int smem = STAGES * stage_bytes<BT>();
  cudaError_t err = cudaFuncSetAttribute(
      argmin_mma_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((NQ + BQ - 1) / BQ, (n_tiles + per - 1) / per);
  argmin_mma_kernel<BT><<<grid, THREADS, smem, stream>>>(q, bank, scales, bsq, keys, NQ, N,
                                                         D, per);
  gather_kernel<BT><<<NQ, 256, 0, stream>>>(keys, bank, scales, out, NQ, D);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (NQ, D) float32; bank: (N, D) int8 (with scales (N,)) or float32
// (scales null); bsq: (N,) and keys: (NQ,) uint64 scratch; out: (NQ, D).
// D must be a multiple of 32 and q and bank 16-byte aligned (the wrapper
// checks).
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
