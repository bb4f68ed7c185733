// Tensor-core pieces of the training backward kernels (resblock_bwd.cu,
// wavenet.cu), 3xTF32 (mma.cuh), for sm_90a. Activations are (B, T, C)
// row-major, as in rowconv.cuh (whose SIMT versions kernel 6 still runs).
//
// conv: a 1-D convolution as an implicit GEMM on the tensor cores, M =
// rows, N = C_out, K = (tap, input channel), where the input may be two
// tensors side by side (kernel 7 reads [d_a | d_b] and [d_res | ds]). A block
// owns 32 WM output rows (WM warps, up to 8) and one warp's 8 NT = 32 output
// channels (blockIdx.z picks them): the weights it streams then serve as
// many rows as the grid allows. Where 8 warps would not give every SM a
// block (C = 256 with T = 432, C = 192 with T = 400), a warp takes 16
// channels (NT = 2) and the blocks fewer rows. Each warp owns 2 m16 x NT n8
// tiles of sums. The input rows with the conv's halo are
// copied to shared memory (cp.async, zero-filled outside [0, T)) 32
// channels at a time, so a tile takes at most 48 KB (256 rows and a halo of
// 50, k = 11 and d = 5). The weights, split into TF32 big parts and residuals and packed in
// B-fragment order by the wrapper (ops/resblock.py::pack_tf32_weights),
// stream through a 4-slot cp.async ring shared by the block's warps, 3
// slices (of 4 k8 steps) ahead of the one being multiplied. The activations
// are split in registers as they are read. For each (chunk, tap) the 4 k8
// steps sum from zero in mma fragments and are then added into float32
// registers: Hopper's mma.sync truncates as it accumulates (mma.cuh), so no
// mma adds into a long running sum.
//
// wgrad: dW[j][i][o] = sum over rows of X[r + j d - p][i] G[r][o], a GEMM
// with M = C_in, N = C_out, K = rows. A block owns one TM x TM (i, o) tile
// (TM = 32, or 16 if C is not a multiple of 32) for a group of taps (one
// warp a tap, at most 6: k = 11 is two groups), one chunk of rows of one
// sample, and stages 64 rows at a time: the X window (64 + (taps - 1) d
// rows, every tap reads it at its own offset) and the G rows, both
// transposed and split into (TF32 big part, exact residual) pairs, laid out
// so that fragment loads hit distinct banks. G is read once per tap group,
// not once per tap; a job of fewer taps than the block has warps gives each
// warp another o tile. Each stage's sum is added into float32 registers. The
// column sums of G (bias gradients, kernel 7's per-sample conditioning sums)
// are exact float32 sums, in row order, taken by the tap-0 warps of the
// blocks of the first i tile from the staged pairs (big + residual == G
// exactly). The partial sums go to a workspace per chunk and
// rowk::wgrad_reduce_kernel adds the chunks in a fixed order: no atomics, so
// two calls give the same bits.
#pragma once

#include "mma.cuh"
#include "rowconv.cuh"

namespace {
namespace tck {

constexpr int MT = 2;          // m16 tiles per warp of a data conv
constexpr int WROWS = 16 * MT; // rows per warp
constexpr int CK = 32;         // input channels staged at a time
constexpr int MAX_WARPS = 8;   // of a data-conv block, all along the rows
constexpr int FILL = 132;      // data-conv blocks wanted: 1 per SM
constexpr int STAGES = 4;      // weight slices in the cp.async ring
constexpr int SLOT_F4 = CK / 8 * 4 * 32;  // float4 of a ring slot (8 KB): the k8 steps of
                                          // a chunk x 4 n8 tiles x 32 lanes

// Row pitch of a staged input tile, in floats: rows g..g+3 of a half-warp's
// float2 loads sit on distinct banks (= 8 or 24 mod 32).
__host__ __device__ inline int pitch(int Cin) { return (Cin < CK ? Cin : CK) + 8; }

// The geometry of a data-conv launch.
struct Geo {
  int NT, WM, M, threads;
  dim3 grid;
  // shared memory: the input tile with a halo of (k - 1) d rows, and the ring
  int smem(int Cin, int k, int d) const {
    return (M + (k - 1) * d) * pitch(Cin) * 4 + STAGES * SLOT_F4 * 16;
  }
};

// WM x 1 warps: a block owns 32 WM rows and one warp's 8 NT channels, so
// that the weights it streams serve as many rows as can be. WM is 8 unless
// the grid would then have fewer than FILL blocks; where it has to be cut,
// warps of 16 channels (NT = 2) give the grid twice the blocks, which
// measured faster at (4, 432, 256) and (4, 400, 192) and slower where 8
// warps of 32 channels fill the card.
inline Geo geo(int B, int T, int Cout) {
  Geo G;
  for (G.NT = Cout % 32 == 0 ? 4 : 2;; G.NT = 2) {
    const int nblk = Cout / (8 * G.NT);
    auto blocks = [&](int wm) { return ((T + WROWS * wm - 1) / (WROWS * wm)) * B * nblk; };
    G.WM = MAX_WARPS;
    while (G.WM > 1 && blocks(G.WM) < FILL) G.WM /= 2;
    G.M = WROWS * G.WM;
    G.threads = 32 * G.WM;
    G.grid = dim3((T + G.M - 1) / G.M, B, nblk);
    if (G.NT == 2 || G.WM == MAX_WARPS) return G;
  }
}

// A warp's place in a data-conv block.
struct Warp {
  int wm, g, t, lane;
  int n0;   // the first n8 tile of the warp and of the block (blockIdx.z)
  int bnt;  // its n8 tiles: NT, fewer at the last channel block
};

template <int NT>
__device__ __forceinline__ Warp warp_of(int Cout) {
  Warp W;
  W.wm = threadIdx.x / 32;
  W.lane = threadIdx.x % 32;
  W.g = W.lane / 4;
  W.t = W.lane % 4;
  W.n0 = blockIdx.z * NT;
  W.bnt = min(NT, Cout / 8 - W.n0);
  return W;
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
}

// Issue cp.async copies: tile[r * S + c] = src(g0 + r, c0 + c), for
// r < nrows, c < cw: channels below C from s0, the rest from s1 (channel
// c - C), both (T, C) row-major; zero where g0 + r lies outside [0, T).
__device__ __forceinline__ void stage_rows(float* tile, int S, const float* __restrict__ s0,
                                           const float* __restrict__ s1, int C, int c0, int cw,
                                           int g0, int nrows, int T) {
  const int n4 = cw / 4;
  for (int e = threadIdx.x; e < nrows * n4; e += blockDim.x) {
    const int r = e / n4, c = c0 + 4 * (e % n4), gr = g0 + r;
    const bool in = gr >= 0 && gr < T;
    const int gc = in ? gr : 0;
    const float* src = c < C ? s0 + (size_t)gc * C + c : s1 + (size_t)gc * C + (c - C);
    mma::cp_async16(tile + (size_t)r * S + (e % n4) * 4, src, in ? 16 : 0);
  }
}

// A weight slice: the k8 steps of tap j over the staged channels
// [c0, c0 + cw). A conv's slices run chunk by chunk, tap by tap.
struct Slice {
  int c0, cw, j;
  bool done;
  __device__ __forceinline__ explicit Slice(int Cin) : c0(0), cw(min(CK, Cin)), j(0), done(false) {}
  __device__ __forceinline__ void next(int Cin, int k) {
    if (++j < k) return;
    j = 0;
    c0 += CK;
    done = c0 >= Cin;
    cw = min(CK, Cin - c0);
  }
};

// Copy a slice's packed weights (the block's n8 tiles of its k8 steps) into
// ring slot q % STAGES with cp.async, and commit them as one group (an
// empty group past the last slice, so that every slice is STAGES - 1 groups
// behind).
__device__ __forceinline__ void issue(float4* ring, int q, const Slice& sl,
                                      const float4* __restrict__ w, int steps_per_tap,
                                      int ntiles, const Warp& W) {
  if (!sl.done) {
    const int row = W.bnt * 32;  // float4 of one k8 step
    const int step0 = sl.j * steps_per_tap + sl.c0 / 8;
    float4* dst = ring + (q % STAGES) * SLOT_F4;
    for (int e = threadIdx.x; e < sl.cw / 8 * row; e += blockDim.x) {
      const int s = e / row, r = e % row;
      mma::cp_async16(dst + e, w + ((size_t)(step0 + s) * ntiles + W.n0) * 32 + r);
    }
  }
  mma::cp_async_commit();
}

// acc[mt][nt] += sum over taps j < k and inputs c < Cin of
//   in(r + j d, c) * W[j][c][n]
// for the warp's rows r = (wm MT + mt) 16 + {g, g + 8} and columns
// n = 8 (n0 + nt) + {2t, 2t + 1}, leaky_relu'd as they are read if LRELU.
// stage(tile, S, c0, cw) issues the cp.async copies of the block's input
// rows (M + (k - 1) d of them) for channels [c0, c0 + cw) to
// tile[r * S + c - c0]. w: packed (k Cin/8 k8 steps) x (Cout/8 n8 tiles) x
// 32 lanes of float4; the block's n8 tiles stream through a ring of STAGES
// slots in shared memory, a slice per (chunk, tap), STAGES - 1 slices ahead
// of the one being multiplied. Each (chunk, tap)'s sum starts from zero in
// mma fragments and is added into acc in float32. Sums of rows past T and
// of n8 tiles past Cout (zero weights) are computed and not written: a
// guard around each mma measured slower on the card. Every thread of the
// block calls it; it returns with no copy in flight.
template <int NT, bool LRELU = false, class Stage>
__device__ __forceinline__ void conv(float* tile, float4* ring, const float4* __restrict__ w,
                                     int Cin, int Cout, int k, int d, float (&acc)[MT][NT][4],
                                     const Warp& W, Stage stage) {
  const int ntiles = Cout / 8, steps_per_tap = Cin / 8, S = pitch(Cin);
  bool n_on[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) n_on[nt] = nt < W.bnt;
  Slice ahead(Cin);
  for (int q = 0; q < STAGES - 1; ++q) {
    issue(ring, q, ahead, w, steps_per_tap, ntiles, W);
    if (!ahead.done) ahead.next(Cin, k);
  }
  for (Slice sl(Cin); !sl.done; sl.next(Cin, k)) {
    const int q = (sl.c0 / CK) * k + sl.j;
    if (sl.j == 0) {                // a new chunk of input channels
      __syncthreads();              // every warp is done with the old tile
      stage(tile, S, sl.c0, sl.cw);
      mma::cp_async_commit();
      mma::cp_async_wait<0>();      // the tile and slice q
    } else {
      mma::cp_async_wait<STAGES - 2>();
    }
    __syncthreads();  // slice q (and the tile) landed for all; slot q - 1 is free
    issue(ring, q + STAGES - 1, ahead, w, steps_per_tap, ntiles, W);
    if (!ahead.done) ahead.next(Cin, k);
    float part[MT][NT][4];
    zero<NT>(part);
    const float* a_base = tile + (size_t)(sl.j * d + W.wm * MT * 16 + W.g) * S + 2 * W.t;
    const float4* ws = ring + (q % STAGES) * SLOT_F4 + W.lane;
    auto step = [&](int s) {  // k8 step s of the slice
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* a = a_base + (size_t)mt * 16 * S + 8 * s;
        float2 lo = *reinterpret_cast<const float2*>(a);
        float2 hi = *reinterpret_cast<const float2*>(a + 8 * S);
        if (LRELU) {
          lo = make_float2(rowk::lrelu(lo.x), rowk::lrelu(lo.y));
          hi = make_float2(rowk::lrelu(hi.x), rowk::lrelu(hi.y));
        }
        mma::split_tf32(lo.x, ab[mt][0], as[mt][0]);  // (row g,   k t)
        mma::split_tf32(hi.x, ab[mt][1], as[mt][1]);  // (row g+8, k t)
        mma::split_tf32(lo.y, ab[mt][2], as[mt][2]);  // (row g,   k t+4)
        mma::split_tf32(hi.y, ab[mt][3], as[mt][3]);  // (row g+8, k t+4)
      }
      uint32_t wb[NT][2], wsm[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n_on[nt]) wv = ws[(s * W.bnt + nt) * 32];
        wb[nt][0] = __float_as_uint(wv.x);  // big parts of (k t, col g), (k t+4, col g)
        wb[nt][1] = __float_as_uint(wv.y);
        wsm[nt][0] = mma::tf32_round(wv.z);  // the residuals, rounded as split_tf32 does
        wsm[nt][1] = mma::tf32_round(wv.w);
      }
      // small products first; consecutive products update different sums
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma::tf32_1688(part[mt][nt], ab[mt], wsm[nt][0], wsm[nt][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma::tf32_1688(part[mt][nt], as[mt], wb[nt][0], wb[nt][1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma::tf32_1688(part[mt][nt], ab[mt], wb[nt][0], wb[nt][1]);
    };
    if (sl.cw == CK) {  // a whole chunk: a fixed count of steps
#pragma unroll
      for (int s = 0; s < CK / 8; ++s) step(s);
    } else {
      for (int s = 0; s < sl.cw / 8; ++s) step(s);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[mt][nt][c];
  }
  mma::cp_async_wait<0>();  // the trailing groups are empty
  __syncthreads();          // every warp is done with the tile and the ring
}

// Calls f(mt, h, nt, r, n, v0, v1) for each pair of sums of the warp that
// lies in the output: local row r (< rows), output channel n (even), the
// sums at (r, n) and (r, n + 1).
template <int NT, class F>
__device__ __forceinline__ void for_outputs(const float (&acc)[MT][NT][4], int rows, int Cout,
                                            const Warp& W, F f) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (W.wm * MT + mt) * 16 + W.g + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = 8 * (W.n0 + nt) + 2 * W.t;
        if (n >= Cout) continue;
        f(mt, h, nt, r, n, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// weight gradients

constexpr int WG_RS = 64;          // rows per staged step
constexpr int WG_P2G = WG_RS + 4;  // G's pitch in float2: = 4 mod 16, so that a
                                   // half-warp's fragment loads hit distinct banks
constexpr int WG_MAX_TAPS = 16;    // of a job
constexpr int WG_MAX_WARPS = 6;    // of a block: taps of a group, or o tiles
constexpr int WG_TARGET = 528;     // pass-1 blocks wanted: 4 per SM

struct TcWgPlan {
  rowk::WgPlan P;                       // jobs, chunking, workspace offsets (pass 2 reads it)
  int TM, warps;                        // tile edge, warps per block
  int tg[rowk::MAX_JOBS];               // taps of a block (a tap group) of each job
  int ngrp[rowk::MAX_JOBS];             // tap groups of each job
  int tpb[rowk::MAX_JOBS];              // o tiles a block of each job takes
  int start[rowk::MAX_JOBS + 1];        // each job's first block
};

// X window's pitch in float2 for rows_w rows: at least rows_w, = 4 mod 16
__host__ __device__ inline int wg_p2x(int rows_w) { return (rows_w + 11) / 16 * 16 + 4; }

inline int wg_smem(const TcWgPlan& W, int q) {
  const rowk::WgJob& J = W.P.job[q];
  return (W.TM * wg_p2x(WG_RS + (W.tg[q] - 1) * J.d) + W.TM * W.tpb[q] * WG_P2G) * 8;
}

// The plan of a set of jobs (their k in ks, dilations in ds); the caller
// fills in the jobs' pointers. C a multiple of 16; every k at most
// WG_MAX_TAPS. A job's taps are split into groups of at most WG_MAX_WARPS
// (11 -> 6 + 5), a warp a tap; a job of fewer taps than the block has warps
// gives each warp another o tile.
inline TcWgPlan tc_wgrad_plan(int B, int T, int C, int n_jobs, const int* ks, const int* ds) {
  TcWgPlan W = {};
  rowk::WgPlan& P = W.P;
  P.n_jobs = n_jobs;
  P.B = B;
  P.T = T;
  P.C = C;
  W.TM = C % 32 == 0 ? 32 : 16;
  W.warps = 1;
  for (int q = 0; q < n_jobs; ++q) {
    const int groups = (ks[q] + WG_MAX_WARPS - 1) / WG_MAX_WARPS;
    W.tg[q] = (ks[q] + groups - 1) / groups;
    W.ngrp[q] = (ks[q] + W.tg[q] - 1) / W.tg[q];
    W.warps = W.tg[q] > W.warps ? W.tg[q] : W.warps;
  }
  const int nt = C / W.TM;
  int per_chunk = 0;  // blocks of one chunk of every sample
  for (int q = 0; q < n_jobs; ++q) {
    W.tpb[q] = W.warps / W.tg[q];
    P.job[q].k = ks[q];
    P.job[q].d = ds[q];
    per_chunk += nt * ((nt + W.tpb[q] - 1) / W.tpb[q]) * W.ngrp[q];
  }
  int ncb = (WG_TARGET + B * per_chunk - 1) / (B * per_chunk);
  const int max_ncb = (T + WG_RS - 1) / WG_RS;
  ncb = ncb < 1 ? 1 : (ncb > max_ncb ? max_ncb : ncb);
  int R = (T + ncb - 1) / ncb;
  R = (R + WG_RS - 1) / WG_RS * WG_RS;
  P.R = R;
  P.ncb = (T + R - 1) / R;
  size_t off = 0;
  const size_t chunks = (size_t)B * P.ncb;
  W.start[0] = 0;
  for (int q = 0; q < n_jobs; ++q) {
    P.off[q] = off;
    off += chunks * ((size_t)ks[q] * C * C + C);
    W.start[q + 1] =
        W.start[q] + (int)chunks * nt * ((nt + W.tpb[q] - 1) / W.tpb[q]) * W.ngrp[q];
  }
  return W;
}

inline size_t tc_wgrad_floats(const TcWgPlan& W) {
  size_t total = 0;
  const size_t chunks = (size_t)W.P.B * W.P.ncb;
  for (int q = 0; q < W.P.n_jobs; ++q)
    total += chunks * ((size_t)W.P.job[q].k * W.P.C * W.P.C + W.P.C);
  return total;
}

// (big, residual) of x: big = tf32_round(x), x - big exact
__device__ __forceinline__ float2 split_pair(float x) {
  const float big = __uint_as_float(mma::tf32_round(x));
  return make_float2(big, x - big);
}

// Stage rows [r_lo, r_lo + nrows) (zero outside [valid_lo, valid_hi)) of
// channels [c0, c0 + ncols) of src (T, C), transposed and split: dst[c * P2 +
// r] = split_pair(src[r_lo + r][c0 + c]). A half-warp takes 16 rows of one
// group of 4 channels, so its stores are 16 consecutive pairs.
__device__ __forceinline__ void stage_t(float2* dst, int P2, const float* __restrict__ src,
                                        int C, int c0, int ncols, int r_lo, int nrows,
                                        int valid_lo, int valid_hi, bool lrelu_on) {
  constexpr int U = 4;  // loads in flight per thread
  const int cg_n = ncols / 4;
  const int total = (nrows + 15) / 16 * 16 * cg_n;
  for (int e0 = threadIdx.x; e0 < total; e0 += U * blockDim.x) {
    float4 v[U];
    int at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      const int rr = (e / (16 * cg_n)) * 16 + e % 16, cg = (e / 16) % cg_n, r = r_lo + rr;
      at[u] = e < total && rr < nrows ? (4 * cg) * P2 + rr : -1;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (at[u] >= 0 && r >= valid_lo && r < valid_hi && c0 + 4 * cg < C)
        v[u] = rowk::ldg4(src + (size_t)r * C + c0 + 4 * cg);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (at[u] < 0) continue;
      float4 x = v[u];
      if (lrelu_on)
        x = make_float4(rowk::lrelu(x.x), rowk::lrelu(x.y), rowk::lrelu(x.z), rowk::lrelu(x.w));
      float2* o = dst + at[u];
      o[0] = split_pair(x.x);
      o[P2] = split_pair(x.y);
      o[2 * P2] = split_pair(x.z);
      o[3 * P2] = split_pair(x.w);
    }
  }
}

// Pass 1 (see the note at the top). Block: job q, chunk (sample b, rows
// [r0, r1)), tap group, i tile, group of o tiles; warp: tap j = group tg +
// warp % tg, o tile og tpb + warp / tg.
template <int TM>
__global__ void __launch_bounds__(32 * WG_MAX_WARPS) tc_wgrad_kernel(TcWgPlan W) {
  constexpr int WMT = TM / 16, WNT = TM / 8;  // m16 and n8 tiles of a warp
  extern __shared__ float4 smem4[];
  int q = 0;
  while ((int)blockIdx.x >= W.start[q + 1]) ++q;
  const rowk::WgJob J = W.P.job[q];
  const int C = W.P.C, T = W.P.T, nt_all = C / TM, tpb = W.tpb[q], ncb = W.P.ncb;
  const int nch = W.P.B * ncb;
  int local = blockIdx.x - W.start[q];
  const int chunk = local % nch;
  local /= nch;
  const int grp = local % W.ngrp[q];
  local /= W.ngrp[q];
  const int ti = local % nt_all, og = local / nt_all;
  const int tg = W.tg[q];
  const int b = chunk / ncb, r0 = (chunk % ncb) * W.P.R, r1 = min(r0 + W.P.R, T);
  const int i0 = ti * TM, ocol0 = og * tpb * TM;
  const int ncols_g = min(tpb * TM, C - ocol0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int jl = warp % tg, sub = warp / tg, j = grp * tg + jl;
  const bool active = warp < tpb * tg && j < J.k && sub * TM < ncols_g;
  const int rows_w = WG_RS + (tg - 1) * J.d, P2x = wg_p2x(rows_w);
  float2* xs = reinterpret_cast<float2*>(smem4);
  float2* gs = xs + (size_t)TM * P2x;
  const float* Xb = J.X + (size_t)b * T * C;
  const float* Gb = J.G + (size_t)b * T * C;
  const bool colsum = active && j == 0 && ti == 0 && lane < TM;
  float acc[WMT][WNT][4];
#pragma unroll
  for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
  float csum = 0.f;
  const float2* gcol = gs + (size_t)(sub * TM + lane) * WG_P2G;
  for (int rs = r0; rs < r1; rs += WG_RS) {
    __syncthreads();  // the previous stage is no longer read
    stage_t(xs, P2x, Xb, C, i0, TM, rs - J.p + grp * tg * J.d, rows_w, 0, T, J.lrelu);
    stage_t(gs, WG_P2G, Gb, C, ocol0, tpb * TM, rs, WG_RS, 0, r1, false);
    __syncthreads();
    if (!active) continue;
    float part[WMT][WNT][4];
#pragma unroll
    for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.f;
#pragma unroll
    for (int s = 0; s < WG_RS / 8; ++s) {
      uint32_t ab[WMT][4], as[WMT][4];
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt) {
        const float2* a = xs + (size_t)(mt * 16 + g) * P2x + 8 * s + jl * J.d + t;
        const float2 v[4] = {a[0], a[8 * P2x], a[4], a[8 * P2x + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // (i g, r t), (i g+8, r t), (i g, r t+4), (i g+8, r t+4)
          ab[mt][e] = __float_as_uint(v[e].x);
          as[mt][e] = mma::tf32_round(v[e].y);
        }
      }
      uint32_t bb[WNT][2], bs[WNT][2];
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt) {
        const float2* p = gs + (size_t)(sub * TM + nt * 8 + g) * WG_P2G + 8 * s + t;
        const float2 v0 = p[0], v1 = p[4];  // (r t, o g), (r t+4, o g)
        bb[nt][0] = __float_as_uint(v0.x);
        bb[nt][1] = __float_as_uint(v1.x);
        bs[nt][0] = mma::tf32_round(v0.y);
        bs[nt][1] = mma::tf32_round(v1.y);
      }
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < WNT; ++nt) mma::tf32_1688(part[mt][nt], ab[mt], bs[nt][0], bs[nt][1]);
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < WNT; ++nt) mma::tf32_1688(part[mt][nt], as[mt], bb[nt][0], bb[nt][1]);
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < WNT; ++nt) mma::tf32_1688(part[mt][nt], ab[mt], bb[nt][0], bb[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[mt][nt][c];
    if (colsum) {
      for (int rr = 0; rr < WG_RS; ++rr) {
        const float2 v = gcol[rr];
        csum += v.x + v.y;  // == G exactly
      }
    }
  }
  if (!active) return;
  const int o0 = ocol0 + sub * TM;
  float* const part = W.P.part + W.P.off[q];
  float* pw = part + ((size_t)chunk * J.k + j) * C * C;
#pragma unroll
  for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt) {
        const int i = i0 + mt * 16 + g + 8 * h, o = o0 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(pw + (size_t)i * C + o) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  if (colsum) part[(size_t)nch * J.k * C * C + (size_t)chunk * C + o0 + lane] = csum;
}

// Both passes, in stream order. part must hold tc_wgrad_floats(W) floats.
inline cudaError_t tc_wgrad_launch(TcWgPlan W, float* part, cudaStream_t stream) {
  W.P.part = part;
  int smem = 0;
  for (int q = 0; q < W.P.n_jobs; ++q) smem = wg_smem(W, q) > smem ? wg_smem(W, q) : smem;
  const void* kern =
      W.TM == 32 ? (const void*)tc_wgrad_kernel<32> : (const void*)tc_wgrad_kernel<16>;
  cudaError_t err = rowk::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(W.start[W.P.n_jobs]);
  if (W.TM == 32)
    tc_wgrad_kernel<32><<<grid, 32 * W.warps, smem, stream>>>(W);
  else
    tc_wgrad_kernel<16><<<grid, 32 * W.warps, smem, stream>>>(W);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  size_t most = 0;
  for (int q = 0; q < W.P.n_jobs; ++q) {
    const size_t n = (size_t)W.P.job[q].k * W.P.C * W.P.C + W.P.C + (size_t)W.P.B * W.P.C;
    most = n > most ? n : most;
  }
  dim3 rgrid((unsigned)((most + 255) / 256), W.P.n_jobs);
  rowk::wgrad_reduce_kernel<<<rgrid, 256, 0, stream>>>(W.P);
  return cudaGetLastError();
}

}  // namespace tck
}  // namespace
