// The gated WaveNet (VITS "WN") stack, forward (kernel 6) and backward
// (kernel 7), float32, for sm_90a.
//
// Replaces rvc_tpu/ops/pallas_wavenet.py::_wn_fwd_call and ::_wn_bwd_call
// (wrapper fused_wn and its custom VJP). Per layer i of L, with the split
// weight layout of the JAX glue (w_a, w_b (L k, C, C) [tap][in][out]):
//     a, b  = conv_k(x) W{a,b}_i + b{a,b}_i + g{a,b}[b, i]   (same padding)
//     acts  = tanh(a) sigmoid(b)
//     x     = (x + acts Wres_i + bres_i) * mask
//     skip += acts Wskip_i + bskip_i
// and the stack returns skip * mask, mask = (t < lengths[b]).
//
// Forward (kernel 6, rvc_wn_fwd): two launches a layer (a whole-stack tile
// would need an L (k-1) row halo) on the TF32 wgmma conv core that kernel 4
// shares (tf32_conv.cuh), in 3xTF32:
// - the in-conv (K = k C, N = 2C) with w_a and w_b interleaved by groups of
//   8 channels (outputs 16q..16q+7 are a of channels 8q..8q+7, the next 8
//   their b), so that each thread's wgmma sums hold both halves of its
//   channels and it writes them as float2 (a row's four threads: a 32-byte
//   sector); its epilogue adds the bias and g, writes pre_a and pre_b for
//   kernel 7 and acts = tanh(a) sigmoid(b) to a scratch buffer (1.2 MB at
//   the training shapes, through L2);
// - the res/skip 1x1 (K = C, N = 2C, res and skip interleaved alike) over
//   acts; its epilogue writes x_{i+1} = (x_i + res + bres) mask to its own
//   buffer (kernel 7 reads every layer's input) and adds into skip; the
//   last layer masks the skip sum and computes only skip (N = C), unless
//   the caller wants the final x (x_final: a group of layers that is not
//   the stack's last, whose last layer has res weights, as the Pallas
//   kernel's xout_ref).
// A stack deeper than 8 layers runs as groups of 8 (ops/wavenet.py, as
// the JAX wrapper's group_size): each group's x_final is the next group's
// input, and its backward takes that x's cotangent (gyx) with the skip's.
// The B T rows of the batch are one slab of the core, tiled by 128-row
// blocks (1664 rows for the training batch's 1600, not 2048 when each
// sample starts a block), with each tap kept within its row's sample. The
// SIMT forward it replaced (rvc_wn_fwd_simt, one launch a layer on rowconv,
// C/4 column threads) stays as chip_smoke.py's yardstick, on no path.
//
// Backward, per layer in reverse (the forward's x_i and a, b kept):
//   gate: d_res = dx_{i+1} mask, d_acts = [d_res | ds] [Wres^T; Wskip^T]
//         (ds = gy mask), d_a = d_acts sigmoid(b)(1 - tanh(a)^2),
//         d_b = d_acts tanh(a) sigmoid(b)(1 - sigmoid(b));
//   dx:   dx_i = d_res + conv over [d_a | d_b] with the flipped transposed
//         in-conv taps;
//   wgrad: dW{a,b}_i = sum x_i[t + j - p]^T d_{a,b}[t],
//         dWres_i = sum acts^T d_res, dWskip_i = sum acts^T ds, the bias
//         sums, and dG[b, i] = sum over t of d_a[b, t] (the conditioning is
//         broadcast along T), the same for d_b.
// Rows at and past lengths[b] get d_acts = 0, but dx reaches the conv halo
// past them, as autograd of the layer-by-layer module does.
//
// What bounds it: operations. A layer's in-conv does 2 k C^2 multiply-adds
// per row for each half and the 1x1 products 2 C^2, about 1.1 GFLOP per
// layer at (4, 400, 192), against ~4 MB of activations moved: the forward's
// three TF32 passes take 8.6 us a layer at the card's TF32 rate, so launch
// tails count as much as the products. The forward ran on the float32
// pipes (rvc_wn_fwd_simt) at 23.6 times its bound. The backward ran there
// too (rvc_wn_bwd_simt, kept on no path of the port as the same-run
// yardstick), at under a tenth of that pipe's bound: at (4, 400, 192) its
// gate and dx launches had 40 blocks for 132 SMs. rvc_wn_bwd runs the gate's 1x1
// product (K = 2C over [d_res | ds]), the dx conv (K = 2C k over
// [d_a | d_b]) and the four weight gradients in 3xTF32 on mma.sync
// (tc_rowconv.cuh), with grids sized to fill the card; the gate math and
// the mask stay float32 in the epilogue.

#include "tc_rowconv.cuh"
#include "tf32_conv.cuh"

namespace {

using namespace rowk;

__global__ void __launch_bounds__(MAX_THREADS) wn_fwd_layer_kernel(
    const float* __restrict__ x_in, float* __restrict__ x_out, float* __restrict__ pre_a,
    float* __restrict__ pre_b, float* __restrict__ skip, const float* __restrict__ wa,
    const float* __restrict__ wb, const float* __restrict__ ba, const float* __restrict__ bb,
    const float* __restrict__ ga, const float* __restrict__ gb,
    const float* __restrict__ wres, const float* __restrict__ wskip,
    const float* __restrict__ bres, const float* __restrict__ bskip,
    const int* __restrict__ lengths, int T, int C, int k, int g_stride, int first, int last) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const Layout l = layout(C);
  const int tx = threadIdx.x % l.NC, ty = threadIdx.x / l.NC;
  const int S = C + 4, p = (k - 1) / 2;
  float* as = xs + (size_t)(l.M + 2 * p) * S;
  const int b = blockIdx.y, t0 = blockIdx.x * l.M;
  const int len = lengths[b];
  const size_t base = (size_t)b * T * C;
  load_rows(xs, S, x_in + base, C, t0 - p, l.M + 2 * p, T, false);
  __syncthreads();
  float acc[2][RM][4];
  zero_acc(acc);
  const float* w_in[2] = {wa, wb};
  rowconv<2>(xs, S, C, w_in, C, k, 1, acc, tx, ty, l.NR);
  const float4 bA = ldg4(ba + 4 * tx), bB = ldg4(bb + 4 * tx);
  const float4 gA = ldg4(ga + (size_t)b * g_stride + 4 * tx);
  const float4 gB = ldg4(gb + (size_t)b * g_stride + 4 * tx);
  const float addA[4] = {bA.x + gA.x, bA.y + gA.y, bA.z + gA.z, bA.w + gA.w};
  const float addB[4] = {bB.x + gB.x, bB.y + gB.y, bB.z + gB.z, bB.w + gB.w};
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int rl = ty + m * l.NR, r = t0 + rl;
    float av[4], bv[4], act[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      av[q] = acc[0][m][q] + addA[q];
      bv[q] = acc[1][m][q] + addB[q];
      act[q] = tanhf(av[q]) * sigmoidf_(bv[q]);
    }
    if (r < T) {
      const size_t at = base + (size_t)r * C + 4 * tx;
      st4(pre_a + at, av[0], av[1], av[2], av[3]);
      st4(pre_b + at, bv[0], bv[1], bv[2], bv[3]);
    }
    st4(as + (size_t)rl * S + 4 * tx, act[0], act[1], act[2], act[3]);
  }
  __syncthreads();
  zero_acc(acc);
  const float* w_rs[2] = {wres, wskip};
  rowconv<2>(as, S, C, w_rs, C, 1, 1, acc, tx, ty, l.NR);
  const float4 bR = ldg4(bres + 4 * tx), bS = ldg4(bskip + 4 * tx);
  const float bRv[4] = {bR.x, bR.y, bR.z, bR.w}, bSv[4] = {bS.x, bS.y, bS.z, bS.w};
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int rl = ty + m * l.NR, r = t0 + rl;
    if (r >= T) continue;
    const float keep = r < len ? 1.f : 0.f;
    const size_t at = base + (size_t)r * C + 4 * tx;
    const float4 xv = f4(xs + (size_t)(rl + p) * S + 4 * tx);
    const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
    float xn[4], sk[4];
    float4 old = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!first) old = f4(skip + at);
    const float olda[4] = {old.x, old.y, old.z, old.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      xn[q] = (xa[q] + (acc[0][m][q] + bRv[q])) * keep;
      const float s = acc[1][m][q] + bSv[q];
      sk[q] = first ? s : olda[q] + s;
      if (last) sk[q] *= keep;
    }
    if (x_out) st4(x_out + at, xn[0], xn[1], xn[2], xn[3]);
    st4(skip + at, sk[0], sk[1], sk[2], sk[3]);
  }
}

// ds = gy * mask
__global__ void wn_mask_kernel(const float* __restrict__ gy, float* __restrict__ ds,
                               const int* __restrict__ lengths, int B, int T, int C) {
  const size_t n4 = (size_t)B * T * C / 4;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n4;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t row = e * 4 / C;
    const int b = (int)(row / T), t = (int)(row % T);
    float4 v = ldg4(gy + 4 * e);
    if (t >= lengths[b]) v = make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(ds)[e] = v;
  }
}

// rows [t0, t0 + M): d_res, d_a, d_b, acts of layer i
__global__ void __launch_bounds__(MAX_THREADS) wn_bwd_gate_kernel(
    const float* __restrict__ dx_next, const float* __restrict__ ds,
    const float* __restrict__ pre_a, const float* __restrict__ pre_b,
    const float* __restrict__ wrsT, float* __restrict__ d_a, float* __restrict__ d_b,
    float* __restrict__ acts, float* __restrict__ d_res, const int* __restrict__ lengths,
    int T, int C) {
  extern __shared__ float4 smem4[];
  float* in_s = reinterpret_cast<float*>(smem4);
  const Layout l = layout(C);
  const int tx = threadIdx.x % l.NC, ty = threadIdx.x / l.NC;
  const int S = 2 * C + 4, nc4 = C / 4;
  const int b = blockIdx.y, t0 = blockIdx.x * l.M;
  const int len = lengths[b];
  const size_t base = (size_t)b * T * C;
  for (int e = threadIdx.x; e < l.M * 2 * nc4; e += blockDim.x) {
    const int rl = e / (2 * nc4), c4 = e % (2 * nc4), r = t0 + rl;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < T) {
      if (c4 < nc4) {
        if (dx_next && r < len) v = ldg4(dx_next + base + (size_t)r * C + 4 * c4);
        *reinterpret_cast<float4*>(d_res + base + (size_t)r * C + 4 * c4) = v;
      } else {
        v = ldg4(ds + base + (size_t)r * C + 4 * (c4 - nc4));
      }
    }
    *reinterpret_cast<float4*>(in_s + (size_t)rl * S + 4 * c4) = v;
  }
  __syncthreads();
  float acc[1][RM][4];
  zero_acc(acc);
  const float* w_[1] = {wrsT};
  rowconv<1>(in_s, S, 2 * C, w_, C, 1, 1, acc, tx, ty, l.NR);
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = t0 + ty + m * l.NR;
    if (r >= T) continue;
    const size_t at = base + (size_t)r * C + 4 * tx;
    const float4 a4 = ldg4(pre_a + at), b4 = ldg4(pre_b + at);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
    float oa[4], ob[4], oc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float th = tanhf(av[q]), sg = sigmoidf_(bv[q]), g = acc[0][m][q];
      oa[q] = g * sg * (1.f - th * th);
      ob[q] = g * th * sg * (1.f - sg);
      oc[q] = th * sg;
    }
    st4(d_a + at, oa[0], oa[1], oa[2], oa[3]);
    st4(d_b + at, ob[0], ob[1], ob[2], ob[3]);
    st4(acts + at, oc[0], oc[1], oc[2], oc[3]);
  }
}

// rows [t0, t0 + M): dx_i = d_res + conv over [d_a | d_b] (flipped, transposed taps)
__global__ void __launch_bounds__(MAX_THREADS) wn_bwd_dx_kernel(
    const float* __restrict__ d_a, const float* __restrict__ d_b,
    const float* __restrict__ d_res, const float* __restrict__ wabT, float* __restrict__ dx,
    int T, int C, int k) {
  extern __shared__ float4 smem4[];
  float* in_s = reinterpret_cast<float*>(smem4);
  const Layout l = layout(C);
  const int tx = threadIdx.x % l.NC, ty = threadIdx.x / l.NC;
  const int S = 2 * C + 4, p = (k - 1) / 2, rows = l.M + 2 * p;
  const int b = blockIdx.y, t0 = blockIdx.x * l.M;
  const size_t base = (size_t)b * T * C;
  load_rows(in_s, S, d_a + base, C, t0 - p, rows, T, false);
  load_rows(in_s + C, S, d_b + base, C, t0 - p, rows, T, false);
  __syncthreads();
  float acc[1][RM][4];
  zero_acc(acc);
  const float* w_[1] = {wabT};
  rowconv<1>(in_s, S, 2 * C, w_, C, k, 1, acc, tx, ty, l.NR);
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = t0 + ty + m * l.NR;
    if (r >= T) continue;
    const size_t at = base + (size_t)r * C + 4 * tx;
    const float4 dr = ldg4(d_res + at);
    st4(dx + at, dr.x + acc[0][m][0], dr.y + acc[0][m][1], dr.z + acc[0][m][2],
        dr.w + acc[0][m][3]);
  }
}

WgPlan plan_for(int B, int T, int C, int k) {
  const int ks[4] = {k, k, 1, 1};
  return wgrad_plan(B, T, C, 4, ks);
}

}  // namespace

// Kernel 6 as first written, on the float32 SIMT pipes (the yardstick of
// rvc_wn_fwd, launched only by chip_smoke.py): one launch a layer. x (B, T,
// C); writes xs (L-1, B, T, C) (inputs of layers 1..L-1), pre_a, pre_b (L,
// B, T, C) and out = skip * mask (B, T, C). Weights as the module
// docstring; g_ab (B, 2L, C); lengths (B,) int32. C a multiple of 16, at
// most 256, k odd.
extern "C" int rvc_wn_fwd_simt(const void* x, void* xs, void* pre_a, void* pre_b, void* out,
                               const void* w_a, const void* w_b, const void* b_ab,
                               const void* g_ab, const void* w_res, const void* w_skip,
                               const void* b_rs2, const void* lengths, int B, int T, int C,
                               int k, int L, void* stream) {
  const size_t btc = (size_t)B * T * C, wk = (size_t)k * C * C, cc = (size_t)C * C;
  const Layout l = layout(C);
  const int p = (k - 1) / 2, S = C + 4;
  const int smem = ((l.M + 2 * p) + l.M) * S * 4;
  cudaError_t err = allow_smem((const void*)wn_fwd_layer_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const float* bab = (const float*)b_ab;
  const float* gab = (const float*)g_ab;
  const float* brs = (const float*)b_rs2;
  const dim3 grid((T + l.M - 1) / l.M, B);
  for (int i = 0; i < L; ++i) {
    const float* xin = i == 0 ? (const float*)x : (const float*)xs + (size_t)(i - 1) * btc;
    float* xout = i < L - 1 ? (float*)xs + (size_t)i * btc : nullptr;
    wn_fwd_layer_kernel<<<grid, l.threads, smem, (cudaStream_t)stream>>>(
        xin, xout, (float*)pre_a + i * btc, (float*)pre_b + i * btc, (float*)out,
        (const float*)w_a + i * wk, (const float*)w_b + i * wk, bab + (size_t)i * C,
        bab + (size_t)(L + i) * C, gab + (size_t)i * C, gab + (size_t)(L + i) * C,
        (const float*)w_res + i * cc, (const float*)w_skip + i * cc, brs + (size_t)i * C,
        brs + (size_t)(L + i) * C, (const int*)lengths, T, C, k, 2 * L * C, i == 0,
        i == L - 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// Workspace of rvc_wn_bwd_simt, in floats.
extern "C" long long rvc_wn_bwd_simt_workspace(int B, int T, int C, int k) {
  const int ks[4] = {k, k, 1, 1};
  return (long long)(7 * (size_t)B * T * C + wgrad_floats(B, T, C, 4, ks));
}

// The VJP of the stack on the float32 SIMT pipes (the yardstick of
// rvc_wn_bwd). wabT (L, k, 2C, C): [d_a | d_b] -> dx taps;
// wrsT (L, 2C, C): [Wres_i^T; Wskip_i^T]. Writes dx (B, T, C) and the
// weight gradients dwa, dwb (L k, C, C), dbab (2L, C), dg (B, 2L, C),
// dwres, dwskip (L, C, C), dbrs (2L, C).
extern "C" int rvc_wn_bwd_simt(const void* x, const void* xs, const void* pre_a,
                               const void* pre_b, const void* gy, const void* wabT,
                               const void* wrsT, const void* lengths, void* dx, void* dwa,
                               void* dwb, void* dbab, void* dg, void* dwres, void* dwskip,
                               void* dbrs, void* work, long long work_floats, int B, int T,
                               int C, int k, int L, void* stream) {
  const size_t btc = (size_t)B * T * C, wk = (size_t)k * C * C, cc = (size_t)C * C;
  if (work_floats < rvc_wn_bwd_simt_workspace(B, T, C, k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* w = (float*)work;
  float *ds = w, *da = w + btc, *db = w + 2 * btc, *acts = w + 3 * btc, *dres = w + 4 * btc;
  float* dxb[2] = {w + 5 * btc, w + 6 * btc};
  float* part = w + 7 * btc;
  const Layout l = layout(C);
  const int p = (k - 1) / 2, S2 = 2 * C + 4;
  const int smem_gate = l.M * S2 * 4, smem_dx = (l.M + 2 * p) * S2 * 4;
  cudaError_t err = allow_smem((const void*)wn_bwd_gate_kernel, smem_gate);
  if (err == cudaSuccess) err = allow_smem((const void*)wn_bwd_dx_kernel, smem_dx);
  if (err != cudaSuccess) return (int)err;
  const int* lens = (const int*)lengths;
  wn_mask_kernel<<<264, 256, 0, s>>>((const float*)gy, ds, lens, B, T, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid((T + l.M - 1) / l.M, B);
  const float* dx_next = nullptr;
  for (int i = L - 1; i >= 0; --i) {
    const float* xi = i == 0 ? (const float*)x : (const float*)xs + (size_t)(i - 1) * btc;
    float* dxi = i == 0 ? (float*)dx : dxb[i % 2];
    wn_bwd_gate_kernel<<<grid, l.threads, smem_gate, s>>>(
        dx_next, ds, (const float*)pre_a + i * btc, (const float*)pre_b + i * btc,
        (const float*)wrsT + (size_t)i * 2 * cc, da, db, acts, dres, lens, T, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    wn_bwd_dx_kernel<<<grid, l.threads, smem_dx, s>>>(
        da, db, dres, (const float*)wabT + (size_t)i * 2 * wk, dxi, T, C, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    WgPlan P = plan_for(B, T, C, k);
    const int gs = 2 * L * C;
    P.job[0] = WgJob{xi, da, (float*)dwa + i * wk, (float*)dbab + (size_t)i * C,
                     (float*)dg + (size_t)i * C, k, 1, p, 0, gs};
    P.job[1] = WgJob{xi, db, (float*)dwb + i * wk, (float*)dbab + (size_t)(L + i) * C,
                     (float*)dg + (size_t)(L + i) * C, k, 1, p, 0, gs};
    P.job[2] = WgJob{acts, dres, (float*)dwres + i * cc, (float*)dbrs + (size_t)i * C,
                     nullptr, 1, 1, 0, 0, 0};
    P.job[3] = WgJob{acts, ds, (float*)dwskip + i * cc, (float*)dbrs + (size_t)(L + i) * C,
                     nullptr, 1, 1, 0, 0, 0};
    if ((err = wgrad_launch(P, part, s)) != cudaSuccess) return (int)err;
    dx_next = dxi;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// kernel 7 on the tensor cores

namespace {

// rows [t0, t0 + M) of sample blockIdx.y, the channels of blockIdx.z: d_acts
// = [d_res | ds] [Wres^T; Wskip^T], then d_a, d_b and acts.
template <int NT>
__global__ void __launch_bounds__(32 * tck::MAX_WARPS) wn_tc_gate_kernel(
    const float* __restrict__ d_res, const float* __restrict__ ds,
    const float* __restrict__ pre_a, const float* __restrict__ pre_b,
    const float4* __restrict__ prs, float* __restrict__ d_a, float* __restrict__ d_b,
    float* __restrict__ acts, int T, int C) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const tck::Warp W = tck::warp_of<NT>(C);
  const int M = blockDim.x / 32 * tck::WROWS;
  const int tile_rows = M;
  float4* ring = smem4 + (size_t)tile_rows * tck::pitch(2 * C) / 4;
  const int b = blockIdx.y, t0 = blockIdx.x * M, rows = min(M, T - t0);
  const size_t base = (size_t)b * T * C + (size_t)t0 * C;
  float acc[tck::MT][NT][4];
  tck::zero<NT>(acc);
  tck::conv<NT>(tile, ring, prs, 2 * C, C, 1, 1, acc, W,
                [&](float* tl, int S, int c0, int cw) {
                  tck::stage_rows(tl, S, d_res + (size_t)b * T * C, ds + (size_t)b * T * C, C,
                                  c0, cw, t0, M, T);
                });
  tck::for_outputs<NT>(acc, rows, C, W, [&](int, int, int, int r, int n, float v0, float v1) {
    const size_t at = base + (size_t)r * C + n;
    const float2 a = __ldg(reinterpret_cast<const float2*>(pre_a + at));
    const float2 bb = __ldg(reinterpret_cast<const float2*>(pre_b + at));
    const float av[2] = {a.x, a.y}, bv[2] = {bb.x, bb.y}, gv[2] = {v0, v1};
    float oa[2], ob[2], oc[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float th = tanhf(av[q]), sg = rowk::sigmoidf_(bv[q]);
      oa[q] = gv[q] * sg * (1.f - th * th);
      ob[q] = gv[q] * th * sg * (1.f - sg);
      oc[q] = th * sg;
    }
    *reinterpret_cast<float2*>(d_a + at) = make_float2(oa[0], oa[1]);
    *reinterpret_cast<float2*>(d_b + at) = make_float2(ob[0], ob[1]);
    *reinterpret_cast<float2*>(acts + at) = make_float2(oc[0], oc[1]);
  });
}

// rows [t0, t0 + M) of sample blockIdx.y, the channels of blockIdx.z:
// dx_i = d_res + conv over [d_a | d_b] (flipped, transposed taps), written
// as it is (layer 0: the stack's dx) or masked (d_res of layer i - 1)
template <int NT>
__global__ void __launch_bounds__(32 * tck::MAX_WARPS) wn_tc_dx_kernel(
    const float* __restrict__ d_a, const float* __restrict__ d_b,
    const float* __restrict__ d_res, const float4* __restrict__ pab, float* __restrict__ out,
    const int* __restrict__ lengths, int masked, int T, int C, int k) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const tck::Warp W = tck::warp_of<NT>(C);
  const int M = blockDim.x / 32 * tck::WROWS;
  const int tile_rows = M + (k - 1);
  float4* ring = smem4 + (size_t)tile_rows * tck::pitch(2 * C) / 4;
  const int b = blockIdx.y, t0 = blockIdx.x * M, rows = min(M, T - t0);
  const int p = (k - 1) / 2;
  const int keep_to = masked ? lengths[b] - t0 : rows;  // local rows kept
  float acc[tck::MT][NT][4];
  tck::zero<NT>(acc);
  tck::conv<NT>(tile, ring, pab, 2 * C, C, k, 1, acc, W,
                [&](float* tl, int S, int c0, int cw) {
                  tck::stage_rows(tl, S, d_a + (size_t)b * T * C, d_b + (size_t)b * T * C, C,
                                  c0, cw, t0 - p, M + 2 * p, T);
                });
  const size_t base = (size_t)b * T * C + (size_t)t0 * C;
  tck::for_outputs<NT>(acc, rows, C, W, [&](int, int, int, int r, int n, float v0, float v1) {
    const size_t at = base + (size_t)r * C + n;
    const float2 dr = __ldg(reinterpret_cast<const float2*>(d_res + at));
    const float2 v = r < keep_to ? make_float2(dr.x + v0, dr.y + v1) : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(out + at) = v;
  });
}

tck::TcWgPlan tc_plan(int B, int T, int C, int k) {
  const int ks[4] = {k, k, 1, 1}, ds[4] = {1, 1, 1, 1};
  return tck::tc_wgrad_plan(B, T, C, 4, ks, ds);
}

template <int NT>
cudaError_t launch_layer(const tck::Geo& G, const float* dres, const float* ds, const float* pa,
                         const float* pb, const float4* prs, const float4* pab, float* da,
                         float* db, float* acts, float* out, const int* lens, int masked, int T,
                         int C, int k, cudaStream_t s) {
  const int smem_gate = G.smem(2 * C, 1, 1), smem_dx = G.smem(2 * C, k, 1);
  cudaError_t err = rowk::allow_smem((const void*)wn_tc_gate_kernel<NT>, smem_gate);
  if (err == cudaSuccess) err = rowk::allow_smem((const void*)wn_tc_dx_kernel<NT>, smem_dx);
  if (err != cudaSuccess) return err;
  wn_tc_gate_kernel<NT><<<G.grid, G.threads, smem_gate, s>>>(dres, ds, pa, pb, prs, da, db,
                                                             acts, T, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wn_tc_dx_kernel<NT><<<G.grid, G.threads, smem_dx, s>>>(da, db, dres, pab, out, lens, masked,
                                                         T, C, k);
  return cudaGetLastError();
}

}  // namespace

// Workspace of rvc_wn_bwd, in floats.
extern "C" long long rvc_wn_bwd_workspace(int B, int T, int C, int k) {
  return (long long)(6 * (size_t)B * T * C + tck::tc_wgrad_floats(tc_plan(B, T, C, k)));
}

// Kernel 7: the VJP of kernel 6 (rvc_wn_fwd) on the tensor cores. pab (L
// packed convs): each layer's [d_a | d_b] -> dx conv, a (C, 2C, k) conv with flipped,
// transposed taps; prs (L packed convs): [Wres_i^T; Wskip_i^T] as a (C, 2C,
// 1) conv; both as ops/resblock.py::pack_tf32_weights lays a conv out.
// gy: the cotangent of out; gyx: of x_final, or null where kernel 6 wrote
// none (the Pallas kernel's dyxp). Writes dx (B, T, C) and the weight
// gradients dwa, dwb (L k, C, C), dbab (2L, C), dg (B, 2L, C), dwres,
// dwskip (L, C, C), dbrs (2L, C). C a multiple of 16, at most 256, k odd, at
// most 15 (the wrapper checks). Per layer: the gate, dx (which writes the
// next layer's d_res = dx_i masked) and the two passes of the weight
// gradients; first, ds = gy mask and the last layer's d_res = gyx mask (0
// without gyx).
extern "C" int rvc_wn_bwd(const void* x, const void* xs, const void* pre_a, const void* pre_b,
                          const void* gy, const void* gyx, const void* pab, const void* prs,
                          const void* lengths, void* dx, void* dwa, void* dwb, void* dbab,
                          void* dg, void* dwres, void* dwskip, void* dbrs, void* work,
                          long long work_floats, int B, int T, int C, int k, int L,
                          void* stream) {
  const size_t btc = (size_t)B * T * C, wk = (size_t)k * C * C, cc = (size_t)C * C;
  if (work_floats < rvc_wn_bwd_workspace(B, T, C, k) || k > tck::WG_MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* w = (float*)work;
  float *ds = w, *da = w + btc, *db = w + 2 * btc, *acts = w + 3 * btc;
  float* dres[2] = {w + 4 * btc, w + 5 * btc};  // layer i reads dres[i % 2]
  float* part = w + 6 * btc;
  const int* lens = (const int*)lengths;
  const float4* pab4 = (const float4*)pab;
  const float4* prs4 = (const float4*)prs;
  wn_mask_kernel<<<264, 256, 0, s>>>((const float*)gy, ds, lens, B, T, C);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) {
    if (gyx) {
      wn_mask_kernel<<<264, 256, 0, s>>>((const float*)gyx, dres[(L - 1) % 2], lens, B, T, C);
      err = cudaGetLastError();
    } else {
      err = cudaMemsetAsync(dres[(L - 1) % 2], 0, btc * sizeof(float), s);
    }
  }
  if (err != cudaSuccess) return (int)err;
  const int p = (k - 1) / 2;
  const tck::Geo G = tck::geo(B, T, C);
  for (int i = L - 1; i >= 0; --i) {
    const float* xi = i == 0 ? (const float*)x : (const float*)xs + (size_t)(i - 1) * btc;
    const float* dr = dres[i % 2];
    float* out = i == 0 ? (float*)dx : dres[(i + 1) % 2];
    const float* pa = (const float*)pre_a + i * btc;
    const float* pb = (const float*)pre_b + i * btc;
    const float4* prs_i = prs4 + (size_t)i * cc;  // (C, 2C, 1) packed: C^2 float4
    const float4* pab_i = pab4 + (size_t)i * wk;  // (C, 2C, k) packed: k C^2 float4
    err = G.NT == 4 ? launch_layer<4>(G, dr, ds, pa, pb, prs_i, pab_i, da, db, acts, out, lens,
                                      i > 0, T, C, k, s)
                    : launch_layer<2>(G, dr, ds, pa, pb, prs_i, pab_i, da, db, acts, out, lens,
                                      i > 0, T, C, k, s);
    if (err != cudaSuccess) return (int)err;
    tck::TcWgPlan P = tc_plan(B, T, C, k);
    const int gs = 2 * L * C;
    P.P.job[0] = rowk::WgJob{xi, da, (float*)dwa + i * wk, (float*)dbab + (size_t)i * C,
                             (float*)dg + (size_t)i * C, k, 1, p, 0, gs};
    P.P.job[1] = rowk::WgJob{xi, db, (float*)dwb + i * wk, (float*)dbab + (size_t)(L + i) * C,
                             (float*)dg + (size_t)(L + i) * C, k, 1, p, 0, gs};
    P.P.job[2] = rowk::WgJob{acts, dr, (float*)dwres + i * cc, (float*)dbrs + (size_t)i * C,
                             nullptr, 1, 1, 0, 0, 0};
    P.P.job[3] = rowk::WgJob{acts, ds, (float*)dwskip + i * cc,
                             (float*)dbrs + (size_t)(L + i) * C, nullptr, 1, 1, 0, 0, 0};
    if ((err = tck::tc_wgrad_launch(P, part, s)) != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// kernel 6 on the tensor cores

namespace {

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// The in-conv's epilogue. Its outputs are interleaved by groups of 8
// channels: n8 tile 2m of the block holds a of 8 channels and tile 2m + 1 b
// of the same 8, so that each thread holds both halves of its channels c,
// c + 1. Writes the gate's pre-activations (bias and g included) for kernel
// 7 and acts = tanh(a) sigmoid(b) for the 1x1 launch, a float2 a thread
// (the four threads of a row: 32 bytes).
struct Gate {
  float* pre_a;
  float* pre_b;
  float* acts;
  const float* ba;
  const float* bb;
  const float* ga;
  const float* gb;
  int gs, T, C;
  template <int N2>
  __device__ __forceinline__ void operator()(int r, int h, int n0, int t,
                                             const float (&acc)[N2]) const {
    const size_t gi = (size_t)(r / T) * gs;
#pragma unroll
    for (int m = 0; m < N2 / 8; ++m) {
      const int c = n0 / 2 + 8 * m + 2 * t;
      const float2 bA = ldg2(ba + c), bB = ldg2(bb + c);
      const float2 gA = ldg2(ga + gi + c), gB = ldg2(gb + gi + c);
      const float a0 = acc[8 * m + 2 * h] + (bA.x + gA.x);
      const float a1 = acc[8 * m + 2 * h + 1] + (bA.y + gA.y);
      const float b0 = acc[8 * m + 4 + 2 * h] + (bB.x + gB.x);
      const float b1 = acc[8 * m + 4 + 2 * h + 1] + (bB.y + gB.y);
      const size_t at = (size_t)r * C + c;
      st2(pre_a + at, a0, a1);
      st2(pre_b + at, b0, b1);
      st2(acts + at, tanhf(a0) * rowk::sigmoidf_(b0), tanhf(a1) * rowk::sigmoidf_(b1));
    }
  }
};

// The 1x1's epilogue. Where x_out is wanted (below the last layer, and at
// the last when the caller wants the final x) its outputs are interleaved
// as the in-conv's: tile 2m res of 8 channels, tile 2m + 1 their skip; x_out
// = (x_in + res + bres) keep and skip (+)= skip_c + bskip. Otherwise (the
// stack's last layer, whose res is zero and not computed) it has only skip
// outputs, in order. The last layer masks the skip sum.
struct ResSkip {
  const float* x_in;
  float* x_out;
  float* skip;
  const float* bres;
  const float* bskip;
  const int* lengths;
  int T, C, first, last;
  template <int N2>
  __device__ __forceinline__ void operator()(int r, int h, int n0, int t,
                                             const float (&acc)[N2]) const {
    const int b = r / T;
    const float keep = r - b * T < __ldg(lengths + b) ? 1.f : 0.f;
    if (x_out) {
#pragma unroll
      for (int m = 0; m < N2 / 8; ++m) {
        const int c = n0 / 2 + 8 * m + 2 * t;
        const size_t at = (size_t)r * C + c;
        const float2 xv = ldg2(x_in + at), bR = ldg2(bres + c), bS = ldg2(bskip + c);
        st2(x_out + at, (xv.x + (acc[8 * m + 2 * h] + bR.x)) * keep,
            (xv.y + (acc[8 * m + 2 * h + 1] + bR.y)) * keep);
        float2 sk =
            make_float2(acc[8 * m + 4 + 2 * h] + bS.x, acc[8 * m + 4 + 2 * h + 1] + bS.y);
        if (!first) {
          const float2 old = *reinterpret_cast<const float2*>(skip + at);
          sk = make_float2(old.x + sk.x, old.y + sk.y);
        }
        if (last) sk = make_float2(sk.x * keep, sk.y * keep);
        st2(skip + at, sk.x, sk.y);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < N2 / 4; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      const size_t at = (size_t)r * C + c;
      const float2 bS = ldg2(bskip + c);
      float2 sk = make_float2(acc[4 * j + 2 * h] + bS.x, acc[4 * j + 2 * h + 1] + bS.y);
      if (!first) {
        const float2 old = *reinterpret_cast<const float2*>(skip + at);
        sk = make_float2(old.x + sk.x, old.y + sk.y);
      }
      st2(skip + at, sk.x * keep, sk.y * keep);
    }
  }
};

// the in-conv over the stack's B T rows as one slab of the core, its taps
// kept within each sample
template <int NB>
__global__ void __launch_bounds__(tfc::THREADS, 1) wn_gate_kernel(tfc::Conv cv, Gate epi) {
  tfc::conv_core<NB, 1, true, tfc::Identity>(cv, epi);
}

template <int NB>
__global__ void __launch_bounds__(tfc::THREADS, 1) wn_res_skip_kernel(tfc::Conv cv, ResSkip epi) {
  tfc::conv_core<NB, 1, false, tfc::Identity>(cv, epi);
}

// A block's outputs (a multiple of 16: whole groups of 8 channels of both
// halves): 48 where they divide N (8 blocks across 2C = 384 at C = 192: 13 x
// 8 = 104 blocks over the 1600 rows of the training batch, one wave), else
// 32, else 16.
int gate(const tfc::Conv& cv, const Gate& e, int N, cudaStream_t s) {
  return N % 48 == 0 ? tfc::launch<48, 1>(wn_gate_kernel<48>, cv, e, 1, N, s)
                     : tfc::launch<32, 1>(wn_gate_kernel<32>, cv, e, 1, N, s);
}

int res_skip(const tfc::Conv& cv, const ResSkip& e, int N, cudaStream_t s) {
  if (N % 48 == 0) return tfc::launch<48, 1>(wn_res_skip_kernel<48>, cv, e, 1, N, s);
  if (N % 32 == 0) return tfc::launch<32, 1>(wn_res_skip_kernel<32>, cv, e, 1, N, s);
  return tfc::launch<16, 1>(wn_res_skip_kernel<16>, cv, e, 1, N, s);
}

}  // namespace

// Kernel 6. x (B, T, C); writes xs (L-1, B, T, C) (inputs of layers
// 1..L-1), pre_a, pre_b (L, B, T, C), out = skip * mask (B, T, C) and, when
// x_final is not null, the last layer's output x_L = (x + res + bres) mask
// there (B, T, C); acts: (B, T, C) scratch. w_ab, w_rs: each layer's
// in-conv, a (2C, C, k) conv with a and b interleaved by 8 channels, and its
// 1x1, a (2C, C, 1) conv with res and skip interleaved alike (the last
// layer's without x_final: skip in rows 0..C-1), each as
// ops/resblock.py::pack_tf32_wgmma_weights lays a conv out (ops/wavenet.py::
// pack_forward_weights). b_ab, g_ab, b_rs2, lengths as rvc_wn_fwd_simt. C a
// multiple of 16, at most 256, k odd (the wrapper checks). Two launches a
// layer on `stream`.
extern "C" int rvc_wn_fwd(const void* x, void* xs, void* pre_a, void* pre_b, void* out,
                          void* x_final, void* acts, const void* w_ab, const void* w_rs,
                          const void* b_ab, const void* g_ab, const void* b_rs2,
                          const void* lengths, int B, int T, int C, int k, int L,
                          void* stream) {
  const size_t btc = (size_t)B * T * C;
  // floats of one layer's packed in-conv and 1x1: 2 images of ceil(K / 32) slices of 2C rows
  const size_t s_ab = (size_t)2 * ((k * C + 31) / 32) * 2 * C * 32;
  const size_t s_rs = (size_t)2 * ((C + 31) / 32) * 2 * C * 32;
  const float* bab = (const float*)b_ab;
  const float* gab = (const float*)g_ab;
  const float* brs = (const float*)b_rs2;
  float* a = (float*)acts;
  cudaStream_t s = (cudaStream_t)stream;
  for (int i = 0; i < L; ++i) {
    const float* xi = i == 0 ? (const float*)x : (const float*)xs + (size_t)(i - 1) * btc;
    const bool last = i == L - 1;
    const tfc::Conv in_conv{xi, (const uint8_t*)((const float*)w_ab + i * s_ab), 2 * C, C, k,
                            1, B * T, T, 0, 0};
    const Gate ge{(float*)pre_a + i * btc, (float*)pre_b + i * btc, a, bab + (size_t)i * C,
                  bab + (size_t)(L + i) * C, gab + (size_t)i * C, gab + (size_t)(L + i) * C,
                  2 * L * C, T, C};
    int err = gate(in_conv, ge, 2 * C, s);
    if (err) return err;
    const tfc::Conv one{a, (const uint8_t*)((const float*)w_rs + i * s_rs), 2 * C, C, 1, 1,
                        B * T, T, 0, 0};
    float* x_next = last ? (float*)x_final : (float*)xs + (size_t)i * btc;
    const ResSkip re{xi, x_next, (float*)out, brs + (size_t)i * C, brs + (size_t)(L + i) * C,
                     (const int*)lengths, T, C, i == 0, last};
    if ((err = res_skip(one, re, x_next ? 2 * C : C, s))) return err;
  }
  return 0;
}
