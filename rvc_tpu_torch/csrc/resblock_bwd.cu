// The backward of one HiFiGAN ResBlock1 chain (kernel 5), float32-accurate,
// sm_90a: a tensor-core version (rvc_resblock1_bwd) and the float32 SIMT
// version it replaced (rvc_resblock1_bwd_simt, on no path of the port; kept
// as the same-run yardstick that chip_smoke.py times beside it).
//
// Replaces rvc_tpu/ops/pallas_resblock.py::_fused_bwd_call (glue
// _fused_resblock1_bwd), the VJP of fused_resblock1_train. One residual unit
// of the chain is
//     h -> a1 = lrelu(h) -> t = conv_a(a1) -> a2 = lrelu(t) -> u = conv_b(a2)
//       -> h + u
// with conv_a of kernel k and dilation d, conv_b of kernel k and dilation 1,
// every conv reading zeros outside [0, T) (the forward zeroes rows outside
// [0, T) after each conv, which is the same thing). Given the unit's input h
// (kept by kernel 4) and gy, the cotangent of its output, per unit and in
// reverse order:
//   1. dt: recompute t = conv_a(lrelu(h)) for a tile, da2 = conv_b^T(gy)
//      (the conv with flipped taps and transposed (C, C) blocks),
//      dt = da2 * lrelu'(t); writes dt and a2 = lrelu(t);
//   2. dx: dh = gy + conv_a^T(dt) * lrelu'(h); dh is the next unit's gy;
//   3. wgrad: dW_a[j] = sum a1[t + j d - p_a]^T dt[t], db_a = sum dt,
//      dW_b[j] = sum a2[t + j - p_b]^T gy[t], db_b = sum gy, by partial sums
//      per chunk of rows and a second pass that adds them in a fixed order.
// rvc_resblock1_bwd runs the units' kernels in stream order (4 launches a
// unit); the Python wrapper counts it as one launch.
//
// What bounds it: operations. Per unit, dt and dx are three convs of the
// forward's size and wgrad two more, 5 * 2 k C^2 flops per row, against 4
// reads and 3 writes of the (B, T, C) activations. On the float32 pipes
// (67 TFLOP/s) the SIMT version reached about a fifth of that pipe's bound,
// and at C = 256 (T = 432) its dt and dx launches had 56 blocks for 132 SMs.
// The tensor-core version runs all five convolutions in 3xTF32 on mma.sync
// (tc_rowconv.cuh): the three data convs as implicit GEMMs (blocks of up to
// 256 rows x 32 channels; at C = 256, 64 rows, 224 blocks), the two weight
// gradients as one split-K GEMM launch in which a block serves up to 6 taps
// of its (i, o) tile from one staged window of rows. The
// recomputed t therefore rounds as 3xTF32 products summed in float32, not as
// kernel 4's SIMT forward; a pre-activation within rounding of 0 may take the
// other leaky-ReLU slope, which ops/resblock.py::check_chain_grads allows
// for and nothing else does.

#include "tc_rowconv.cuh"

namespace {

using namespace rowk;

// rows [t0, t0 + M) of sample blockIdx.y: dt and a2
__global__ void __launch_bounds__(MAX_THREADS) rb_bwd_dt_kernel(
    const float* __restrict__ h, const float* __restrict__ gy, const float* __restrict__ wa,
    const float* __restrict__ ba, const float* __restrict__ wbT, float* __restrict__ dt,
    float* __restrict__ a2, int T, int C, int k, int da) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout l = layout(C);
  const int tx = threadIdx.x % l.NC, ty = threadIdx.x / l.NC;
  const int S = C + 4, pa = (k - 1) * da / 2, pb = (k - 1) / 2;
  const int rows_h = l.M + 2 * pa, rows_g = l.M + 2 * pb;
  float* hs = smem;
  float* gs = hs + (size_t)rows_h * S;
  const int b = blockIdx.y, t0 = blockIdx.x * l.M;
  const size_t base = (size_t)b * T * C;
  load_rows(hs, S, h + base, C, t0 - pa, rows_h, T, true);
  load_rows(gs, S, gy + base, C, t0 - pb, rows_g, T, false);
  __syncthreads();
  float acc_t[1][RM][4], acc_g[1][RM][4];
  const float4 bias = ldg4(ba + 4 * tx);
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    acc_t[0][m][0] = bias.x;
    acc_t[0][m][1] = bias.y;
    acc_t[0][m][2] = bias.z;
    acc_t[0][m][3] = bias.w;
  }
  zero_acc(acc_g);
  const float* wa_[1] = {wa};
  const float* wb_[1] = {wbT};
  rowconv<1>(hs, S, C, wa_, C, k, da, acc_t, tx, ty, l.NR);
  rowconv<1>(gs, S, C, wb_, C, k, 1, acc_g, tx, ty, l.NR);
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = t0 + ty + m * l.NR;
    if (r >= T) continue;
    const float* t = acc_t[0][m];
    const float* g = acc_g[0][m];
    const size_t at = base + (size_t)r * C + 4 * tx;
    st4(a2 + at, lrelu(t[0]), lrelu(t[1]), lrelu(t[2]), lrelu(t[3]));
    st4(dt + at, g[0] * lrelu_grad(t[0]), g[1] * lrelu_grad(t[1]), g[2] * lrelu_grad(t[2]),
        g[3] * lrelu_grad(t[3]));
  }
}

// rows [t0, t0 + M) of sample blockIdx.y: dh = gy + conv_a^T(dt) * lrelu'(h)
__global__ void __launch_bounds__(MAX_THREADS) rb_bwd_dx_kernel(
    const float* __restrict__ h, const float* __restrict__ gy, const float* __restrict__ dt,
    const float* __restrict__ waT, float* __restrict__ dh, int T, int C, int k, int da) {
  extern __shared__ float4 smem4[];
  float* ds = reinterpret_cast<float*>(smem4);
  const Layout l = layout(C);
  const int tx = threadIdx.x % l.NC, ty = threadIdx.x / l.NC;
  const int S = C + 4, pa = (k - 1) * da / 2;
  const int b = blockIdx.y, t0 = blockIdx.x * l.M;
  const size_t base = (size_t)b * T * C;
  load_rows(ds, S, dt + base, C, t0 - pa, l.M + 2 * pa, T, false);
  __syncthreads();
  float acc[1][RM][4];
  zero_acc(acc);
  const float* w_[1] = {waT};
  rowconv<1>(ds, S, C, w_, C, k, da, acc, tx, ty, l.NR);
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = t0 + ty + m * l.NR;
    if (r >= T) continue;
    const size_t at = base + (size_t)r * C + 4 * tx;
    const float4 hv = ldg4(h + at), g = ldg4(gy + at);
    const float* a = acc[0][m];
    st4(dh + at, g.x + a[0] * lrelu_grad(hv.x), g.y + a[1] * lrelu_grad(hv.y),
        g.z + a[2] * lrelu_grad(hv.z), g.w + a[3] * lrelu_grad(hv.w));
  }
}

size_t act_floats(int B, int T, int C) { return (size_t)B * T * C; }

WgPlan plan_for(int B, int T, int C, int k) {
  const int ks[2] = {k, k};
  return wgrad_plan(B, T, C, 2, ks);
}

}  // namespace

// Workspace of rvc_resblock1_bwd_simt, in floats.
extern "C" long long rvc_resblock1_bwd_simt_workspace(int B, int T, int C, int k) {
  const int ks[2] = {k, k};
  return (long long)(4 * act_floats(B, T, C) + wgrad_floats(B, T, C, 2, ks));
}

// x (B, T, C): the chain's input; hs (n-1, B, T, C): the inputs of units
// 1..n-1; gy: the cotangent of the chain's output; w, wT (2n, k, C, C): the
// convs' taps [tap][in][out] and their flipped transposes; b (2n, C).
// Writes dx (B, T, C), dw (2n, k, C, C) [tap][in][out], db (2n, C).
// C a multiple of 16, at most 256 (the wrapper checks).
extern "C" int rvc_resblock1_bwd_simt(const void* x, const void* hs, const void* gy,
                                      const void* w, const void* wT, const void* b, void* dx,
                                      void* dw, void* db, void* work, long long work_floats,
                                      int B, int T, int C, int k, int n_units, const int* dil,
                                      void* stream) {
  const size_t btc = act_floats(B, T, C), wsz = (size_t)k * C * C;
  if (work_floats < rvc_resblock1_bwd_simt_workspace(B, T, C, k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* wk = (float*)work;
  float* gbuf[2] = {wk, wk + btc};
  float* dtb = wk + 2 * btc;
  float* a2b = wk + 3 * btc;
  float* part = wk + 4 * btc;
  const float* wf = (const float*)w;
  const float* wtf = (const float*)wT;
  const float* bf = (const float*)b;
  const Layout l = layout(C);
  const int S = C + 4;
  const float* g = (const float*)gy;
  for (int u = n_units - 1; u >= 0; --u) {
    const int da = dil[u], pa = (k - 1) * da / 2, pb = (k - 1) / 2;
    const float* h = u == 0 ? (const float*)x : (const float*)hs + (size_t)(u - 1) * btc;
    float* dh = u == 0 ? (float*)dx : gbuf[u % 2];
    const dim3 grid((T + l.M - 1) / l.M, B);
    const int smem_dt = ((l.M + 2 * pa) + (l.M + 2 * pb)) * S * 4;
    const int smem_dx = (l.M + 2 * pa) * S * 4;
    cudaError_t err = allow_smem((const void*)rb_bwd_dt_kernel, smem_dt);
    if (err == cudaSuccess) err = allow_smem((const void*)rb_bwd_dx_kernel, smem_dx);
    if (err != cudaSuccess) return (int)err;
    rb_bwd_dt_kernel<<<grid, l.threads, smem_dt, s>>>(h, g, wf + 2 * u * wsz, bf + 2 * u * C,
                                                      wtf + (2 * u + 1) * wsz, dtb, a2b, T, C,
                                                      k, da);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    rb_bwd_dx_kernel<<<grid, l.threads, smem_dx, s>>>(h, g, dtb, wtf + 2 * u * wsz, dh, T, C,
                                                      k, da);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    WgPlan P = plan_for(B, T, C, k);
    P.job[0] = WgJob{h, dtb, (float*)dw + 2 * u * wsz, (float*)db + 2 * u * C, nullptr,
                     k, da, pa, 1, 0};
    P.job[1] = WgJob{a2b, g, (float*)dw + (2 * u + 1) * wsz, (float*)db + (2 * u + 1) * C,
                     nullptr, k, 1, pb, 0, 0};
    if ((err = wgrad_launch(P, part, s)) != cudaSuccess) return (int)err;
    g = dh;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// kernel 5 on the tensor cores

namespace {

// rows [t0, t0 + M) of sample blockIdx.y, the channels of blockIdx.z: dt and a2
template <int NT>
__global__ void __launch_bounds__(32 * tck::MAX_WARPS, 2) rb_tc_dt_kernel(
    const float* __restrict__ h, const float* __restrict__ gy, const float4* __restrict__ pa,
    const float* __restrict__ ba, const float4* __restrict__ pbT, float* __restrict__ dt,
    float* __restrict__ a2, int T, int C, int k, int da) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const tck::Warp W = tck::warp_of<NT>(C);
  const int M = blockDim.x / 32 * tck::WROWS;
  const int tile_rows = M + (k - 1) * da;
  float4* ring = smem4 + (size_t)tile_rows * tck::pitch(C) / 4;
  const int b = blockIdx.y, t0 = blockIdx.x * M, rows = min(M, T - t0);
  const int pa_ = (k - 1) * da / 2, pb_ = (k - 1) / 2;
  const float* hb = h + (size_t)b * T * C;
  const float* gb = gy + (size_t)b * T * C;
  float acc[tck::MT][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = 8 * (W.n0 + nt) + 2 * W.t;
    const float2 bv =
        n < C ? __ldg(reinterpret_cast<const float2*>(ba + n)) : make_float2(0.f, 0.f);
#pragma unroll
    for (int mt = 0; mt < tck::MT; ++mt) {
      acc[mt][nt][0] = bv.x; acc[mt][nt][1] = bv.y;
      acc[mt][nt][2] = bv.x; acc[mt][nt][3] = bv.y;
    }
  }
  tck::conv<NT, true>(tile, ring, pa, C, C, k, da, acc, W,
                      [&](float* tl, int S, int c0, int cw) {
                        tck::stage_rows(tl, S, hb, nullptr, C, c0, cw, t0 - pa_, M + 2 * pa_, T);
                      });
  // t > 0 per sum, one bit each (MT * NT * 4 <= 64)
  unsigned long long pos = 0;
  const size_t base = (size_t)b * T * C + (size_t)t0 * C;
  tck::for_outputs<NT>(acc, rows, C, W, [&](int mt, int hh, int nt, int r, int n, float v0,
                                           float v1) {
    const int bit = ((mt * NT + nt) * 2 + hh) * 2;
    pos |= (v0 > 0.f ? 1ull : 0ull) << bit;
    pos |= (v1 > 0.f ? 1ull : 0ull) << (bit + 1);
    *reinterpret_cast<float2*>(a2 + base + (size_t)r * C + n) =
        make_float2(rowk::lrelu(v0), rowk::lrelu(v1));
  });
  tck::zero<NT>(acc);
  tck::conv<NT>(tile, ring, pbT, C, C, k, 1, acc, W,
                [&](float* tl, int S, int c0, int cw) {
                  tck::stage_rows(tl, S, gb, nullptr, C, c0, cw, t0 - pb_, M + 2 * pb_, T);
                });
  tck::for_outputs<NT>(acc, rows, C, W, [&](int mt, int hh, int nt, int r, int n, float v0,
                                           float v1) {
    const int bit = ((mt * NT + nt) * 2 + hh) * 2;
    const float s0 = (pos >> bit) & 1ull ? 1.f : rowk::SLOPE;
    const float s1 = (pos >> (bit + 1)) & 1ull ? 1.f : rowk::SLOPE;
    *reinterpret_cast<float2*>(dt + base + (size_t)r * C + n) = make_float2(v0 * s0, v1 * s1);
  });
}

// rows [t0, t0 + M) of sample blockIdx.y, the channels of blockIdx.z:
// dh = gy + conv_a^T(dt) * lrelu'(h)
template <int NT>
__global__ void __launch_bounds__(32 * tck::MAX_WARPS) rb_tc_dx_kernel(
    const float* __restrict__ h, const float* __restrict__ gy, const float* __restrict__ dt,
    const float4* __restrict__ paT, float* __restrict__ dh, int T, int C, int k, int da) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const tck::Warp W = tck::warp_of<NT>(C);
  const int M = blockDim.x / 32 * tck::WROWS;
  const int tile_rows = M + (k - 1) * da;
  float4* ring = smem4 + (size_t)tile_rows * tck::pitch(C) / 4;
  const int b = blockIdx.y, t0 = blockIdx.x * M, rows = min(M, T - t0);
  const int pa_ = (k - 1) * da / 2;
  const float* db_ = dt + (size_t)b * T * C;
  float acc[tck::MT][NT][4];
  tck::zero<NT>(acc);
  tck::conv<NT>(tile, ring, paT, C, C, k, da, acc, W,
                [&](float* tl, int S, int c0, int cw) {
                  tck::stage_rows(tl, S, db_, nullptr, C, c0, cw, t0 - pa_, M + 2 * pa_, T);
                });
  const size_t base = (size_t)b * T * C + (size_t)t0 * C;
  tck::for_outputs<NT>(acc, rows, C, W, [&](int, int, int, int r, int n, float v0, float v1) {
    const size_t at = base + (size_t)r * C + n;
    const float2 hv = __ldg(reinterpret_cast<const float2*>(h + at));
    const float2 g = __ldg(reinterpret_cast<const float2*>(gy + at));
    *reinterpret_cast<float2*>(dh + at) =
        make_float2(g.x + v0 * rowk::lrelu_grad(hv.x), g.y + v1 * rowk::lrelu_grad(hv.y));
  });
}

tck::TcWgPlan tc_plan(int B, int T, int C, int k, int da) {
  const int ks[2] = {k, k}, ds[2] = {da, 1};
  return tck::tc_wgrad_plan(B, T, C, 2, ks, ds);
}

template <int NT>
cudaError_t launch_unit(const tck::Geo& G, const float* h, const float* g, const float4* pa,
                        const float* ba, const float4* pbT, const float4* paT, float* dtb,
                        float* a2b, float* dh, int T, int C, int k, int da, cudaStream_t s) {
  const int smem = G.smem(C, k, da);  // conv_a's halo, at least conv_b^T's
  cudaError_t err = rowk::allow_smem((const void*)rb_tc_dt_kernel<NT>, smem);
  if (err == cudaSuccess) err = rowk::allow_smem((const void*)rb_tc_dx_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  rb_tc_dt_kernel<NT><<<G.grid, G.threads, smem, s>>>(h, g, pa, ba, pbT, dtb, a2b, T, C, k,
                                                         da);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rb_tc_dx_kernel<NT><<<G.grid, G.threads, smem, s>>>(h, g, dtb, paT, dh, T, C, k, da);
  return cudaGetLastError();
}

}  // namespace

// Workspace of rvc_resblock1_bwd, in floats (the dilation only moves the
// workspace's layout, not its size).
extern "C" long long rvc_resblock1_bwd_workspace(int B, int T, int C, int k) {
  return (long long)(4 * act_floats(B, T, C) + tck::tc_wgrad_floats(tc_plan(B, T, C, k, 1)));
}

// Kernel 5. x (B, T, C): the chain's input; hs (n-1, B, T, C): the inputs of
// units 1..n-1; gy: the cotangent of the chain's output; pa (n packed convs):
// each unit's conv_a; pT (2n packed convs): every conv's flipped transpose,
// both as ops/resblock.py::pack_tf32_weights lays a (C, C, k) conv out
// (k C/8 k8 steps x C/8 n8 tiles x 32 lanes of float4); b (2n, C). Writes
// dx (B, T, C), dw (2n, k, C, C) [tap][in][out], db (2n, C). C a multiple
// of 16, at most 256, k odd, at most 15 (the wrapper checks).
extern "C" int rvc_resblock1_bwd(const void* x, const void* hs, const void* gy, const void* pa,
                                 const void* pT, const void* b, void* dx, void* dw, void* db,
                                 void* work, long long work_floats, int B, int T, int C, int k,
                                 int n_units, const int* dil, void* stream) {
  const size_t btc = act_floats(B, T, C), wsz = (size_t)k * C * C;
  if (work_floats < rvc_resblock1_bwd_workspace(B, T, C, k) || k > tck::WG_MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* wk = (float*)work;
  float* gbuf[2] = {wk, wk + btc};
  float* dtb = wk + 2 * btc;
  float* a2b = wk + 3 * btc;
  float* part = wk + 4 * btc;
  const float4* pa4 = (const float4*)pa;
  const float4* pT4 = (const float4*)pT;
  const size_t psz = 2 * wsz / 4;  // float4 of one packed conv
  const float* bf = (const float*)b;
  const float* g = (const float*)gy;
  const tck::Geo G = tck::geo(B, T, C);
  for (int u = n_units - 1; u >= 0; --u) {
    const int da = dil[u], pa_ = (k - 1) * da / 2, pb = (k - 1) / 2;
    const float* h = u == 0 ? (const float*)x : (const float*)hs + (size_t)(u - 1) * btc;
    float* dh = u == 0 ? (float*)dx : gbuf[u % 2];
    const float4* wa = pa4 + u * psz;
    const float4* waT = pT4 + 2 * u * psz;
    const float4* wbT = pT4 + (2 * u + 1) * psz;
    cudaError_t err = G.NT == 4
        ? launch_unit<4>(G, h, g, wa, bf + 2 * u * C, wbT, waT, dtb, a2b, dh, T, C, k, da, s)
        : launch_unit<2>(G, h, g, wa, bf + 2 * u * C, wbT, waT, dtb, a2b, dh, T, C, k, da, s);
    if (err != cudaSuccess) return (int)err;
    tck::TcWgPlan P = tc_plan(B, T, C, k, da);
    P.P.job[0] = rowk::WgJob{h, dtb, (float*)dw + 2 * u * wsz, (float*)db + 2 * u * C,
                             nullptr, k, da, pa_, 1, 0};
    P.P.job[1] = rowk::WgJob{a2b, g, (float*)dw + (2 * u + 1) * wsz,
                             (float*)db + (2 * u + 1) * C, nullptr, k, 1, pb, 0, 0};
    if ((err = tck::tc_wgrad_launch(P, part, s)) != cudaSuccess) return (int)err;
    g = dh;
  }
  return 0;
}
