// The backward of one HiFiGAN ResBlock1 chain (kernel 5), float32, sm_90a.
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
//   1. bwd_dt: recompute t for a tile (conv_a over lrelu(h) with its halo in
//      shared memory), da2 = conv_b^T(gy) (the conv with flipped taps and
//      transposed (C, C) blocks, gy with its halo in shared memory),
//      dt = da2 * lrelu'(t); writes dt and a2 = lrelu(t);
//   2. bwd_dx: dh = gy + conv_a^T(dt) * lrelu'(h); dh is the next unit's gy;
//   3. wgrad (rowconv.cuh): dW_a[j] = sum a1[t + j d - p_a]^T dt[t],
//      db_a = sum dt, dW_b[j] = sum a2[t + j - p_b]^T gy[t], db_b = sum gy,
//      by per-block partial sums and a second pass in a fixed order.
// rvc_resblock1_bwd runs the three units' kernels in stream order; the
// Python wrapper counts it as one launch.
//
// What bounds it: operations. Per unit, bwd_dt and bwd_dx are three convs
// of the forward's size and wgrad two more, 5 * 2 k C^2 flops per row, against
// 4 reads and 3 writes of the (B, T, C) activations. Design: the data convs
// are rowconv tiles as in the forward (a tile's inputs and halo in shared
// memory, sums in registers); the weight reductions are split into chunks of
// rows per sample, the chunk length picked per stage so that the first pass
// fills the card whether the stage is long and narrow (C = 32, 69120 rows) or
// short and wide (C = 256, 1728 rows).

#include "rowconv.cuh"

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

// Workspace of rvc_resblock1_bwd, in floats.
extern "C" long long rvc_resblock1_bwd_workspace(int B, int T, int C, int k) {
  const int ks[2] = {k, k};
  return (long long)(4 * act_floats(B, T, C) + wgrad_floats(B, T, C, 2, ks));
}

// x (B, T, C): the chain's input; hs (n-1, B, T, C): the inputs of units
// 1..n-1; gy: the cotangent of the chain's output; w, wT (2n, k, C, C): the
// convs' taps [tap][in][out] and their flipped transposes; b (2n, C).
// Writes dx (B, T, C), dw (2n, k, C, C) [tap][in][out], db (2n, C).
// C a multiple of 16, at most 256 (the wrapper checks).
extern "C" int rvc_resblock1_bwd(const void* x, const void* hs, const void* gy, const void* w,
                                 const void* wT, const void* b, void* dx, void* dw, void* db,
                                 void* work, long long work_floats, int B, int T, int C, int k,
                                 int n_units, const int* dil, void* stream) {
  const size_t btc = act_floats(B, T, C), wsz = (size_t)k * C * C;
  if (work_floats < rvc_resblock1_bwd_workspace(B, T, C, k)) return (int)cudaErrorInvalidValue;
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
