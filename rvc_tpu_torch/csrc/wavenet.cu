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
// Forward: one launch per layer (a whole-stack tile would need an L (k-1)
// row halo): a block loads its rows of x with the k-tap halo into shared
// memory, computes a and b in registers (rowconv, both halves in one pass),
// writes them out for the backward, puts the gate's output in shared memory
// and applies the res/skip 1x1 products, the mask and the skip accumulation.
// C = 192 needs no padding: the block has C/4 column threads.
//
// Backward, per layer in reverse (the forward's x_i and a, b kept):
//   gate: d_res = dx_{i+1} mask, d_acts = [d_res | ds] [Wres^T; Wskip^T]
//         (ds = gy mask), d_a = d_acts sigmoid(b)(1 - tanh(a)^2),
//         d_b = d_acts tanh(a) sigmoid(b)(1 - sigmoid(b));
//   dx:   dx_i = d_res + conv over [d_a | d_b] with the flipped transposed
//         in-conv taps;
//   wgrad (rowconv.cuh): dW{a,b}_i = sum x_i[t + j - p]^T d_{a,b}[t],
//         dWres_i = sum acts^T d_res, dWskip_i = sum acts^T ds, the bias
//         sums, and dG[b, i] = sum over t of d_a[b, t] (the conditioning is
//         broadcast along T), the same for d_b.
// Rows at and past lengths[b] get d_acts = 0, but dx reaches the conv halo
// past them, as autograd of the layer-by-layer module does.
//
// What bounds it: operations. A layer's in-conv does 2 k C^2 multiply-adds
// per row for each half and the 1x1 products 2 C^2, about 1.1 GFLOP per
// layer at (4, 400, 192), against ~4 MB of activations moved.

#include "rowconv.cuh"

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

// x (B, T, C); writes xs (L-1, B, T, C) (inputs of layers 1..L-1), pre_a,
// pre_b (L, B, T, C) and out = skip * mask (B, T, C). Weights as the module
// docstring; g_ab (B, 2L, C); lengths (B,) int32. C a multiple of 16, at
// most 256, k odd (the wrapper checks).
extern "C" int rvc_wn_fwd(const void* x, void* xs, void* pre_a, void* pre_b, void* out,
                          const void* w_a, const void* w_b, const void* b_ab, const void* g_ab,
                          const void* w_res, const void* w_skip, const void* b_rs2,
                          const void* lengths, int B, int T, int C, int k, int L,
                          void* stream) {
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

// Workspace of rvc_wn_bwd, in floats.
extern "C" long long rvc_wn_bwd_workspace(int B, int T, int C, int k) {
  const int ks[4] = {k, k, 1, 1};
  return (long long)(7 * (size_t)B * T * C + wgrad_floats(B, T, C, 4, ks));
}

// The VJP of rvc_wn_fwd. wabT (L, k, 2C, C): [d_a | d_b] -> dx taps;
// wrsT (L, 2C, C): [Wres_i^T; Wskip_i^T]. Writes dx (B, T, C) and the
// weight gradients dwa, dwb (L k, C, C), dbab (2L, C), dg (B, 2L, C),
// dwres, dwskip (L, C, C), dbrs (2L, C).
extern "C" int rvc_wn_bwd(const void* x, const void* xs, const void* pre_a, const void* pre_b,
                          const void* gy, const void* wabT, const void* wrsT,
                          const void* lengths, void* dx, void* dwa, void* dwb, void* dbab,
                          void* dg, void* dwres, void* dwskip, void* dbrs, void* work,
                          long long work_floats, int B, int T, int C, int k, int L,
                          void* stream) {
  const size_t btc = (size_t)B * T * C, wk = (size_t)k * C * C, cc = (size_t)C * C;
  if (work_floats < rvc_wn_bwd_workspace(B, T, C, k)) return (int)cudaErrorInvalidValue;
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
