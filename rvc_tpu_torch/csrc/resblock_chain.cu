// Kernel 4: one ResBlock1 chain forward in float32 (the forward of
// fused_resblock1_train), for sm_90a, on wgmma in 3xTF32.
//
// Replaces rvc_tpu/ops/pallas_resblock.py::_fused_call (its pallas_call at
// :171), the primal of fused_resblock1_train: for each of the chain's n units
//     h' = h + conv_b(lrelu(conv_a(lrelu(h)))),
// conv_a of kernel k and dilation d, conv_b of kernel k and dilation 1, rows
// outside [0, T) zero at every conv (torch's same padding), each unit's output
// kept for the backward (kernel 5, resblock_bwd.cu).
//
// What bounds it: operations. A conv does k C^2 multiply-adds a row, three
// TF32 passes of them on the tensor cores (a . w ~ a_big.w_big + a_big.w_small
// + a_small.w_big, float32-level error: mma.cuh); at the training run's shapes
// (batch 4, (T, C) from (432, 256) to (17280, 32)) that is 0.93 ms a step at
// the card's TF32 rate. The SIMT unit kernel that ran it before
// (resblock_group.cu, rvc_resblock1_fwd_simt, chip_smoke.py's yardstick) ran
// them on the float32 pipes at 11.7 times the bound. The design (the conv
// core it shares with kernel 6, tf32_conv.cuh, has the rest):
// - one launch per conv, not per unit: a block owns M = 128 rows of a sample
//   and NB of the C output channels, so a stage's grid has (T / 128) x
//   (C / NB) x batch blocks. At the first stage (T = 432, C = 256) a unit a
//   launch gave 16 blocks for 132 SMs; with NB = 32 it is 128. conv_a writes
//   t = conv_a + bias (rows in [0, T)) to a scratch buffer, conv_b reads it
//   back with its halo (zero outside [0, T)) and adds the unit's input: one
//   extra write and read of the activations a unit, from L2;
// - the core's products on wgmma m64nNBk8 in 3xTF32, A through the leaky
//   ReLU as it is loaded, B streamed from the two weight images that
//   ops/resblock.py::pack_tf32_wgmma_weights writes once per set of weights
//   (a chain in one batch);
// - at C <= 64 with NB <= 32 two blocks an SM, so that one block's tile load
//   and epilogue run under the other's products (in half the registers, so
//   without the A prefetch);
// - bias and the residual in the epilogue, float2 stores straight from the
//   wgmma registers.
// What holds it back now (chip_smoke, H100 SXM): 4.6 times its bound over a
// step. The first stage's 128 blocks load a 180 KB tile each for 32 outputs
// and keep only 5 ring slots beside it; the second stage's 272 blocks are
// 2.06 waves at one block an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_conv.cuh"

namespace {

// out[r, c] = acc + bias[c] (+ res[r, c]) for the thread's output pairs c,
// c + 1 of row r
struct BiasResidual {
  float* out;
  const float* res;
  const float* bias;
  int C;
  template <int N2>
  __device__ __forceinline__ void operator()(int r, int h, int n0, int t,
                                             const float (&acc)[N2]) const {
#pragma unroll
    for (int j = 0; j < N2 / 4; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + c));
      float2 v = make_float2(acc[4 * j + 2 * h] + bv.x, acc[4 * j + 2 * h + 1] + bv.y);
      if (res) {
        const float2 hv = __ldg(reinterpret_cast<const float2*>(res + (size_t)r * C + c));
        v = make_float2(hv.x + v.x, hv.y + v.y);
      }
      *reinterpret_cast<float2*>(out + (size_t)r * C + c) = v;
    }
  }
};

// out[b, r, n0 + c] = bias + (res) + sum_{j, i} lrelu(in[b, r + j d - p, i]) w[n0 + c, i, j]
// for the block's M rows of sample blockIdx.z and NB outputs; in zero
// outside [0, T) (a sample a slab of the core). MINB: blocks an SM.
template <int NB, int MINB>
__global__ void __launch_bounds__(tfc::THREADS, MINB)
    chain_conv_kernel(tfc::Conv cv, BiasResidual epi) {
  tfc::conv_core<NB, MINB, false, tfc::LeakyRelu>(cv, epi);
}

template <int NB, int MINB>
int launch_conv(const float* in, const float* res, float* out, const void* w, const float* bias,
                int B, int T, int C, int k, int d, float slope, cudaStream_t stream) {
  const tfc::Conv cv{in, (const uint8_t*)w, C, C, k, d, T, T, 0, 0, slope};
  return tfc::launch<NB, MINB>(chain_conv_kernel<NB, MINB>, cv, BiasResidual{out, res, bias, C},
                               B, C, stream);
}

// The block's outputs: 32 at C = 256, so that the first stage's grid fills
// the card and its tile and ring fit; else the widest of 64, 32, 16 that
// divides C. Two blocks an SM at C <= 64 (with 32 or 16 outputs: their sums
// fit in half the registers), so that one block's tile load and epilogue run
// under the other's products; one where the tile is wider.
int conv(const float* in, const float* res, float* out, const void* w, const float* bias, int B,
         int T, int C, int k, int d, float slope, cudaStream_t stream) {
  if (C % 64 == 0 && C != 256)
    return launch_conv<64, 1>(in, res, out, w, bias, B, T, C, k, d, slope, stream);
  if (C % 32 == 0)
    return C <= 64 ? launch_conv<32, 2>(in, res, out, w, bias, B, T, C, k, d, slope, stream)
                   : launch_conv<32, 1>(in, res, out, w, bias, B, T, C, k, d, slope, stream);
  return C <= 64 ? launch_conv<16, 2>(in, res, out, w, bias, B, T, C, k, d, slope, stream)
                 : launch_conv<16, 1>(in, res, out, w, bias, B, T, C, k, d, slope, stream);
}

}  // namespace

// Kernel 4. x, out: (B, T, C) float32; hs: (n_units - 1, B, T, C), unit u's
// output for u < n_units - 1 (the input of unit u + 1, kept for kernel 5);
// t: (B, T, C) scratch; w[c]: conv c's weights as pack_tf32_wgmma_weights lays
// them out (2n convs in chain order); bias: (2n, C); dil[u]: the dilation of
// unit u's first conv (the second has dilation 1); slope: the leaky ReLU's
// (0.1; bf16(0.1) where the bf16 training route recomputes the chain in
// float32, as the JAX backward does). C a multiple of 16 up to 256 (the
// wrapper checks). Two launches a unit on `stream`.
extern "C" int rvc_resblock1_fwd(const void* x, void* hs, void* out, void* t,
                                 const void* const* w, const void* bias, int B, int T, int C,
                                 int k, int n_units, const int* dil, float slope,
                                 void* stream) {
  const size_t btc = (size_t)B * T * C;
  const float* bf = (const float*)bias;
  const float* h = (const float*)x;
  float* tf = (float*)t;
  cudaStream_t s = (cudaStream_t)stream;
  for (int u = 0; u < n_units; ++u) {
    float* dst = u == n_units - 1 ? (float*)out : (float*)hs + (size_t)u * btc;
    int err = conv(h, nullptr, tf, w[2 * u], bf + 2 * u * C, B, T, C, k, dil[u], slope, s);
    if (!err)
      err = conv(tf, h, dst, w[2 * u + 1], bf + (2 * u + 1) * C, B, T, C, k, 1, slope, s);
    if (err) return err;
    h = dst;
  }
  return 0;
}
