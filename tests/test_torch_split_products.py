"""The split-precision arithmetic of kernels 1 and 3, emulated in plain torch
on the CPU.

Kernel 3 (``csrc/nearest_rows.cu``) takes its dot products on the tensor
cores from bf16 pieces: a float32 query is hi + mid + lo, three bf16 pieces
(exact), an int8 bank value is bf16-exact, so every piece product is exact
in float32. Kernel 1 (``csrc/resblock_group.cu``) runs its convs in 3xTF32:
a.w ~ a_big.w_big + a_big.w_small + a_small.w_big. Here each split is
checked, the kernel-1 weight packing is checked to round-trip bit for bit,
and each kernel's arithmetic, emulated by the piece products summed in
float32, is held against the exact plain version and against the JAX
package on the same numpy inputs. The CUDA kernels themselves are held
against the plain versions on the card (test_torch_gpu.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import no_compile_cache_writes  # noqa: F401
from rvc_tpu.ops import pallas_retrieval as jret
from rvc_tpu.ops.pallas_resblock import fused_resblock_group as jax_group
from rvc_tpu_torch.ops import resblock, retrieval


def split_bf16x3(x: torch.Tensor):
    """mma.cuh::split_bf16x3: hi = bf16(x), mid = bf16(x - hi), lo =
    bf16(x - hi - mid), each rounded to nearest even, as float32."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


tf32_round = resblock.tf32_round  # the wrapper's rounding, as mma.cuh::tf32_round


def split_tf32(x: torch.Tensor):
    """mma.cuh::split_tf32: big = tf32(x), small = tf32(x - big)."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def _spread(rng, shape, lo=-6, hi=6):
    """Values whose magnitudes span 10^lo .. 10^hi, both signs."""
    mag = 10.0 ** rng.uniform(lo, hi, shape)
    return (rng.choice([-1.0, 1.0], shape) * mag * rng.uniform(1, 2, shape)).astype(np.float32)


def test_bf16_pieces_sum_exactly(rng):
    x = torch.from_numpy(_spread(rng, (4096,)))
    hi, mid, lo = split_bf16x3(x)
    for p in (hi, mid, lo):  # each piece is a bf16 value
        assert torch.equal(p, p.to(torch.bfloat16).float())
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    # and the three pieces in float32, summed smallest first, give x back
    assert torch.equal((lo + mid) + hi, x)


def test_tf32_split_residual(rng):
    """big and small carry 11 significant bits each (low 13 bits zero); the
    residual x - big - small is within 2^-22 of |x|."""
    x = torch.from_numpy(_spread(rng, (4096,)))
    big, small = split_tf32(x)
    for p in (big, small):
        assert torch.all((p.view(torch.int32) & 0x1FFF) == 0)
    res = (x.double() - big.double() - small.double()).abs()
    assert torch.all(res <= 2.0 ** -22 * x.double().abs())
    # ties away from zero, as cvt.rna rounds: 1 + 2^-11 is halfway
    t = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)], dtype=torch.float32)
    assert tf32_round(t).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]


@pytest.mark.parametrize("C,k", [(16, 3), (32, 11), (64, 7)])
def test_kernel1_weight_packing_round_trips(rng, C, k):
    """Kernel 1's weights, split on the host and laid out in B-fragment
    order: unpacked, big + residual gives the weights back bit for bit."""
    w = torch.from_numpy(_spread(rng, (C, C, k), -3, 1))
    packed = resblock.pack_tf32_weights(w)
    assert packed.shape == (k * C * C * 2,)
    big, r = resblock.unpack_tf32_weights(packed, C, k)
    assert torch.equal(big, tf32_round(w))
    assert torch.equal((big + r).view(torch.int32), w.view(torch.int32))
    # the fragment order: k8 step (tap j, inputs 8s..), n8 tile, lane 4g + t,
    # (k t, k t + 4) stored at inputs 8s + 2t, 8s + 2t + 1
    frag = packed.reshape(k, C // 8, C // 8, 32, 4)
    for j, s, n, g, t in ((k - 1, C // 8 - 1, 1, 5, 3), (0, 0, 0, 0, 0), (k // 2, 1, 0, 7, 2)):
        o, i = 8 * n + g, 8 * s + 2 * t
        assert frag[j, s, n, 4 * g + t].tolist() == [big[o, i, j], big[o, i + 1, j],
                                                     r[o, i, j], r[o, i + 1, j]]


def nearest_emulated(feats: torch.Tensor, bank: torch.Tensor, scales) -> torch.Tensor:
    """Kernel 3's arithmetic: the dot as bf16 piece products summed in
    float32 (int8 bank: three; float32 bank: the six of the kernel), then
    d = |b|^2 s^2 - 2 s (q.b), the first least d, the row gathered."""
    q = split_bf16x3(feats)
    if scales is not None:
        b = bank.float()
        dots = q[0] @ b.T + q[1] @ b.T + q[2] @ b.T
        s = scales[:, 0]
    else:
        b = split_bf16x3(bank)
        pairs = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
        dots = sum(q[i] @ b[j].T for i, j in pairs)
        s = torch.ones(bank.shape[0])
    bf = bank.float()
    d = torch.sum(bf * bf, 1) * s * s - 2.0 * (dots * s)
    idx = torch.argmin(d, dim=1)
    return bf[idx] * s[idx, None]


@pytest.mark.parametrize("int8", [True, False])
def test_kernel3_arithmetic_matches_plain_and_pallas(rng, int8):
    """Same rows as the exact plain version and the Pallas kernel
    (interpret mode) over a bank of 3 Pallas tiles; queries span 1e-3 .. 1e3
    in magnitude."""
    T, N, D = 40, 2 * jret.TN + 500, 64
    feats = _spread(rng, (T, D), -3, 3) / 100.0
    bank = rng.standard_normal((N, D)).astype(np.float32)
    bank[: T] = feats * 0.9 + 0.01  # near rows for every query
    if int8:
        bq, s = (np.array(a) for a in jret.quantize_bank(bank))
        ref = jret.nearest_rows_q(jnp.asarray(feats), jnp.asarray(bq), jnp.asarray(s),
                                  interpret=True)
        got = nearest_emulated(torch.from_numpy(feats), torch.from_numpy(bq),
                               torch.from_numpy(s))
        plain = retrieval.nearest_rows_q(torch.from_numpy(feats), torch.from_numpy(bq),
                                         torch.from_numpy(s))
    else:
        ref = jret.nearest_rows(jnp.asarray(feats), jnp.asarray(bank), interpret=True)
        got = nearest_emulated(torch.from_numpy(feats), torch.from_numpy(bank), None)
        plain = retrieval.nearest_rows(torch.from_numpy(feats), torch.from_numpy(bank))
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def conv_3xtf32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """A conv as kernel 1 computes it: x (B, C, T), w (O, I, k); the three
    TF32 piece products, each exact in float32, summed in float32."""
    k = w.shape[2]
    xb, xs = split_tf32(x)
    wb, ws = split_tf32(w)
    pad = (k - 1) * d // 2
    conv = lambda a, v: F.conv1d(a, v, padding=pad, dilation=d)  # noqa: E731
    return conv(xb, ws) + conv(xs, wb) + conv(xb, wb) + b[None, :, None]


def group_emulated(x: torch.Tensor, chains) -> torch.Tensor:
    h0 = x.transpose(1, 2)
    acc = None
    for chain in chains:
        h = h0
        for (wa, ba, _, da), (wb, bb, _, db) in zip(chain[0::2], chain[1::2]):
            t = conv_3xtf32(F.leaky_relu(h, 0.1), wa, ba, da)
            h = h + conv_3xtf32(F.leaky_relu(t, 0.1), wb, bb, db)
        acc = h if acc is None else acc + h
    return (acc / len(chains)).transpose(1, 2)


def _chains(rng, C, spec):
    chains = []
    for k, dils in spec:
        chain = []
        for d in dils:
            for dd in (d, 1):
                w = (rng.standard_normal((C, C, k)) / np.sqrt(C * k)).astype(np.float32)
                b = (0.1 * rng.standard_normal(C)).astype(np.float32)
                chain.append((w, b, k, dd))
        chains.append(chain)
    return chains


@pytest.mark.parametrize("C,T,spec", [
    (16, 300, ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5)))),
    (32, 77, ((11, (1, 3, 5)),)),
])
def test_kernel1_arithmetic_matches_plain_and_pallas(rng, C, T, spec):
    """3xTF32 within 1e-5 of the largest magnitude of the exact plain version
    (float64 here) and of the Pallas kernel run as the JAX package's tests run
    it on the CPU (interpret mode, S = 1)."""
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    chains = _chains(rng, C, spec)
    tchains = [[(torch.from_numpy(w), torch.from_numpy(b), k, d) for w, b, k, d in c]
               for c in chains]
    got = group_emulated(torch.from_numpy(x), tchains)
    exact = resblock.resblock_group_plain(
        torch.from_numpy(x).double(),
        [[(w.double(), b.double(), k, d) for w, b, k, d in c] for c in tchains])
    ref = np.asarray(jax_group(jnp.asarray(x), [[(jnp.asarray(w), jnp.asarray(b), k, d)
                                                 for w, b, k, d in c] for c in chains],
                               S=1, interpret=True))
    scale = exact.abs().max().item()
    assert (got.double() - exact).abs().max().item() <= 1e-5 * scale
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale
