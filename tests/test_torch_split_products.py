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


@pytest.mark.parametrize("C,k", [(16, 3), (32, 11), (256, 7)])
def test_bf16_unit_weight_packing_round_trips(rng, C, k):
    """The bf16 unit kernel's weights, laid out as its shared-memory B
    image (slices of 64 of K = (tap, input), rows of 128 bytes, 128-byte
    swizzle): unpacked, they are the bf16 weights bit for bit, and a value
    sits where wgmma's descriptor reads it."""
    w = torch.from_numpy(_spread(rng, (C, C, k), -3, 1))
    packed = resblock.pack_bf16_weights(w)
    assert packed.dtype == torch.bfloat16 and packed.shape == (-(-k * C // 64), C, 8, 8)
    got = resblock.unpack_bf16_weights(packed, C, k)
    assert torch.equal(got.view(torch.int16), w.to(torch.bfloat16).view(torch.int16))
    # K index q = j C + i lies in slice q // 64 at 16-byte chunk (q % 64) // 8,
    # stored in row o at chunk ((q % 64) // 8) ^ (o % 8), element q % 8
    flat = packed.reshape(packed.shape[0], C, 64)
    for o, i, j in ((C - 1, C - 1, k - 1), (0, 0, 0), (5, C // 2 + 3, k // 2), (9, 7, 1)):
        q = j * C + i
        chunk = ((q % 64) // 8) ^ (o % 8)
        assert flat[q // 64, o, 8 * chunk + q % 8] == w[o, i, j].to(torch.bfloat16)
    # the last slice's K past k C is zero
    tail = (k * C) % 64
    if tail:
        assert torch.all(resblock._swizzle(packed)[-1].reshape(C, 64)[:, tail:] == 0)


def attention_3xtf32(q, k, v, ek, ev, lengths, *, window: int, scale: float,
                     BK: int = 16, QD: int = 8, halves: int = 2) -> torch.Tensor:
    """Kernel 2 in float32 as the tensor-core kernel computes it: qs = q *
    scale, each score as float32 partial sums over 8 of D of the three TF32
    piece products (qs_big.k_small + qs_small.k_big + qs_big.k_big), the
    band (qs . ek) and the mask; the key tiles of 16 split into two halves
    (the first ceil(n / 2) tiles and the rest), each with its own online
    softmax: per tile the new maximum, p = exp(s - max), P.V as the three
    piece products of p and v summed in float32 and added into the rescaled
    running sum; the halves' maxima, sums and P.V sums combined in order;
    at the end out = sum / l + the value-side band term from the raw band
    scores with the final maximum and sum."""
    B, H, T, D = q.shape
    W = 2 * window + 1
    qs = q * scale
    qb, qsm = split_tf32(qs)
    qe = qs @ ek.T  # (B, H, T, W)
    t = torch.arange(T)
    valid = t[None, :] < lengths[:, None]  # (B, T)
    n_tiles = -(-T // BK)
    per_half = -(-n_tiles // halves)
    scores, runs = [], []
    for hf in range(halves):
        m = torch.full((B, H, T), -torch.inf)
        l = torch.zeros(B, H, T)
        acc = torch.zeros(B, H, T, D)
        for it in range(hf * per_half, min(n_tiles, (hf + 1) * per_half)):
            j = torch.arange(it * BK, min((it + 1) * BK, T))
            kb, ksm = split_tf32(k[:, :, j])
            vb, vsm = split_tf32(v[:, :, j])
            s = torch.zeros(B, H, T, len(j))
            for d0 in range(0, D, QD):
                sl = slice(d0, d0 + QD)
                mt = lambda a, b: a[..., sl] @ b[..., sl].transpose(-1, -2)  # noqa: E731
                s = s + (mt(qb, ksm) + mt(qsm, kb) + mt(qb, kb))
            rel = j[None, :] - t[:, None] + window
            in_band = (rel >= 0) & (rel < W)
            band = torch.gather(qe, 3, rel.clamp(0, W - 1).expand(B, H, T, len(j)))
            s = torch.where(in_band, s + band, s)
            masked = ~(valid[:, None, :, None] & valid[:, None, None, j])
            s = torch.where(masked, torch.full_like(s, -1e4), s)
            scores.append(s)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - mx)
            p = torch.exp(s - mx[..., None])
            l = l * alpha + p.sum(-1)
            pb, psm = split_tf32(p)
            acc = acc * alpha[..., None] + (pb @ vsm + psm @ vb + pb @ vb)
            m = mx
        runs.append((m, l, acc))
    m, l, acc = runs[0]
    for m1, l1, acc1 in runs[1:]:
        mx = torch.maximum(m, m1)
        a0, a1 = torch.exp(m - mx), torch.exp(m1 - mx)
        l = l * a0 + l1 * a1
        acc = acc * a0[..., None] + acc1 * a1[..., None]
        m = mx
    S = torch.cat(scores, -1)  # the raw scores, (B, H, T, T)
    jj = t[:, None] + torch.arange(W)[None, :] - window  # (T, W): the band's keys
    ok = (jj >= 0) & (jj < T)
    raw = torch.gather(S, 3, jj.clamp(0, T - 1).expand(B, H, T, W))
    p_band = torch.where(ok, torch.exp(raw - m[..., None]), torch.zeros(())) / l[..., None]
    return acc / l[..., None] + p_band @ ev


@pytest.mark.parametrize("T,D", [(77, 64), (33, 32)])
def test_kernel2_arithmetic_matches_plain_and_pallas(rng, T, D):
    """Kernel 2 in float32 (3xTF32, online softmax over 16-key tiles in two
    key halves, combined) within 1e-5 of the largest magnitude of the exact
    plain version (float64 here) and of the Pallas kernel in interpret mode;
    T not a multiple of the key tile, an odd number of tiles, and rows of
    length T, 1 and 0 (a length-0 row is uniform over all T keys)."""
    from rvc_tpu.ops.pallas_attention import banded_rel_attention as jax_attention
    from rvc_tpu_torch.ops import attention

    B, H, w = 3, 2, 10
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    ek, ev = ((D ** -0.5) * rng.standard_normal((2 * w + 1, D)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([T, 1, 0], np.int32)
    args = [torch.from_numpy(a) for a in (q, k, v, ek, ev, lengths)]
    got = attention_3xtf32(*args, window=w, scale=D ** -0.5)
    exact = attention.banded_rel_attention_plain(
        *[a.double() for a in args[:5]], args[5], window=w, scale=D ** -0.5)
    ref = np.asarray(jax_attention(*map(jnp.asarray, (q, k, v, ek, ev, lengths)), window=w,
                                   scale=D ** -0.5, interpret=True))
    scale = exact.abs().max().item()
    assert (got.double() - exact).abs().max().item() <= 1e-5 * scale
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * scale
