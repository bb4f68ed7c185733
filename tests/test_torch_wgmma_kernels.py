"""The arithmetic of kernel 4 (the ResBlock1 chain forward on ``wgmma`` in
3xTF32) and of kernel 2 in bfloat16 (banded attention with its keys split
over blocks), emulated in plain torch on the CPU.

Kernel 4 (``csrc/resblock_chain.cu``) runs each conv as TF32 piece products
a_big.w_big + a_big.w_small + a_small.w_big (``mma.cuh``), K = (tap, input)
cut into slices of 32 (``resblock.TF32_SLICE_K``): each slice's products are
summed from zero, and the slices added in order into float32, then the bias
and, for a unit's second conv, the unit's input. Its weights are packed once
per set of weights as two swizzled images (``pack_tf32_wgmma_weights``).

Kernel 2 in bf16 (``csrc/banded_attention.cu``, namespace ``bfs``) splits the
keys into S runs of 64-key tiles: per split each row's max m and sum l of
e^(s - m) (online over the tiles), then M = max m and L = sum of l e^(m - M)
in split order, p = bf16(e^(s - M) / L), each split's P.V as float32 tile
sums added in order, the splits' sums added in order and rounded, and the
band's value term from the rounded p added and rounded. The kernel takes
e^x from CUDA's ``expf`` (within 2 ulps) and p by a true division, as its
first version did; the emulation takes ``torch.exp`` and the same division,
and sums each tile's terms in torch's order, not the kernel's shuffles.

Kernel 6 (``csrc/wavenet.cu``, the WaveNet stack forward on the same
``wgmma`` core as kernel 4) runs two such products a layer: the in-conv
with its a and b outputs interleaved by groups of 8 channels
(``wavenet.forward_convs``), whose
epilogue adds the bias and g and takes acts = tanh(a) sigmoid(b), and the
res/skip 1x1 over acts with res and skip interleaved (the last layer skip
only), whose epilogue updates x and adds into skip. Its weights are packed
at every call (``wavenet.pack_forward_weights``).

All three are held against the plain versions and against the JAX
package's Pallas kernels run in interpret mode on the same numpy inputs. The CUDA
kernels themselves are held against the plain versions on the card
(test_torch_gpu.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import no_compile_cache_writes  # noqa: F401
from rvc_tpu.ops.pallas_attention import banded_rel_attention as jax_attention
from rvc_tpu.ops.pallas_resblock import fused_resblock1 as jax_chain_forward
from rvc_tpu.ops.pallas_wavenet import fused_wn as jax_wn
from rvc_tpu_torch.ops import attention, resblock, wavenet
from test_torch_bf16_kernels import MAX_BEYOND, MAX_REL, agreement, to_bf16
from test_torch_gpu import _wn_inputs
from test_torch_split_products import _chains, _spread, split_tf32

VALUE_TOL = 2e-5  # of the largest magnitude, as chip_smoke.py holds kernel 4 on the card


# ---- kernel 4 ----

@pytest.mark.parametrize("C,k", [(16, 3), (48, 7), (256, 11)])
def test_kernel4_weight_packing_round_trips(rng, C, k):
    """Kernel 4's weights, split on the host into two images (slices of 32
    of K = (tap, input), k relabelled within each 8, 128-byte rows with the
    128-byte swizzle): unpacked, big is tf32(w) and big + small is w within
    TF32's rounding of the residual; a value sits where wgmma's descriptor
    reads it; the last slice's K past k C is zero."""
    w = torch.from_numpy(_spread(rng, (C, C, k), -3, 1))
    packed = resblock.pack_tf32_wgmma_weights(w)
    n_slices = -(-k * C // resblock.TF32_SLICE_K)
    assert packed.dtype == torch.float32 and packed.shape == (2, n_slices, C, 8, 4)
    big, small = resblock.unpack_tf32_wgmma_weights(packed, C, k)
    assert torch.equal(big, resblock.tf32_round(w))
    assert torch.equal(small, resblock.tf32_round(w - big))
    assert torch.all((big.double() + small.double() - w.double()).abs()
                     <= 2.0 ** -22 * w.double().abs())
    # K index q = j C + 8 c + p holds input i = 8 c + (2 (p % 4) + p // 4) of
    # tap j; it lies in slice q // 32 at 4-float chunk (q % 32) // 4, stored in
    # row o at chunk ((q % 32) // 4) ^ (o % 8), element q % 4
    flat = packed.reshape(2, n_slices, C, 32)
    for o, i, j in ((C - 1, C - 1, k - 1), (0, 0, 0), (5, C // 2 + 3, k // 2), (9, 7, 1)):
        pos = 4 * (i % 2) + (i % 8) // 2
        q = j * C + 8 * (i // 8) + pos
        at = 4 * (((q % 32) // 4) ^ (o % 8)) + q % 4
        assert flat[0, q // 32, o, at] == big[o, i, j]
        assert flat[1, q // 32, o, at] == small[o, i, j]
    tail = (k * C) % 32
    if tail:
        assert torch.all(resblock._swizzle(packed)[:, -1].reshape(2, C, 32)[..., tail:] == 0)


def conv_tf32_slices(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """A conv as kernel 4 computes it, a (N, I, T) already through the leaky
    ReLU, w (O, I, k): ``slice_sums`` on w's TF32 pieces, then the bias."""
    return slice_sums(a, *split_tf32(w), d) + b[None, :, None]


def slice_sums(a: torch.Tensor, wb: torch.Tensor, ws: torch.Tensor, d: int) -> torch.Tensor:
    """The conv core's sums (``csrc/tf32_conv.cuh``) over a (N, I, T), rows
    outside [0, T) zero, with the weights' pieces wb = tf32(w) and ws =
    tf32(w - wb), each (O, I, k): per slice of 32 of K = (tap, input), the
    three TF32 piece products summed in float32 from zero; the slices added
    in order into float32 from zero."""
    O, I, k = wb.shape
    T = a.shape[-1]
    p = (k - 1) * d // 2
    ab, asm = split_tf32(F.pad(a, (p, p)))
    # K = (tap j, input i) as j I + i
    Xb = torch.cat([ab[..., j * d:j * d + T] for j in range(k)], 1)  # (N, k I, T)
    Xs = torch.cat([asm[..., j * d:j * d + T] for j in range(k)], 1)
    Wb = wb.permute(0, 2, 1).reshape(O, k * I)
    Ws = ws.permute(0, 2, 1).reshape(O, k * I)
    acc = torch.zeros(a.shape[0], O, T)
    for s0 in range(0, k * I, resblock.TF32_SLICE_K):
        sl = slice(s0, s0 + resblock.TF32_SLICE_K)
        mm = lambda W, X: torch.einsum("ok,nkt->not", W[:, sl], X[:, sl])  # noqa: E731
        acc = acc + (mm(Ws, Xb) + mm(Wb, Xs) + mm(Wb, Xb))
    return acc


def kernel4_emulated(x: torch.Tensor, convs) -> list[torch.Tensor]:
    """Kernel 4's arithmetic: each unit's output (B, T, C), the last one the
    chain's, with t = conv_a(lrelu(h)) + bias and h' = h + (conv_b(lrelu(t))
    + bias), rows outside [0, T) zero at each conv."""
    h = x.transpose(1, 2)
    outs = []
    for (wa, ba, _, da), (wb, bb, _, db) in zip(convs[0::2], convs[1::2]):
        t = conv_tf32_slices(F.leaky_relu(h, 0.1), wa, ba, da)
        h = h + conv_tf32_slices(F.leaky_relu(t, 0.1), wb, bb, db)
        outs.append(h.transpose(1, 2))
    return outs


@pytest.mark.parametrize("C,T,k", [(16, 150, 7), (32, 131, 3)])
def test_kernel4_arithmetic_matches_plain_and_pallas(rng, C, T, k):
    """Every unit's kept output within 2e-5 of the largest magnitude of the
    plain chain's in float64, and the chain's output of the Pallas forward
    (``_fused_call``, interpret mode); T not a multiple of the kernel's 128
    rows, C = 16 (a slice spans two taps) and 32 (a slice is one tap)."""
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    chain = _chains(rng, C, ((k, (1, 3, 5)),))[0]
    tconvs = [(torch.from_numpy(w), torch.from_numpy(b), kk, d) for w, b, kk, d in chain]
    got = kernel4_emulated(torch.from_numpy(x), tconvs)
    c64 = [(w.double(), b.double(), kk, d) for w, b, kk, d in tconvs]
    for u, out in enumerate(got):
        exact = resblock.fused_resblock1_plain(torch.from_numpy(x).double(), c64[:2 * u + 2])
        scale = exact.abs().max().item()
        assert (out.double() - exact).abs().max().item() <= VALUE_TOL * scale, u
    ref = np.asarray(jax_chain_forward(jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(b), kk, d)
                                                        for w, b, kk, d in chain],
                                       S=1, interpret=True))
    assert np.abs(got[-1].numpy() - ref).max() <= VALUE_TOL * np.abs(ref).max()


# ---- kernel 6 ----

def _wn_torch(w: dict) -> dict:
    return {n: torch.from_numpy(v) for n, v in w.items()}


def halves(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 6's interleaved outputs (2C, ...) -> the two (C, ...) halves:
    rows 16q..16q+7 are the first's 8q..8q+7, the next 8 the second's."""
    g = v.reshape(v.shape[0] // 16, 2, 8, *v.shape[1:])
    return tuple(g[:, i].reshape(v.shape[0] // 2, *v.shape[1:]) for i in range(2))


@pytest.mark.parametrize("C,L,k", [(16, 3, 5), (48, 2, 3), (192, 1, 5)])
def test_kernel6_weight_packing_round_trips(rng, C, L, k):
    """Kernel 6's weights, interleaved by groups of 8 outputs and split into
    two images a conv: unpacked, the in-conv's rows 16q..16q+7 hold a's taps
    of channels 8q..8q+7 and the next 8 rows b's, the 1x1's res and skip
    alike below the last layer and rows 0..C-1 skip in the last (zeros
    after), each as big = tf32(w) and small = tf32(w - big); L = 1 is a last
    layer only."""
    w = _wn_torch(_wn_inputs(rng, 2, 10, C, L, k))
    p_ab, p_rs = wavenet.pack_forward_weights(w["w_a"], w["w_b"], w["w_res"], w["w_skip"], k)
    assert p_ab.shape == (L, 2, -(-k * C // 32), 2 * C, 8, 4)
    assert p_rs.shape == (L, 2, -(-C // 32), 2 * C, 8, 4)

    def pieces(v):
        big = resblock.tf32_round(v)
        return big, resblock.tf32_round(v - big)

    for i in range(L):
        got = resblock.unpack_tf32_wgmma_weights(p_ab[i], C, k)
        for half, name in enumerate(("w_a", "w_b")):
            want = pieces(w[name][i * k:(i + 1) * k].permute(2, 1, 0))
            for g, e in zip(got, want):
                assert torch.equal(halves(g)[half], e)
        got = resblock.unpack_tf32_wgmma_weights(p_rs[i], C, 1)
        res, skip = (pieces(w[n][i].t()[..., None]) for n in ("w_res", "w_skip"))
        for g, r, s_ in zip(got, res, skip):
            if i < L - 1:
                assert torch.equal(halves(g)[0], r) and torch.equal(halves(g)[1], s_)
            else:
                assert torch.equal(g[:C], s_) and not torch.any(g[C:])


def kernel6_emulated(x: torch.Tensor, w: dict, lengths: torch.Tensor, k: int) -> dict:
    """Kernel 6's arithmetic on x (B, T, C), from its packed weights: per
    layer the in-conv's slice sums over x (outputs interleaved, ``halves``),
    a = s_a + (b_a + g_a), b = s_b + (b_b + g_b), acts = tanh(a) sigmoid(b);
    the 1x1's slice sums over acts, x' = (x + (s_res + b_res)) keep and skip
    += s_skip + b_skip (the last layer: skip only, then the mask). Returns
    out, xs (L-1, B, T, C), pre_a and pre_b (L, B, T, C)."""
    B, T, C = x.shape
    L = w["w_res"].shape[0]
    p_ab, p_rs = wavenet.pack_forward_weights(w["w_a"], w["w_b"], w["w_res"], w["w_skip"], k)
    keep = (torch.arange(T)[None, :] < lengths[:, None]).float()[:, None]
    g, b_ab, b_rs = w["g_ab"][..., None], w["b_ab"][..., None], w["b_rs2"][..., None]
    h, skip = x.transpose(1, 2), None
    xs, pre_a, pre_b = [], [], []
    for i in range(L):
        s = slice_sums(h, *resblock.unpack_tf32_wgmma_weights(p_ab[i], C, k), 1)
        s_a, s_b = halves(s.transpose(0, 1))
        a = s_a.transpose(0, 1) + (b_ab[i] + g[:, i])
        b = s_b.transpose(0, 1) + (b_ab[L + i] + g[:, L + i])
        pre_a.append(a)
        pre_b.append(b)
        acts = torch.tanh(a) * torch.sigmoid(b)
        r = slice_sums(acts, *resblock.unpack_tf32_wgmma_weights(p_rs[i], C, 1), 1)
        if i < L - 1:
            s_res, s_skip = (v.transpose(0, 1) for v in halves(r.transpose(0, 1)))
            h = (h + (s_res + b_rs[i])) * keep
            xs.append(h)
            sk = s_skip + b_rs[L + i]
        else:
            sk = r[:, :C] + b_rs[L + i]
        skip = sk if skip is None else skip + sk
    t = lambda vs: torch.stack(vs).transpose(-1, -2)  # noqa: E731
    return dict(out=(skip * keep).transpose(1, 2), xs=t(xs) if xs else None, pre_a=t(pre_a),
                pre_b=t(pre_b))


def wn_exact(x: torch.Tensor, w: dict, lengths: torch.Tensor, k: int) -> dict:
    """The plain stack in float64, layer by layer, with what kernel 6 keeps."""
    B, T, C = x.shape
    L = w["w_res"].shape[0]
    w = {n: v.double() for n, v in w.items()}
    keep = (torch.arange(T)[None, :] < lengths[:, None]).double()[:, None]
    h, skip = x.double().transpose(1, 2), 0.0
    xs, pre_a, pre_b = [], [], []
    for i in range(L):
        a, b = (F.conv1d(h, w[n][i * k:(i + 1) * k].permute(2, 1, 0), padding=(k - 1) // 2)
                + w["b_ab"][j * L + i][:, None] + w["g_ab"][:, j * L + i, :, None]
                for j, n in enumerate(("w_a", "w_b")))
        pre_a.append(a)
        pre_b.append(b)
        acts = torch.tanh(a) * torch.sigmoid(b)
        rs, sk = (torch.einsum("bct,cd->bdt", acts, w[n][i]) + w["b_rs2"][j * L + i][:, None]
                  for j, n in enumerate(("w_res", "w_skip")))
        h = (h + rs) * keep
        if i < L - 1:
            xs.append(h)
        skip = skip + sk
    t = lambda vs: torch.stack(vs).transpose(-1, -2)  # noqa: E731
    return dict(out=(skip * keep).transpose(1, 2), xs=t(xs) if xs else None, pre_a=t(pre_a),
                pre_b=t(pre_b))


@pytest.mark.parametrize("C,L,T,lengths", [
    (16, 9, 150, (150, 1, 0)),   # 9 layers: the JAX wrapper chains two groups
    (48, 3, 133, (0, 133, 57)),  # C = 48: a 1x1 slice of 32 and one of 16 (zero-padded)
])
def test_kernel6_arithmetic_matches_plain_and_pallas(rng, C, L, T, lengths):
    """Kernel 6's emulated arithmetic: out, xs, pre_a and pre_b each within
    2e-5 of their largest magnitude of the plain stack in float64 (and its
    out of ``fused_wn_plain`` in float64), and out of the Pallas stack
    (interpret mode); B T (450, 399) and T not multiples of the kernel's 128
    rows, lengths of 0, 1, below T and T, the input masked."""
    k, B = 5, len(lengths)
    lens = np.asarray(lengths, np.int32)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((B, T, C)).astype(np.float32) * mask
    w = _wn_inputs(rng, B, T, C, L, k)
    tw, tx, tl = _wn_torch(w), torch.from_numpy(x), torch.from_numpy(lens)
    got = kernel6_emulated(tx, tw, tl, k)
    exact = wn_exact(tx, tw, tl, k)
    plain = wavenet.fused_wn_plain(tx.double(), *[v.double() for v in tw.values()], tl,
                                   kernel_size=k)
    torch.testing.assert_close(exact["out"], plain, rtol=0, atol=1e-12)
    for name, ref in exact.items():
        scale = ref.abs().max().item()
        assert (got[name].double() - ref).abs().max().item() <= VALUE_TOL * scale, name
    ref = np.asarray(jax_wn(jnp.asarray(x), *[jnp.asarray(v) for v in w.values()],
                            jnp.asarray(lens), kernel_size=k, interpret=True))
    assert np.abs(got["out"].numpy() - ref).max() <= VALUE_TOL * np.abs(ref).max()
    assert not got["out"][torch.arange(T)[None, :] >= tl[:, None]].any()


# ---- kernel 2 in bf16 ----

def rb(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bf16 value, as float32."""
    return v.to(torch.bfloat16).float()


def attention_bf16_split(q, k, v, ek, ev, lengths, *, window: int, scale: float, S: int,
                         BK: int = 64) -> torch.Tensor:
    """Kernel 2 in bf16 as the key-split kernel computes it (bf16 inputs ->
    bf16 output); S key splits of ceil(tiles / S) tiles of BK keys."""
    B, H, T, D = q.shape
    W = 2 * window + 1
    qs = rb(q.float() * rb(torch.tensor(scale)))
    qe = rb(qs @ ek.float().T)  # (B, H, T, W)
    s = rb(qs @ k.float().transpose(-1, -2))  # (B, H, T, T)
    t = torch.arange(T)
    rel = t[None, :] - t[:, None] + window  # key j - row t + w
    in_band = (rel >= 0) & (rel < W)
    band = torch.gather(qe, 3, rel.clamp(0, W - 1).expand(B, H, T, T))
    s = torch.where(in_band, rb(s + band), s)
    valid = t[None, :] < lengths[:, None]
    masked = ~(valid[:, None, :, None] & valid[:, None, None, :])
    s = torch.where(masked, torch.full_like(s, -9984.0), s)
    n_tiles = -(-T // BK)
    per = -(-n_tiles // S)
    splits = [(a * BK, min(T, (a + per) * BK)) for a in range(0, n_tiles, per)]
    stats = []
    for j0, j1 in splits:  # per split: online max and sum over its tiles
        m = torch.full((B, H, T), -torch.inf)
        l = torch.zeros(B, H, T)
        for k0 in range(j0, j1, BK):
            st = s[..., k0:min(k0 + BK, j1)]
            mx = torch.maximum(m, st.amax(-1))
            l = l * torch.exp(m - mx) + torch.exp(st - mx[..., None]).sum(-1)
            m = mx
        stats.append((m, l))
    M = torch.stack([m for m, _ in stats]).amax(0)
    L = torch.zeros(B, H, T)
    for m, l in stats:
        L = L + l * torch.exp(m - M)
    p = rb(torch.exp(s - M[..., None]) / L[..., None])
    total = torch.zeros(B, H, T, D)
    for j0, j1 in splits:
        part = torch.zeros(B, H, T, D)
        for k0 in range(j0, j1, BK):
            k1 = min(k0 + BK, j1)
            part = part + p[..., k0:k1] @ v.float()[:, :, k0:k1]
        total = total + part
    p_band = torch.where(in_band, p, torch.zeros(()))
    band_v = rb(attention.dense_to_band(p_band, window) @ ev.float())
    return rb(rb(total) + band_v).to(torch.bfloat16)


@pytest.mark.parametrize("T,D,S,lengths", [
    (150, 96, 2, (150, 133, 1)),   # T not a multiple of the 64-key tile, splits of 2 and 1 tiles
    (200, 32, 4, (200, 0, 64)),    # one tile a split, a length of 0 (a uniform row)
])
def test_kernel2_bf16_split_arithmetic_matches_plain_and_pallas(rng, T, D, S, lengths):
    """Kernel 2 in bf16 with its keys split, emulated, against the plain
    version and the Pallas kernel in interpret mode, both in bf16: within
    MAX_REL of the largest magnitude, at most MAX_BEYOND of the elements more
    than one bf16 ulp apart; and against itself with the keys in one split
    (the order of the float32 sums only)."""
    B, H, w = 3, 2, 10
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    ek, ev = ((D ** -0.5) * rng.standard_normal((2 * w + 1, D)).astype(np.float32)
              for _ in range(2))
    lens = np.array(lengths, np.int32)
    pairs = [to_bf16(a) for a in (q, k, v, ek, ev)]
    targs = [p[1] for p in pairs] + [torch.from_numpy(lens)]
    kw = dict(window=w, scale=D ** -0.5)
    got = attention_bf16_split(*targs, S=S, **kw).float().numpy()
    one = attention_bf16_split(*targs, S=1, **kw).float().numpy()
    plain = attention.banded_rel_attention_plain(*targs, **kw).float().numpy()
    ref = np.asarray(jax_attention(*[p[0] for p in pairs], jnp.asarray(lens), interpret=True,
                                   **kw), np.float32)
    for other, what in ((plain, "plain version"), (ref, "Pallas kernel"), (one, "one split")):
        rel, beyond = agreement(got, other, f"kernel 2 bf16, {S} key splits, vs the {what}")
        assert rel <= MAX_REL and beyond <= MAX_BEYOND


def test_kernel2_bf16_split_edges(rng):
    """T of 1 (one key, every split but the first empty, so one split), and
    T = 65 in two splits (a split of one key), against the plain version."""
    for T, S, lengths in ((1, 1, (1, 0, 1)), (65, 2, (65, 64, 1))):
        q, k, v = (rng.standard_normal((3, 2, T, 32)).astype(np.float32) for _ in range(3))
        ek, ev = (rng.standard_normal((21, 32)).astype(np.float32) / 6 for _ in range(2))
        targs = [to_bf16(a)[1] for a in (q, k, v, ek, ev)] + [torch.tensor(lengths)]
        got = attention_bf16_split(*targs, window=10, scale=32 ** -0.5, S=S)
        plain = attention.banded_rel_attention_plain(*targs, window=10, scale=32 ** -0.5)
        rel, beyond = agreement(got.float().numpy(), plain.float().numpy(), f"T={T}")
        assert rel <= MAX_REL and beyond <= MAX_BEYOND
