"""The tensor-core arithmetic of kernels 5 and 7, emulated in plain torch on
the CPU.

Kernels 5 (``csrc/resblock_bwd.cu``) and 7 (``csrc/wavenet.cu``) run every
product of the backward on the tensor cores in 3xTF32 (``csrc/tc_rowconv.cuh``):
a.w ~ a_big.w_big + a_big.w_small + a_small.w_big, each piece product exact
in float32.
- A data convolution (kernel 5's recomputed t, conv_b^T and conv_a^T;
  kernel 7's gate over [d_res | ds] and its dx over [d_a | d_b]) sums the
  piece products of one 32-channel chunk and one tap, then adds that sum
  into a float32 total in (chunk, tap) order, starting from the bias.
- A weight gradient is a split-K GEMM over rows: per chunk of rows of one
  sample (the kernel's plan), each 64-row stage's piece products are added
  into float32, and the chunks are added in a fixed order, sample by
  sample. Bias and conditioning gradients are plain float32 sums.
Here that arithmetic is emulated (within a (chunk, tap) or a stage the sum
is torch's float32 sum, not mma.sync's truncating one) and held against the
plain versions (autograd of the plain forward) and the JAX package's Pallas
kernels run in interpret mode, differentiated through their custom VJPs, on
the same numpy inputs. The CUDA kernels themselves are held against the
plain versions on the card (test_torch_gpu.py)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import no_compile_cache_writes  # noqa: F401
from rvc_tpu.ops.pallas_resblock import fused_resblock1_train as jax_chain
from rvc_tpu.ops.pallas_wavenet import fused_wn as jax_wn
from rvc_tpu_torch.ops import resblock, wavenet
from test_torch_gpu import _wn_inputs
from test_torch_split_products import split_tf32
from test_torch_train_kernels import _chain

CK = 32            # input channels a data conv stages at a time
WG_RS = 64         # rows a weight-gradient stage takes
WG_TARGET = 528    # weight-gradient blocks the plan aims for
WG_MAX_WARPS = 6   # taps of a weight-gradient block
# Tolerances, of each gradient's largest magnitude. The emulation, the plain
# version and the Pallas kernel compute one float32 function: they differ by
# the order of float32 sums over up to k C (data convs) or B T (weight
# gradients) terms, and the emulation by the 3xTF32 split, about 2^-22 of
# each product. At these sizes the largest difference is below 1e-6 (6.4e-7,
# dWres against the Pallas kernel); 1e-5 leaves ten times that and is ten
# times tighter than the card's 1e-4 (GRAD_TOL), which also allows for the
# sums of 69120 rows.
TOL = 1e-5


def lrelu(v):
    return F.leaky_relu(v, 0.1)


def slope(v):
    return torch.where(v > 0, 1.0, 0.1)


def conv_tc(x: torch.Tensor, w: torch.Tensor, d: int, bias=None) -> torch.Tensor:
    """x (N, Cin, T), w (O, Cin, k): the zero-padded same conv as the kernel
    sums it, from the bias (or zero) up, one (32-channel chunk, tap) at a
    time, each the sum of its three TF32 piece products."""
    N, Cin, T = x.shape
    k = w.shape[2]
    p = (k - 1) * d // 2
    xb, xs = split_tf32(F.pad(x, (p, p)))
    wb, ws = split_tf32(w)
    acc = torch.zeros(N, w.shape[0], T) if bias is None else bias[None, :, None].expand(
        N, -1, T).clone()
    for c0 in range(0, Cin, CK):
        c = slice(c0, c0 + CK)
        for j in range(k):
            a_b, a_s = xb[:, c, j * d:j * d + T], xs[:, c, j * d:j * d + T]
            part = (torch.einsum("nct,oc->not", a_b, ws[:, c, j])
                    + torch.einsum("nct,oc->not", a_s, wb[:, c, j])
                    + torch.einsum("nct,oc->not", a_b, wb[:, c, j]))
            acc = acc + part
    return acc


def wgrad_rows(B: int, T: int, C: int, ks) -> int:
    """Rows per chunk of the weight-gradient plan (tc_rowconv.cuh,
    tc_wgrad_plan)."""
    TM = 32 if C % 32 == 0 else 16
    tg = [math.ceil(k / math.ceil(k / WG_MAX_WARPS)) for k in ks]
    ngrp = [math.ceil(k / g) for k, g in zip(ks, tg)]
    warps = max(tg)
    nt = C // TM
    per_chunk = sum(nt * math.ceil(nt / (warps // g)) * n for g, n in zip(tg, ngrp))
    ncb = min(max(math.ceil(WG_TARGET / (B * per_chunk)), 1), math.ceil(T / WG_RS))
    return math.ceil(math.ceil(T / ncb) / WG_RS) * WG_RS


def wgrad_tc(X: torch.Tensor, G: torch.Tensor, k: int, d: int, R: int):
    """X, G (B, T, C): dW[j][i][o] = sum_r X[r + j d - p][i] G[r][o] (X zero
    outside [0, T)) as the kernel sums it: per chunk of R rows of a sample,
    each 64-row stage's three TF32 piece products added into float32, the
    chunks added in order; and the column sums of G, in total and per
    sample. Returns (dW (k, C, C), colsum (C,), per-sample sums (B, C))."""
    B, T, C = X.shape
    p = (k - 1) * d // 2
    xb, xs = split_tf32(F.pad(X, (0, 0, p, p)))
    gb, gs = split_tf32(G)
    dw, colsum, per_b = torch.zeros(k, C, C), torch.zeros(C), torch.zeros(B, C)
    for b in range(B):
        for r0 in range(0, T, R):
            r1 = min(r0 + R, T)
            acc = torch.zeros(k, C, C)
            for rs in range(r0, r1, WG_RS):
                re = min(rs + WG_RS, r1)
                for j in range(k):
                    a_b, a_s = xb[b, rs + j * d:re + j * d], xs[b, rs + j * d:re + j * d]
                    acc[j] += a_b.T @ gs[b, rs:re] + a_s.T @ gb[b, rs:re] + a_b.T @ gb[b, rs:re]
            dw = dw + acc
            s = G[b, r0:r1].sum(0)
            colsum = colsum + s
            per_b[b] = per_b[b] + s
    return dw, colsum, per_b


def resblock1_backward_emulated(x, gy, convs):
    """Kernel 5's arithmetic: (dx (B, T, C), dW (2n, O, I, k), db (2n, C))."""
    B, T, C = x.shape
    k = convs[0][2]
    R = wgrad_rows(B, T, C, (k, k))
    units = list(zip(convs[0::2], convs[1::2]))
    hs = [x]  # each unit's input, from the float32 forward (kernel 4)
    for conv_a, conv_b in units[:-1]:
        hs.append(resblock.fused_resblock1_plain(hs[-1], [conv_a, conv_b]))
    g = gy.transpose(1, 2)
    dws, dbs = [None] * len(convs), [None] * len(convs)
    for u in reversed(range(len(units))):
        (wa, ba, _, da), (wb, _, _, _) = units[u]
        h = hs[u].transpose(1, 2)
        t = conv_tc(lrelu(h), wa, da, bias=ba)
        dt = conv_tc(g, wb.transpose(0, 1).flip(2), 1) * slope(t)
        dh = g + conv_tc(dt, wa.transpose(0, 1).flip(2), da) * slope(h)
        for c, (X, G, dd) in ((2 * u, (lrelu(h), dt, da)), (2 * u + 1, (lrelu(t), g, 1))):
            dw, db, _ = wgrad_tc(X.transpose(1, 2), G.transpose(1, 2), k, dd, R)
            dws[c], dbs[c] = dw.permute(2, 1, 0), db
        g = dh
    return g.transpose(1, 2), torch.stack(dws), torch.stack(dbs)


def wn_backward_emulated(x, gy, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths, k):
    """Kernel 7's arithmetic: (dx, dWa, dWb, dBab, dG, dWres, dWskip, dBrs)."""
    B, T, C = x.shape
    L = w_res.shape[0]
    R = wgrad_rows(B, T, C, (k, k, 1, 1))
    mask = (torch.arange(T)[None, :] < lengths[:, None]).float()[:, None]
    xs, pre = [], []  # each layer's input and gate pre-activations (kernel 6)
    h = x.transpose(1, 2)
    for i in range(L):
        xs.append(h)
        a = F.conv1d(h, w_a[i * k:(i + 1) * k].permute(2, 1, 0), b_ab[i], padding=(k - 1) // 2)
        b = F.conv1d(h, w_b[i * k:(i + 1) * k].permute(2, 1, 0), b_ab[L + i],
                     padding=(k - 1) // 2)
        pre.append((a + g_ab[:, i, :, None], b + g_ab[:, L + i, :, None]))
        acts = torch.tanh(pre[-1][0]) * torch.sigmoid(pre[-1][1])
        h = (h + torch.einsum("bct,cd->bdt", acts, w_res[i]) + b_rs2[i][:, None]) * mask
    wab, wrs = wavenet.backward_convs(w_a, w_b, w_res, w_skip, k)
    ds = gy.transpose(1, 2) * mask
    d_res = torch.zeros_like(ds)
    dwa, dwb, dwres, dwskip = (torch.zeros_like(t) for t in (w_a, w_b, w_res, w_skip))
    dbab, dbrs, dg = torch.zeros_like(b_ab), torch.zeros_like(b_rs2), torch.zeros_like(g_ab)
    rows = lambda v: v.transpose(1, 2)  # noqa: E731
    for i in reversed(range(L)):
        d_acts = conv_tc(torch.cat([d_res, ds], 1), wrs[i], 1)
        th, sg = torch.tanh(pre[i][0]), torch.sigmoid(pre[i][1])
        d_a, d_b, acts = d_acts * sg * (1 - th * th), d_acts * th * sg * (1 - sg), th * sg
        dx = d_res + conv_tc(torch.cat([d_a, d_b], 1), wab[i], 1)
        for dw, dbias, G, row in ((dwa, dbab, d_a, i), (dwb, dbab, d_b, L + i)):
            w_, s, per_b = wgrad_tc(rows(xs[i]), rows(G), k, 1, R)
            dw[i * k:(i + 1) * k] = w_
            dbias[row] = s
            dg[:, row] = per_b
        for dw, G, row in ((dwres, d_res, i), (dwskip, ds, L + i)):
            w_, s, _ = wgrad_tc(rows(acts), rows(G), 1, 1, R)
            dw[i] = w_[0]
            dbrs[row] = s
        d_res = dx * mask
    return rows(dx), dwa, dwb, dbab, dg, dwres, dwskip, dbrs


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(1e-6, float(np.max(np.abs(ref))))
    err = float(np.max(np.abs(got - ref))) / scale
    assert err <= TOL, f"{what}: {err:.3g} of the largest magnitude > {TOL}"


@pytest.mark.parametrize("C,T,k", [(16, 150, 11), (32, 77, 3)])
def test_kernel5_arithmetic_matches_plain_and_pallas(rng, C, T, k):
    """3xTF32 convs and split-K weight gradients against autograd of the
    plain chain and the Pallas kernel's VJP: C = 16 (16-wide tiles) with
    k = 11 (two tap groups) and T past two 64-row stages; C = 32 with T
    shorter than one stage. Every element of dx, dW and db within TOL of its
    tensor's largest magnitude."""
    convs = _chain(rng, C, k, (1, 3, 5))
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    cot = rng.standard_normal((2, T, C)).astype(np.float32)
    tconvs = [(torch.from_numpy(w), torch.from_numpy(b), kk, d) for w, b, kk, d in convs]
    got = resblock1_backward_emulated(torch.from_numpy(x), torch.from_numpy(cot), tconvs)
    plain = resblock.fused_resblock1_backward_plain(torch.from_numpy(x), None,
                                                    torch.from_numpy(cot), tconvs)
    ws = tuple(jnp.asarray(w) for w, _, _, _ in convs)
    bs = tuple(jnp.asarray(b) for _, b, _, _ in convs)

    def loss(x_, ws_, bs_):
        cv = [(w, b, kk, d) for w, b, (_, _, kk, d) in zip(ws_, bs_, convs)]
        return jnp.sum(jax_chain(x_, cv, S=1, interpret=True) * cot)

    gx, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), ws, bs)
    pallas = (np.asarray(gx), np.stack(gw), np.stack(gb))
    for name, a, p_, j in zip(("dx", "dW", "db"), got, plain, pallas):
        _close(a, p_, f"{name} vs plain")
        _close(a, j, f"{name} vs Pallas")


def test_kernel7_arithmetic_matches_plain_and_pallas(rng):
    """3xTF32 gate and dx products and split-K weight gradients against
    autograd of the plain stack and the Pallas kernel's VJP: C = 32, 2C = 64
    inputs (two channel chunks), L = 3, one length 0 and one T, the input
    masked. Every gradient within TOL of its largest magnitude."""
    B, T, C, L, k = 3, 70, 32, 3, 5
    lens = np.asarray([T, 0, 41], np.int32)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((B, T, C)).astype(np.float32) * mask
    cot = rng.standard_normal((B, T, C)).astype(np.float32)
    w = _wn_inputs(rng, B, T, C, L, k)
    names = list(w)
    tw = [torch.from_numpy(w[n]) for n in names]
    lt = torch.from_numpy(lens)
    got = wn_backward_emulated(torch.from_numpy(x), torch.from_numpy(cot), *tw, lt, k)
    plain = wavenet.fused_wn_backward_plain(torch.from_numpy(x), None, None,
                                            torch.from_numpy(cot), *tw, lt, kernel_size=k)

    def loss(x_, *ws):
        return jnp.sum(jax_wn(x_, *ws, jnp.asarray(lens), kernel_size=k, interpret=True) * cot)

    pallas = jax.grad(loss, argnums=tuple(range(8)))(jnp.asarray(x),
                                                     *[jnp.asarray(w[n]) for n in names])
    for name, a, p_, j in zip(["dx"] + names, got, plain, pallas):
        _close(a, p_, f"{name} vs plain")
        _close(a, j, f"{name} vs Pallas")


def test_split_k_plan_and_order(rng):
    """The weight gradient's chunks: the plan splits a long stage into
    64-row multiples, and adding the chunks' float32 sums in order gives the
    float64 product within TOL."""
    assert wgrad_rows(4, 17280, 32, (3, 3)) % WG_RS == 0
    assert wgrad_rows(4, 17280, 32, (3, 3)) < 17280
    assert wgrad_rows(4, 432, 256, (11, 11)) >= 432  # one chunk per sample
    X = torch.from_numpy(rng.standard_normal((2, 300, 16)).astype(np.float32))
    G = torch.from_numpy(rng.standard_normal((2, 300, 16)).astype(np.float32))
    dw, colsum, per_b = wgrad_tc(X, G, 3, 2, 128)
    Xp = F.pad(X.double(), (0, 0, 2, 2))
    ref = torch.stack([torch.einsum("bti,bto->io", Xp[:, 2 * j:2 * j + 300], G.double())
                       for j in range(3)])
    _close(dw, ref, "dW")
    _close(colsum, G.double().sum((0, 1)), "column sums")
    _close(per_b, G.double().sum(1), "per-sample sums")
