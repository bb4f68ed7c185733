"""The CUDA kernels against their plain PyTorch versions, on the card;
for the training kernels (4-7) values and every gradient against autograd
of the plain version.

Needs a CUDA card and no JAX; every test here skips without a card. On the
card's machine (which has no JAX, so the repository's conftest cannot load):

    python -m pytest tests/test_torch_gpu.py --noconftest -q -m gpu
"""
import types

import numpy as np
import pytest
import torch

from rvc_tpu_torch.ops import attention, resblock, retrieval, wavenet


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _chains(rng, C, spec):
    """spec: ((k, dilations), ...) -> numpy chains of (w, b, k, d)."""
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


def _attention_inputs(rng, B=3, H=2, T=70, D=8, w=10):
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    ek, ev = ((D ** -0.5) * rng.standard_normal((2 * w + 1, D)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([T, T - 17, T // 3], np.int32)
    return q, k, v, ek, ev, lengths


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C,T", [(256, 1000), (128, 3001), (64, 777), (32, 5000)])
def test_resblock_kernel_matches_plain(rng, cuda, C, T):
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32)).to(cuda)
    chains = [[(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda), k, d)
               for w, b, k, d in c]
              for c in _chains(rng, C, ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5))))]
    n = resblock.fused_resblock_group.launches
    got = resblock.fused_resblock_group(x, chains)
    torch.cuda.synchronize()
    assert resblock.fused_resblock_group.launches == n + 9
    ref = resblock.resblock_group_plain(x, chains)
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("T,D", [(70, 96), (1937, 96), (300, 32), (300, 128)])
def test_attention_kernel_matches_plain(rng, cuda, T, D):
    args = [torch.from_numpy(a).to(cuda) for a in _attention_inputs(rng, T=T, D=D)]
    got = attention.banded_rel_attention(*args, window=10, scale=D ** -0.5)
    torch.cuda.synchronize()
    ref = attention.banded_rel_attention_plain(*args, window=10, scale=D ** -0.5)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [True, False])
def test_nearest_rows_kernel_matches_plain(rng, cuda, int8):
    feats = rng.standard_normal((300, 768)).astype(np.float32)
    bank = rng.standard_normal((20000, 768)).astype(np.float32)
    f = torch.from_numpy(feats).to(cuda)
    if int8:
        bq, s = (torch.from_numpy(a).to(cuda) for a in retrieval.quantize_bank(bank))
        got = retrieval.nearest_rows_q(f, bq, s)
        ref = retrieval.topk_blend(f, bq.float() * s)
    else:
        b = torch.from_numpy(bank).to(cuda)
        got = retrieval.nearest_rows(f, b)
        ref = retrieval.topk_blend(f, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


# every width kernel 1 is built for, with the widest halo (k = 11, d = 5), at
# T = 1 and T = 1237, not a multiple of any row tile (54, 118, 246 or 502
# output rows a block)
TILE_CASES = [(C, T, ((11, (5, 1, 3)), (3, (1, 5)))) for C in (16, 32, 64, 128, 256)
              for T in (1, 1237)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,T,spec", [
    (32, 1, ((3, (1, 3, 5)),)),
    (256, 3, ((11, (1, 3, 5)), (3, (1, 3, 5)))),
    (16, 50, ((3, (1, 3)), (5, (1, 2)))),
] + TILE_CASES)
def test_resblock_kernel_edges(rng, cuda, C, T, spec):
    """Sequences shorter than the kernels' reach, one and two chains, chains
    of 2 units, the smallest C the kernel takes, and kernel 1's tiles."""
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32)).to(cuda)
    chains = [[(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda), k, d)
               for w, b, k, d in c] for c in _chains(rng, C, spec)]
    got = resblock.fused_resblock_group(x, chains)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, resblock.resblock_group_plain(x, chains),
                               atol=5e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("T,lengths", [(1, [1, 0, 1]), (5, [5, 0, 2]), (65, [65, 64, 1])])
def test_attention_kernel_edges(rng, cuda, T, lengths):
    """One-row and one-tile sequences, a length of 0 (every row uniform)."""
    q, k, v, ek, ev, _ = _attention_inputs(rng, T=T, D=64)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, ek, ev)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = attention.banded_rel_attention(*args, lens, window=10, scale=0.125)
    torch.cuda.synchronize()
    ref = attention.banded_rel_attention_plain(*args, lens, window=10, scale=0.125)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("NQ,N", [(1, 5), (33, 129), (7, 128)])
def test_nearest_rows_kernel_edges(rng, cuda, NQ, N):
    """Banks smaller than, equal to and one past a 128-row tile; one query."""
    f = torch.from_numpy(rng.standard_normal((NQ, 32)).astype(np.float32)).to(cuda)
    bank = rng.standard_normal((N, 32)).astype(np.float32)
    bq, s = (torch.from_numpy(a).to(cuda) for a in retrieval.quantize_bank(bank))
    got = retrieval.nearest_rows_q(f, bq, s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, retrieval.topk_blend(f, bq.float() * s), atol=1e-5, rtol=0)


def _wn_inputs(rng, B, T, C, L, k):
    """A WN stack's weights in the split layout, the last layer's res
    weights zero (its output is all skip)."""
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    w_res = f(L, C, C, sc=C ** -0.5)
    w_res[-1] = 0.0  # the last layer's output is all skip
    b_rs2 = f(2 * L, C, sc=0.1)
    b_rs2[L - 1] = 0.0
    return dict(w_a=f(L * k, C, C, sc=(C * k) ** -0.5), w_b=f(L * k, C, C, sc=(C * k) ** -0.5),
                b_ab=f(2 * L, C, sc=0.1), g_ab=f(B, 2 * L, C, sc=0.3), w_res=w_res,
                w_skip=f(L, C, C, sc=C ** -0.5), b_rs2=b_rs2)


def _scaled_close(got, ref, tol):
    """max |got - ref| within tol of the reference's largest magnitude."""
    scale = max(ref.abs().max().item(), 1e-6)
    err = (got - ref).abs().max().item()
    assert err <= tol * scale, f"max abs err {err:.3g} > {tol} x {scale:.3g}"


# Through a leaky ReLU a gradient jumps (slope 1 or 0.1) where the
# pre-activation crosses 0. A pre-activation within float32 rounding of 0 can
# take the other slope in the kernel than in the plain version, which changes
# the gradients through it. So kernel 5's gradients are held to the plain
# version's in every element of dx, dW and db at 1e-4 of the largest
# magnitude once the cotangents at such pre-activations (found in a float64
# run of the plain chain) are fitted (resblock.check_chain_grads). (The WN
# stack is smooth: its gradients are held elementwise.)
def _chain_grads_close(x, convs, got, ref):
    msg, counts = resblock.check_chain_grads(x.detach(), [(w.detach(), b.detach(), k, d)
                                                          for w, b, k, d in convs], got, ref)
    assert msg is None, f"{msg} ({counts})"


def _train_chain(rng, cuda, C, k, dils, T, B=2):
    convs = [(torch.from_numpy(w).to(cuda).requires_grad_(),
              torch.from_numpy(b).to(cuda).requires_grad_(), kk, d)
             for w, b, kk, d in _chains(rng, C, ((k, dils),))[0]]
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(cuda)
    cot = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(cuda)
    return x.requires_grad_(), convs, cot


def _grads(fn, x, params, cot):
    """(output, gradients of <output, cot> for x and params); zeros for an
    input the function does not use (a one-layer WN's zero res weights)."""
    y = fn()
    g = torch.autograd.grad((y * cot).sum(), [x, *params], allow_unused=True)
    return y.detach(), [torch.zeros_like(p) if d is None else d for p, d in zip([x, *params], g)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,T,k,dils", [
    (32, 5001, 3, (1, 3, 5)), (64, 777, 7, (1, 3, 5)), (128, 301, 11, (1, 3, 5)),
    (192, 100, 5, (1, 3, 5)), (256, 37, 11, (1, 3, 5)), (16, 3, 3, (1, 3)),
])
def test_resblock1_train_kernels_match_plain(rng, cuda, C, T, k, dils):
    """Kernel 4 (forward) and kernel 5 (dx, dW, db) against autograd of the
    plain chain: T not a multiple of any tile, shorter than the reach, a
    2-unit chain. Values within 2e-5 of the largest magnitude (float32 sums
    in another order); gradients by _chain_grads_close."""
    x, convs, cot = _train_chain(rng, cuda, C, k, dils, T)
    params = [t for w, b, _, _ in convs for t in (w, b)]
    n4, n5 = resblock.fused_resblock1.launches, resblock.fused_resblock1_backward.launches
    got, g_got = _grads(lambda: resblock.fused_resblock1_train(x, convs), x, params, cot)
    torch.cuda.synchronize()
    assert (resblock.fused_resblock1.launches, resblock.fused_resblock1_backward.launches) \
        == (n4 + 1, n5 + 1)
    ref, g_ref = _grads(lambda: resblock.fused_resblock1_plain(x, convs), x, params, cot)
    _scaled_close(got, ref, 2e-5)
    stack = lambda g: (g[0], torch.stack(g[1::2]), torch.stack(g[2::2]))  # noqa: E731
    _chain_grads_close(x, convs, stack(g_got), stack(g_ref))


@pytest.mark.gpu
@pytest.mark.parametrize("C,T,L,lengths", [
    (192, 400, 16, (400, 377, 200, 1)), (192, 400, 3, (400, 400, 399, 250)),
    (32, 1000, 4, (1000, 613)), (64, 57, 2, (57, 0)), (128, 300, 1, (300,)),
    (256, 130, 3, (130, 129)),
])
def test_wn_kernels_match_plain(rng, cuda, C, T, L, lengths):
    """Kernel 6 (forward) and kernel 7 (dx, dWa, dWb, dBab, dG, dWres,
    dWskip, dBrs) against autograd of the plain stack, lengths < T (one of
    0), the input masked. Values within 2e-5 and gradients within 1e-4 of
    the largest magnitude (sums over every row in another order)."""
    B, k = len(lengths), 5
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    mask = (torch.arange(T, device=cuda)[None, :] < lens[:, None]).float()[..., None]
    x = (torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(cuda)
         * mask).requires_grad_()
    w = [torch.from_numpy(a).to(cuda).requires_grad_()
         for a in _wn_inputs(rng, B, T, C, L, k).values()]
    cot = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(cuda)
    n6, n7 = wavenet.fused_wn.launches, wavenet.fused_wn_backward.launches
    got, g_got = _grads(lambda: wavenet.fused_wn(x, *w, lens, kernel_size=k), x, w, cot)
    torch.cuda.synchronize()
    assert (wavenet.fused_wn.launches, wavenet.fused_wn_backward.launches) == (n6 + 1, n7 + 1)
    ref, g_ref = _grads(lambda: wavenet.fused_wn_plain(x, *w, lens, kernel_size=k), x, w,
                        cot)
    _scaled_close(got, ref, 2e-5)
    for a, b in zip(g_got, g_ref):
        _scaled_close(a, b, 1e-4)


@pytest.mark.gpu
def test_forward_only_kernels_raise_under_grad(rng, cuda):
    """Kernels 1, 2 and 4 have no backward: called with inputs that need
    gradients they raise instead of cutting the graph."""
    x, convs, _ = _train_chain(rng, cuda, 32, 3, (1, 3, 5), 50)
    with pytest.raises(RuntimeError, match="no backward"):
        resblock.fused_resblock_group(x, [convs])
    with pytest.raises(RuntimeError, match="no backward"):
        resblock.fused_resblock1(x, convs)
    q, k, v, ek, ev, lengths = (torch.from_numpy(a).to(cuda)
                                for a in _attention_inputs(rng, D=32))
    with pytest.raises(RuntimeError, match="no backward"):
        attention.banded_rel_attention(q.requires_grad_(), k, v, ek, ev, lengths, window=10,
                                       scale=0.2)


def _near_zero_rows(x, convs):
    """(sample, row) of every pre-activation of the chain within 1e-3 of 0."""
    sites = resblock._preactivations(x.detach(), [(w.detach(), b.detach(), k, d)
                                                  for w, b, k, d in convs])
    return sorted({(b, t) for v in sites for b, _, t in (v.abs() < 1e-3).nonzero().tolist()})


def _kernel_grads(x, convs, cot):
    with torch.no_grad():
        y, hs = resblock._resblock1_forward(x, convs)
        got = resblock.fused_resblock1_backward(x, hs, cot, convs)
        ref = resblock.fused_resblock1_backward_plain(x, hs, cot, convs)
    return [g.clone() for g in got], ref


@pytest.mark.gpu
def test_chain_grad_check_catches_a_wrong_dx_row(rng, cuda):
    """Kernel 5's check passes the kernel's gradients and fails them once one
    time row of dx is wrong, a row at a pre-activation near 0."""
    x, convs, cot = _train_chain(rng, cuda, 32, 3, (1, 3, 5), 5001)
    got, ref = _kernel_grads(x, convs, cot)
    _chain_grads_close(x, convs, got, ref)
    b, t = _near_zero_rows(x, convs)[0]
    got[0][b, t] = -got[0][b, t]
    msg, _ = resblock.check_chain_grads(x.detach(), convs, got, ref)
    assert msg is not None and f"sample {b}, row {t})" in msg, msg


@pytest.mark.gpu
@pytest.mark.parametrize("C,T,k,where", [
    (256, 432, 11, "dx_row"), (256, 432, 11, "dw_conv0_tap"), (128, 1000, 7, "db_conv0"),
])
def test_chain_grad_check_catches_wrong_gradients(rng, cuda, C, T, k, where):
    """At the training run's C = 256 shapes (B = 4) and at C = 128: the
    check passes the kernel's gradients and fails them once one dx row at a
    pre-activation near 0 is negated, one tap of conv 0's dW is zeroed, or
    one element of conv 0's db is off by 1e-3 of its largest magnitude."""
    x, convs, cot = _train_chain(rng, cuda, C, k, (1, 3, 5), T, B=4)
    got, ref = _kernel_grads(x, convs, cot)
    _chain_grads_close(x, convs, got, ref)
    if where == "dx_row":
        b, t = _near_zero_rows(x, convs)[0]
        got[0][b, t] = -got[0][b, t]
        expect = f"sample {b}, row {t})"
    elif where == "dw_conv0_tap":
        got[1][0, :, :, 0] = 0.0
        expect = "dW of conv 0"
    else:
        got[2][0, 7] += 1e-3 * got[2][0].abs().max()
        expect = "db of conv 0"
    msg, _ = resblock.check_chain_grads(x.detach(), convs, got, ref)
    assert msg is not None and expect in msg, msg


@pytest.mark.gpu
def test_resblock1_forward_is_the_simt_unit_kernel(rng, cuda):
    """Kernel 4 runs the SIMT unit kernel: bit for bit what a launch of
    that kernel per unit gives."""
    x, convs, _ = _train_chain(rng, cuda, 64, 7, (1, 3, 5), 777)
    with torch.no_grad():
        convs = [(w.detach(), b.detach(), k, d) for w, b, k, d in convs]
        got = resblock.fused_resblock1(x.detach(), convs)
        simt = resblock._run_units(x.detach(), [convs], "rvc_resblock_unit_simt",
                                   lambda w: w.permute(2, 1, 0).contiguous(),
                                   types.SimpleNamespace(launches=0))
    torch.cuda.synchronize()
    assert torch.equal(got, simt)


def _nearest_within_ties(got, feats, bank_f):
    """Rows identical to the plain version's unless the query's two best
    plain distances lie within 1e-5 relative of each other."""
    ref = retrieval.topk_blend(feats, bank_f, 1)
    d2 = torch.sum(bank_f * bank_f, 1)[None] - 2.0 * feats @ bank_f.T
    best2 = torch.topk(-d2, min(2, bank_f.shape[0]), dim=1).values
    gap = ((best2[:, 0] - best2[:, -1]) / best2[:, 0].abs().clamp(min=1.0)
           if best2.shape[1] > 1 else torch.ones_like(best2[:, 0]))
    same = (got - ref).abs().max(dim=1).values <= 1e-6 * ref.abs().max().clamp(min=1.0)
    assert bool(torch.all(same | (gap.abs() < 1e-5))), f"{int((~same).sum())} rows differ"


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("NQ,N", [(1, 129), (130, 257), (300, 40 * 128 + 1)])
def test_nearest_rows_tensor_core_tiles(rng, cuda, int8, NQ, N):
    """Kernel 3's tiles: NQ = 1 and not a multiple of the 128-query tile, N
    one past a 128-row bank tile, D = 768, query entries spanning 1e-3 to
    1e3 in magnitude."""
    D = 768
    mag = 10.0 ** rng.uniform(-3, 3, (NQ, D))
    feats = (rng.choice([-1.0, 1.0], (NQ, D)) * mag).astype(np.float32)
    bank = rng.standard_normal((N, D)).astype(np.float32) * 30.0
    f = torch.from_numpy(feats).to(cuda)
    if int8:
        bq, s = (torch.from_numpy(a).to(cuda) for a in retrieval.quantize_bank(bank))
        got = retrieval.nearest_rows_q(f, bq, s)
        bank_f = bq.float() * s
    else:
        bank_f = torch.from_numpy(bank).to(cuda)
        got = retrieval.nearest_rows(f, bank_f)
    torch.cuda.synchronize()
    _nearest_within_ties(got, f, bank_f)
