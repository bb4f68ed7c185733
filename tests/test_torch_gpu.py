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


def _wn_case(rng, cuda, C, T, L, lengths, k=5):
    B = len(lengths)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    mask = (torch.arange(T, device=cuda)[None, :] < lens[:, None]).float()[..., None]
    x = (torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(cuda)
         * mask).requires_grad_()
    w = [torch.from_numpy(a).to(cuda).requires_grad_()
         for a in _wn_inputs(rng, B, T, C, L, k).values()]
    cot = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(cuda)
    return x, w, lens, cot


@pytest.mark.gpu
@pytest.mark.parametrize("C,T,B,k,dils", [
    (64, 5, 1, 3, (1, 3, 5)),        # B T smaller than one row tile
    (128, 300, 2, 7, (1, 3, 5)),     # T not a multiple of the 256-row tile
    (256, 433, 4, 11, (1, 3, 5)),    # C = 256: 64-row tiles, taps in two groups
    (16, 70, 3, 5, (1, 3)),          # C = 16: 16-channel warp tiles, a 2-unit chain
    (48, 257, 2, 3, (1, 3, 5)),      # C not a multiple of 32
])
def test_resblock1_backward_tensor_core_tiles(rng, cuda, C, T, B, k, dils):
    """Kernel 5's row, channel, tap and K tiling at its edges, against
    autograd of the plain chain (_chain_grads_close)."""
    x, convs, cot = _train_chain(rng, cuda, C, k, dils, T, B=B)
    got, ref = _kernel_grads(x, convs, cot)
    torch.cuda.synchronize()
    _chain_grads_close(x, convs, got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("C,T,L,lengths", [
    (16, 40, 2, (40, 0)), (48, 33, 3, (0, 33, 17)), (256, 70, 2, (70, 1)),
    (192, 400, 3, (400, 0, 257, 300)),
])
def test_wn_backward_tensor_core_tiles(rng, cuda, C, T, L, lengths):
    """Kernel 7 at C = 16, 48 (not a multiple of 32), 192 and 256, with
    lengths of 0 and T: every gradient within 1e-4 of its largest magnitude
    of autograd of the plain stack."""
    x, w, lens, cot = _wn_case(rng, cuda, C, T, L, lengths)
    _, g_got = _grads(lambda: wavenet.fused_wn(x, *w, lens, kernel_size=5), x, w, cot)
    torch.cuda.synchronize()
    _, g_ref = _grads(lambda: wavenet.fused_wn_plain(x, *w, lens, kernel_size=5), x, w, cot)
    for a, b in zip(g_got, g_ref):
        _scaled_close(a, b, 1e-4)


@pytest.mark.gpu
def test_backward_weight_gradients_are_bit_identical(rng, cuda):
    """The weight gradients are reduced in a fixed order (no atomics): two
    calls of kernels 5 and 7 give the same bits in every output."""
    x, convs, cot = _train_chain(rng, cuda, 128, 11, (1, 3, 5), 1001, B=4)
    with torch.no_grad():
        _, hs = resblock._resblock1_forward(x, convs)
        runs = [resblock.fused_resblock1_backward(x, hs, cot, convs) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    x, w, lens, cot = _wn_case(rng, cuda, 192, 400, 4, (400, 377, 200, 1))
    with torch.no_grad():
        _, xs, pre = wavenet._forward(x, *w, lens, 5)
        runs = [wavenet.fused_wn_backward(x, xs, pre, cot, *w, lens, kernel_size=5)
                for _ in range(2)]
    for a, b in zip(*runs):  # dx, dWa, dWb, dBab, dG, dWres, dWskip, dBrs
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_simt_yardsticks_are_on_no_path(rng, cuda, monkeypatch):
    """The float32 SIMT backward entries that kernels 5 and 7 replaced stay
    in the library only as chip_smoke.py's yardstick: a differentiable chain
    and WN stack on the card never call them."""
    from rvc_tpu_torch.ops import _cuda

    lib = _cuda.library()
    called = []
    for name in ("rvc_resblock1_bwd_simt", "rvc_wn_bwd_simt"):
        monkeypatch.setattr(lib, name, lambda *a, _n=name: called.append(_n) or 0)
    x, convs, cot = _train_chain(rng, cuda, 32, 3, (1, 3, 5), 100)
    params = [t for w, b, _, _ in convs for t in (w, b)]
    _grads(lambda: resblock.fused_resblock1_train(x, convs), x, params, cot)
    x, w, lens, cot = _wn_case(rng, cuda, 32, 50, 2, (50, 20))
    _grads(lambda: wavenet.fused_wn(x, *w, lens, kernel_size=5), x, w, cot)
    torch.cuda.synchronize()
    assert called == []


# ---- bfloat16: kernels 1 and 2 in bf16 and kernel 8 ----
# The kernel and its plain version round at the same points and differ only
# in the order of float32 sums, so a rounding flips by one bf16 ulp now and
# then. In one residual unit that stays at single flips (measured on the
# card at C = 256: 0.08% of elements differ, as the plain version on the
# card differs from itself on the CPU). Through a chain of wide convs each
# flip moves every output it reaches by a fraction of an ulp, which flips
# more roundings: after a stage of three chains at C = 256, 16% of elements
# differ and 7% by more than one ulp, for the kernel against the plain
# version as for the plain version on the card against the CPU. So a unit
# is held elementwise and a chain or stage by its size: the relative L2
# distance within one bf16 ulp (2^-8) and the largest difference within
# 2e-2 of the largest magnitude (5 ulps there).


def _bf16_close(got, ref, unit: bool = False):
    assert got.dtype == ref.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    rel = (diff.max() / ref.abs().max()).item()
    l2 = (diff.norm() / ref.norm()).item()
    if unit:
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=2.0 ** -126))) - 7)
        beyond = (diff > ulp).float().mean().item()
        assert rel <= 1e-2 and beyond <= 1e-3, (rel, beyond)
    assert rel <= 2e-2 and l2 <= 2.0 ** -8, (rel, l2)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [16, 32, 64, 128, 256])
def test_resblock_bf16_unit_matches_plain(rng, cuda, C):
    """One residual unit (k 11, d 5: the widest halo) at T = 1237, held
    elementwise: at most 0.1% of the elements more than one ulp apart."""
    x = torch.from_numpy(rng.standard_normal((2, 1237, C)).astype(np.float32)).to(cuda)
    chains = _bf16_chains(rng, cuda, C, ((11, (5,)),))
    got = resblock.fused_resblock_group(x.bfloat16(), chains)
    _bf16_close(got, resblock.resblock_group_plain(x.bfloat16(), chains), unit=True)


def _bf16_chains(rng, cuda, C, spec):
    return [[(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda), k, d)
             for w, b, k, d in c] for c in _chains(rng, C, spec)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,T,spec", [
    (256, 1000, ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5)))),
] + TILE_CASES)
def test_resblock_bf16_kernel_tiles(rng, cuda, C, T, spec):
    """Kernel 1 in bf16 at every width it is built for, the widest halo, T
    of 1 and not a multiple of any row tile; a launch per unit, counted as
    bf16."""
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32)).to(cuda).bfloat16()
    chains = _bf16_chains(rng, cuda, C, spec)
    n32, n16 = resblock.fused_resblock_group.launches, resblock.fused_resblock_group.launches_bf16
    got = resblock.fused_resblock_group(x, chains)
    torch.cuda.synchronize()
    assert resblock.fused_resblock_group.launches == n32
    assert resblock.fused_resblock_group.launches_bf16 == n16 + sum(len(c) // 2 for c in chains)
    _bf16_close(got, resblock.resblock_group_plain(x, chains))


@pytest.mark.gpu
@pytest.mark.parametrize("C,T,k", [(16, 1237, 11), (256, 1237, 11), (128, 77, 3)])
def test_resblock1_v2_kernel_matches_plain(rng, cuda, C, T, k):
    """Kernel 8 (one chain, bf16 carry), and the mean of a stage's chains
    through it equal, bit for bit, to kernel 1 in bf16 on the same stage."""
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32)).to(cuda).bfloat16()
    chains = _bf16_chains(rng, cuda, C, ((k, (1, 3, 5)), (3, (1, 3, 5)), (7, (1, 3, 5))))
    n = resblock.fused_resblock1_v2.launches
    got = resblock.fused_resblock1_v2(x, chains[0])
    torch.cuda.synchronize()
    assert resblock.fused_resblock1_v2.launches == n + 3
    _bf16_close(got, resblock.fused_resblock1_plain(x, chains[0]))
    from rvc_tpu_torch.models.nsf import mean_of

    per_chain = mean_of([resblock.fused_resblock1_v2(x, c) for c in chains])
    assert torch.equal(per_chain, resblock.fused_resblock_group(x, chains))


@pytest.mark.gpu
def test_resblock1_v2_raises_under_grad_and_on_float32(rng, cuda):
    x, convs, _ = _train_chain(rng, cuda, 32, 3, (1, 3, 5), 50)
    with pytest.raises(RuntimeError, match="no backward"):
        resblock.fused_resblock1_v2(x.detach().bfloat16().requires_grad_(), convs)
    with pytest.raises(RuntimeError, match="no backward"):
        resblock.fused_resblock_group(x.detach().bfloat16().requires_grad_(), [convs])
    with pytest.raises(ValueError, match="bfloat16"):
        resblock.fused_resblock1_v2(x.detach(), [(w.detach(), b.detach(), k, d)
                                                 for w, b, k, d in convs])


def _bf16_attention(rng, cuda, T, D, lengths=None):
    q, k, v, ek, ev, lens = _attention_inputs(rng, T=T, D=D)
    args = [torch.from_numpy(a).to(cuda).bfloat16() for a in (q, k, v, ek, ev)]
    if lengths is not None:
        lens = np.array(lengths, np.int32)
    return args + [torch.from_numpy(lens).to(cuda)]


@pytest.mark.gpu
@pytest.mark.parametrize("T,D,lengths", [
    (70, 96, None), (1937, 96, None), (300, 32, None), (300, 128, None),
    (1, 96, [1, 0, 1]), (5, 64, [5, 0, 2]), (65, 96, [65, 64, 1])])
def test_attention_bf16_kernel_matches_plain(rng, cuda, T, D, lengths):
    """Kernel 2 in bf16: the head widths it is built for, key tiles of 64
    cut at T, one-row sequences and a length of 0 (every row uniform)."""
    args = _bf16_attention(rng, cuda, T, D, lengths)
    n = attention.banded_rel_attention.launches_bf16
    got = attention.banded_rel_attention(*args, window=10, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert attention.banded_rel_attention.launches_bf16 == n + 1
    _bf16_close(got, attention.banded_rel_attention_plain(*args, window=10, scale=D ** -0.5))


@pytest.mark.gpu
def test_attention_bf16_kernel_beyond_the_longest_default_chunk(rng, cuda):
    """T = 7700 frames, longer than any chunk of the default chunking (at
    most x_center + x_query = 70 s and the 3 s pads on both sides), lengths
    < T on two rows: the kernel keeps no row of scores."""
    args = _bf16_attention(rng, cuda, 7700, 96, [7700, 6000, 100])
    got = attention.banded_rel_attention(*args, window=10, scale=96 ** -0.5)
    torch.cuda.synchronize()
    _bf16_close(got, attention.banded_rel_attention_plain(*args, window=10, scale=96 ** -0.5))
