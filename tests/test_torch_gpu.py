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
    # kernel 6's 128-row blocks over the B T rows: T one short of, at and
    # one past a block, B T not a multiple of it (254, 256, 387, 129, 384)
    (64, 127, 2, (127, 126)), (192, 128, 3, (128, 5)), (64, 129, 3, (129, 0, 64)),
    (16, 129, 2, (129,)), (48, 128, 3, (128, 1, 127)),
])
def test_wn_kernels_match_plain(rng, cuda, C, T, L, lengths):
    """Kernel 6 (forward) and kernel 7 (dx, dWa, dWb, dBab, dG, dWres,
    dWskip, dBrs) against autograd of the plain stack, lengths < T (one of
    0), the input masked; C = 16 and 48 (a block of 32 outputs, and the last
    layer's 1x1 in blocks of 16 and 48); L = 16 as two groups of 8, a launch
    each way a group. Values within 2e-5 and gradients within 1e-4 of the
    largest magnitude (sums over every row in another order)."""
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
    groups = -(-L // wavenet.GROUP_SIZE)
    assert (wavenet.fused_wn.launches, wavenet.fused_wn_backward.launches) == (n6 + groups,
                                                                               n7 + groups)
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
    """Kernel 4 (the wgmma chain) computes what its first version, the SIMT
    unit kernel a launch per unit (``rvc_resblock1_fwd_simt``, chip_smoke's
    yardstick), computes: within 2e-5 of the largest magnitude (chip_smoke's
    VALUE_TOL), both sums in float32 in other orders."""
    x, convs, _ = _train_chain(rng, cuda, 64, 7, (1, 3, 5), 777)
    with torch.no_grad():
        convs = [(w.detach(), b.detach(), k, d) for w, b, k, d in convs]
        got = resblock.fused_resblock1(x.detach(), convs)
        simt = _chip_smoke().previous_chain(x.detach(), convs)
    torch.cuda.synchronize()
    _scaled_close(got, simt, 2e-5)


# kernel 4's blocks own 128 rows: T one short of, at and one past a block;
# every blocking it chooses (outputs a block / blocks an SM): 16/2 at C 16
# and 48, 32/2 at 32, 64/1 at 64, 128 and 192, 32/1 at 256, 16/1 at 80 and 240
K4_TILES = [(C, T) for C in (16, 48, 64, 128, 192, 256) for T in (1, 127, 128, 129)] + [
    (256, 432), (32, 1000), (80, 129), (240, 129)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,T", K4_TILES)
def test_resblock1_forward_tiles(rng, cuda, C, T):
    """Kernel 4 at its tiles' edges, a chain of k = 11 and dilations 1, 3, 5
    (the widest halo): every unit's kept output and the chain's within 2e-5
    of the largest magnitude of the plain chain cut after that unit; a
    launch counted a call."""
    x, convs, _ = _train_chain(rng, cuda, C, 11, (1, 3, 5), T, B=3)
    with torch.no_grad():
        convs = [(w.detach(), b.detach(), k, d) for w, b, k, d in convs]
        n = resblock.fused_resblock1.launches
        y, hs = resblock._resblock1_forward(x.detach(), convs)
        torch.cuda.synchronize()
        assert resblock.fused_resblock1.launches == n + 1
        for u, got in enumerate(list(hs) + [y]):
            _scaled_close(got, resblock.fused_resblock1_plain(x.detach(), convs[:2 * u + 2]),
                          2e-5)


@pytest.mark.gpu
def test_training_chain_keeps_no_packed_weights(rng, cuda):
    """Weights that weight norm folds anew every training step carry
    autograd history and are never seen again: differentiable chain calls
    on such weights pack them at every call and leave the packing cache as
    it was, and their gradients are those of weights given as they are."""
    x, convs, cot = _train_chain(rng, cuda, 64, 3, (1, 3, 5), 200)
    params = [t for w, b, _, _ in convs for t in (w, b)]
    _, want = _grads(lambda: resblock.fused_resblock1_train(x, convs), x, params, cot)
    kept = len(resblock._pack_cache)
    for _ in range(3):
        folded = [(w * 1.0, b, k, d) for w, b, k, d in convs]  # a new tensor a step
        _, got = _grads(lambda: resblock.fused_resblock1_train(x, folded), x, params, cot)
        assert len(resblock._pack_cache) == kept
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_new_kernels_give_the_same_bits_twice(rng, cuda):
    """Kernel 4 and kernel 2 in bf16 sum in a fixed order (no atomics): two
    calls give the same bits."""
    x, convs, _ = _train_chain(rng, cuda, 256, 11, (1, 3, 5), 433, B=4)
    with torch.no_grad():
        convs = [(w.detach(), b.detach(), k, d) for w, b, k, d in convs]
        a, b = (resblock._resblock1_forward(x.detach(), convs) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    args = _bf16_attention(rng, cuda, 2178, 96, [2178, 1221, 7])
    a, b = (attention.banded_rel_attention(*args, window=10, scale=96 ** -0.5)
            for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 63, 64, 65, 129, 300, 513, 769, 1000, 2178])
def test_attention_bf16_key_split_tiles(rng, cuda, T):
    """Kernel 2 in bf16 at its tiles' edges (64 query rows a block, 64-key
    tiles, the keys in splits of whole tiles), lengths T, 1 and 0; with 6
    (batch, head) pairs the kernel takes one key split up to T = 300, and
    2, 3 (the last one shorter), 4 and 4 at T = 513 (a last tile of one
    key), 769, 1000 and 2178: within the bf16 bars of the plain version,
    and of its first version (chip_smoke's yardstick); a call counted once."""
    args = _bf16_attention(rng, cuda, T, 96, [T, 1, 0])
    n = attention.banded_rel_attention.launches_bf16
    with torch.no_grad():
        got = attention.banded_rel_attention(*args, window=10, scale=96 ** -0.5)
    prev = _chip_smoke().attention_bf16_sync(*args, window=10, scale=96 ** -0.5)
    torch.cuda.synchronize()
    assert attention.banded_rel_attention.launches_bf16 == n + 1
    _bf16_close(got, attention.banded_rel_attention_plain(*args, window=10, scale=96 ** -0.5))
    _bf16_close(got, prev)


@pytest.mark.gpu
def test_backward_packs_given_apart_give_the_same_bits(rng, cuda):
    """Kernels 5 and 7 on weights packed before the call (as chip_smoke
    times them) give what they give packing inside the call, bit for bit."""
    x, convs, cot = _train_chain(rng, cuda, 128, 7, (1, 3, 5), 301, B=2)
    with torch.no_grad():
        convs = [(w.detach(), b.detach(), k, d) for w, b, k, d in convs]
        _, hs = resblock._resblock1_forward(x.detach(), convs)
        inside = resblock.fused_resblock1_backward(x.detach(), hs, cot, convs)
        apart = resblock.fused_resblock1_backward(x.detach(), hs, cot, convs,
                                                  resblock.pack_backward_weights(convs))
    for a, b in zip(inside, apart):
        assert torch.equal(a, b)
    x, w, lens, cot = _wn_case(rng, cuda, 192, 100, 3, (100, 77))
    with torch.no_grad():
        _, xs, pre = wavenet._forward(x, *w, lens, 5)
        inside = wavenet.fused_wn_backward(x, xs, pre, cot, *w, lens, kernel_size=5)
        packs = wavenet.pack_backward_weights(w[0], w[1], w[4], w[5], 5)
        apart = wavenet.fused_wn_backward(x, xs, pre, cot, *w, lens, kernel_size=5, packs=packs)
    for a, b in zip(inside, apart):
        assert torch.equal(a, b)


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
@pytest.mark.parametrize("C,T,L,lengths", [
    (192, 400, 16, (400, 377, 200, 1)), (48, 129, 3, (129, 0, 64)), (16, 127, 1, (127, 3)),
])
def test_wn_forward_is_the_simt_kernel(rng, cuda, C, T, L, lengths):
    """Kernel 6 (on wgmma) computes what its first version, the SIMT forward
    (``rvc_wn_fwd_simt``, chip_smoke's yardstick), computes, and keeps the
    same values for kernel 7: out, xs, pre_a and pre_b each within 2e-5 of
    their largest magnitude (chip_smoke's VALUE_TOL), both summed in float32
    in other orders."""
    cs = _chip_smoke()
    x, w, lens, _ = _wn_case(rng, cuda, C, T, L, lengths)
    with torch.no_grad():
        args = [x.detach()] + [t.detach() for t in w] + [lens]
        got = wavenet._forward(*args, 5)
        ref = cs.wn_forward_simt(*args, kernel_size=5)
    torch.cuda.synchronize()
    _scaled_close(got[0], ref[0], 2e-5)
    if L > 1:
        _scaled_close(got[1], ref[1], 2e-5)
    for half in range(2):
        _scaled_close(got[2][half], ref[2][half], 2e-5)


@pytest.mark.gpu
def test_wn_forward_is_bit_identical(rng, cuda):
    """Kernel 6 sums in a fixed order: two calls give the same bits in out,
    xs, pre_a and pre_b, at the training shapes and at a ragged edge."""
    for C, T, L, lengths in ((192, 400, 16, (400, 377, 200, 1)), (48, 129, 3, (129, 0, 64))):
        x, w, lens, _ = _wn_case(rng, cuda, C, T, L, lengths)
        with torch.no_grad():
            args = [x.detach()] + [t.detach() for t in w] + [lens]
            runs = [wavenet._forward(*args, 5) for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


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
    """The entries that redesigned kernels replaced stay in the library only
    as chip_smoke.py's yardsticks: a differentiable chain and WN stack (the
    float32 SIMT chain forward and backward of kernels 4, 5, 6 and 7), a bf16
    stage through both decoder routes (the bf16 unit on mma.sync) and kernel
    2 in float32 and in bf16 (its SIMT kernel, the first bf16 kernel) on the card
    never call them."""
    from rvc_tpu_torch.ops import _cuda

    lib = _cuda.library()
    called = []
    for name in ("rvc_resblock1_fwd_simt", "rvc_resblock1_bwd_simt", "rvc_wn_fwd_simt",
                 "rvc_wn_bwd_simt",
                 "rvc_resblock_unit_bf16_sync", "rvc_banded_attention_simt",
                 "rvc_banded_attention_bf16_sync"):
        monkeypatch.setattr(lib, name, lambda *a, _n=name: called.append(_n) or 0)
    x, convs, cot = _train_chain(rng, cuda, 32, 3, (1, 3, 5), 100)
    params = [t for w, b, _, _ in convs for t in (w, b)]
    _grads(lambda: resblock.fused_resblock1_train(x, convs), x, params, cot)
    x, w, lens, cot = _wn_case(rng, cuda, 32, 50, 2, (50, 20))
    _grads(lambda: wavenet.fused_wn(x, *w, lens, kernel_size=5), x, w, cot)
    xb = torch.from_numpy(rng.standard_normal((2, 300, 64)).astype(np.float32)).to(cuda).bfloat16()
    chains = _bf16_chains(rng, cuda, 64, ((3, (1, 3, 5)), (7, (1, 3, 5))))
    resblock.fused_resblock_group(xb, chains)
    resblock.fused_resblock1_v2(xb, chains[0])
    args = [torch.from_numpy(a).to(cuda) for a in _attention_inputs(rng, T=100, D=96)]
    attention.banded_rel_attention(*args, window=10, scale=96 ** -0.5)
    attention.banded_rel_attention(*[a.bfloat16() for a in args[:5]], args[5], window=10,
                                   scale=96 ** -0.5)
    torch.cuda.synchronize()
    assert called == []


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_yardsticks_compute_the_same_function(rng, cuda):
    """chip_smoke.py's yardsticks for the redesigned kernels (the bf16
    unit on mma.sync, the SIMT kernel 2, the SIMT chain and the mma.sync
    float32 unit beside kernel 4, the first bf16 kernel 2) still compute their
    kernels' functions, so their times are comparable: the bf16 stage and
    kernel 2 in bf16 within the bf16 bars of the plain version, kernel 2
    within 1e-5, the chains within 2e-5 of the largest magnitude."""
    cs = _chip_smoke()
    x = torch.from_numpy(rng.standard_normal((2, 1237, 128)).astype(np.float32)).to(cuda)
    chains = _bf16_chains(rng, cuda, 128, ((11, (1, 3, 5)), (3, (1, 3, 5))))
    got = cs.previous_bf16(x.bfloat16(), chains)
    torch.cuda.synchronize()
    _bf16_close(got, resblock.resblock_group_plain(x.bfloat16(), chains))
    args = [torch.from_numpy(a).to(cuda) for a in _attention_inputs(rng, T=300, D=96)]
    got = cs.attention_simt(*args, window=10, scale=96 ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, attention.banded_rel_attention_plain(*args, window=10, scale=96 ** -0.5),
        atol=1e-5, rtol=1e-5)
    args16 = [a.bfloat16() for a in args[:5]] + [args[5]]
    got = cs.attention_bf16_sync(*args16, window=10, scale=96 ** -0.5)
    torch.cuda.synchronize()
    _bf16_close(got, attention.banded_rel_attention_plain(*args16, window=10, scale=96 ** -0.5))
    x, convs, _ = _train_chain(rng, cuda, 128, 11, (1, 3, 5), 500)
    with torch.no_grad():
        convs = [(w.detach(), b.detach(), k, d) for w, b, k, d in convs]
        ref = resblock.fused_resblock1_plain(x.detach(), convs)
        for chain in (cs.previous_chain, cs.mma_sync_chain):
            _scaled_close(chain(x.detach(), convs), ref, 2e-5)


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


# the wgmma unit kernel's output rows a block at k = 11 (conv_b's halo 10):
# M - 10 with M = 128, 256, 256, 512, 512 conv rows at C = 256 .. 16
WG_ROWS = {256: 118, 128: 246, 64: 246, 32: 502, 16: 502}


@pytest.mark.gpu
@pytest.mark.parametrize("C,T", [(C, T) for C in (16, 32, 64, 128, 256)
                                 for T in (30, WG_ROWS[C], WG_ROWS[C] + 1, 2 * WG_ROWS[C] + 7)])
def test_resblock_bf16_wgmma_unit_tiles(rng, cuda, C, T):
    """The wgmma unit kernel at its tiles' edges: every width it is built
    for, one unit of k = 11 and d = 5 (the widest halo), T below the halo
    (30 < 50), T of one block's output rows, one past it, and two blocks and
    a part. Held elementwise, as one unit: at most 0.1% of the elements more
    than one ulp from the plain version."""
    x = torch.from_numpy(rng.standard_normal((2, T, C)).astype(np.float32)).to(cuda).bfloat16()
    chains = _bf16_chains(rng, cuda, C, ((11, (5,)),))
    n = resblock.fused_resblock_group.launches_bf16
    got = resblock.fused_resblock_group(x, chains)
    torch.cuda.synchronize()
    assert resblock.fused_resblock_group.launches_bf16 == n + 1
    _bf16_close(got, resblock.resblock_group_plain(x, chains), unit=True)


@pytest.mark.gpu
@pytest.mark.parametrize("T,D", [(31, 32), (32, 96), (33, 128), (97, 96), (2178, 96)])
def test_attention_tensor_core_tiles(rng, cuda, T, D):
    """Kernel 2 in float32 on the tensor cores at its tiles' edges (32 query
    rows a block, 32 keys a tile): T one short of, at and one past a tile,
    three tiles and a part, the 30 s conversion's T; lengths T, 1 and 0."""
    q, k, v, ek, ev, _ = _attention_inputs(rng, T=T, D=D)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, ek, ev)]
    lens = torch.tensor([T, 1, 0], dtype=torch.int32, device=cuda)
    n = attention.banded_rel_attention.launches
    got = attention.banded_rel_attention(*args, lens, window=10, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert attention.banded_rel_attention.launches == n + 1
    ref = attention.banded_rel_attention_plain(*args, lens, window=10, scale=D ** -0.5)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_packing_cache_follows_in_place_changes(rng, cuda):
    """The unit kernels pack a set of weights once; a change of the weights
    in place is seen at the next call."""
    x = torch.from_numpy(rng.standard_normal((2, 500, 64)).astype(np.float32)).to(cuda)
    chains = _bf16_chains(rng, cuda, 64, ((3, (1, 3)),))
    for xx in (x, x.bfloat16()):
        resblock.fused_resblock_group(xx, chains)
        with torch.no_grad():
            chains[0][0][0].mul_(-2.0)
        got = resblock.fused_resblock_group(xx, chains)
        torch.cuda.synchronize()
        ref = resblock.resblock_group_plain(xx, chains)
        if xx.dtype == torch.bfloat16:
            _bf16_close(got, ref)
        else:
            torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("src,dst", [(48000, 44100), (40000, 16000), (44100, 16000)])
def test_resample_on_the_card_matches_scipy(cuda, src, dst):
    """ops.resample on the card (cuDNN's conv1d in float32, TF32 off)
    against scipy.signal.resample_poly in float64: 1e-5 absolute on 1 s of
    unit-variance noise in two rows."""
    import math

    from scipy import signal

    from rvc_tpu_torch.ops.resample import resample

    x = np.random.default_rng(src + dst).standard_normal((2, src)).astype(np.float32)
    g = math.gcd(src, dst)
    ref = signal.resample_poly(x.astype(np.float64), dst // g, src // g, axis=-1)
    got = resample(torch.from_numpy(x).to(cuda), src, dst).cpu().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_cli_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The command line on a narrow v1 48 kHz model written as the
    reference's files (chip_smoke.py's writers; full-size rmvpe.pt), 1 s of
    stereo 44.1 kHz in, 44.1 kHz out, on the card and on the CPU: the wavs
    within 4 LSB of int16 (phase 5's bar: float32 summed in another order).
    The widths are the narrowest the kernels take: attention heads of 32,
    decoder stages of 128 down to 16 channels."""
    import os

    from scipy.io import wavfile

    import chip_smoke
    from rvc_tpu_torch.cli import main as cli
    from rvc_tpu_torch.models.hubert import HubertConfig

    kw = dict(spec_channels=129, segment_size=16, inter_channels=16, hidden_channels=64,
              filter_channels=128, n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.0,
              resblock="1", resblock_kernel_sizes=(3, 5),
              resblock_dilation_sizes=((1, 3), (1, 2)), upsample_rates=(10, 6, 4, 2),
              upsample_initial_channel=256, upsample_kernel_sizes=(16, 12, 8, 4),
              spk_embed_dim=4, gin_channels=8, sr=48000, feature_dim=256, use_f0=True)
    p = {k: os.path.join(tmp_path, n) for k, n in (
        ("model", "m.pth"), ("hubert", "h.safetensors"), ("rmvpe", "r.pt"), ("input", "in.wav"))}
    chip_smoke.write_rvc_pth(p["model"], kw, "v1", seed=1)
    chip_smoke.write_hubert_safetensors(p["hubert"], HubertConfig(
        hidden_size=32, intermediate_size=64, num_attention_heads=2, conv_dim=(16,) * 7,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4), seed=2)
    chip_smoke.write_rmvpe_pt(p["rmvpe"], seed=3)
    t = np.arange(44100) / 44100
    mono = 0.5 * np.sin(2 * np.pi * 150 * t * (1 + 0.2 * t)) * (1 + np.sin(2 * np.pi * 3 * t))
    wavfile.write(p["input"], 44100, (np.stack([mono, mono[::-1]], 1) * 20000).astype(np.int16))
    outs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(tmp_path, f"{dev}.wav")
        cli.main(["convert", p["input"], out, "--model", p["model"], "--hubert", p["hubert"],
                  "--rmvpe", p["rmvpe"], "--resample-sr", "44100", "--device", dev])
        sr, outs[dev] = wavfile.read(out)
        assert sr == 44100
    assert outs["cuda"].shape == outs["cpu"].shape
    assert np.all(np.isfinite(outs["cuda"])) and np.abs(outs["cuda"]).max() > 0.5
    assert np.abs(outs["cuda"].astype(np.float64) - outs["cpu"]).max() * 32768 <= 4


@pytest.mark.gpu
def test_multi_tensor_adamw_matches_per_tensor_on_card(rng, cuda):
    """The training update (``torch._foreach_*`` over all tensors at once)
    against its plain version, a tensor at a time, over 3 updates with the
    schedule crossing an epoch: parameters, moments and the gradient norm
    within tests/test_torch_optimizer.py's bar."""
    from rvc_tpu_torch.train.step import AdamW, MultiTensorAdamW, lr_schedule

    shapes = [(5, 3), (256, 256, 7), (7,), (192, 768), (1, 1, 16), (109, 256)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)
              for s in shapes] for _ in range(3)]
    sched = lr_schedule(1e-2, 0.5, 2)
    runs = []
    for cls in (MultiTensorAdamW, AdamW):
        opt = cls([torch.from_numpy(p).to(cuda) for p in params], sched, (0.8, 0.99), 1e-9)
        norms = [float(opt.step(g)) for g in grads]
        runs.append((opt, norms))
    (multi, n_m), (plain, n_p) = runs
    for xs, ys in ((multi.params, plain.params), (multi.m, plain.m), (multi.v, plain.v)):
        for x, y in zip(xs, ys):
            np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(n_m, n_p, rtol=1e-6)


@pytest.mark.gpu
def test_kmeans_chunked_matches_whole_on_card(rng, cuda):
    """``_kmeans`` in chunks of 4096 rows against one chunk of all 20000 rows
    (seeded clusters 10 apart, spread 0.5, 64 of them, each centroid started
    near its own cluster's centre, so that no row lies near a boundary), 5
    iterations: the same centroids within float32 sums in another order
    (index_add_ adds with atomics)."""
    from rvc_tpu_torch.retrieval.index import _kmeans

    centres = 10.0 * rng.standard_normal((64, 32))
    data = (centres[rng.integers(0, 64, 20000)] + 0.5 * rng.standard_normal((20000, 32)))
    data = torch.from_numpy(data.astype(np.float32)).to(cuda)
    init = torch.from_numpy((centres + 0.5 * rng.standard_normal((64, 32))).astype(np.float32))
    init = init.to(cuda)
    chunked = _kmeans(data, init, 64, 5, chunk_rows=4096)
    whole = _kmeans(data, init, 64, 5, chunk_rows=20000)
    np.testing.assert_allclose(chunked.cpu().numpy(), whole.cpu().numpy(), atol=1e-5, rtol=1e-5)


# ---- bfloat16 training: kernels 4-7 in their bf16 form ----


@pytest.mark.gpu
@pytest.mark.parametrize("C,T,k", [(256, 433, 11), (32, 5001, 3), (128, 300, 7)])
def test_resblock1_train_bf16_matches_plain(rng, cuda, C, T, k):
    """The chain in bf16: the bf16 unit kernel forward (a launch a unit)
    against the plain bf16 chain within the bf16 bars; its backward (kernel 4
    in float32 at bf16(0.1), then kernel 5 at bf16(0.1), a launch each)
    against autograd of the plain float32 chain at bf16(0.1) on x upcast,
    by check_chain_grads at that slope (dx before its cast), and dx in
    bf16 as that gradient rounded."""
    x, convs, cot = _train_chain(rng, cuda, C, k, (1, 3, 5), T, B=2)
    xb = x.detach().bfloat16().requires_grad_()
    cot = cot.bfloat16()
    params = [t for w, b, _, _ in convs for t in (w, b)]
    before = (resblock.fused_resblock1_train.launches_bf16, resblock.fused_resblock1.launches,
              resblock.fused_resblock1_backward.launches)
    y = resblock.fused_resblock1_train(xb, convs)
    grads = torch.autograd.grad(y, [xb, *params], cot)
    torch.cuda.synchronize()
    assert (resblock.fused_resblock1_train.launches_bf16, resblock.fused_resblock1.launches,
            resblock.fused_resblock1_backward.launches) == (before[0] + 3, before[1] + 1,
                                                            before[2] + 1)
    plain = [(w.detach(), b.detach(), kk, d) for w, b, kk, d in convs]
    _bf16_close(y.detach(), resblock.fused_resblock1_plain(xb.detach(), plain))
    x32 = xb.detach().float()
    ref = resblock.fused_resblock1_backward_plain(x32, None, cot.float(), plain,
                                                  resblock.BF16_SLOPE)
    with torch.no_grad():
        _, hs = resblock._resblock1_forward(x32, plain, resblock.BF16_SLOPE)
        got = resblock.fused_resblock1_backward(x32, hs, cot.float(), plain,
                                                slope=resblock.BF16_SLOPE)
    msg, counts = resblock.check_chain_grads(x32, plain, got, ref, slope=resblock.BF16_SLOPE)
    assert msg is None, f"{msg} ({counts})"
    assert torch.equal(grads[0], got[0].bfloat16())
    for i, (dw, db) in enumerate(zip(grads[1::2], grads[2::2])):
        assert torch.equal(dw, got[1][i]) and torch.equal(db, got[2][i])


@pytest.mark.gpu
def test_chain_slope_argument_on_the_card(rng, cuda):
    """Kernels 4 and 5 at slope 0.1 given give the default's bits; at
    bf16(0.1) kernel 4 matches the plain chain at that slope within 2e-5,
    and kernel 5's gradients pass check_chain_grads at that slope but not
    at 0.1."""
    x, convs, cot = _train_chain(rng, cuda, 64, 7, (1, 3, 5), 777)
    x = x.detach()
    plain = [(w.detach(), b.detach(), k, d) for w, b, k, d in convs]
    with torch.no_grad():
        default = resblock._resblock1_forward(x, plain)
        at_01 = resblock._resblock1_forward(x, plain, 0.1)
        assert all(torch.equal(a, b) for a, b in zip(default, at_01))
        assert all(torch.equal(a, b) for a, b in zip(
            resblock.fused_resblock1_backward(x, default[1], cot, plain),
            resblock.fused_resblock1_backward(x, default[1], cot, plain, slope=0.1)))
        y, hs = resblock._resblock1_forward(x, plain, resblock.BF16_SLOPE)
        got = resblock.fused_resblock1_backward(x, hs, cot, plain, slope=resblock.BF16_SLOPE)
    torch.cuda.synchronize()
    _scaled_close(y, resblock.fused_resblock1_plain(x, plain, resblock.BF16_SLOPE), 2e-5)
    ref = resblock.fused_resblock1_backward_plain(x, None, cot, plain, resblock.BF16_SLOPE)
    msg, counts = resblock.check_chain_grads(x, plain, got, ref, slope=resblock.BF16_SLOPE)
    assert msg is None, f"{msg} ({counts})"
    ref01 = resblock.fused_resblock1_backward_plain(x, None, cot, plain)
    msg, _ = resblock.check_chain_grads(x, plain, got, ref01)
    assert msg is not None


@pytest.mark.gpu
@pytest.mark.parametrize("C,T,L,lengths,group_size", [
    (192, 400, 16, (400, 377, 200, 1), 8), (64, 129, 5, (129, 0, 64), 2),
])
def test_wn_stack_bf16_gradients_against_float32(rng, cuda, C, T, L, lengths, group_size):
    """The whole WN stack in bf16 through kernels 6 and 7 by groups (x rounded
    to bf16 between groups), against the plain float32 stack on the same x
    and cotangent: dx and every weight and conditioning gradient within
    chip_smoke.STACK_MARGIN times the plain bf16 stack's own relative L2
    distance to that float32 result (chip_smoke.check_wn_stack_bf16 says
    why). And the cause of the whole stack's distance from the plain bf16
    stack: the kernel groups fed the plain bf16 stack's x and its gradient
    there between groups (chip_smoke.wn_stack_grads) agree with the plain
    bf16 stack's weight gradients within 1e-4 of the largest, the group bar
    of test_wn_groups_match_plain. Both run on cuDNN's deterministic engines:
    on its free engines the plain bf16 stack's own weight gradients move
    from run to run by as much as that bar (2.8e-5 to 1.42e-4 of the largest
    in one case), so the fed-x comparison read the engines' choice."""
    import chip_smoke

    x, w, lens, cot = _wn_case(rng, cuda, C, T, L, lengths)
    deterministic, benchmark = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = chip_smoke.wn_stack_grads(x.detach(), [t.detach() for t in w], lens, 5, cot,
                                         group_size)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
    dist = chip_smoke.stack_distances(runs)
    for got, own in zip(dist["card16"], dist["plain16"]):
        assert got <= chip_smoke.STACK_MARGIN * own, (got, own)
    for a, p in zip(runs["fed_x_dx"][1:], runs["plain16"][1:]):
        _scaled_close(a, p, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("C,T,L,lengths,group_size", [
    (192, 400, 16, (400, 377, 200, 1), 8), (64, 129, 5, (129, 0, 64), 2),
    (48, 128, 3, (128, 1, 127), 2),
])
def test_wn_groups_match_plain(rng, cuda, C, T, L, lengths, group_size):
    """Kernels 6 and 7 by groups: a group that gives its last x to the next
    (kernel 6's x_final, kernel 7's gyx) against autograd of the plain
    group, both cotangents, values within 2e-5 and gradients within 1e-4 of
    the largest magnitude; the whole stack in float32 and in bf16 (x, the
    groups' last x, the skip sum and dx rounded where the JAX package rounds
    them) against the plain stack: float32 at those bars, bf16 within the
    bf16 bars on values and dx; and in bf16 each group's route on the same
    input (the kernel route's x from the group before) against the plain
    group's: its skip, last x and dx within the bf16 bars, its float32
    weight gradients within 1e-4 (over the whole stack a rounding of the x
    between groups that flips by one ulp moves the later groups' inputs, and
    their weight gradients by more than that: 0.066 of a largest magnitude
    of 32 at C = 64)."""
    x, w, lens, cot = _wn_case(rng, cuda, C, T, L, lengths)
    (ws, final), *_ = wavenet.groups(*[t.detach() for t in w], 5, group_size)
    assert final
    cot_x = torch.from_numpy(rng.standard_normal(cot.shape).astype(np.float32)).to(cuda)
    with torch.no_grad():
        y, xs, pre, xf = wavenet._forward(x.detach(), *ws, lens, 5, final=True)
        got = wavenet.fused_wn_backward(x.detach(), xs, pre, cot, *ws, lens, kernel_size=5,
                                        gyx=cot_x)
    torch.cuda.synchronize()
    y_ref, xf_ref = wavenet._layers_plain(x.detach(), *ws, lens, 5)
    _scaled_close(y, y_ref, 2e-5)
    _scaled_close(xf, xf_ref, 2e-5)
    ref = wavenet.fused_wn_backward_plain(x.detach(), xs, pre, cot, *ws, lens, kernel_size=5,
                                          gyx=cot_x)
    for a, b in zip(got, ref):
        _scaled_close(a, b, 1e-4)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.detach().to(dtype).requires_grad_()
        runs = []
        for fn in (wavenet.fused_wn, wavenet.fused_wn_plain):
            out, g = _grads(lambda: fn(xd, *w, lens, kernel_size=5, group_size=group_size).float(),
                            xd, w, cot)
            runs.append((out.to(dtype), g))
        (out, g), (out_ref, g_ref) = runs
        if dtype == torch.float32:
            _scaled_close(out, out_ref, 2e-5)
            for a, b in zip(g, g_ref):
                _scaled_close(a, b, 1e-4)
        else:
            _bf16_close(out, out_ref)
            _bf16_close(g[0], g_ref[0])
    xg = x.detach().bfloat16()
    cot16, cot_x16 = cot.bfloat16(), cot_x.bfloat16()
    for ws, final in wavenet.groups(*[t.detach() for t in w], 5, group_size):
        runs = []
        for group in (wavenet._group_card, wavenet._group_plain):
            xi = xg.clone().requires_grad_()
            wi = [t.clone().requires_grad_() for t in ws]
            skip, x_out = group(xi, *wi, lens, 5, final)
            outs, cots = ([skip, x_out], [cot16, cot_x16]) if final else ([skip], [cot16])
            g = torch.autograd.grad(outs, [xi] + wi, cots, allow_unused=True)
            runs.append(([o.detach() for o in outs],
                         [torch.zeros_like(t) if d is None else d for t, d in zip([xi] + wi, g)]))
        (outs, g), (outs_ref, g_ref) = runs
        for a, b in zip(outs + g[:1], outs_ref + g_ref[:1]):
            _bf16_close(a, b)
        for a, b in zip(g[1:], g_ref[1:]):
            _scaled_close(a, b, 1e-4)
        if final:
            xg = outs[1]


# ---- separation (no kernel of the repository: cuFFT, cuDNN and cuBLAS) ----

SEP_LAYOUT = {  # tests/test_torch_separation.py's narrowed 2-band layout
    "bins": 64, "unstable_bins": 4, "reduction_bins": 60, "sr": 8000,
    "pre_filter_start": 60, "pre_filter_stop": 64,
    "band": {
        1: {"sr": 2000, "hl": 32, "n_fft": 64, "crop_start": 0, "crop_stop": 20,
            "lpf_start": 10, "lpf_stop": 20, "res_type": "polyphase"},
        2: {"sr": 8000, "hl": 128, "n_fft": 128, "crop_start": 4, "crop_stop": 48,
            "hpf_start": 10, "hpf_stop": 4, "res_type": "polyphase"},
    },
}


def _song(rng, seconds, sr):
    t = np.arange(int(seconds * sr)) / sr
    return np.stack([0.3 * np.sin(2 * np.pi * f * t) + 0.1 * rng.standard_normal(t.size)
                     for f in (220.0, 330.0)]).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n_fft,hop", [(320, 80), (960, 480), (6144, 1024)])
def test_stft_on_the_card_matches_the_cpu(rng, cuda, n_fft, hop):
    """stft (cuFFT) and istft on the card within 1e-5 of the CPU's."""
    from rvc_tpu_torch.ops import stft

    x = torch.from_numpy(0.3 * rng.standard_normal((2, 50000)).astype(np.float32))
    ref = stft.stft(x, n_fft, hop)
    got = stft.stft(x.to(cuda), n_fft, hop)
    for a, b in zip(got, ref):
        _scaled_close(a.cpu(), b, 1e-5)
    back = stft.istft(*got, n_fft, hop).cpu()
    _scaled_close(back, stft.istft(*ref, n_fft, hop), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("tta", [False, True])
def test_vr_separator_on_the_card_matches_the_cpu(rng, cuda, tta):
    """The narrowed VR route, 3 s at 8 kHz: int16 stems within 4 LSB."""
    import copy

    from rvc_tpu_torch.models.vr_network import CascadedASPPNet
    from rvc_tpu_torch.ops.bands import ModelParameters
    from rvc_tpu_torch.pipelines.separate import VRSeparator

    state = _chip_smoke().lively_state(CascadedASPPNet(128), seed=3)
    audio = _song(rng, 3.0, 8000)
    outs = []
    for dev in ("cpu", "cuda"):
        mp = ModelParameters()
        mp.param = {**copy.deepcopy(SEP_LAYOUT), "mid_side": False, "mid_side_b2": False,
                    "reverse": False}
        sep = VRSeparator(state, mp, window_size=384, tta=tta, device=dev)
        outs.append(sep.run_inference(audio, 8000))
    for stem in ("vocals", "instrumentals"):
        a, b = (o[stem][0].astype(np.int32) for o in outs)
        assert a.shape == b.shape and np.abs(a - b).max() <= 4


@pytest.mark.gpu
@pytest.mark.parametrize("denoise", [False, True])
def test_mdx_separator_on_the_card_matches_the_cpu(rng, cuda, denoise):
    """The tiny MDX net, 3 s at 44.1 kHz in 1 s segments: stems within 4 LSB."""
    from rvc_tpu_torch.models.mdx_net import ConvTDFNetTrim
    from rvc_tpu_torch.pipelines.separate import MDXSeparator

    cfg = dict(num_blocks=5, l=1, g=4, bn=2, dim_f=256, norm="GroupNorm2")
    state = _chip_smoke().lively_state(ConvTDFNetTrim(**cfg), seed=4)
    audio = _song(rng, 3.0, 44100)
    outs = [MDXSeparator(state, dim_f=256, dim_t=32, n_fft=512, hop=128, chunks=1,
                         margin=22050, denoise=denoise, net=ConvTDFNetTrim(**cfg),
                         device=dev).run_inference(audio, 44100) for dev in ("cpu", "cuda")]
    for stem in ("vocals", "instrumentals"):
        a, b = (o[stem][0].astype(np.int32) for o in outs)
        assert a.shape == b.shape and np.abs(a - b).max() <= 4


def _demucs_nets():
    """Tiny HTDemucs (cross transformer, bottom channels), HDemucs with the
    framed BLSTM (T 2048 at its first time layer) and LocalState, and
    Conv-TasNet, each with (input shape) and lively weights."""
    from rvc_tpu_torch.models.htdemucs import HDemucs, HTDemucs
    from rvc_tpu_torch.models.tasnet import ConvTasNet

    return {
        "htdemucs": (lambda: HTDemucs(sources=("a", "b"), channels=16, depth=2, nfft=512,
                                      norm_starts=1, t_layers=3, t_heads=2, bottom_channels=8,
                                      use_train_segment=False), (2, 2, 8192)),
        "hdemucs": (lambda: HDemucs(sources=("a", "b"), audio_channels=1, channels=16, depth=2,
                                    nfft=64, norm_starts=1, dconv_lstm=0, dconv_attn=1),
                    (1, 1, 8192)),
        "tasnet": (lambda: ConvTasNet(N=16, L=8, B=8, H=16, P=3, X=4, R=2), (2, 2, 8000)),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["htdemucs", "hdemucs", "tasnet"])
def test_demucs_nets_on_the_card_match_the_cpu(rng, cuda, name):
    """The same weights and mix through each net on the CPU and the card
    (cuDNN convs and LSTMs, cuBLAS attention, cuFFT, TF32 off): within
    1e-4 of the largest output."""
    make, shape = _demucs_nets()[name]
    state = _chip_smoke().lively_state(make(), seed=5)
    x = torch.from_numpy(0.3 * rng.standard_normal(shape).astype(np.float32))
    outs = []
    for dev in ("cpu", "cuda"):
        net = make()
        net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        with torch.no_grad():
            outs.append(net.to(dev).eval()(x.to(dev)).cpu())
    _scaled_close(outs[1], outs[0], 1e-4)


@pytest.mark.gpu
def test_wiener_on_the_card_matches_the_cpu(rng, cuda):
    """The EM filter in complex64 at 430 frames (two windows), 2 channels,
    4 sources: within 1e-5 of the largest magnitude."""
    from rvc_tpu_torch.ops.wiener import wiener

    mix = torch.from_numpy((rng.standard_normal((2, 430, 33, 2)) + 1j * rng.standard_normal(
        (2, 430, 33, 2))).astype(np.complex64) * 30)
    mag = torch.from_numpy(np.abs(rng.standard_normal((2, 430, 33, 2, 4)) * 20)
                           .astype(np.float32))
    ref = torch.view_as_real(wiener(mag, mix, 1))
    got = torch.view_as_real(wiener(mag.to(cuda), mix.to(cuda), 1)).cpu()
    _scaled_close(got, ref, 1e-5)


@pytest.mark.gpu
def test_tasnet_depthwise_forms_agree_on_the_card(rng, cuda):
    """The depthwise dilated conv as shifted multiply-adds and as cuDNN's
    grouped conv, at the full model's width (H 512) and dilations 1-512."""
    from rvc_tpu_torch.models.tasnet import depthwise, depthwise_conv1d

    y = torch.from_numpy(rng.standard_normal((2, 512, 5000)).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.standard_normal((512, 1, 3)) / 3 ** 0.5).astype(np.float32))
    for d in (1, 8, 64, 512):
        _scaled_close(depthwise(y, w.to(cuda), d).cpu(),
                      depthwise_conv1d(y, w.to(cuda), d).cpu(), 1e-6)


@pytest.mark.gpu
def test_istft_ignores_imaginary_dc_on_the_card(rng, cuda):
    """A network's complex output (HDemucs's CaC masks, MDX-Net's) has
    imaginary DC and Nyquist parts, which cuFFT's C2R transform would read
    and the CPU's ignores: istft zeroes them, card and CPU within 1e-5."""
    from rvc_tpu_torch.ops import stft

    re, im = (torch.from_numpy(rng.standard_normal((2, 60, 2049)).astype(np.float32))
              for _ in range(2))
    ref = stft.istft(re, im, 4096, 1024)
    _scaled_close(stft.istft(re.to(cuda), im.to(cuda), 4096, 1024).cpu(), ref, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bs", "mel"])
def test_roformer_separators_on_the_card_match_the_cpu(rng, cuda, kind):
    """A narrow RoFormer at the released layout (n_fft 2048, hop 441, 62 or 60
    bands; dim 32, 2 layers, 2 heads), 10 s of stereo in two 8 s windows:
    the memory-efficient attention, the mask sum by atomics (Mel) and the
    overlap-add on the card, int16 stems within 4 LSB of the CPU's."""
    from rvc_tpu_torch.models import bs_roformer, mel_roformer

    mod = bs_roformer if kind == "bs" else mel_roformer
    cfg = (mod.BSRoformerConfig if kind == "bs" else mod.MelRoformerConfig)(
        dim=32, depth=2, heads=2, dim_head=32)
    model_cls = mod.BSRoformer if kind == "bs" else mod.MelBandRoformer
    sep_cls = mod.BSRoformerSeparator if kind == "bs" else mod.MelRoformerSeparator
    with torch.device("meta"):
        state = _chip_smoke().roformer_weights(model_cls(cfg), seed=6)
    audio = _song(rng, 10.0, 44100)
    outs = [sep_cls(state, cfg, device=dev).run_inference(audio, 44100) for dev in ("cpu", "cuda")]
    assert list(outs[1]) == ["sr", "input_audio", "vocals", "instrumentals"]
    for stem in ("vocals", "instrumentals"):
        a, b = (o[stem][0].astype(np.int32) for o in outs)
        assert a.shape == b.shape == (2, 441000) and np.abs(a).max() > 1000
        assert np.abs(a - b).max() <= 4


@pytest.mark.gpu
@pytest.mark.parametrize("n_steps", [12.0, -5.0])
def test_pitch_shift_on_the_card_matches_the_cpu(rng, cuda, n_steps):
    """The phase vocoder on the card within 2e-3 relative L2 of the CPU's,
    the CPU tests' bar against JAX: its phase arithmetic is float64 on both
    (the card's running sum a parallel scan); the song has no silent frame,
    whose rounding-level phase would carry into every later frame."""
    from rvc_tpu_torch.ops.stretch import pitch_shift

    y = torch.from_numpy(_song(rng, 5.0, 44100))
    ref = pitch_shift(y, 44100, n_steps)
    got = pitch_shift(y.to(cuda), 44100, n_steps).cpu()
    assert got.shape == ref.shape == y.shape
    assert float((got - ref).norm() / ref.norm()) <= 2e-3


@pytest.mark.gpu
def test_musetalk_networks_on_the_card_match_the_cpu(rng, cuda):
    """The MuseTalk networks at tiny widths (S3FD, BiSeNet, FAN at full width
    on small inputs) on the card within 1e-4 relative L2 of the CPU on the
    same seeded weights, the class map and landmarks equal on 99.9%."""
    from rvc_tpu_torch.models.musetalk import face, unet, vae

    def rel(a, b):
        return float((a.cpu().double() - b.double()).norm() / b.double().norm())

    image = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32))
    cases = [
        (vae.AutoencoderKL(vae.VAEConfig(block_out_channels=(32, 64), norm_num_groups=8)),
         lambda m, d: m(image.to(d))),
        (unet.UNet2DCondition(unet.UNetConfig(
            block_out_channels=(32, 64), norm_num_groups=8, attention_head_dim=2,
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))),
         lambda m, d: m(torch.ones(2, 8, 16, 16, device=d), torch.zeros(2, device=d),
                        torch.full((2, 10, 384), 0.3, device=d))),
        (face.S3FD(), lambda m, d: torch.cat([o.flatten() for o in m(
            torch.full((1, 3, 128, 128), 40.0, device=d))])),
        (face.BiSeNet(), lambda m, d: m(torch.linspace(-2, 2, 2 * 3 * 64 * 64, device=d)
                                        .reshape(2, 3, 64, 64))),
        (face.FAN(1), lambda m, d: m(torch.linspace(0, 1, 2 * 3 * 64 * 64, device=d)
                                     .reshape(2, 3, 64, 64))),
    ]
    for i, (model, run) in enumerate(cases):
        model.load_state_dict(_chip_smoke().musetalk_state(model, 50 + i, "cpu"))
        model.eval()
        with torch.no_grad():
            ref = run(model, "cpu")
            got = run(model.to(cuda), cuda)
        assert rel(got, ref) <= 1e-4, type(model).__name__
        if isinstance(model, face.BiSeNet):
            assert float((got.argmax(1).cpu() == ref.argmax(1)).float().mean()) >= 0.999
        if isinstance(model, face.FAN):
            same = (face.heatmaps_to_landmarks(got).cpu() == face.heatmaps_to_landmarks(ref))
            assert float(same.all(-1).float().mean()) >= 0.999


@pytest.mark.gpu
def test_image_ops_on_the_card_match_the_cpu(rng, cuda):
    """ops/image.py's integer paths give the CPU's bytes on the card."""
    from rvc_tpu_torch.ops import image

    img = torch.from_numpy(rng.integers(0, 256, (301, 257, 3)).astype(np.uint8))
    for interp in (image.INTER_NEAREST, image.INTER_LINEAR, image.INTER_LANCZOS4):
        ref = image.resize(img, (256, 256), interp)
        got = image.resize(img.to(cuda), (256, 256), interp)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), ref)
    mask = (img[..., 0] > 128).to(torch.uint8) * 255
    assert torch.equal(image.gaussian_blur(mask.to(cuda), (31, 31)).cpu(),
                       image.gaussian_blur(mask, (31, 31)))


def _op_direct_cases(rng, cuda):
    """Each rvc op at a preset's shape beside a direct call of its kernel as
    the wrappers launched it before the ops (the same C entry, packing and
    arguments): 48k_v2's first decoder stage (C 256) in float32 and bf16, a
    ResBlock of it through kernel 4 and kernel 8, the text encoder's
    attention (2 heads of 96, window 10) in both dtypes, and the search of
    800 queries in 131072 x 768 banks."""
    from rvc_tpu_torch.ops import _cuda

    lib = _cuda.library()
    x = torch.from_numpy(rng.standard_normal((1, 1200, 256)).astype(np.float32)).to(cuda)
    chains = _bf16_chains(rng, cuda, 256, ((3, (1, 3, 5)), (7, (1, 3, 5)), (11, (1, 3, 5))))
    xb = x.bfloat16()

    def units(x, cs, entry, pack):
        return resblock._run_units(x, cs, entry, pack, types.SimpleNamespace(launches=0))

    def attend(q, k, v, ek, ev, lens, window, scale):
        B, H, T, D = q.shape
        out = torch.empty_like(q)
        lens = lens.to(torch.int32).contiguous()
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), ek.data_ptr(), ev.data_ptr(),
                lens.data_ptr(), out.data_ptr(), B, H, T, D, window)
        if q.dtype == torch.bfloat16:
            work = q.new_empty(lib.rvc_banded_attention_bf16_workspace(B, H, T, D),
                               dtype=torch.float32)
            err = lib.rvc_banded_attention_bf16(*args[:7], work.data_ptr(), *args[7:],
                                                float(torch.tensor(scale).bfloat16()),
                                                _cuda.stream_ptr(q))
        else:
            err = lib.rvc_banded_attention(*args, float(scale), _cuda.stream_ptr(q))
        _cuda.check(err, "attention")
        return out

    def search(feats, bank, scales):
        NQ, D = feats.shape
        N = bank.shape[0]
        out = torch.empty_like(feats)
        bsq = torch.empty(N, device=cuda)
        keys = torch.empty(NQ, device=cuda, dtype=torch.int64)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        n_split = max(1, min(-(-N // 128), -(-4 * sms // -(-NQ // 128))))
        err = lib.rvc_nearest_rows(feats.data_ptr(), bank.data_ptr(), int(scales is not None),
                                   None if scales is None else scales.data_ptr(),
                                   bsq.data_ptr(), keys.data_ptr(), out.data_ptr(), NQ, N, D,
                                   n_split, _cuda.stream_ptr(feats))
        _cuda.check(err, "nearest_rows")
        return out

    q, k, v, ek, ev, lens = (torch.from_numpy(a).to(cuda)
                             for a in _attention_inputs(rng, B=1, T=1000, D=96))
    lens = lens[:1]
    feats = torch.from_numpy(rng.standard_normal((800, 768)).astype(np.float32)).to(cuda)
    bank = rng.standard_normal((131072, 768)).astype(np.float32)
    bq, sc = (torch.from_numpy(a).to(cuda) for a in retrieval.quantize_bank(bank))
    bf = torch.from_numpy(bank).to(cuda)
    bf16 = [t.bfloat16() for t in (q, k, v, ek, ev)]
    return {
        "resblock_group": (torch.ops.rvc.resblock_group, (x, *resblock._flat(chains)),
                           lambda: units(x, chains, "rvc_resblock_unit",
                                         resblock.pack_tf32_weights)),
        "resblock_group[bf16]": (torch.ops.rvc.resblock_group, (xb, *resblock._flat(chains)),
                                 lambda: units(xb, chains, "rvc_resblock_unit_bf16",
                                               resblock.pack_bf16_weights)),
        "resblock1": (torch.ops.rvc.resblock1, (x, *resblock._flat(chains[1:2])[:4]),
                      lambda: resblock._resblock1_forward(x, chains[1])[0]),
        "resblock1_v2": (torch.ops.rvc.resblock1_v2, (xb, *resblock._flat(chains[2:])[:4]),
                         lambda: units(xb, chains[2:], "rvc_resblock_unit_bf16",
                                       resblock.pack_bf16_weights)),
        "banded_rel_attention": (torch.ops.rvc.banded_rel_attention,
                                 (q, k, v, ek, ev, lens, 10, 96 ** -0.5),
                                 lambda: attend(q, k, v, ek, ev, lens, 10, 96 ** -0.5)),
        "banded_rel_attention[bf16]": (torch.ops.rvc.banded_rel_attention,
                                       (*bf16, lens, 10, 96 ** -0.5),
                                       lambda: attend(*bf16, lens, 10, 96 ** -0.5)),
        "nearest_rows[int8]": (torch.ops.rvc.nearest_rows, (feats, bq, sc),
                               lambda: search(feats, bq, sc)),
        "nearest_rows": (torch.ops.rvc.nearest_rows, (feats, bf, None),
                         lambda: search(feats, bf, None)),
    }


@pytest.mark.gpu
def test_rvc_ops_on_the_card_are_the_kernels(rng, cuda):
    """Each rvc op's CUDA implementation gives the bits of a direct call of
    its kernel, counts one launch per kernel launch on its wrapper, and
    passes torch.library.opcheck on the card (its schema, its registrations,
    the fake implementation against the real one)."""
    counters = {"resblock_group": (resblock.fused_resblock_group, "launches", 9),
                "resblock_group[bf16]": (resblock.fused_resblock_group, "launches_bf16", 9),
                "resblock1": (resblock.fused_resblock1, "launches", 1),
                "resblock1_v2": (resblock.fused_resblock1_v2, "launches", 3),
                "banded_rel_attention": (attention.banded_rel_attention, "launches", 1),
                "banded_rel_attention[bf16]": (attention.banded_rel_attention, "launches_bf16",
                                               1),
                "nearest_rows[int8]": (retrieval.nearest_rows_q, "launches", 1),
                "nearest_rows": (retrieval.nearest_rows, "launches", 1)}
    for name, (op, args, direct) in _op_direct_cases(rng, cuda).items():
        fn, attr, n = counters[name]
        before = getattr(fn, attr)
        got = op(*args)
        torch.cuda.synchronize()
        assert getattr(fn, attr) == before + n, name
        assert torch.equal(got, direct()), name
        torch.library.opcheck(op, args)
