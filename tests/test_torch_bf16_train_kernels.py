"""The plain versions of the port's training kernels 4-7 in bfloat16, and
the grouped WN stack, against the JAX package's Pallas kernels, on the CPU.

Each wrapper runs its plain version here (the tensors lie on the CPU): the
chain in bf16 (``fused_resblock1_train``: the bf16 unit kernel's function
forward, the float32 backward at bf16(0.1) on x upcast, dx cast to bf16),
and the WN stack by groups (``fused_wn``: each group float32 on x upcast,
its skip and last x cast to x's dtype, the skips summed in x's dtype). Each
is held against the Pallas kernels run with interpret=True at the same
dtype, differentiated through their custom VJPs, on the same numpy inputs
and cotangent: ``rvc_tpu/ops/pallas_resblock.py::fused_resblock1_train``
(3 units, the Pallas chain's count) and ``pallas_wavenet.py::fused_wn``
with ``group_size`` below L (L = 5 in groups of 2: three groups).

Bars, fixed before the first run. Values and dx (bf16), as
tests/test_torch_bf16_kernels.py holds the bf16 kernels: within 1e-2 of the
largest magnitude, at most 1% of the elements more than one bf16 ulp apart
(both sides round at the same points; float32 sums in another order flip a
rounding now and then). The weight and bias gradients are float32 VJPs on
the same bf16-exact values: the chain's within 1e-4 of each tensor's
largest magnitude (float32 sums in another order, as the float32 test's
bar), the WN stack's within 2e-3 (a bf16 rounding of the x passed between
groups that flips by one ulp moves the later groups' inputs). Beside each
the JAX package's own bf16-to-float32 distance on the same inputs is
printed: the chain's backward differs from the float32 one by its slope
(bf16(0.1) for 0.1), which the chain's bar must see. The grouped stack in
float32 keeps the float32 test's bars (2e-5 on values, 1e-4 on gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes  # noqa: F401
from rvc_tpu.ops.pallas_resblock import fused_resblock1_train as jax_chain
from rvc_tpu.ops.pallas_wavenet import fused_wn as jax_wn
from rvc_tpu_torch.ops import resblock, wavenet
from test_torch_bf16_kernels import MAX_BEYOND, MAX_REL, agreement, to_bf16
from test_torch_gpu import _wn_inputs
from test_torch_train_kernels import GRAD_TOL, VALUE_TOL, _chain

CHAIN_GRAD_TOL = 1e-4  # float32 VJPs of the chain on the same bf16-exact values
WN_GRAD_TOL = 2e-3     # the WN stack's, after groups whose x may flip by one ulp


def _scaled_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / max(1e-6, float(np.max(np.abs(ref)))))


def _jax_chain_vjp(x, convs, cot, dtype):
    """The Pallas chain at ``dtype`` (weights float32, cast inside as the
    JAX package casts them): (y, dx, dWs, dbs) as float32 numpy."""
    ws = tuple(jnp.asarray(w) for w, _, _, _ in convs)
    bs = tuple(jnp.asarray(b) for _, b, _, _ in convs)

    def f(x_, ws_, bs_):
        cv = [(w, b, k, d) for w, b, (_, _, k, d) in zip(ws_, bs_, convs)]
        return jax_chain(x_, cv, S=1, interpret=True)

    y, vjp = jax.vjp(f, jnp.asarray(x, jnp.float32).astype(dtype), ws, bs)
    gx, gw, gb = vjp(jnp.asarray(cot, jnp.float32).astype(dtype))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return f32(y), f32(gx), [f32(g) for g in gw], [f32(g) for g in gb]


@pytest.mark.parametrize("C,T,k", [(16, 300, 3), (32, 77, 5)])
def test_resblock1_train_bf16_plain_matches_pallas(rng, C, T, k):
    """Kernels 4 and 5 in bf16: the chain's value and its VJP (dx, every
    dW and db) against the Pallas chain at bf16, T shorter than the Pallas
    tiles; the JAX package's own float32 VJP beside it."""
    convs = _chain(rng, C, k, (1, 3, 5))
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    cot = rng.standard_normal((2, T, C)).astype(np.float32)
    _, xt = to_bf16(x)
    _, ct = to_bf16(cot)
    ref_y, ref_dx, ref_dw, ref_db = _jax_chain_vjp(x, convs, cot, jnp.bfloat16)
    f32_y, f32_dx, f32_dw, f32_db = _jax_chain_vjp(xt.float().numpy(), convs,
                                                   ct.float().numpy(), jnp.float32)

    xg = xt.clone().requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w, _, _, _ in convs]
    bt = [torch.from_numpy(b).requires_grad_() for _, b, _, _ in convs]
    y = resblock.fused_resblock1_train(
        xg, [(w, b, kk, d) for w, b, (_, _, kk, d) in zip(wt, bt, convs)])
    assert y.dtype == torch.bfloat16
    (y.float() * ct.float()).sum().backward()
    assert xg.grad.dtype == torch.bfloat16 and all(w.grad.dtype == torch.float32 for w in wt)
    for what, got, ref in (("value", y, ref_y), ("dx", xg.grad, ref_dx)):
        rel, beyond = agreement(got.detach().float().numpy(), ref,
                                f"chain bf16 {what}, C={C}, T={T}")
        assert rel <= MAX_REL and beyond <= MAX_BEYOND, what
    errs = [_scaled_err(t.grad.numpy(), r) for t, r in zip(wt + bt, ref_dw + ref_db)]
    own = [_scaled_err(a, b) for a, b in zip(ref_dw + ref_db, f32_dw + f32_db)]
    print(f"chain bf16 dW, db: worst {max(errs):.3g} of the largest magnitude (bar "
          f"{CHAIN_GRAD_TOL}); JAX's own bf16-to-float32 distance: least {min(own):.3g}, "
          f"worst {max(own):.3g}")
    assert max(errs) <= CHAIN_GRAD_TOL
    assert max(own) > CHAIN_GRAD_TOL  # the bar sees the bf16 backward's slope


def test_chain_slope_argument(rng):
    """The slope argument: at 0.1 the float32 plain chain and its backward
    are the defaults' bits, and check_chain_grads at 0.1 is the default's
    verdict; at bf16(0.1) the grad check holds the bf16 route's backward
    to its own reference and refuses the 0.1 one."""
    convs = [(torch.from_numpy(w), torch.from_numpy(b), k, d)
             for w, b, k, d in _chain(rng, 16, 3, (1, 3, 5))]
    x = torch.from_numpy(rng.standard_normal((2, 90, 16)).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((2, 90, 16)).astype(np.float32))
    assert torch.equal(resblock.fused_resblock1_plain(x, convs),
                       resblock.fused_resblock1_plain(x, convs, slope=0.1))
    at_01 = resblock.fused_resblock1_backward(x, None, gy, convs)
    again = resblock.fused_resblock1_backward(x, None, gy, convs, slope=0.1)
    assert all(torch.equal(a, b) for a, b in zip(at_01, again))
    assert resblock.check_chain_grads(x, convs, at_01, again) == \
        resblock.check_chain_grads(x, convs, at_01, again, slope=0.1)
    at_bf16 = resblock.fused_resblock1_backward(x, None, gy, convs,
                                                slope=resblock.BF16_SLOPE)
    ok, _ = resblock.check_chain_grads(x, convs, at_bf16, at_bf16, slope=resblock.BF16_SLOPE)
    assert ok is None
    wrong, _ = resblock.check_chain_grads(x, convs, at_01, at_bf16, slope=resblock.BF16_SLOPE)
    assert wrong is not None and "beyond" in wrong


def _wn_case(rng, dtype):
    B, T, C, L, k = 2, 37, 16, 5, 5
    lens = np.asarray((37, 20), np.int32)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((B, T, C)).astype(np.float32) * mask
    cot = rng.standard_normal((B, T, C)).astype(np.float32)
    w = _wn_inputs(rng, B, T, C, L, k)
    if dtype == torch.bfloat16:  # the same bf16 values on both sides
        x, cot = (to_bf16(a)[1].float().numpy() for a in (x, cot))
    return x, cot, w, lens, k


def _jax_wn_vjp(x, cot, w, lens, k, dtype, group_size):
    names = list(w)

    def f(x_, *ws):
        return jax_wn(x_, *ws, jnp.asarray(lens), kernel_size=k, interpret=True,
                      group_size=group_size)

    y, vjp = jax.vjp(f, jnp.asarray(x).astype(dtype), *[jnp.asarray(w[n]) for n in names])
    grads = vjp(jnp.asarray(cot).astype(dtype))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return f32(y), [f32(g) for g in grads]


def _port_wn_vjp(x, cot, w, lens, k, dtype, group_size):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = [torch.from_numpy(a).requires_grad_() for a in w.values()]
    y = wavenet.fused_wn(xt, *wt, torch.from_numpy(lens), kernel_size=k,
                         group_size=group_size)
    assert y.dtype == dtype
    (y.float() * torch.from_numpy(cot)).sum().backward()
    assert xt.grad.dtype == dtype and all(t.grad.dtype == torch.float32 for t in wt)
    return y.detach().float().numpy(), [t.grad.float().numpy() for t in [xt] + wt]


def test_wn_grouped_bf16_plain_matches_pallas(rng):
    """Kernels 6 and 7 in bf16 in three groups (L = 5, group_size 2): the
    value and the VJP (dx, dWa, dWb, dBab, dG, dWres, dWskip, dBrs), lengths
    < T on one row, the input masked; the JAX package's own float32 run of
    the same groups beside it."""
    x, cot, w, lens, k = _wn_case(rng, torch.bfloat16)
    ref_y, ref_g = _jax_wn_vjp(x, cot, w, lens, k, jnp.bfloat16, 2)
    f32_y, f32_g = _jax_wn_vjp(x, cot, w, lens, k, jnp.float32, 2)
    y, g = _port_wn_vjp(x, cot, w, lens, k, torch.bfloat16, 2)
    for what, got, ref in (("value", y, ref_y), ("dx", g[0], ref_g[0])):
        rel, beyond = agreement(got, ref, f"WN bf16 {what}, 3 groups")
        assert rel <= MAX_REL and beyond <= MAX_BEYOND, what
    names = ["dWa", "dWb", "dBab", "dG", "dWres", "dWskip", "dBrs"]
    errs = {n: _scaled_err(a, b) for n, a, b in zip(names, g[1:], ref_g[1:])}
    own = {n: _scaled_err(a, b) for n, a, b in zip(names, ref_g[1:], f32_g[1:])}
    print(f"WN bf16 weight gradients: {errs} of their largest magnitudes (bar {WN_GRAD_TOL}); "
          f"JAX's own bf16-to-float32 distance {own}, value "
          f"{_scaled_err(ref_y, f32_y):.3g}")
    assert max(errs.values()) <= WN_GRAD_TOL, errs


def test_wn_grouped_float32_plain_matches_pallas(rng):
    """The same three groups in float32: the value within 2e-5 and every
    gradient within 1e-4 of its largest magnitude, as the ungrouped-size
    float32 test holds them; and the groups sum their skips in another order
    than one group of 5 layers, within float32 rounding."""
    x, cot, w, lens, k = _wn_case(rng, torch.float32)
    ref_y, ref_g = _jax_wn_vjp(x, cot, w, lens, k, jnp.float32, 2)
    y, g = _port_wn_vjp(x, cot, w, lens, k, torch.float32, 2)
    assert _scaled_err(y, ref_y) <= VALUE_TOL
    for got, ref in zip(g, ref_g):
        assert _scaled_err(got, ref) <= GRAD_TOL
    one, _ = _port_wn_vjp(x, cot, w, lens, k, torch.float32, 8)
    assert _scaled_err(one, y) <= VALUE_TOL


def test_bf16_train_wrappers_count_only_kernel_launches(rng):
    """On CPU tensors the bf16 training routes run their plain versions and
    count nothing."""
    counts = lambda: (resblock.fused_resblock1_train.launches_bf16,  # noqa: E731
                      resblock.fused_resblock1.launches,
                      resblock.fused_resblock1_backward.launches,
                      wavenet.fused_wn.launches, wavenet.fused_wn_backward.launches)
    before = counts()
    convs = [(torch.from_numpy(wt).requires_grad_(), torch.from_numpy(b), k, d)
             for wt, b, k, d in _chain(rng, 16, 3, (1, 3, 5))]
    x = torch.zeros(1, 20, 16, dtype=torch.bfloat16, requires_grad=True)
    resblock.fused_resblock1_train(x, convs).float().sum().backward()
    xw, _, w, lens, k = _wn_case(rng, torch.bfloat16)
    xw = torch.from_numpy(xw).bfloat16().requires_grad_()
    wavenet.fused_wn(xw, *[torch.from_numpy(a) for a in w.values()], torch.from_numpy(lens),
                     kernel_size=k, group_size=2).float().sum().backward()
    assert counts() == before
