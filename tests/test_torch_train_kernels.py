"""The plain versions of the port's training kernels (4-7) against the JAX
package's Pallas kernels, values and every gradient.

On the CPU each wrapper runs its plain PyTorch version under autograd; it is
held against the Pallas kernel run with interpret=True, differentiated
through its custom VJP, on the same numpy inputs and cotangent, float32.
The CUDA kernels are held against these plain versions on the card in
test_torch_gpu.py. Tolerances: 2e-5 on values, 1e-4 of the largest
magnitude on gradients (float32 sums over every row in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes  # noqa: F401
from rvc_tpu.ops.pallas_resblock import fused_resblock1_train as jax_chain
from rvc_tpu.ops.pallas_wavenet import fused_wn as jax_wn
from rvc_tpu_torch.ops import resblock, wavenet
from test_torch_gpu import _wn_inputs

VALUE_TOL = 2e-5
GRAD_TOL = 1e-4


def _close_scaled(got, ref, tol=GRAD_TOL, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = max(1e-6, float(np.max(np.abs(ref))))
    np.testing.assert_allclose(got / scale, ref / scale, atol=tol, rtol=0, err_msg=what)


def _chain(rng, C, k, dils):
    convs = []
    for d in dils:
        for dd in (d, 1):
            w = (rng.standard_normal((C, C, k)) / np.sqrt(C * k)).astype(np.float32)
            b = (0.1 * rng.standard_normal(C)).astype(np.float32)
            convs.append((w, b, k, dd))
    return convs


@pytest.mark.parametrize("C,T,k", [(16, 300, 3), (32, 1101, 5), (16, 77, 5)])
def test_resblock1_train_plain_matches_pallas(rng, C, T, k):
    """Kernel 4 (the chain) and kernel 5 (its VJP): T=300 and T=77 are
    shorter than the Pallas tiles, T=1101 spans two backward tiles and is
    not a multiple of 8."""
    convs = _chain(rng, C, k, (1, 3, 5))
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    cot = rng.standard_normal((2, T, C)).astype(np.float32)
    ws = tuple(jnp.asarray(w) for w, _, _, _ in convs)
    bs = tuple(jnp.asarray(b) for _, b, _, _ in convs)

    def loss(x_, ws_, bs_):
        cv = [(w, b, kk, d) for w, b, (_, _, kk, d) in zip(ws_, bs_, convs)]
        y = jax_chain(x_, cv, S=1, interpret=True)
        return jnp.sum(y * cot), y

    (_, ref), (gx, gw, gb) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), ws, bs)

    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w, _, _, _ in convs]
    bt = [torch.from_numpy(b).requires_grad_() for _, b, _, _ in convs]
    y = resblock.fused_resblock1_train(
        xt, [(w, b, kk, d) for w, b, (_, _, kk, d) in zip(wt, bt, convs)])
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=VALUE_TOL, rtol=0)
    _close_scaled(xt.grad.numpy(), gx, what="dx")
    for i in range(len(convs)):
        _close_scaled(wt[i].grad.numpy(), gw[i], what=f"dW {i}")
        _close_scaled(bt[i].grad.numpy(), gb[i], what=f"db {i}")


@pytest.mark.parametrize("C,T,lengths", [(16, 50, (50, 33)), (32, 37, (20, 37))])
def test_wn_plain_matches_pallas(rng, C, T, lengths):
    """Kernel 6 (the stack) and kernel 7 (its VJP: dx, dWa, dWb, dBab, dG,
    dWres, dWskip, dBrs): L = 9, so that the JAX wrapper chains two groups
    of at most 8 layers; lengths < T on one row, the input masked."""
    B, L, k = len(lengths), 9, 5
    lens = np.asarray(lengths, np.int32)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((B, T, C)).astype(np.float32) * mask
    cot = rng.standard_normal((B, T, C)).astype(np.float32)
    w = _wn_inputs(rng, B, T, C, L, k)
    names = list(w)

    def loss(x_, *ws):
        y = jax_wn(x_, *ws, jnp.asarray(lens), kernel_size=k, interpret=True)
        return jnp.sum(y * cot), y

    (_, ref), grads = jax.value_and_grad(loss, argnums=tuple(range(8)), has_aux=True)(
        jnp.asarray(x), *[jnp.asarray(w[n]) for n in names])

    xt = torch.from_numpy(x).requires_grad_()
    wt = {n: torch.from_numpy(w[n]).requires_grad_() for n in names}
    y = wavenet.fused_wn(xt, *[wt[n] for n in names], torch.from_numpy(lens), kernel_size=k)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=VALUE_TOL, rtol=0)
    for b, n in enumerate(lens):  # rows at and past the length are zero
        assert not np.any(y.detach().numpy()[b, n:])
    _close_scaled(xt.grad.numpy(), grads[0], what="dx")
    for n, g in zip(names, grads[1:]):
        _close_scaled(wt[n].grad.numpy(), g, what=n)


def test_backward_wrappers_run_their_plain_versions_on_the_cpu(rng):
    """On CPU tensors kernels 5 and 7 run their plain versions, autograd of
    the plain forward: the gradients of the differentiable wrappers."""
    convs = [(torch.from_numpy(w), torch.from_numpy(b), k, d)
             for w, b, k, d in _chain(rng, 16, 3, (1, 3))]
    x = torch.from_numpy(rng.standard_normal((2, 40, 16)).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((2, 40, 16)).astype(np.float32))
    dx, dw, db = resblock.fused_resblock1_backward(x, None, gy, convs)
    leaves = [x.clone().requires_grad_()] + [t.clone().requires_grad_()
                                             for w, b, _, _ in convs for t in (w, b)]
    y = resblock.fused_resblock1_train(leaves[0], [(w, b, k, d) for w, b, (_, _, k, d) in
                                                   zip(leaves[1::2], leaves[2::2], convs)])
    ref = torch.autograd.grad(y, leaves, gy)
    torch.testing.assert_close(dx, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(dw, torch.stack(ref[1::2]), rtol=0, atol=0)
    torch.testing.assert_close(db, torch.stack(ref[2::2]), rtol=0, atol=0)
    w = {n: torch.from_numpy(a) for n, a in _wn_inputs(rng, 2, 40, 16, 3, 5).items()}
    lens = torch.tensor([40, 25])
    got = wavenet.fused_wn_backward(x, None, None, gy, *w.values(), lens, kernel_size=5)
    leaves = [t.clone().requires_grad_() for t in (x, *w.values())]
    ref = torch.autograd.grad(wavenet.fused_wn(*leaves, lens, kernel_size=5), leaves, gy)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _chain_near_zero(rng, C, T, B, n_sites):
    """A chain, x, a cotangent, and the (sample, row) of one element in each
    of the first n_sites channels where conv 0's output is moved within
    float32 rounding of 0 (its bias set to minus the rest of the sum), so
    that the float32 and float64 chains take different slopes at some."""
    convs = [(torch.from_numpy(w), torch.from_numpy(b), k, d)
             for w, b, k, d in _chain(rng, C, 3, (1, 3, 5))]
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32))
    w, b, k, d = convs[0]
    t64 = torch.nn.functional.conv1d(torch.nn.functional.leaky_relu(x.double().transpose(1, 2),
                                                                    0.1),
                                     w.double(), None, padding=(k - 1) * d // 2, dilation=d)
    b = b.clone()
    sites = [(int(rng.integers(B)), int(rng.integers(T))) for _ in range(n_sites)]
    for c, (i, t) in enumerate(sites):
        b[c] = -t64[i, c, t].item()
    convs[0] = (w, b, k, d)
    return convs, x, gy, sites


@pytest.mark.parametrize("where", ["none", "dx_row", "dw", "dx_row_near", "dw_conv0_tap", "db",
                                   "dx_row_c256"])
def test_chain_grad_check(rng, where):
    """Kernel 5's check (resblock.check_chain_grads), on the plain
    gradients. The float64 gradients cast to float32 pass against them:
    they take other slopes at some pre-activations within rounding of 0
    (so they differ beyond 1e-4 of the largest magnitude), which the check
    fits. Any one wrong row of dx (also at C = 256, and a row at such a
    pre-activation), one wrong element of the last conv's dW or of conv 0's
    db, or one zeroed tap of conv 0's dW fails."""
    C, T, B = (256, 64, 1) if where == "dx_row_c256" else (16, 400, 2)
    convs, x, gy, sites = _chain_near_zero(rng, C, T, B, n_sites=8)
    ref = resblock.fused_resblock1_backward_plain(x, None, gy, convs)
    g64 = resblock.fused_resblock1_backward_plain(
        x.double(), None, gy.double(), [(w.double(), b.double(), k, d) for w, b, k, d in convs])
    msg, counts = resblock.check_chain_grads(x, convs, [g.float() for g in g64], ref)
    assert msg is None and counts["explained"] > 0, (msg, counts)
    got = [g.clone() for g in ref]
    if where.startswith("dx_row"):
        sample, row = sites[0] if where == "dx_row_near" else (B - 1, T // 2)
        got[0][sample, row] *= -1.0
    elif where == "dw":
        got[1][-1, 3, 5, 1] += 1e-2 * got[1][-1].abs().max()
    elif where == "dw_conv0_tap":
        got[1][0, :, :, 0] = 0.0
    elif where == "db":
        got[2][0, 3] += 1e-3 * got[2][0].abs().max()
    msg, counts = resblock.check_chain_grads(x, convs, got, ref)
    if where == "none":
        assert msg is None
    elif where.startswith("dx_row"):
        assert msg is not None and f"row {row})" in msg, msg
    elif where == "dw":
        assert msg is not None and "dW of conv 5" in msg, msg
    elif where == "dw_conv0_tap":
        assert msg is not None and "dW of conv 0" in msg, msg
    else:
        assert msg is not None and "db of conv 0" in msg, msg
