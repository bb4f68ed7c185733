"""The port's monotonic alignment search and VITS flows (Log,
ElementwiseAffine, DDSConv, the rational-quadratic spline and ConvFlow)
against the JAX package's, on the same numpy inputs and weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_tpu.models import flows as jflows
from rvc_tpu.ops.monotonic_align import maximum_path as jax_maximum_path
from rvc_tpu_torch.compat.weights import flatten_tree, flax_path_to_torch_key
from rvc_tpu_torch.models import flows
from rvc_tpu_torch.ops.monotonic_align import maximum_path
from _torch_port import finit, no_compile_cache_writes, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
TOL = 1e-5


def ragged(rng, B, T_y, T_x):
    """Scores and a mask whose valid rectangles differ by item (t_y >= t_x)."""
    neg = rng.standard_normal((B, T_y, T_x)).astype(np.float32)
    t_x = rng.integers(1, T_x + 1, B)
    t_y = np.maximum(t_x, rng.integers(1, T_y + 1, B))
    mask = ((np.arange(T_y)[None, :, None] < t_y[:, None, None])
            & (np.arange(T_x)[None, None, :] < t_x[:, None, None])).astype(np.float32)
    return neg, mask


@pytest.mark.parametrize("B,T_y,T_x,seed", [(4, 23, 9, 0), (2, 9, 9, 2)])
def test_maximum_path_equals_jax(B, T_y, T_x, seed):
    neg, mask = ragged(np.random.default_rng(seed), B, T_y, T_x)
    want = np.asarray(jax_maximum_path(jnp.asarray(neg), jnp.asarray(mask)))
    got = maximum_path(torch.from_numpy(neg), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    # each valid frame takes exactly one token, and the path never moves back
    assert np.array_equal(got.sum(2), mask[:, :, 0])
    idx = got.argmax(2)
    for b in range(B):
        ty = int(mask[b, :, 0].sum())
        assert np.all(np.diff(idx[b, :ty]) >= 0)


def port_state(params) -> dict:
    """A JAX flow tree -> the port's names (``norms_1_0`` -> ``norms_1.0``),
    ElementwiseAffine's vectors as the reference's (C, 1)."""
    out = {}
    for path, arr in flatten_tree(params["params"]).items():
        arr = np.asarray(arr, np.float32)
        out[flax_path_to_torch_key(path)] = arr[:, None] if path[-1] in ("m", "logs") else arr
    return out


def loaded(module, params):
    module.load_state_dict({k: torch.tensor(v) for k, v in port_state(params).items()},
                           strict=True)
    return module.eval()


def channels_last(t) -> np.ndarray:
    return np.asarray(t).transpose(0, 2, 1)


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= tol, err


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    B, T, C = 2, 23, 4
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = (np.arange(T)[None, :, None] < np.array([T, 15])[:, None, None]).astype(np.float32)
    return x, mask


def test_log_flow(batch):
    x, mask = batch
    pos = np.abs(x) + 0.1
    y, ld = jflows.Log().apply({}, jnp.asarray(pos), jnp.asarray(mask))
    got, gld = flows.Log()(torch.from_numpy(channels_last(pos)), torch.from_numpy(channels_last(mask)))
    close(channels_last(got), y)
    close(gld, ld)
    back, none = flows.Log()(got, torch.from_numpy(channels_last(mask)), reverse=True)
    jback, _ = jflows.Log().apply({}, y, jnp.asarray(mask), reverse=True)
    close(channels_last(back), jback)
    assert none is None


def test_elementwise_affine(batch):
    x, mask = batch
    jm = jflows.ElementwiseAffine(4)
    params = finit(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), seed=4,
                   scale=0.5)
    pm = loaded(flows.ElementwiseAffine(4), params)
    xt, mt = torch.from_numpy(channels_last(x)), torch.from_numpy(channels_last(mask))
    y, ld = jm.apply(params, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got, gld = pm(xt, mt)
        back, _ = pm(got, mt, reverse=True)
    close(channels_last(got), y)
    close(gld, ld)
    jback, _ = jm.apply(params, y, jnp.asarray(mask), reverse=True)
    close(channels_last(back), jback)
    close(back.numpy(), xt.numpy() * mt.numpy())


def test_ddsconv(batch):
    x, mask = batch
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 23, 8)).astype(np.float32)
    g = rng.standard_normal((2, 23, 8)).astype(np.float32)
    jm = jflows.DDSConv(8, 3, 3)
    params = finit(jm.init, jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(mask), seed=6,
                   scale=0.3)
    pm = loaded(flows.DDSConv(8, 3, 3), params)
    want = jm.apply(params, jnp.asarray(h), jnp.asarray(mask), g=jnp.asarray(g))
    with torch.no_grad():
        got = pm(torch.from_numpy(channels_last(h)), torch.from_numpy(channels_last(mask)),
                 g=torch.from_numpy(channels_last(g)))
    close(channels_last(got), want)


def test_rational_quadratic_spline_and_its_inverse():
    """Forward and inverse against JAX's; the inverse round-trips and the
    log-determinants cancel, as tests/test_models.py checks JAX's; outside
    the tails the map is the identity."""
    rng = np.random.default_rng(7)
    shape = (2, 7, 3)
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    uw, uh = (rng.standard_normal((*shape, 10)).astype(np.float32) for _ in range(2))
    ud = rng.standard_normal((*shape, 9)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, uw, uh, ud)]
    y, ld = flows.rational_quadratic_spline(*t)
    jy, jld = jflows.rational_quadratic_spline(*(jnp.asarray(a) for a in (x, uw, uh, ud)))
    close(y, jy)
    close(ld, jld)
    x_rec, ld_inv = flows.rational_quadratic_spline(y, *t[1:], inverse=True)
    jx, jld_inv = jflows.rational_quadratic_spline(jy, *(jnp.asarray(a) for a in (uw, uh, ud)),
                                                   inverse=True)
    close(x_rec, jx)
    close(ld_inv, jld_inv)
    np.testing.assert_allclose(x_rec.numpy(), x, atol=1e-4)
    np.testing.assert_allclose((ld + ld_inv).numpy(), 0.0, atol=1e-3)
    far = torch.full(shape, 7.0)
    y_far, ld_far = flows.rational_quadratic_spline(far, *t[1:])
    np.testing.assert_allclose(y_far.numpy(), 7.0, atol=1e-6)
    np.testing.assert_allclose(ld_far.numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True])
def test_conv_flow(batch, reverse):
    x, mask = batch
    g = np.random.default_rng(8).standard_normal((2, 23, 16)).astype(np.float32)
    jm = jflows.ConvFlow(4, 16, 3, 2)
    params = finit(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask), seed=9,
                   scale=0.3)
    pm = loaded(flows.ConvFlow(4, 16, 3, 2), params)
    y, ld = jm.apply(params, jnp.asarray(x), jnp.asarray(mask), g=jnp.asarray(g), reverse=reverse)
    with torch.no_grad():
        got, gld = pm(torch.from_numpy(channels_last(x)), torch.from_numpy(channels_last(mask)),
                      g=torch.from_numpy(channels_last(g)), reverse=reverse)
    close(channels_last(got), y)
    if reverse:
        assert gld is None and ld is None
    else:
        close(gld, ld)
        with torch.no_grad():
            back, _ = pm(got, torch.from_numpy(channels_last(mask)),
                         g=torch.from_numpy(channels_last(g)), reverse=True)
        np.testing.assert_allclose(back.numpy(), channels_last(x * mask), atol=1e-4)
