"""The port's multi-tensor AdamW against the JAX package's GroupedAdamW and
against the port's per-tensor AdamW, and the import of the reference's
torch Adam state against ``torch_adam_to_optax``, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import no_compile_cache_writes  # noqa: F401
from rvc_tpu.compat.optimizer_import import torch_adam_to_optax
from rvc_tpu.train.step import GroupedAdamW
from rvc_tpu_torch.compat.optimizer_import import torch_adam_to_adamw
from rvc_tpu_torch.train.step import AdamW, MultiTensorAdamW, lr_schedule

THRESHOLD = 64
# leaves below and above GroupedAdamW's small_threshold (64 here), in the
# order jax.tree_util flattens the dict (sorted keys)
SHAPES = {"a": (5, 3), "b": (16, 8), "c": (7,), "d": (3, 50), "e": (2, 2, 4), "f": (64,)}
ATOL, RTOL = 1e-7, 1e-6  # test_adamw_matches_optax's bar
STEPS = 3


def _problem(rng):
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def _port_run(cls, params, grads, sched):
    tp = [torch.tensor(params[k]) for k in SHAPES]
    opt = cls(tp, sched, (0.8, 0.99), 1e-9)
    out = []
    for g in grads:
        norm = opt.step([torch.tensor(g[k]) for k in SHAPES])
        out.append(([p.clone() for p in tp], [m.clone() for m in opt.m],
                    [v.clone() for v in opt.v], float(norm)))
    return out, opt


def _grouped_moments(state, which):
    """GroupedAdamW's state -> one array per leaf, in leaf order."""
    small = [k for k in SHAPES if np.prod(SHAPES[k]) < THRESHOLD]
    flat = np.asarray(state[f"{which}_flat"])
    big = iter(np.asarray(a) for a in state[f"{which}_big"])
    out, off = {}, 0
    for k in small:
        n = int(np.prod(SHAPES[k]))
        out[k] = flat[off:off + n].reshape(SHAPES[k])
        off += n
    return [out[k] if k in out else next(big) for k in SHAPES]


def test_multi_tensor_adamw_matches_grouped_adamw(rng):
    """3 updates, the schedule crossing an epoch between them (2 steps an
    epoch): parameters, both moments and the gradient norm against
    ``GroupedAdamW.apply_with_norm`` with leaves on both sides of its
    small_threshold."""
    params, grads = _problem(rng)
    sched = lr_schedule(1e-2, 0.5, 2)
    tx = GroupedAdamW(sched, (0.8, 0.99), 1e-9, small_threshold=THRESHOLD)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    assert js["m_flat"].size and len(js["m_big"]) == 3  # both halves are exercised
    got, opt = _port_run(MultiTensorAdamW, params, grads, sched)
    for g, (tp, tm, tv, tnorm) in zip(grads, got):
        jp, js, jnorm = tx.apply_with_norm({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        for k, a in zip(SHAPES, tp):
            np.testing.assert_allclose(a.numpy(), np.asarray(jp[k]), atol=ATOL, rtol=RTOL)
        for which, mine in (("m", tm), ("v", tv)):
            for a, b in zip(mine, _grouped_moments(js, which)):
                np.testing.assert_allclose(a.numpy(), b, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tnorm, float(jnorm), atol=ATOL, rtol=RTOL)
    assert opt.count == int(js["count"]) == STEPS


def test_multi_tensor_adamw_matches_per_tensor(rng):
    """The multi-tensor update against the per-tensor loop (its plain
    version) over the same 3 updates, at the same bar."""
    params, grads = _problem(rng)
    sched = lr_schedule(1e-2, 0.5, 2)
    multi, _ = _port_run(MultiTensorAdamW, params, grads, sched)
    plain, _ = _port_run(AdamW, params, grads, sched)
    for a, b in zip(multi, plain):
        for xs, ys in zip(a[:3], b[:3]):
            for x, y in zip(xs, ys):
                np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(a[3], b[3], atol=ATOL, rtol=RTOL)


class _Net(torch.nn.Module):
    """Parameters named as a reference model's: ``a.weight``, ``a.bias``,
    ``b.0.weight``, ``b.0.bias`` (flax paths ``a``, ``b_0``)."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(3, 4)
        self.b = torch.nn.ModuleList([torch.nn.Linear(4, 2)])


@pytest.mark.parametrize("mismatch", [False, True])
def test_torch_adam_import_matches_jax(rng, mismatch):
    """A reference training checkpoint's torch Adam state (ids in
    param_groups, per id step / exp_avg / exp_avg_sq) into the port's AdamW
    and into optax.adamw's state: the same moments per parameter and the
    same count and iteration. With ``mismatch`` one moment has another
    shape, and that parameter keeps its zero moments on both sides."""
    net = _Net()
    model_sd = {k: v.detach().clone() for k, v in net.state_dict().items()}
    state = {}
    for pid, (k, v) in enumerate(model_sd.items()):
        shape = (5, 5) if mismatch and k == "b.0.weight" else v.shape
        state[pid] = {"step": torch.tensor(float(7 + pid)),
                      "exp_avg": torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
                      "exp_avg_sq": torch.from_numpy(
                          rng.uniform(0, 1, shape).astype(np.float32))}
    ckpt = {"model": model_sd, "iteration": 42,
            "optimizer": {"state": state, "param_groups": [{"params": list(state)}]}}

    params = {"a": {"weight": model_sd["a.weight"].numpy(), "bias": model_sd["a.bias"].numpy()},
              "b_0": {"weight": model_sd["b.0.weight"].numpy(),
                      "bias": model_sd["b.0.bias"].numpy()}}
    tx = optax.adamw(1e-4, b1=0.8, b2=0.99, eps=1e-9, weight_decay=0.01)
    jstate, jiter = torch_adam_to_optax(ckpt, {"params": params},
                                        tx.init(jax.tree.map(jnp.asarray, params)))
    adam = jstate[0]
    opt = MultiTensorAdamW(net.parameters(), lambda s: 1e-4)
    titer = torch_adam_to_adamw(ckpt, net, opt)
    assert titer == jiter == 42 and opt.count == int(adam.count) == 10
    for (name, _), m, v in zip(net.named_parameters(), opt.m, opt.v):
        mod, leaf = name.rsplit(".", 1)
        key = mod.replace(".", "_")
        np.testing.assert_array_equal(m.numpy(), np.asarray(adam.mu[key][leaf]), err_msg=name)
        np.testing.assert_array_equal(v.numpy(), np.asarray(adam.nu[key][leaf]), err_msg=name)
        if mismatch and name == "b.0.weight":
            assert not m.any() and not v.any()
        else:
            assert m.abs().sum() > 0
