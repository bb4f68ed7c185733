"""The port's bfloat16 training step with every loss on, against the JAX
package's.

``rvc_tpu_torch.train.step.Trainer(dtype=torch.bfloat16)`` on the CPU with
``c_gp = c_hd = c_tsi = c_tefs = 1`` and ``use_multiscale()``, against the
JAX ``Trainer(cfg, dtype=jnp.bfloat16, fuse_resblocks=True)`` (its Pallas
kernels in interpret mode) with the same losses, at tests/
test_torch_bf16_train_step.py's configuration (``tiny_config()`` with one
ResBlock1 of dilations (1, 3, 5) a stage, feature_dim 16), from the same
weights, batch and the JAX run's recorded draws (five a step), for one step;
the JAX float32 step on the same weights and draws gives the JAX package's
own bf16-to-float32 distance. JAX's TSI pool runs through ``frame_signal``'s
gather, as in tests/test_torch_train_losses.py (its conv lowering makes
every TSI gradient NaN).

The bars are that file's, fixed before its first run (``_within``): each
loss within 1e-3 of max(1, |loss|) of the JAX bf16 loss or twice JAX's own
bf16-to-float32 distance; each gradient norm within twice JAX's own
relative distance and at least 1e-3; parameters within 4.05 lr, and at
most half as many elements more than 0.01 lr from the JAX bf16 run's as
the JAX float32 run has. The port's float32 step on the same weights and
draws must fall outside them (the bars separate the dtypes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes, np_tree, recorded_draws, one_thread  # noqa: F401
from rvc_tpu.parallel.dryrun import make_tiny_batch
from rvc_tpu.train import losses as jlosses
from rvc_tpu.train.step import Trainer as JaxTrainer
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.pipelines import convert as tconvert
from rvc_tpu_torch.train.step import Trainer
from test_torch_aux_losses import _max_pool_gather
from test_torch_bf16_train_step import _config, _copy, _port_state, _within
from test_torch_train_losses import all_losses_config, port_draws
from test_torch_train_step import _jax_state, _port_config

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def runs():
    """One step each of the JAX bf16 and float32 trainers and of the port's
    bf16 and float32 trainers with every loss on, from the same weights,
    batch and draws: {name: [(metrics, parameters)]}, and the port's bf16
    penalty (the balancer's history)."""
    cfg = all_losses_config(_config())
    batch = {k: np.asarray(v) for k, v in make_tiny_batch(2).items()}
    out, init, draws = {}, None, None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlosses, "_max_pool_lastdim", _max_pool_gather)
        kwargs_of = tconvert.synth_kwargs_from_config
        mp.setattr(tconvert, "synth_kwargs_from_config",
                   lambda c: {**kwargs_of(c), "feature_dim": 16})
        for name, dtype, fuse in (("jax_bf16", jnp.bfloat16, True),
                                  ("jax_f32", jnp.float32, False)):
            jt = JaxTrainer(cfg, dtype=dtype, fuse_resblocks=fuse)
            object.__setattr__(jt.synth, "feature_dim", 16)
            jt.use_multiscale()
            state = jt.init_state(jax.random.PRNGKey(0), batch, steps_per_epoch=100,
                                  fast_params=True)
            if init is None:
                init = (weights.synthesizer_state_dict(np_tree(state.params_g), fold=False),
                        weights.discriminator_state_dict(np_tree(state.params_d)))
                init = tuple(_copy(sd) for sd in init)
            with recorded_draws(mp) as recorded:
                state, m = jt.step_fn()(state, batch, jax.random.PRNGKey(10))
                out[name] = [({k: float(v) for k, v in m.items() if k != "viz"},
                              _copy(_jax_state(state)))]
            assert len(recorded) == 5  # posterior, slice, sine phase, noise, alpha
            if draws is None:
                draws = [np.array(d) for d in recorded]
            else:  # both dtypes draw the same float32 numbers from the same keys
                assert all(np.array_equal(a, b) for a, b in zip(draws, recorded))
        for name, dtype in (("port_bf16", torch.bfloat16), ("port_f32", torch.float32)):
            tt = Trainer(_port_config(cfg), dtype=dtype, device="cpu")
            tt.use_multiscale()
            ts = tt.init_state(state_g=init[0], state_d=init[1], steps_per_epoch=100)
            ts, m = tt.step(ts, batch, draws=port_draws(draws))
            m.pop("viz")
            out[name] = [({k: float(v) for k, v in m.items()}, _port_state(tt))]
            out[f"{name}_penalty"] = float(ts.balancer_d.hist_losses[1])
    return out


def test_trainer_bf16_all_losses_step_matches_jax(runs):
    """The port's bf16 step against the JAX bf16 step: every loss, both
    gradient norms and every parameter within the bars; the aux losses and
    the penalty nonzero and finite."""
    assert _within(runs, "port_bf16", 0) == []
    metrics = runs["port_bf16"][0][0]
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert all(metrics[k] != 0 for k in ("harmonic_loss", "tsi_loss", "tefs_loss")), metrics
    assert np.isfinite(runs["port_bf16_penalty"]) and runs["port_bf16_penalty"] > 0


def test_bf16_all_losses_bar_separates_float32(runs):
    """The port's float32 step, on the same weights and draws, falls outside
    the bf16 bars."""
    faults = _within(runs, "port_f32", 0)
    assert faults, faults
