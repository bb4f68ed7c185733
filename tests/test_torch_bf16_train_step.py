"""The port's GAN training step in bfloat16 against the JAX package's.

``rvc_tpu_torch.train.step.Trainer(dtype=torch.bfloat16)`` on the CPU
against the JAX ``Trainer(cfg, dtype=jnp.bfloat16, fuse_resblocks=True)``,
the route the JAX package takes on its accelerator (the fused ResBlock1
chains and WN groups; its Pallas kernels run in interpret mode here), at
``tiny_config()`` with one ResBlock1 of dilations (1, 3, 5) a stage (the
Pallas chain kernel takes exactly three units) and feature_dim 16, from the
same weights, batch and the JAX run's recorded draws, over 2 steps, as
tests/test_torch_train_step.py holds the float32 step. A JAX float32 step
on the same weights and draws gives the JAX package's own bf16-to-float32
distance, and the port's float32 step is run beside it.

Bars, fixed before the first run of this file, per step. The JAX step is
jitted, and under jit XLA keeps excess precision in fused element-wise
chains where the port rounds each op, so the two bf16 runs round apart in
places and a GAN's gradients spread that.
- Each loss within 1e-3 of max(1, |loss|) of the JAX bf16 loss (the card
  vs CPU bar of the float32 step in chip_smoke phase 8), or within twice
  the JAX package's own bf16-to-float32 distance where that is larger: if
  the port's bf16 error is at most JAX's, the triangle inequality bounds
  their distance by twice it.
- Each gradient norm within twice JAX's own bf16-to-float32 relative
  distance, and at least 1e-3 relative.
- Parameters: Adam moves a parameter by at most about 1.006 lr a step
  (betas 0.8, 0.99), so two runs are at most 4.05 lr apart after two
  steps; and at most half as many elements more than 0.01 lr from the JAX
  bf16 run's as the JAX float32 run has: the port's bf16 run must follow
  JAX's bf16 run closer than float32 does. That is the bar that separates:
  the port's float32 step must fall outside it (asserted).
The three runs' distances are printed. ``Trainer.eval_loss`` in bf16 is the
bf16 step's forward: on the step's draws it gives its loss_mel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes, np_tree, recorded_draws, one_thread  # noqa: F401
from rvc_tpu.parallel.dryrun import make_tiny_batch, tiny_config
from rvc_tpu.train.step import Trainer as JaxTrainer
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.pipelines import convert as tconvert
from rvc_tpu_torch.train.step import Trainer
from test_torch_train_step import _jax_state, _port_config, _port_draws

pytestmark = pytest.mark.usefixtures("one_thread")

LR = 1e-4  # TrainConfig.learning_rate
MAX_PARAM = 4.05 * LR
SHARE_AT = 0.01 * LR


def _config():
    cfg = tiny_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, resblock_dilation_sizes=((1, 3, 5),)))


def _copy(state: dict) -> dict:
    return {k: np.array(v, copy=True) for k, v in state.items()}


def _port_state(trainer) -> dict:
    sd = {**{f"g.{k}": v for k, v in trainer.synth.state_dict().items()},
          **{f"d.{k}": v for k, v in trainer.disc.state_dict().items()}}
    return {k: v.detach().float().numpy().copy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def runs():
    """Two steps each of the JAX bf16 and float32 trainers and of the port's
    bf16 and float32 trainers, from the same weights, batch and draws:
    {name: [(metrics, parameters) per step]}, and the port's bf16 eval_loss
    on the first step's draws before it."""
    cfg = _config()
    batch = {k: np.asarray(v) for k, v in make_tiny_batch(2).items()}
    out, init, draws = {}, None, None
    with pytest.MonkeyPatch.context() as mp:
        kwargs_of = tconvert.synth_kwargs_from_config
        mp.setattr(tconvert, "synth_kwargs_from_config",
                   lambda c: {**kwargs_of(c), "feature_dim": 16})
        for name, dtype, fuse in (("jax_bf16", jnp.bfloat16, True),
                                  ("jax_f32", jnp.float32, False)):
            jt = JaxTrainer(cfg, dtype=dtype, fuse_resblocks=fuse)
            object.__setattr__(jt.synth, "feature_dim", 16)
            state = jt.init_state(jax.random.PRNGKey(0), batch, steps_per_epoch=100,
                                  fast_params=True)
            if init is None:
                init = (weights.synthesizer_state_dict(np_tree(state.params_g), fold=False),
                        weights.discriminator_state_dict(np_tree(state.params_d)))
                init = tuple(_copy(sd) for sd in init)
            step = jt.step_fn()
            out[name] = []
            with recorded_draws(mp) as recorded:  # the compiled step keeps its first list
                for i in range(2):
                    state, m = step(state, batch, jax.random.PRNGKey(10 + i))
                    out[name].append(({k: float(v) for k, v in m.items() if k != "viz"},
                                      _copy(_jax_state(state))))
            assert len(recorded) == 8  # per step: posterior, slice, sine phase, noise
            if draws is None:
                draws = [np.array(d) for d in recorded]
            else:  # both dtypes draw the same float32 numbers from the same keys
                assert all(np.array_equal(a, b) for a, b in zip(draws, recorded))
        for name, dtype in (("port_bf16", torch.bfloat16), ("port_f32", torch.float32)):
            tt = Trainer(_port_config(cfg), dtype=dtype, device="cpu")
            ts = tt.init_state(state_g=init[0], state_d=init[1], steps_per_epoch=100)
            if dtype == torch.bfloat16:
                out["eval_loss"] = float(tt.eval_loss(batch, draws=_port_draws(*draws[:4])))
            out[name] = []
            for i in range(2):
                ts, m = tt.step(ts, batch, draws=_port_draws(*draws[4 * i:4 * i + 4]))
                m.pop("viz")
                out[name].append(({k: float(v) for k, v in m.items()}, _port_state(tt)))
    return out


def _distance(a, b):
    """(per-metric |a - b|, parameters' largest |a - b|, share of elements
    more than 0.01 lr apart) of two runs' (metrics, parameters) at a step."""
    (ma, pa), (mb, pb) = a, b
    assert set(ma) == set(mb) and set(pa) == set(pb)
    diff = np.concatenate([np.abs(pa[k] - pb[k]).ravel() for k in pb])
    return ({k: abs(ma[k] - mb[k]) for k in mb}, float(diff.max()),
            float(np.mean(diff > SHARE_AT)))


def _bars(runs, i):
    """The step's bars from the JAX package's own bf16-to-float32 distance."""
    ref = runs["jax_bf16"][i][0]
    own, _, own_share = _distance(runs["jax_f32"][i], runs["jax_bf16"][i])
    bars = {}
    for k, v in ref.items():
        if k.startswith("grad_norm"):
            bars[k] = max(1e-3 * abs(v), 2 * own[k])
        else:
            bars[k] = max(1e-3 * max(1.0, abs(v)), 2 * own[k])
    return bars, 0.5 * own_share, own, own_share


def _within(runs, name, i):
    got, worst, share = _distance(runs[name][i], runs["jax_bf16"][i])
    bars, share_bar, own, own_share = _bars(runs, i)
    print(f"step {i}, {name} against JAX bf16: metrics {got}, parameters max "
          f"{worst / LR:.3g} lr, share beyond 0.01 lr {share:.4%}; bars {bars}, share "
          f"{share_bar:.4%}; JAX's own bf16-to-float32 distance {own}, share {own_share:.4%}")
    faults = [k for k in got if got[k] > bars[k]]
    if worst > MAX_PARAM:
        faults.append(f"parameters {worst / LR:.3g} lr apart")
    if share > share_bar:
        faults.append(f"{share:.4%} of the parameters beyond 0.01 lr")
    return faults


@pytest.mark.parametrize("i", [0, 1])
def test_trainer_bf16_step_matches_jax(runs, i):
    """The port's bf16 step ``i`` against the JAX bf16 step: every loss,
    both gradient norms and every parameter within the module's bars."""
    assert _within(runs, "port_bf16", i) == []


def test_bf16_bar_separates_float32(runs):
    """The port's float32 step, on the same weights and draws, falls outside
    the bf16 bars: its parameters follow the JAX bf16 run no closer than
    JAX's own float32 run does."""
    faults = [f for i in range(2) for f in _within(runs, "port_f32", i)]
    assert any("of the parameters beyond" in f for f in faults), faults


def test_trainer_bf16_eval_loss_is_the_steps_forward(runs):
    """``Trainer.eval_loss`` in bf16 runs the bf16 step's forward (the WN
    stacks fused, as the JAX trainer's evaluation runs them): on the first
    step's draws and weights it gives the first step's loss_mel, bit for
    bit, and it stays within the step bar of the JAX bf16 step's."""
    assert runs["eval_loss"] == runs["port_bf16"][0][0]["loss_mel"]
    ref = runs["jax_bf16"][0][0]["loss_mel"]
    assert abs(runs["eval_loss"] - ref) <= _bars(runs, 0)[0]["loss_mel"]
