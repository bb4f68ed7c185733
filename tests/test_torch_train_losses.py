"""The port's training step with every loss the JAX trainer has, and on a
no-f0 model, against the JAX package's.

As tests/test_torch_train_step.py holds the default step: the port's
``Trainer`` on the CPU against the JAX ``Trainer`` at ``tiny_config()``
(batch 2, feature_dim 16), from the same weights, the same batch and the
JAX run's recorded draws, over 2 steps, at that file's bars, fixed before
the first run: each loss within 1e-4 of max(1, |loss|), the gradient norms
within 1e-4 relative, every parameter within 2.05 lr of JAX's and all but
0.1% of them within 1e-3 lr (Adam's first updates move a parameter by
about lr times the sign of its gradient, so a gradient within rounding of
0 may step the two runs up to 2 lr apart).

- Every loss on: ``c_gp = c_hd = c_tsi = c_tefs = 1`` (``combined_aux_loss``'s
  own default weight) and ``use_multiscale()`` on both sides. The JAX step
  draws five numbers a step, the penalty's interpolation weight last.
  JAX's TSI envelope pools through ``frame_signal``'s conv lowering, which
  makes every TSI gradient NaN (tests/test_torch_aux_losses.py); the JAX
  step runs here with that pool taken by ``frame_signal``'s gather instead
  (``_max_pool_gather``), as the port computes it.
- No f0: ``tiny_config()`` with ``use_f0 = False`` (the plain HiFiGAN
  decoder, no pitch embedding) on a batch without ``pitch``/``pitchf``, as
  ``RVCDataset(use_f0=False)`` gives it; two draws a step; and
  ``Trainer.eval_loss`` against ``eval_fn`` at the step's bar for
  ``loss_mel``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes, np_tree, recorded_draws, one_thread  # noqa: F401
from rvc_tpu.parallel.dryrun import make_tiny_batch, tiny_config
from rvc_tpu.train import losses as jlosses
from rvc_tpu.train.step import Trainer as JaxTrainer
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.pipelines import convert as tconvert
from rvc_tpu_torch.train.step import Trainer
from test_torch_aux_losses import _max_pool_gather
from test_torch_train_step import _jax_state, _port_config, _port_state

pytestmark = pytest.mark.usefixtures("one_thread")

LR = 1e-4  # TrainConfig.learning_rate


def all_losses_config(cfg):
    """``cfg`` with the gradient penalty and the three aux losses at weight 1."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, c_gp=1.0, c_hd=1.0, c_tsi=1.0, c_tefs=1.0))


def nof0_config():
    cfg = tiny_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_f0=False))


def _trainers(monkeypatch, cfg, batch, multiscale: bool):
    """The JAX and the port's trainers and states from the same weights."""
    jt = JaxTrainer(cfg)
    object.__setattr__(jt.synth, "feature_dim", 16)
    kwargs_of = tconvert.synth_kwargs_from_config
    monkeypatch.setattr(tconvert, "synth_kwargs_from_config",
                        lambda c: {**kwargs_of(c), "feature_dim": 16})
    jstate = jt.init_state(jax.random.PRNGKey(0), batch, steps_per_epoch=100,
                           fast_params=True)
    tt = Trainer(_port_config(cfg), device="cpu")
    if multiscale:
        jt.use_multiscale()
        tt.use_multiscale()
    tstate = tt.init_state(state_g=weights.synthesizer_state_dict(np_tree(jstate.params_g),
                                                                  fold=False),
                           state_d=weights.discriminator_state_dict(np_tree(jstate.params_d)),
                           steps_per_epoch=100)
    return jt, jstate, tt, tstate


def port_draws(draws: list) -> dict:
    """One step's recorded JAX draws in the port's layouts: the posterior's
    normal and the slice's uniform, then with f0 the sine source's phase and
    noise, then with the penalty its interpolation weight."""
    names = (["eps_q", "u_slice"] + (["rand_ini", "noise"] if len(draws) in (4, 5) else [])
             + (["alpha"] if len(draws) in (3, 5) else []))
    out = {k: torch.from_numpy(np.array(v)) for k, v in zip(names, draws)}
    out["eps_q"] = out["eps_q"].transpose(1, 2)
    return out


def _run_and_compare(monkeypatch, trainers, batch, per_step: int):
    """2 steps of both trainers, each port step on the JAX step's draws,
    held at the module's bars; returns the JAX metrics and the port's last
    state."""
    jt, jstate, tt, tstate = trainers
    step = jt.step_fn()
    jax_runs = []
    with recorded_draws(monkeypatch) as draws:  # the compiled step keeps its first list
        for i in range(2):
            jstate, jm = step(jstate, batch, jax.random.PRNGKey(10 + i))
            jax_runs.append(({k: float(v) for k, v in jm.items() if k != "viz"},
                             _jax_state(jstate)))
    assert len(draws) == 2 * per_step
    for i, (jm, ref) in enumerate(jax_runs):
        tstate, tm = tt.step(tstate, batch,
                             draws=port_draws(draws[per_step * i:per_step * (i + 1)]))
        tm.pop("viz")
        tm = {k: float(v) for k, v in tm.items()}
        assert set(tm) == set(jm)
        assert all(np.isfinite(v) for v in tm.values()), tm
        for k in tm:
            tol = 1e-4 * (abs(jm[k]) if k.startswith("grad_norm") else max(1.0, abs(jm[k])))
            assert abs(tm[k] - jm[k]) <= tol, (i, k, tm[k], jm[k])
        got = _port_state(tt)
        assert set(got) == set(ref)
        diff = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
        assert diff.max() <= 2.05 * LR, (i, diff.max())
        assert np.mean(diff > 1e-3 * LR) <= 1e-3, (i, np.mean(diff > 1e-3 * LR))
    return [jm for jm, _ in jax_runs], tstate


def test_trainer_all_losses_step_matches_jax(monkeypatch):
    """Every loss on, over 2 steps; the aux losses and the penalty nonzero
    (the penalty from the balancer's history of the discriminator's losses,
    where the step keeps it)."""
    monkeypatch.setattr(jlosses, "_max_pool_lastdim", _max_pool_gather)
    cfg = all_losses_config(tiny_config())
    batch = {k: np.asarray(v) for k, v in make_tiny_batch(2).items()}
    jax_metrics, tstate = _run_and_compare(
        monkeypatch, _trainers(monkeypatch, cfg, batch, True), batch, 5)
    for jm in jax_metrics:
        assert all(jm[k] != 0 for k in ("harmonic_loss", "tsi_loss", "tefs_loss")), jm
    assert float(tstate.balancer_d.hist_losses[1]) > 0


def test_trainer_nof0_step_matches_jax(monkeypatch):
    """The no-f0 model: ``eval_loss`` against ``eval_fn`` on the first
    weights (at loss_mel's step bar), then 2 steps."""
    cfg = nof0_config()
    batch = {k: np.asarray(v) for k, v in make_tiny_batch(2).items()
             if k not in ("pitch", "pitchf")}
    trainers = jt, jstate, tt, _ = _trainers(monkeypatch, cfg, batch, False)
    assert not tt.synth.use_f0 and not hasattr(tt.synth.enc_p, "emb_pitch")
    with recorded_draws(monkeypatch) as draws:
        ref = float(jt.eval_fn()(jstate.params_g, batch, jax.random.PRNGKey(7)))
    assert len(draws) == 2  # posterior normal, slice uniform
    got = float(tt.eval_loss(batch, draws=port_draws(draws)))
    assert abs(got - ref) <= 1e-4 * max(1.0, abs(ref)), (got, ref)
    assert set(tt.draws(batch, 0)) == {"eps_q", "u_slice"}
    _run_and_compare(monkeypatch, trainers, batch, 2)
