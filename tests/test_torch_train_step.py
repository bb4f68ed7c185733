"""The port's GAN training step and data path against the JAX package's.

The step: ``rvc_tpu_torch.train.step.Trainer`` on the CPU against the JAX
``Trainer`` at ``rvc_tpu/parallel/dryrun.py::tiny_config()`` (batch 2,
feature_dim 16, as tests/test_train_step.py builds it), from the same
weights, the same batch and the JAX run's recorded draws, over 2 steps: the
per-loss metrics, the gradient norms and every parameter after each step;
and the held-out evaluation (``Trainer.eval_loss``) on the same. The data
path: the port's BucketBatcher gives the JAX one's batches."""
import jax
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes, np_tree, recorded_draws, one_thread  # noqa: F401
from rvc_tpu.parallel.dryrun import make_tiny_batch, tiny_config
from rvc_tpu.train import data as jdata
from rvc_tpu.train.step import Trainer as JaxTrainer
from rvc_tpu_torch import config as tconfig
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.pipelines import convert as tconvert
from rvc_tpu_torch.train import data as tdata
from rvc_tpu_torch.train.step import Trainer

pytestmark = pytest.mark.usefixtures("one_thread")

LR = 1e-4  # TrainConfig.learning_rate


def _port_config(cfg):
    return tconfig.RVCConfig.from_json(cfg.to_json())


def _port_state(trainer):
    sd = {**{f"g.{k}": v for k, v in trainer.synth.state_dict().items()},
          **{f"d.{k}": v for k, v in trainer.disc.state_dict().items()}}
    return {k: v.detach().numpy() for k, v in sd.items()}


def _jax_state(state):
    g = weights.synthesizer_state_dict(np_tree(state.params_g), fold=False)
    d = weights.discriminator_state_dict(np_tree(state.params_d))
    return {**{f"g.{k}": v for k, v in g.items()}, **{f"d.{k}": v for k, v in d.items()}}


def _trainers(monkeypatch):
    """The tiny batch, and the JAX and the port's trainers and states from
    the same weights."""
    cfg = tiny_config()
    batch = {k: np.asarray(v) for k, v in make_tiny_batch(2).items()}
    jt = JaxTrainer(cfg)
    object.__setattr__(jt.synth, "feature_dim", 16)
    # the same override on the port's side: tiny features of width 16
    kwargs_of = tconvert.synth_kwargs_from_config
    monkeypatch.setattr(tconvert, "synth_kwargs_from_config",
                        lambda c: {**kwargs_of(c), "feature_dim": 16})
    jstate = jt.init_state(jax.random.PRNGKey(0), batch, steps_per_epoch=100,
                           fast_params=True)
    tt = Trainer(_port_config(cfg), device="cpu")
    tstate = tt.init_state(state_g=weights.synthesizer_state_dict(np_tree(jstate.params_g),
                                                                  fold=False),
                           state_d=weights.discriminator_state_dict(np_tree(jstate.params_d)),
                           steps_per_epoch=100)
    return batch, jt, jstate, tt, tstate


def _port_draws(eps_q, u, rand_ini, noise):
    """The JAX run's recorded draws in the port's layouts."""
    return dict(eps_q=torch.from_numpy(eps_q).transpose(1, 2), u_slice=torch.from_numpy(u),
                rand_ini=torch.from_numpy(rand_ini), noise=torch.from_numpy(noise))


def test_trainer_step_matches_jax(monkeypatch):
    """Tolerances. Losses: 1e-4 of max(1, |loss|) (float32 sums in another
    order). Gradient norms: 1e-4 relative. Parameters: Adam's first updates
    move a parameter by about lr times the sign of its gradient, so where a
    gradient is within rounding of 0 the two runs may step apart by up to
    2 lr: every element within 2.05 lr, and all but 0.1% of them within
    1e-3 lr."""
    batch, jt, jstate, tt, tstate = _trainers(monkeypatch)
    step = jt.step_fn()
    jax_runs = []
    with recorded_draws(monkeypatch) as draws:  # the compiled step keeps its first list
        for i in range(2):
            jstate, jm = step(jstate, batch, jax.random.PRNGKey(10 + i))
            jax_runs.append(({k: float(v) for k, v in jm.items() if k != "viz"},
                             _jax_state(jstate)))
    assert len(draws) == 8  # per step: posterior normal, slice uniform, sine phase, noise
    for i, (jm, ref) in enumerate(jax_runs):
        eps_q, u, rand_ini, noise = draws[4 * i:4 * i + 4]
        tstate, tm = tt.step(tstate, batch, draws=_port_draws(eps_q, u, rand_ini, noise))
        assert set(tm.pop("viz")) == {"y_mel", "y_hat_mel", "wave_org", "wave_gen"}
        tm = {k: float(v) for k, v in tm.items()}
        assert set(tm) == set(jm)
        for k in tm:
            tol = 1e-4 * (abs(jm[k]) if k.startswith("grad_norm") else max(1.0, abs(jm[k])))
            assert abs(tm[k] - jm[k]) <= tol, (i, k, tm[k], jm[k])
        got = _port_state(tt)
        assert set(got) == set(ref)
        diff = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
        assert diff.max() <= 2.05 * LR, (i, diff.max())
        assert np.mean(diff > 1e-3 * LR) <= 1e-3, (i, np.mean(diff > 1e-3 * LR))


def test_trainer_eval_loss_matches_jax(monkeypatch):
    """``Trainer.eval_loss`` against the JAX ``Trainer.eval_fn`` from the same
    weights, batch and draws, at the step test's bar for ``loss_mel``: 1e-4
    of max(1, |loss|). Other slice starts give another loss, beyond that
    bar, so a wrong slice or draw would not pass."""
    batch, jt, jstate, tt, _ = _trainers(monkeypatch)
    with recorded_draws(monkeypatch) as draws:
        ref = float(jt.eval_fn()(jstate.params_g, batch, jax.random.PRNGKey(7)))
    assert len(draws) == 4  # posterior normal, slice uniform, sine phase, noise
    port = _port_draws(*draws)
    got = float(tt.eval_loss(batch, draws=port))
    tol = 1e-4 * max(1.0, abs(ref))
    assert abs(got - ref) <= tol, (got, ref)
    other = float(tt.eval_loss(batch, draws={**port, "u_slice": 1.0 - port["u_slice"]}))
    assert abs(other - ref) > tol, (other, ref)


def _write_dataset(root, data, n=7, seed=0):
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        samples = int(rng.integers(20, 360)) * 3 * data.hop_length // 4  # float32 bytes
        frames = samples // data.hop_length
        paths = [str(root / f"{i}{ext}") for ext in (".wav", ".f.npy", ".p.npy", ".pf.npy")]
        wavfile.write(paths[0], data.sampling_rate,
                      (0.1 * rng.standard_normal(samples)).astype(np.float32))
        np.save(paths[1], rng.standard_normal((frames // 2 + 1, 16)).astype(np.float32))
        np.save(paths[2], rng.integers(1, 255, frames).astype(np.int32))
        np.save(paths[3], rng.uniform(80, 400, frames).astype(np.float32))
        rows.append("|".join(paths) + f"|{i % 3}")
    return rows


@pytest.mark.parametrize("batch_size", [2, 3])
def test_bucket_batcher_matches_jax(tmp_path, batch_size):
    """Same filelist and seed: the same batches (keys, layouts, values) over
    two epochs, the spectrograms computed and cached on the way."""
    cfg = tiny_config()
    rows = _write_dataset(tmp_path, cfg.data)
    tdata.write_filelist(str(tmp_path / "list.txt"), rows)
    jb = jdata.BucketBatcher(jdata.RVCDataset(str(tmp_path / "list.txt"), cfg.data),
                             batch_size, seed=7)
    tb = tdata.BucketBatcher(tdata.RVCDataset(str(tmp_path / "list.txt"),
                                              _port_config(cfg).data), batch_size, seed=7)
    n = 0
    for epoch in range(2):
        for a, b in zip(jb.epoch(epoch), tb.epoch(epoch), strict=True):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            n += 1
    assert n >= 2
