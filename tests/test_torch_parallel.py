"""The port's data parallelism (``rvc_tpu_torch/parallel/``) on the CPU.

Two ranks over gloo, each a spawned process on one thread, at the JAX dry
run's ``tiny_config()`` with every loss on (the gradient penalty and the
three aux losses at weight 1, the balancer on), batch 4 (2 rows a rank),
from the JAX ``Trainer``'s initial weights and one set of draws for both
steps:

- two 2-rank steps against the port's one-process steps on the whole
  batch: losses and gradient norms within 1e-5 relative, parameters within
  1e-5, and the two ranks' parameters equal bit for bit;
- the first 2-rank step against the JAX ``Trainer`` step under
  ``make_mesh(2)``
  (on the 8 virtual CPU devices of ``tests/conftest.py``) on the same
  draws, to tests/test_torch_train_step.py's bars: losses within 1e-4 of
  max(1, |loss|), gradient norms within 1e-4 relative, every parameter
  within 2.05 lr and all but 0.1% within 1e-3 lr. JAX's TSI pool runs
  through ``frame_signal``'s gather, as in tests/test_torch_train_losses.py.
  One step: JAX's mesh sums in another order than its one-device step,
  and Adam's first update takes a gradient within rounding of 0 by 2 lr
  either way; the next step's gradient norm then moves by ~1e-2 (JAX's
  mesh step against its own one-device step, measured here), above the
  bar.

Then ``train_model`` over two CPU ranks (only rank 0 writes; a resumed run
at world size 1 takes the step the two ranks take), ``convert_batch`` with
its chunk batch split over two devices (int16 equal to one device's) and
``run_dryrun(2, "cpu")`` (run beside the JAX step's compile)."""
import dataclasses
import operator
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes, np_tree, one_thread  # noqa: F401
from rvc_tpu.parallel import dryrun as jdryrun
from rvc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rvc_tpu.parallel.mesh import replicate as jax_replicate
from rvc_tpu.parallel.mesh import shard_batch as jax_shard_batch
from rvc_tpu.train import losses as jlosses
from rvc_tpu.train.step import Trainer as JaxTrainer
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.parallel import dryrun, mesh
from rvc_tpu_torch.pipelines import convert as tconvert
from rvc_tpu_torch.pipelines import train as ttrain
from rvc_tpu_torch.train.data import write_filelist
from test_torch_aux_losses import _max_pool_gather
from test_torch_train_step import _jax_state, _port_config

pytestmark = pytest.mark.usefixtures("one_thread")

LR = 1e-4  # TrainConfig.learning_rate
STEPS = 2


def all_losses(cfg):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, c_gp=1.0, c_hd=1.0, c_tsi=1.0, c_tefs=1.0))


def _draws(trainer, batch, seed: int = 5) -> dict:
    """One step's draws for the global batch, in the port's layouts."""
    d = trainer.draws(batch, seed)
    assert set(d) == {"eps_q", "u_slice", "rand_ini", "noise", "alpha"}
    return {k: v.numpy() for k, v in d.items()}


def replayed(mp, draws: list) -> list:
    """jax.random.normal / uniform return ``draws`` in call order where a
    call asks for the next one's shape with no range (a parameter
    initializer passes its range: the discriminators hold biases of the
    batch's size, 4); returns the draws not yet replayed."""
    pending = list(draws)

    def wrap(fn):
        def replay(key, shape=(), dtype=jax.numpy.float32, *args, **kwargs):
            if not args and not kwargs and pending and pending[0].shape == tuple(shape):
                return jax.numpy.asarray(pending.pop(0)).astype(dtype)
            return fn(key, shape, dtype, *args, **kwargs)
        return replay

    mp.setattr(jax.random, "normal", wrap(jax.random.normal))
    mp.setattr(jax.random, "uniform", wrap(jax.random.uniform))
    return pending


@pytest.fixture(scope="module")
def runs(one_thread):
    """The JAX mesh step, and the 2-rank and one-process runs of ``STEPS``
    steps, on the same batch, weights and draws; and the outcomes of
    ``run_dryrun(2, "cpu")`` and of a world whose ranks raise. The spawned
    ranks and the dry run go on while JAX traces and compiles its step."""
    cfg = all_losses(jdryrun.tiny_config())
    batch = dryrun.make_tiny_batch(4)
    jt = JaxTrainer(cfg)
    jstate = jt.init_state(jax.random.PRNGKey(0), batch, steps_per_epoch=100, fast_params=True)
    state_g = weights.synthesizer_state_dict(np_tree(jstate.params_g), fold=False)
    state_d = weights.discriminator_state_dict(np_tree(jstate.params_d))
    pcfg = _port_config(cfg)
    draws = _draws(ttrain.Trainer(pcfg, device="cpu"), batch)

    args = (pcfg, [batch] * STEPS, [draws] * STEPS, state_g, state_d)
    with ThreadPoolExecutor(3) as pool:
        ranks = pool.submit(mesh.spawn, dryrun.dp_steps, 2, "cpu", args=args + (0, STEPS))
        dry = pool.submit(dryrun.run_dryrun, 2, "cpu")
        failing = pool.submit(mesh.spawn, operator.truediv, 2, "cpu", args=(0,))
        jax_run = _jax_mesh_step(jt, jstate, batch, draws)
        one = dryrun.dp_steps(None, *args, keep_params=STEPS, device="cpu")
        return {"jax": jax_run, "ranks": ranks.result(), "one": one, "dryrun": dry,
                "failing": failing}


def _jax_mesh_step(jt, jstate, batch: dict, draws: dict) -> tuple:
    """JAX's step under ``make_mesh(2)`` on the port's draws: (metrics,
    parameters by the port's names)."""
    jax_draws = [draws["eps_q"].transpose(0, 2, 1), draws["u_slice"], draws["rand_ini"],
                 draws["noise"], draws["alpha"]]
    jmesh = jax_make_mesh(2)
    jstate = jax_replicate(jmesh, jstate)
    step = jt.step_fn()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlosses, "_max_pool_lastdim", _max_pool_gather)
        pending = replayed(mp, jax_draws)
        with jmesh:
            jstate, jm = step(jstate, jax_shard_batch(jmesh, batch), jax.random.PRNGKey(10))
    assert not pending
    return {k: float(v) for k, v in jm.items() if k != "viz"}, _jax_state(jstate)


def _params(run: dict, step: int) -> dict:
    return {k: v.numpy() for k, v in run["params"][step].items()}


def test_dp_step_matches_one_process(runs):
    ranks, one = runs["ranks"], runs["one"]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert all(r["step"] == STEPS for r in ranks)
    for i in range(STEPS):
        got, ref = ranks[0]["metrics"][i], one["metrics"][i]
        assert got == ranks[1]["metrics"][i]
        assert set(got) == set(ref)
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-5 * max(abs(ref[k]), 1e-30 if
                                                      k.startswith("grad_norm") else 1.0), \
                (i, k, got[k], ref[k])
    for i in range(STEPS):
        got, ref = _params(ranks[0], i), _params(one, i)
        assert got.keys() == ref.keys()
        diff = max(np.abs(got[k] - ref[k]).max() for k in ref)
        assert diff <= 1e-5, (i, diff)


def test_dp_step_matches_jax_mesh(runs):
    jm, ref = runs["jax"]
    tm = runs["ranks"][0]["metrics"][0]
    assert set(tm) == set(jm)
    assert all(jm[k] != 0 for k in ("harmonic_loss", "tsi_loss", "tefs_loss")), jm
    for k in tm:
        tol = 1e-4 * (abs(jm[k]) if k.startswith("grad_norm") else max(1.0, abs(jm[k])))
        assert abs(tm[k] - jm[k]) <= tol, (k, tm[k], jm[k])
    got = _params(runs["ranks"][0], 0)
    assert set(got) == set(ref)
    diff = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref])
    assert diff.max() <= 2.05 * LR, diff.max()
    assert np.mean(diff > 1e-3 * LR) <= 1e-3, np.mean(diff > 1e-3 * LR)


def _dataset(root, cfg, n: int = 4) -> str:
    """``n`` clips of one bucket at the tiny config, v2 features."""
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    rows = []
    hop = cfg.data.hop_length
    for i in range(n):
        frames = 40 + i
        paths = [str(root / f"{i}{ext}") for ext in (".wav", ".f.npy", ".p.npy", ".pf.npy")]
        wavfile.write(paths[0], cfg.data.sampling_rate,
                      (0.1 * rng.standard_normal(frames * hop)).astype(np.float32))
        np.save(paths[1], rng.standard_normal((frames // 2 + 1, 768)).astype(np.float32))
        np.save(paths[2], rng.integers(1, 255, frames).astype(np.int32))
        np.save(paths[3], rng.uniform(100, 300, frames).astype(np.float32))
        rows.append("|".join(paths) + "|0")
    path = str(root / "filelist.txt")
    write_filelist(path, rows)
    return path


def test_train_model_two_ranks_and_resume_at_one(tmp_path, capfd):
    """Two CPU ranks, batch 2, two steps an epoch, 2 epochs saved at each:
    rank 0 alone prints and writes (one line an epoch, each file once),
    and the first epoch's state resumed at world size 1 takes a second
    epoch within 1e-5 of the two ranks' (the state is replicated)."""
    cfg = dataclasses.replace(dryrun.tiny_config(), train=dataclasses.replace(
        dryrun.tiny_config().train, batch_size=2, log_interval=1))
    filelist = _dataset(tmp_path, cfg)
    run = ttrain.TrainRunConfig(model_dir=str(tmp_path / "two"), filelist=filelist,
                                total_epochs=2, save_every_epoch=1, n_devices=2, device="cpu")
    path = ttrain.train_model(cfg, run)
    out = capfd.readouterr().out
    assert path == str(tmp_path / "two" / "model.pth") and os.path.isfile(path)
    assert out.count("epoch 0:") == 1 and out.count("epoch 1:") == 1, out
    files = sorted(f for f in os.listdir(tmp_path / "two") if f != "logs")
    assert files == ["losses.json", "model.pth", "model_best.pth", "state_2", "state_4"], files

    one = tmp_path / "one"
    one.mkdir()
    shutil.copy(tmp_path / "two" / "state_2", one / "state_2")
    ttrain.train_model(cfg, dataclasses.replace(run, model_dir=str(one), n_devices=1))
    assert "resumed" in capfd.readouterr().out
    a = torch.load(tmp_path / "two" / "state_4", weights_only=True)
    b = torch.load(one / "state_4", weights_only=True)
    assert a["step"] == b["step"] == 4
    for part in ("synth", "disc"):
        diff = max((a[part][k] - b[part][k]).abs().max().item() for k in a[part])
        assert diff <= 1e-5, (part, diff)


def test_mesh_sizes_and_a_failing_rank_raises(runs):
    """``make_mesh``: the gcd with the batch size, one rank on the CPU by
    default, more ranks than cards raises; a rank that raises (``truediv(
    world, 0)``, spawned beside the JAX step's compile) makes ``spawn`` (and
    so ``train_model``) raise."""
    assert mesh.make_mesh(None, 4, "cpu") == 1
    assert mesh.make_mesh(4, 6, "cpu") == 2
    with pytest.raises(RuntimeError, match="card"):
        mesh.make_mesh(torch.cuda.device_count() + 1, 4, "cuda")
    with pytest.raises(Exception, match="terminated with the following error"):
        runs["failing"].result()


def test_convert_batch_split_over_two_devices():
    """The chunk batch split over ["cpu", "cpu"] (two replicas): int16 equal
    to the single-device call's, song for song; a new device list drops
    the old replicas."""
    vc = dryrun.tiny_converter("cpu")
    rng = np.random.default_rng(1)
    songs = [(0.3 * np.sin(2 * np.pi * 150 * np.arange(16000 * sec) / 16000)
              + 0.02 * rng.standard_normal(16000 * sec)).astype(np.float32) for sec in (7, 5, 3)]
    s = tconvert.ConvertSettings(f0_method="pm", index_rate=0.75, protect=0.33)
    one = vc.convert_batch(songs, settings=s)
    vc.devices = ["cpu", "cpu"]
    split = vc.convert_batch(songs, settings=s)
    (dev0, synth0, _, _), (dev1, synth1, _, _) = vc.replicas()
    assert synth0 is vc.synth and synth1 is not vc.synth and str(dev1) == "cpu"
    for (a, sr), (b, sr2) in zip(one, split, strict=True):
        assert sr == sr2 and a.dtype == b.dtype == np.int16
        np.testing.assert_array_equal(a, b)
    vc.devices = None
    assert vc._replicas == []


def test_run_dryrun_two_cpu_ranks(runs):
    """``run_dryrun(2, "cpu")`` returns: each of its checks raises."""
    assert runs["dryrun"].result() is None
