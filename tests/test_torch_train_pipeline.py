"""The port's training run (``pipelines/train.py::train_model``) and its
command line, on the CPU at a tiny config (tests/test_e2e_train.py's, with
the discriminators at 1/16 width): checkpoints, held-out evaluation,
best-model and final exports, a resumed run against an uninterrupted one,
the exported model converting through the JAX package's converter and the
port's, and ``preprocess`` -> ``train`` -> ``index`` -> ``convert`` through
``python -m rvc_tpu_torch.cli.main`` in a process that never imports JAX."""
import argparse
import contextlib
import functools
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import chip_smoke
from _torch_port import (NARROW_RMVPE, finit, narrow_jax_rmvpe, no_compile_cache_writes,  # noqa: F401
                         one_thread, recorded_draws)
from rvc_tpu.cli import main as jcli
from rvc_tpu.compat.torch_import import load_rvc_checkpoint as jax_load_rvc
from rvc_tpu.compat.torch_import import synthesizer_kwargs_from_config as jax_kwargs
from rvc_tpu.config import RVCConfig as JaxRVCConfig
from rvc_tpu.models.hubert import HubertConfig, HubertEncoder
from rvc_tpu.models.rmvpe import RMVPE
from rvc_tpu.pipelines import convert as jconv
from rvc_tpu.pitch.extractor import PitchExtractor
from rvc_tpu_torch import config as tconfig
from rvc_tpu_torch.cli import main as tcli
from rvc_tpu_torch.compat import torch_import as ti
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import hubert as thubert
from rvc_tpu_torch.pipelines import convert as tconv
from rvc_tpu_torch.pipelines import train as ttrain
from rvc_tpu_torch.train.data import write_filelist
from test_torch_convert import HUBERT, REPO, speech
from test_torch_convert_batch import lsb, port_draws

pytestmark = pytest.mark.usefixtures("one_thread")

SR = 32000
FEAT = 32  # the tiny HuBERT's width
CHUNKING = dict(x_pad=1, x_query=2, x_center=4, x_max=5)


def tiny_config() -> tconfig.RVCConfig:
    d = tconfig.DataConfig(sampling_rate=SR, filter_length=512, hop_length=320,
                           win_length=512, n_mel_channels=32)
    m = tconfig.ModelConfig(
        inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2, n_layers=1,
        kernel_size=3, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
        upsample_rates=(10, 8, 2, 2), upsample_initial_channel=16,
        upsample_kernel_sizes=(16, 16, 4, 4), gin_channels=8, spk_embed_dim=2, version="v2",
        use_f0=True, disc_scale=1.0 / 16.0)
    return tconfig.RVCConfig(data=d, model=m, train=tconfig.TrainConfig(
        batch_size=2, segment_size=6400, log_interval=1))


@pytest.fixture(scope="module")
def filelist(tmp_path_factory):
    """6 clips of 1.0-1.3 s of speech at 32 kHz (one 200-frame bucket),
    seeded random features, f0 and coarse bins."""
    from scipy.signal import resample_poly

    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    rows = []
    for i, sec in enumerate(np.linspace(1.0, 1.3, 6)):
        clip = resample_poly(speech(float(sec), 2.0 + 3.0 * i), 2, 1).astype(np.float32)
        frames = len(clip) // 320
        paths = [str(root / f"{i}{ext}") for ext in (".wav", ".f.npy", ".p.npy", ".pf.npy")]
        wavfile.write(paths[0], SR, clip)
        np.save(paths[1], rng.standard_normal((frames // 2 + 1, FEAT)).astype(np.float32))
        np.save(paths[2], rng.integers(1, 255, frames).astype(np.int32))
        np.save(paths[3], rng.uniform(100, 300, frames).astype(np.float32))
        rows.append("|".join(paths) + "|0")
    path = str(root / "filelist.txt")
    write_filelist(path, rows)
    return path


@pytest.fixture(scope="module")
def runs(filelist, tmp_path_factory):
    """Runs warm-started from a reference-named G file (speaker table of 3
    rows against the model's 2), every other clip held out (one step an
    epoch at batch 2): "a" one epoch, then run again to two (it resumes);
    "b" two epochs without a stop. Returns the G file, the run directories,
    what the runs printed and the epoch-1 file list of "a"."""
    root = tmp_path_factory.mktemp("runs")
    out = {"G": str(root / "G_pre.pth"), "a": root / "a", "b": root / "b"}
    with pytest.MonkeyPatch.context() as mp:
        kwargs_of = tconv.synth_kwargs_from_config
        mp.setattr(tconv, "synth_kwargs_from_config",
                   lambda c: {**kwargs_of(c), "feature_dim": FEAT})
        kw = {**tconv.synth_kwargs_from_config(tiny_config()), "spk_embed_dim": 3}
        chip_smoke.write_rvc_pth(out["G"], kw, "v2", seed=8)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            out["path"] = _run(filelist, out["a"], 1, pretrained_g=out["G"])
            out["after_1"] = sorted(os.listdir(out["a"]))
            out["best_1"] = json.loads((out["a"] / "losses.json").read_text())
            _run(filelist, out["a"], 2, pretrained_g=out["G"])
            _run(filelist, out["b"], 2, pretrained_g=out["G"])
        out["printed"] = printed.getvalue()
    return out


def _run(filelist, model_dir, epochs, **kw):
    return ttrain.train_model(tiny_config(), ttrain.TrainRunConfig(
        model_dir=str(model_dir), filelist=filelist, total_epochs=epochs, save_every_epoch=1,
        eval_every_n=2, device="cpu", **kw))


def test_train_model_resumes_and_exports(runs):
    """After one epoch: state_1, losses.json, the _best and final exports.
    Run again to 2 epochs it resumes from state_1 (and not from the
    pretrained file); its final model equals that of a 2-epoch run without
    a stop, bit for bit."""
    assert runs["path"] == str(runs["a"] / "model.pth")
    for name in ("state_1", "losses.json", "model_best.pth", "model.pth"):
        assert name in runs["after_1"], name
    assert runs["best_1"]["epoch"] == 0 and np.isfinite(runs["best_1"]["loss"])
    assert runs["printed"].count("resumed") == 1 and (runs["a"] / "state_2").exists()
    a = torch.load(runs["a"] / "model.pth", weights_only=True)["weight"]
    b = torch.load(runs["b"] / "model.pth", weights_only=True)["weight"]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_train_model_nof0_with_multiscale_exports_f0_0(filelist, tmp_path, monkeypatch):
    """``train_model`` on a no-f0 model (``use_f0 = False``, a filelist
    without f0 columns, as ``RVCDataset(use_f0=False)`` reads it) with
    ``use_multiscale``: it runs an epoch on the CPU, the trainer takes the
    multi-scale mel loss, and the exported ``.pth`` says ``f0: 0`` and loads
    through the port's loader into the no-f0 synthesizer."""
    import dataclasses

    from rvc_tpu_torch.models.layers import load_numpy_state_dict
    from rvc_tpu_torch.models.synthesizer import Synthesizer

    rows = [ln.split("|") for ln in open(filelist).read().splitlines()]
    nof0_list = str(tmp_path / "nof0.txt")
    write_filelist(nof0_list, ["|".join([r[0], r[1], r[4]]) for r in rows])
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_f0=False))
    kwargs_of = tconv.synth_kwargs_from_config
    monkeypatch.setattr(tconv, "synth_kwargs_from_config",
                        lambda c: {**kwargs_of(c), "feature_dim": FEAT})
    msml = []
    use_multiscale = ttrain.Trainer.use_multiscale
    monkeypatch.setattr(ttrain.Trainer, "use_multiscale",
                        lambda self, **kw: msml.append(use_multiscale(self, **kw) or self.msml))
    path = ttrain.train_model(cfg, ttrain.TrainRunConfig(
        model_dir=str(tmp_path / "run"), filelist=nof0_list, total_epochs=1, device="cpu",
        use_multiscale=True))
    assert len(msml) == 1 and msml[0].sampling_rate == SR
    state, meta = ti.load_rvc_checkpoint(path)
    assert meta["f0"] == 0
    kw = {**ti.synthesizer_kwargs_from_config(meta["config"], meta["version"], meta["f0"]),
          "feature_dim": FEAT}
    assert kw["use_f0"] is False
    synth = load_numpy_state_dict(Synthesizer(**kw), state)
    assert type(synth.dec).__name__ == "Generator"
    assert all(torch.isfinite(v).all() for v in synth.state_dict().values())


def test_warm_started_run_and_its_export_convert_as_jax(runs, filelist, monkeypatch):
    """The warm-started run's export (the mismatched speaker table kept at its
    initial rows) converts 2 s through the JAX VoiceConverter and the port's
    (narrowed RMVPE, the run's features as a float32 bank, the JAX run's
    draws) within test_torch_convert.py's 2 LSB."""
    path = str(runs["b"] / "model.pth")
    exported = ti.load_rvc_checkpoint(path)[0]
    pre = ti.load_rvc_checkpoint(runs["G"])[0]
    assert exported["emb_g.weight"].shape[0] == 2 != pre["emb_g.weight"].shape[0]

    jparams, meta = jax_load_rvc(path)
    kwargs = {**jax_kwargs(meta["config"], "v2", True), "feature_dim": FEAT}
    hcfg = HubertConfig(**HUBERT)
    hub = HubertEncoder(hcfg)
    hp = finit(lambda x: hub.init(jax.random.PRNGKey(2), x, output_layer=12),
               jnp.zeros((1, 3200)), seed=41)
    with open(filelist) as f:
        bank = np.concatenate([np.load(row.split("|")[1]) for row in f.read().split("\n")])
    chunking = JaxRVCConfig(**CHUNKING)
    audio = speech(2.0, 30.0)
    s = dict(f0_method="rmvpe", index_rate=0.75, protect=0.33, rms_mix_rate=0.25)
    with narrow_jax_rmvpe():
        rm = RMVPE()
        rp = finit(lambda x: rm.init(jax.random.PRNGKey(3), x), jnp.zeros((1, 16000)), seed=42)
        jvc = jconv.VoiceConverter(jparams, kwargs, hp, hcfg,
                                   pitch=PitchExtractor(rmvpe_params=rp), index_bank=bank,
                                   config=chunking)
        with recorded_draws(monkeypatch) as draws:
            ref, ref_sr = jvc.convert(audio, settings=jconv.ConvertSettings(**s))
    tkw = {**ti.synthesizer_kwargs_from_config(meta["config"], "v2", True), "feature_dim": FEAT}
    monkeypatch.setattr(tconv, "RMVPE", functools.partial(tconv.RMVPE, **NARROW_RMVPE))
    tvc = tconv.VoiceConverter.from_state_dicts(
        exported, tkw, weights.hubert_state_dict(hp), thubert.HubertConfig(**HUBERT),
        weights.rmvpe_state_dict(rp), index_bank=bank, config=tconfig.RVCConfig(**CHUNKING),
        device="cpu")
    got, sr = tvc.convert(audio, settings=tconv.ConvertSettings(**s), draws=port_draws(draws))
    assert sr == ref_sr == SR
    d = lsb(got, ref)
    print(f"the trained model's conversion: max |diff| {d} LSB")
    assert d <= 2


def _parser(module):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd")
    for name in ("preprocess", "train", "index"):
        getattr(module, f"_add_{name}")(sub)
    return p


@pytest.mark.parametrize("argv", [["preprocess", "in", "exp", "--hubert", "h.safetensors"],
                                  ["train", "list.txt", "run"], ["index", "exp"]],
                         ids=lambda a: a[0])
def test_cli_parses_the_jax_defaults(argv):
    """The same arguments and defaults as the JAX command line's, plus
    --device (the card by default)."""
    got = vars(_parser(tcli).parse_args(argv))
    ref = vars(_parser(jcli).parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == ref


# Run in a process of its own: the tiny config in place of the preset, the
# tiny HuBERT's width, the narrowed RMVPE, mute fixtures of that width; then
# the four commands, on the CPU; then no JAX module may be loaded.
_COMMANDS_SCRIPT = """
import functools, json, runpy, sys
from rvc_tpu_torch import config
from rvc_tpu_torch.compat import torch_import
from rvc_tpu_torch.models import rmvpe
from rvc_tpu_torch.pipelines import convert, preprocess
cfg = config.RVCConfig.from_json(open(sys.argv[1]).read())
config.preset = lambda name: cfg
narrow = functools.partial(rmvpe.RMVPE, **json.loads(sys.argv[2]))
rmvpe.RMVPE = convert.RMVPE = narrow
preprocess.generate_mute_fixtures = functools.partial(preprocess.generate_mute_fixtures,
                                                      feat_dim=int(sys.argv[3]))
for mod, name in ((convert, "synth_kwargs_from_config"),
                  (torch_import, "synthesizer_kwargs_from_config")):
    fn = getattr(mod, name)
    setattr(mod, name, functools.partial(lambda f, *a: {**f(*a), "feature_dim": int(sys.argv[3])},
                                         fn))
from rvc_tpu_torch.cli import main
for line in sys.argv[4:]:
    main.main(line.split("\\t"))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "rvc_tpu")]
assert not bad, bad
"""


def test_cli_trains_end_to_end_without_jax(tmp_path):
    """``preprocess`` (two files of voiced bursts at 32 kHz; a tiny HuBERT
    .safetensors and a narrowed rmvpe.pt), ``train`` (2 epochs, saving every
    epoch), ``index`` and ``convert`` with the exported model and index, all
    with --device cpu, in one process that never imports jax."""
    from test_torch_preprocess import _source

    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(9)
    for i in range(2):
        x = _source([2.8, 1.5], 3.0 * i, rng)
        wavfile.write(str(src / f"in{i}.wav"), 40000, x)
    hub, rm = str(tmp_path / "h.safetensors"), str(tmp_path / "r.pt")
    chip_smoke.write_hubert_safetensors(hub, thubert.HubertConfig(**HUBERT), seed=2)
    from rvc_tpu_torch.models import rmvpe as trmvpe
    from rvc_tpu_torch.models.layers import init_random_

    torch.save(dict(init_random_(trmvpe.RMVPE(**NARROW_RMVPE), 3).model.state_dict()), rm)
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(tiny_config().to_json())
    exp, run = str(tmp_path / "exp"), str(tmp_path / "run")
    wav_in, wav_out = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    wavfile.write(wav_in, 16000, speech(1.5, 12.0))
    steps = [
        ["preprocess", str(src), exp, "--sr", "32k", "--hubert", hub, "--rmvpe", rm],
        ["train", os.path.join(exp, "filelist.txt"), run, "--epochs", "2", "--batch-size", "2",
         "--save-every", "1"],
        ["index", exp],
        ["convert", wav_in, wav_out, "--model", os.path.join(run, "model.pth"), "--hubert", hub,
         "--rmvpe", rm, "--index", os.path.join(exp, "index.npy")],
    ]
    lines = ["\t".join(s + ["--device", "cpu"]) for s in steps]
    res = subprocess.run([sys.executable, "-c", _COMMANDS_SCRIPT, str(cfg_file),
                          json.dumps(NARROW_RMVPE), str(FEAT), *lines], cwd=REPO,
                         capture_output=True, text=True,
                         timeout=600, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "sliced" in out and "exported:" in out and "wrote" in out
    n_clips = sum(f.endswith(".wav") for f in os.listdir(os.path.join(exp, "0_gt_wavs")))
    assert n_clips >= 4
    for sub in ("3_feature768", "2a_f0", "2b-f0nsf"):
        assert len(os.listdir(os.path.join(exp, sub))) == n_clips
    for name in ("state_", "losses.json", "model_best.pth", "model.pth"):
        assert any(f.startswith(name) for f in os.listdir(run)), name
    bank = np.load(os.path.join(exp, "index.npy"))
    assert bank.shape[1] == FEAT and bank.shape[0] > 100
    sr, y = wavfile.read(wav_out)
    # the frames the 16 kHz input's 10 ms windows give, at the model's rate
    assert sr == SR and abs(len(y) / SR - 1.5) < 0.03 and np.abs(y).max() > 0
