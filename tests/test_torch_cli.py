"""The no-f0 converter against the JAX package's, and the port's command
line ``python -m rvc_tpu_torch.cli.main convert`` on a user's files, on
the CPU. The files are written as the reference's tools write them
(chip_smoke.py's writers: an fp16 ``.pth`` with weight_g/weight_v and
``conv_1`` names, a HuBERT ``.safetensors`` in HF names, an ``rmvpe.pt``)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal
from scipy.io import wavfile

import chip_smoke
from _torch_port import finit, no_compile_cache_writes, one_thread, recorded_draws  # noqa: F401
from rvc_tpu.config import RVCConfig
from rvc_tpu.models.hubert import HubertConfig, HubertEncoder
from rvc_tpu.models.synthesizer import Synthesizer
from rvc_tpu.pipelines import convert as jconv
from rvc_tpu_torch.cli import main as cli
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.io.audio import load_input_audio, save_input_audio
from rvc_tpu_torch.models import hubert as thubert
from rvc_tpu_torch.pipelines import convert as tconv
from test_torch_convert import HUBERT, REPO, SYNTH, speech

pytestmark = pytest.mark.usefixtures("one_thread")


def test_nof0_convert_matches_jax(monkeypatch):
    """A no-f0 model (the plain HiFiGAN decoder, no pitch embedding, no
    pitch model, no protect blend) converts 4 s in two chunks with int8
    retrieval and the RMS mix, on the JAX run's eps draw. Bar: 2 LSB."""
    kw = dict(SYNTH, use_f0=False)
    js = Synthesizer(**kw)
    T = 16
    sp = finit(lambda *a: js.init({"params": jax.random.PRNGKey(0),
                                   "noise": jax.random.PRNGKey(1)}, *a, method=js.infer),
               jnp.zeros((1, T, 32)), jnp.array([T]), None, None, jnp.array([0]), seed=21)
    assert "m_source" not in sp["params"]["dec"] and "emb_pitch" not in sp["params"]["enc_p"]
    hcfg = HubertConfig(**HUBERT)
    hub = HubertEncoder(hcfg)
    hp = finit(lambda x: hub.init(jax.random.PRNGKey(2), x, output_layer=12),
               jnp.zeros((1, 3200)), seed=22)
    bank = np.random.default_rng(27).standard_normal((300, 32)).astype(np.float32)
    chunking = RVCConfig(x_pad=1, x_query=1, x_center=2, x_max=3)
    jvc = jconv.VoiceConverter(sp, kw, hp, hcfg, index_bank=bank, config=chunking,
                               index_int8=True)
    tvc = tconv.VoiceConverter.from_state_dicts(
        weights.synthesizer_state_dict(sp), kw, weights.hubert_state_dict(hp),
        thubert.HubertConfig(**HUBERT), index_bank=bank, config=chunking, index_int8=True,
        device="cpu")
    assert tvc.pitch.rmvpe is None
    audio = speech(4.0, 12.0)
    s = dict(index_rate=0.75, protect=0.33, rms_mix_rate=0.25)
    with recorded_draws(monkeypatch) as draws:
        ref, ref_sr = jvc.convert(audio, settings=jconv.ConvertSettings(**s))
    jax.effects_barrier()
    (eps,) = draws
    got, sr = tvc.convert(audio, settings=tconv.ConvertSettings(**s),
                          draws=dict(eps=torch.from_numpy(eps).transpose(1, 2)))
    assert sr == ref_sr == 16000 and eps.shape[0] == 2
    assert got.dtype == ref.dtype == np.int16 and got.shape == ref.shape
    assert np.abs(ref).max() > 1000
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    print(f"no-f0 convert: max |diff| {diff.max()} LSB")
    assert diff.max() <= 2


TINY48 = dict(SYNTH, upsample_rates=(10, 6, 4, 2), upsample_kernel_sizes=(16, 12, 8, 4),
              sr=48000, feature_dim=256)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny v1 48 kHz model (HuBERT 12 layers of width 32, final_proj to
    256), a full-size rmvpe.pt, a 256-wide float32 bank and 1.2 s of stereo
    44.1 kHz int16 speech, with the arrays each loader must give; and a
    no-f0 copy of the model."""
    d = str(tmp_path_factory.mktemp("cli"))
    path = {k: os.path.join(d, n) for k, n in (
        ("model", "model.pth"), ("nof0", "nof0.pth"), ("hubert", "hubert.safetensors"),
        ("rmvpe", "rmvpe.pt"),
        ("index", "bank.npy"), ("input", "in.wav"))}
    hcfg = thubert.HubertConfig(**dict(HUBERT, classifier_proj_size=256))
    states = dict(synth=chip_smoke.write_rvc_pth(path["model"], TINY48, "v1", seed=1),
                  hubert=chip_smoke.write_hubert_safetensors(path["hubert"], hcfg, seed=2),
                  rmvpe=chip_smoke.write_rmvpe_pt(path["rmvpe"], seed=3), hubert_cfg=hcfg)
    chip_smoke.write_rvc_pth(path["nof0"], dict(TINY48, use_f0=False), "v1", seed=5)
    bank = np.random.default_rng(4).standard_normal((200, 256)).astype(np.float32)
    np.save(path["index"], bank)
    mono = signal.resample_poly(speech(1.2, 25.0), 441, 160)
    stereo = np.stack([mono, 0.5 * np.roll(mono, 300)], 1)
    wavfile.write(path["input"], 44100, (stereo * 30000).astype(np.int16))
    return path, states, bank


def argv(path, out, *extra):
    return ["convert", path["input"], out, "--model", path["model"], "--hubert",
            path["hubert"], "--rmvpe", path["rmvpe"], "--index", path["index"], *extra]


def argv_nof0(path, out, *extra):
    return ["convert", path["input"], out, "--model", path["nof0"], "--hubert",
            path["hubert"], "--index", path["index"], *extra]


def test_cli_convert_equals_convert_on_the_same_arrays(files, tmp_path):
    """The CLI's output wav equals save_input_audio of the converter built by
    from_state_dicts from the arrays written into the files, converting
    the same 16 kHz audio: same weights, draws and math, so equal."""
    path, states, bank = files
    out = os.path.join(tmp_path, "out.wav")
    cli.main(argv(path, out, "--resample-sr", "44100", "--device", "cpu"))
    vc = tconv.VoiceConverter.from_state_dicts(states["synth"], TINY48, states["hubert"],
                                               states["hubert_cfg"], states["rmvpe"],
                                               index_bank=bank, device="cpu")
    audio, sr = load_input_audio(path["input"], 16000)
    ref, ref_sr = vc.convert(audio, sr, tconv.ConvertSettings(resample_sr=44100))
    assert ref_sr == 44100 and ref.dtype == np.int16 and np.abs(ref).max() > 1000
    save_input_audio(os.path.join(tmp_path, "ref.wav"), (ref, ref_sr))
    got_sr, got = wavfile.read(out)
    want_sr, want = wavfile.read(os.path.join(tmp_path, "ref.wav"))
    assert got_sr == want_sr == 44100 and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_cli_imports_neither_jax_nor_the_file_libraries(files, tmp_path):
    """``python -m rvc_tpu_torch.cli.main convert`` in its own process, on
    the no-f0 model (no rmvpe.pt to read): it writes the wav and has
    imported neither jax nor rvc_tpu, and neither safetensors nor
    transformers."""
    path, _, _ = files
    out = os.path.join(tmp_path, "out.wav")
    code = ("import runpy, sys; sys.argv = ['rvc_tpu_torch'] + sys.argv[1:]; "
            "runpy.run_module('rvc_tpu_torch.cli.main', run_name='__main__'); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'rvc_tpu', 'safetensors', 'transformers')]; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code, *argv_nof0(path, out, "--device", "cpu")],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "wrote" in res.stdout and os.path.getsize(out) > 0


@pytest.mark.parametrize("method", ["pm", "dio"])
def test_cli_convert_with_a_method_that_needs_no_weights(files, tmp_path, method):
    """``--f0-method`` pm or dio without ``--rmvpe``: the CLI's wav equals the
    converter's without a pitch model, on the same arrays. A method whose
    weights are absent raises KeyError, as in JAX."""
    path, states, bank = files
    out = os.path.join(tmp_path, "out.wav")
    cli.main(["convert", path["input"], out, "--model", path["model"], "--hubert",
              path["hubert"], "--index", path["index"], "--f0-method", method,
              "--device", "cpu"])
    vc = tconv.VoiceConverter.from_state_dicts(states["synth"], TINY48, states["hubert"],
                                               states["hubert_cfg"], index_bank=bank,
                                               device="cpu")
    audio, sr = load_input_audio(path["input"], 16000)
    ref, ref_sr = vc.convert(audio, sr, tconv.ConvertSettings(f0_method=method))
    save_input_audio(os.path.join(tmp_path, "ref.wav"), (ref, ref_sr))
    got_sr, got = wavfile.read(out)
    want_sr, want = wavfile.read(os.path.join(tmp_path, "ref.wav"))
    assert got_sr == want_sr == 48000 and np.abs(ref).max() > 1000
    np.testing.assert_array_equal(got, want)
    for missing in ("rmvpe", "crepe", "mangio-crepe-tiny"):
        with pytest.raises(KeyError):
            vc.convert(audio, sr, tconv.ConvertSettings(f0_method=missing))


SEPARATE_PATCH = """
import functools, json, sys, torch
from rvc_tpu_torch.ops import bands
from rvc_tpu_torch.pipelines import separate
torch.set_num_threads(1)
narrow = json.loads(sys.argv.pop(1))
narrow["band"] = {int(k): v for k, v in narrow["band"].items()}
bands.FOURBAND_V2_PARAM = narrow
separate.VRSeparator = functools.partial(separate.VRSeparator, window_size=%d)
separate.MDXSeparator = functools.partial(separate.MDXSeparator, **%r)
separate.ConvTDFNetTrim = functools.partial(separate.ConvTDFNetTrim, **%r)
"""


def test_cli_separate_equals_load_separator(tmp_path, monkeypatch):
    """``python -m rvc_tpu_torch.cli.main separate`` in its own process on
    both routes (a VR ``.pth``, an anonymous MDX ``.onnx``), on 1 s of stereo
    44.1 kHz, with the 4-band layout narrowed to the separator test's layout
    and the MDX net to its tiny config (a full-width window costs hundreds
    of GFLOP; full width runs in chip_smoke's phase 22): it imports neither
    jax nor rvc_tpu, and its wavs equal those of load_separator's
    run_inference on the same downmix, saved the same way."""
    import functools
    import json

    from rvc_tpu_torch.ops import bands
    from rvc_tpu_torch.pipelines import separate
    from test_torch_separation import NARROW, NARROW_WINDOW, TINY_MDX, TINY_SPEC

    net_kw = {k: v for k, v in TINY_MDX.items() if k != "dim_f"}
    monkeypatch.setattr(bands, "FOURBAND_V2_PARAM", NARROW)
    monkeypatch.setattr(separate, "VRSeparator",
                        functools.partial(separate.VRSeparator, window_size=NARROW_WINDOW))
    monkeypatch.setattr(separate, "MDXSeparator",
                        functools.partial(separate.MDXSeparator, **TINY_SPEC))
    monkeypatch.setattr(separate, "ConvTDFNetTrim",
                        functools.partial(separate.ConvTDFNetTrim, **net_kw))
    models = {"vr": str(tmp_path / "HP5-vocals.pth"), "mdx": str(tmp_path / "UVR-MDX-NET-t.onnx")}
    chip_smoke.write_vr_pth(models["vr"], NARROW["bins"] * 2, seed=31)
    chip_smoke.write_mdx_onnx(models["mdx"], separate.ConvTDFNetTrim(dim_f=256), seed=32)
    song = np.stack([speech(1.0, 3.0), speech(1.0, 3.01)])
    song = signal.resample_poly(song, 441, 160, axis=1)
    wav = str(tmp_path / "song.wav")
    wavfile.write(wav, 44100, (song.T * 30000).astype(np.int16))

    code = (SEPARATE_PATCH % (NARROW_WINDOW, TINY_SPEC, net_kw)
            + "from rvc_tpu_torch.cli.main import main\n"
            + "main(['separate', *sys.argv[1:4], '--device', 'cpu'])\n"
            + "main(['separate', sys.argv[1], sys.argv[4], '--model', sys.argv[5], "
              "'--device', 'cpu'])\n"
            + "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'rvc_tpu')]\n"
            + "assert not bad, bad\n")
    outs = {k: str(tmp_path / f"stems_{k}") for k in models}
    res = subprocess.run([sys.executable, "-c", code, json.dumps(NARROW), wav, outs["vr"],
                          "--model=" + models["vr"], outs["mdx"], models["mdx"]],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    audio, sr = load_input_audio(wav)
    assert audio.ndim == 1 and sr == 44100
    for kind, model in models.items():
        assert separate.route_separator(model) == kind
        out = separate.load_separator(kind, model, 10.0, device="cpu").run_inference(audio, sr)
        for stem in ("vocals", "instrumentals"):
            ref = str(tmp_path / f"{kind}_{stem}.wav")
            save_input_audio(ref, out[stem])
            got_sr, got = wavfile.read(os.path.join(outs[kind], f"{stem}.wav"))
            want_sr, want = wavfile.read(ref)
            assert got_sr == want_sr == out["sr"] and np.abs(out[stem][0]).max() > 1000
            np.testing.assert_array_equal(got, want)
