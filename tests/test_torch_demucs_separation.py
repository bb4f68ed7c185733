"""The port's Demucs route against the JAX package's on the CPU: the
loaders (a v3/v4 ``.th`` package in float16 with a ``Fraction`` segment, a
vendored module prefix, a bare Conv-TasNet state dict) against JAX's
loaders, the bag-file reader against ``yaml.safe_load``, ``DemucsSeparator``
on an HTDemucs ``.th`` (with shifts), an HDemucs ``.th`` (framed BLSTM,
LocalState), a tasnet ``.th`` and a bag ``.yaml`` against JAX's
``DemucsSeparator`` on 1 s of stereo, the router, ``load_separator`` and
the CLI's ``separate`` on a ``.th``. Files are written by ``chip_smoke``'s
writers at tiny widths."""
import os
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from _torch_port import no_compile_cache_writes, one_thread  # noqa: F401
from test_torch_demucs import TINY_TASNET
from test_torch_separation import stereo
from rvc_tpu.compat import torch_import as jimport
from rvc_tpu.pipelines import separate as jsep
from rvc_tpu_torch.cli import main as cli
from rvc_tpu_torch.compat import torch_import, weights
from rvc_tpu_torch.pipelines import separate as tsep

pytestmark = pytest.mark.usefixtures("one_thread")

LSB = 2  # int16 stems: the conversion's CPU bar (1 expected)

# tiny nets at 44.1 kHz with 0.25 s segments: HTDemucs with the training
# segment; HDemucs whose layer 1 collapses F and carries the framed BLSTM
# (690 frames) and LocalState, as hdemucs_mmi's inner layers do
TINY_HT = dict(sources=chip_smoke.DEMUCS_SOURCES, audio_channels=2, channels=8, depth=2,
               nfft=256, norm_starts=1, t_layers=2, t_heads=2, segment=Fraction(1, 4),
               use_train_segment=True, t_sparse_self_attn=False, t_cape_augment=[0, 0])
TINY_H = dict(sources=chip_smoke.DEMUCS_SOURCES, audio_channels=2, channels=8, depth=3,
              nfft=64, norm_starts=1, dconv_lstm=1, dconv_attn=1, segment=Fraction(1, 4))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("demucs")
    paths = {"htdemucs": str(d / "htdemucs-tiny.th"), "hdemucs": str(d / "hdemucs_mmi-tiny.th"),
             "tasnet": str(d / "tasnet-tiny.th")}
    chip_smoke.write_demucs_model(paths["htdemucs"], "demucs.htdemucs.HTDemucs", TINY_HT, 1)
    chip_smoke.write_demucs_model(paths["hdemucs"], "demucs.hdemucs.HDemucs", TINY_H, 2)
    chip_smoke.write_tasnet_th(paths["tasnet"], TINY_TASNET, 3)
    paths["bag"] = chip_smoke.write_demucs_bag(str(d), "bag_ft", TINY_HT, 4,
                                               [[1.0, 0.0, 0.0, 1.0], [0.0, 1.0, 1.0, 0.5]])
    return paths


def assert_stems_close(ref: dict, got: dict, label: str) -> None:
    """Every int16 stem of JAX's output (the sources and instrumentals)."""
    stems = [k for k in ref if k not in ("sr", "input_audio")]
    assert stems == [k for k in got if k not in ("sr", "input_audio")]
    assert "instrumentals" in stems and ref["sr"] == got["sr"]
    for stem in stems:
        a, b = ref[stem][0], got[stem][0]
        assert a.dtype == b.dtype == np.int16 and a.shape == b.shape and a.shape[0] == 2
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).max()
        print(f"{label} {stem}: max |diff| {diff} LSB, peak {np.abs(a).max()}")
        assert np.abs(a).max() > 1000 and diff <= LSB


# ---- loaders ----

def test_load_demucs_v4_matches_jax(files):
    """float16 state to float32, the class's name, a Fraction segment, the
    kwargs cut to the port's keywords; the state equal to JAX's tree carried
    over by ``compat.weights.demucs_state_dict``."""
    for kind, klass in (("htdemucs", "HTDemucs"), ("hdemucs", "HDemucs")):
        state, meta = torch_import.load_demucs_v4(files[kind])
        jparams, jmeta = jimport.load_demucs_v4(files[kind])
        assert meta["klass"] == jmeta["klass"] == klass
        assert meta["segment"] == 0.25 and meta["sources"] == tuple(chip_smoke.DEMUCS_SOURCES)
        ref = weights.demucs_state_dict(jparams)
        assert set(ref) == set(state)
        for k, v in state.items():
            assert v.dtype == np.float32
            np.testing.assert_array_equal(v, ref[k])
        kw = torch_import.htdemucs_kwargs_from_meta(meta)
        assert kw == jimport.htdemucs_kwargs_from_meta(jmeta)
        assert isinstance(kw["segment"], float) and kw["sources"] == meta["sources"]
        assert "t_cape_augment" not in kw and "t_sparse_self_attn" not in kw


def test_load_tasnet_matches_jax(files):
    state, cfg = torch_import.load_tasnet(files["tasnet"])
    jparams, jcfg = jimport.load_tasnet(files["tasnet"])
    assert cfg == jcfg == {**TINY_TASNET, "audio_channels": 2, "n_sources": 4}
    ref = weights.tasnet_state_dict(jparams, jcfg)
    assert set(ref) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(v, ref[k])


def test_load_demucs_package_forms(tmp_path):
    """A class pickled under a vendored prefix (the loader stubs each module
    it names and retries), a Conv-TasNet package, diffq-quantized state and
    sparse attention (refused)."""
    net_state = {"w": np.ones(3, np.float32)}
    path = str(tmp_path / "vendored.th")
    prefix = "uvr_vendored_test"
    chip_smoke.write_demucs_th(path, f"{prefix}.demucs.htdemucs.HTDemucs", {"channels": 8},
                               net_state)
    try:
        state, meta = torch_import.load_demucs_v4(path)
    finally:
        for m in [m for m in sys.modules if m.split(".")[0] == prefix]:
            del sys.modules[m]
    assert meta["klass"] == "HTDemucs" and meta["kwargs"] == {"channels": 8}
    np.testing.assert_array_equal(state["w"], 1.0)
    # a Conv-TasNet saved as a demucs package (its class demucs.tasnet's,
    # a module the JAX package's loader does not stub)
    tasnet = chip_smoke.write_tasnet_th(str(tmp_path / "plain.th"), TINY_TASNET, 3)
    chip_smoke.write_demucs_th(str(tmp_path / "tasnet-pkg.th"), "demucs.tasnet.ConvTasNet", {},
                               tasnet, half=False)
    state, cfg = torch_import.load_tasnet(str(tmp_path / "tasnet-pkg.th"))
    assert cfg == {**TINY_TASNET, "audio_channels": 2, "n_sources": 4}
    for k, v in tasnet.items():
        np.testing.assert_array_equal(state[k], v)
    quant = str(tmp_path / "diffq.th")
    torch.save({"klass": None, "kwargs": {}, "state": {"__quantized": True}}, quant)
    with pytest.raises(NotImplementedError, match="diffq"):
        torch_import.load_demucs_v4(quant)
    with pytest.raises(NotImplementedError, match="sparse"):
        torch_import.htdemucs_kwargs_from_meta({"klass": "HTDemucs",
                                                "kwargs": {"t_sparse_self_attn": True}})


BAGS = [
    "models: ['f7e0c4bc', 'd12395a8', '92cfc3b6', '04573f0d']\n"
    "weights: [\n    [1., 0., 0., 0.],\n    [0., 1., 0., 0.],\n    [0., 0., 1., 0.],\n"
    "    [0., 0., 0., 1.],\n]\n",
    "models: ['75fc33f5']\nsegment: 44\n",
    "# a bag\nmodels:\n- 955717e8\n- \"5d2d6c55\"\nweights: [[1.0, 0.5], [0.25, 1e-3]]\n"
    "segment: 7.8  # seconds\n",
    "models: [a1d90b5c, e51eebcc]\nweights:\n  - [1, 0]\n  - [0, 1]\n",
]


@pytest.mark.parametrize("text", BAGS)
def test_read_demucs_bag_matches_yaml(tmp_path, text):
    """The forms demucs writes: flow lists on one or several lines (trailing
    commas), block lists, quoted and plain signatures, ints, floats, comments."""
    path = tmp_path / "bag.yaml"
    path.write_text(text)
    assert torch_import.read_demucs_bag(str(path)) == yaml.safe_load(text)


# ---- the separator ----

def run_both(path: str, song: np.ndarray, **kw) -> tuple[dict, dict]:
    ref = jsep.DemucsSeparator(path, **kw).run_inference(song, 44100)
    got = tsep.DemucsSeparator(path, device="cpu", **kw).run_inference(song, 44100)
    return ref, got


@pytest.mark.parametrize("kind,kw", [("htdemucs", {"shifts": 2}), ("hdemucs", {}),
                                     ("tasnet", {}), ("bag", {})])
def test_demucs_separator_matches_jax(files, kind, kw):
    """1 s of stereo at 44.1 kHz (chunks of 0.25 s at 3/4 overlap stride;
    HTDemucs also with 2 random shifts from JAX's generator; the tasnet in
    one padded 8 s chunk; the bag's per-source weights, one of them 0.5)."""
    song = stereo(1.0, 44100)
    ref, got = run_both(files[kind], song, **kw)
    assert got["sr"] == 44100 and got["input_audio"][0].shape == (2, 44100)
    assert_stems_close(ref, got, f"{kind} {kw}")


def test_demucs_resamples_to_the_models_rate(files):
    """Mono at 22.05 kHz: doubled to stereo and brought to 44.1 kHz (scipy's
    resample_poly on the host, as JAX's ``_to_stereo_44k``)."""
    song = stereo(1.0, 22050)[0]
    ref = jsep.DemucsSeparator(files["hdemucs"]).run_inference(song, 22050)
    got = tsep.DemucsSeparator(files["hdemucs"], device="cpu").run_inference(song, 22050)
    assert_stems_close(ref, got, "hdemucs 22.05 kHz mono")


def test_route_and_load_separator(files):
    for kind in ("htdemucs", "tasnet", "bag"):
        path = files[kind]
        assert tsep.route_separator(path) == jsep.route_separator(path) == "demucs"
        sep = tsep.load_separator(tsep.route_separator(path), path, device="cpu")
        assert isinstance(sep, tsep.DemucsSeparator)
        assert sep.sources == chip_smoke.DEMUCS_SOURCES
    assert len(sep.sub) == 2 and sep.segment_samples == 11025
    for name, kind in (("BS-Roformer-1297.ckpt", "bs_roformer"),
                       ("MelBandRoformer.ckpt", "mel_roformer")):
        assert tsep.route_separator(name) == kind
        with pytest.raises(FileNotFoundError):  # ported: the loader reads the file
            tsep.load_separator(kind, name, device="cpu")


def test_cli_separate_demucs(files, tmp_path):
    """``separate --model X.th --device cpu`` writes stereo vocals.wav and
    instrumentals.wav equal to load_separator's stems on the file's
    downmix, saved the same way."""
    from scipy.io import wavfile

    from rvc_tpu_torch.io.audio import load_input_audio, save_input_audio

    song = stereo(1.0, 44100)
    wav = str(tmp_path / "song.wav")
    wavfile.write(wav, 44100, (song.T * 32767).astype(np.int16))
    outdir = str(tmp_path / "stems")
    cli.main(["separate", wav, outdir, "--model", files["htdemucs"], "--device", "cpu"])
    audio, sr = load_input_audio(wav)
    ref = tsep.load_separator("demucs", files["htdemucs"], device="cpu").run_inference(audio, sr)
    for stem in ("vocals", "instrumentals"):
        save_input_audio(str(tmp_path / f"{stem}_ref.wav"), ref[stem])
        rate, got = wavfile.read(os.path.join(outdir, f"{stem}.wav"))
        _, want = wavfile.read(str(tmp_path / f"{stem}_ref.wav"))
        assert rate == 44100 and got.shape == want.shape == (44100, 2)
        np.testing.assert_array_equal(got, want)
