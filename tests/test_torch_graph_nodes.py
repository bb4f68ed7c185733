"""The port's node layer (``rvc_tpu_torch.graph``) against the JAX package's
(``rvc_tpu.graph``) on the CPU: the registry and every node's contract,
the audio nodes, ``UVR5Node`` on a seeded VR ``.pth``, ``RVCNode`` on
seeded ``.pth``, HuBERT ``.safetensors`` and ``rmvpe.pt`` files, the
dataset nodes' arguments to training, feature extraction and indexing, and
one tiny run of the port's nodes from clips to a converted clip. The
nodes compute on ``nodes.DEVICE = "cpu"``; every test starts with empty
caches on both sides."""
import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal
from scipy.io import wavfile

import chip_smoke
from _torch_port import (NARROW_RMVPE, finit, narrow_jax_rmvpe, no_compile_cache_writes,  # noqa: F401
                         one_thread, recorded_draws)
from rvc_tpu import graph as jgraph
from rvc_tpu.graph import nodes as jnodes
from rvc_tpu.models import rmvpe as jrmvpe
from rvc_tpu.ops import bands as jbands
from rvc_tpu.pipelines import preprocess as jpre
from rvc_tpu.pipelines import separate as jsep
from rvc_tpu.pipelines import train as jtrain
from rvc_tpu_torch import graph as tgraph
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.graph import nodes
from rvc_tpu_torch.io.audio import load_input_audio
from rvc_tpu_torch.models import hubert as thubert
from rvc_tpu_torch.models import rmvpe as trmvpe
from rvc_tpu_torch.ops import bands as tbands
from rvc_tpu_torch.pipelines import convert as tconv
from rvc_tpu_torch.pipelines import preprocess as tpre
from rvc_tpu_torch.pipelines import separate as tsep
from rvc_tpu_torch.pipelines import train as ttrain
from test_torch_convert import HUBERT, REPO, SYNTH, speech
from test_torch_separation import NARROW, NARROW_WINDOW, _mask_times_mix, stereo
from test_torch_train_pipeline import tiny_config

pytestmark = pytest.mark.usefixtures("one_thread")

NOT_PORTED = {"RVC_TPU_MuseAudioFeatures", "RVC_TPU_MuseImageFeatures", "RVC_TPU_MuseTalk"}
CONTRACT = ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY", "OUTPUT_NODE",
            "INPUT_IS_LIST", "OUTPUT_IS_LIST")
LSB = 2  # int16 outputs against JAX's: the conversion's CPU bar


@pytest.fixture(autouse=True)
def cpu_nodes(monkeypatch, tmp_path):
    """Both node layers with empty caches, the port's on the CPU, and the
    preview folder of both under this test's temporary directory."""
    monkeypatch.setattr(nodes, "DEVICE", "cpu")
    monkeypatch.setattr(nodes, "_CACHE", {})
    monkeypatch.setattr(jnodes, "_CACHE", {})
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def i16(payload: dict) -> np.ndarray:
    """An AUDIO dict's waveform back in int16 steps."""
    return np.rint(np.asarray(payload["waveform"]) * 32768.0).astype(np.int32)


def assert_audio_equal(got, ref) -> None:
    assert got["sample_rate"] == ref["sample_rate"]
    assert got["waveform"].dtype == ref["waveform"].dtype
    np.testing.assert_array_equal(got["waveform"], ref["waveform"])


# ---- the registry ----

@pytest.mark.parametrize("key", sorted(set(jgraph.NODE_CLASS_MAPPINGS) - NOT_PORTED))
def test_node_contract_matches_jax(key):
    """Each node the port registers has JAX's INPUT_TYPES, RETURN_TYPES,
    RETURN_NAMES, FUNCTION, CATEGORY, OUTPUT_NODE and list flags."""
    cls, jcls = tgraph.NODE_CLASS_MAPPINGS[key], jgraph.NODE_CLASS_MAPPINGS[key]
    assert cls.INPUT_TYPES() == jcls.INPUT_TYPES()
    for attr in CONTRACT:
        assert getattr(cls, attr, None) == getattr(jcls, attr, None), attr
    assert callable(getattr(cls, cls.FUNCTION))


def test_registry_is_jax_minus_the_models_not_ported():
    assert set(tgraph.NODE_CLASS_MAPPINGS) == set(jgraph.NODE_CLASS_MAPPINGS) - NOT_PORTED
    assert NOT_PORTED <= set(jgraph.NODE_CLASS_MAPPINGS)
    assert tgraph.NODE_DISPLAY_NAME_MAPPINGS == {
        k: v for k, v in jgraph.NODE_DISPLAY_NAME_MAPPINGS.items() if k not in NOT_PORTED}
    assert os.path.samefile(tgraph.WEB_DIRECTORY, os.path.join(REPO, "web"))
    assert os.path.isfile(os.path.join(tgraph.WEB_DIRECTORY, "js", "ui_handlers.js"))
    assert nodes.DEVICE == "cpu"  # the fixture's; the module's own is None: the card


def test_graph_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys, rvc_tpu_torch.graph, rvc_tpu_torch.i18n, rvc_tpu_torch.utils.profiling, "
            "rvc_tpu_torch.bench.parity, rvc_tpu_torch.graph.downloader; "
            "from rvc_tpu_torch.graph import nodes; assert nodes.DEVICE is None; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'rvc_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


# ---- the audio nodes ----

def _song(tmp_path, seconds=0.6, sr=44100) -> str:
    path = str(tmp_path / "song.wav")
    x = signal.resample_poly(stereo(seconds, 16000, seed=4), sr // 100, 160, axis=1)
    wavfile.write(path, sr, (x.T * 20000).astype(np.int16))
    return path


def test_audio_nodes_match_jax(tmp_path):
    """LoadAudio, SaveAudio, PreviewAudio (both channel counts, no
    overwrite), MergeAudio, AudioInfo, ProcessAudio (both fill methods) and
    AudioBatchValue give JAX's payloads on the same inputs; a waveform given
    as a torch tensor reads as its numpy array."""
    wav = _song(tmp_path)
    (got,), (ref,) = nodes.LoadAudioNode().load(wav, 16000), jnodes.LoadAudioNode().load(wav, 16000)
    assert_audio_equal(got, ref)
    audio = got
    as_tensor = {"waveform": torch.from_numpy(audio["waveform"]), "sample_rate": 16000}
    for side, node_mod in (("t", nodes), ("j", jnodes)):
        out = node_mod.SaveAudioNode().save(audio, str(tmp_path / f"{side}.wav"))
        assert out["result"] == (str(tmp_path / f"{side}.wav"),)
        assert out["ui"]["preview"][0]["type"] == "temp"
    assert open(tmp_path / "t.wav", "rb").read() == open(tmp_path / "j.wav", "rb").read()
    for channels in (1, 2):
        for _ in range(2):
            outs = [m.PreviewAudioNode().save_audio(
                        audio, filename=f"clip{channels}", save_format="wav",
                        save_channels=channels, overwrite_existing=False,
                        output_dir=str(tmp_path / side))
                    for side, m in (("t", nodes), ("j", jnodes))]
            (gp, ga), (rp, ra) = outs[0]["result"], outs[1]["result"]
            assert os.path.relpath(gp, tmp_path / "t") == os.path.relpath(rp, tmp_path / "j")
            assert open(gp, "rb").read() == open(rp, "rb").read()
            assert_audio_equal(ga, ra)
            gu, ru = outs[0]["ui"]["preview"][0], outs[1]["ui"]["preview"][0]
            assert gu["autoplay"] is ru["autoplay"] is True and gu["subfolder"] == "preview"
    other = nodes.LoadAudioNode().load(_song(tmp_path, 0.4, 48000), 48000)[0]
    for sr in (40000, 16000):
        assert_audio_equal(nodes.MergeAudioNode().merge(audio, other, sr)[0],
                           jnodes.MergeAudioNode().merge(audio, other, sr)[0])
    got, ref = nodes.AudioInfoNode().get_info(as_tensor), jnodes.AudioInfoNode().get_info(audio)
    assert got[1:] == ref[1:] and abs(got[1] - 0.6) < 1e-3
    for method in ("median", "interpolation"):
        kw = dict(normalize=True, threshold_silence=True, dynamic_threshold=True,
                  dynamic_threshold_sample_size=800, dynamic_threshold_fill_method=method)
        (gproc, gout), (rproc, rout) = (m.ProcessAudioNode().process_audio(audio=as_tensor, **kw)
                                        for m in (nodes, jnodes))
        assert str(gproc) == str(rproc)
        assert_audio_equal(gout, rout)
    assert nodes.ProcessAudioNode().process_audio(True, False, False)[1] is None
    for invert in (False, True):
        got = nodes.AudioBatchValueNode().get_frame_weights(as_tensor, 7, 0.2, 0.9, invert)
        assert got == jnodes.AudioBatchValueNode().get_frame_weights(audio, 7, 0.2, 0.9, invert)


def test_download_audio_is_cache_first(tmp_path, monkeypatch):
    """A file already under ``output_dir`` is read without a download, with
    JAX's payload; without one and without ``yt_dlp`` both raise; a URL not
    of YouTube raises ValueError on both sides."""
    import builtins

    real_import = builtins.__import__

    def no_yt_dlp(name, *args, **kwargs):
        if name == "yt_dlp":
            raise ImportError("no yt_dlp")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yt_dlp)
    x = nodes.LoadAudioNode().load(_song(tmp_path), 44100)[0]
    nodes.SaveAudioNode().save(x, str(tmp_path / "cache" / "song.wav"))
    url = "https://youtube.com/watch?v=x"
    args = dict(sr=16000, song_name="song", format="wav", output_dir=str(tmp_path / "cache"))
    got, ref = (m.DownloadAudioNode().download_audio(url, **args) for m in (nodes, jnodes))
    assert got["ui"] == ref["ui"] and got["result"][0] == ref["result"][0] == "song"
    assert_audio_equal(got["result"][1], ref["result"][1])
    for m in (nodes, jnodes):
        with pytest.raises(RuntimeError, match="yt_dlp"):
            m.DownloadAudioNode().download_audio("https://youtu.be/y", format="wav",
                                                 output_dir=str(tmp_path / "cache"))
        with pytest.raises(ValueError):
            m.DownloadAudioNode().download_audio("https://example.com/x")


# ---- UVR5Node ----

@pytest.fixture
def narrow_vr(monkeypatch):
    """Both packages' 4-band layout narrowed to the separation tests' 64-bin
    layout and window (a full-width window costs hundreds of GFLOP), and
    JAX's VR magnitude taken as the reference's mask x mix
    (``test_torch_separation._mask_times_mix``)."""
    monkeypatch.setattr(tbands, "FOURBAND_V2_PARAM", NARROW)
    monkeypatch.setattr(jbands, "FOURBAND_V2_PARAM", NARROW)
    monkeypatch.setattr(tsep, "VRSeparator",
                        functools.partial(tsep.VRSeparator, window_size=NARROW_WINDOW))
    jvr = jsep.VRSeparator

    def jax_vr(*args, **kwargs):
        sep = jvr(*args, window_size=NARROW_WINDOW, **kwargs)
        sep._predict_mask = _mask_times_mix(sep)
        return sep

    monkeypatch.setattr(jsep, "VRSeparator", jax_vr)


def test_uvr5_node_matches_jax_and_caches(tmp_path, narrow_vr, monkeypatch):
    """UVR5 through a seeded VR ``.pth`` on 1 s at 44.1 kHz as LoadAudio
    gives it (the downmix, one channel: (1, 1, T)): both stems within 2 LSB
    of JAX's node (which doubles the channel; the port's separator takes
    (T,) and (1, T) alike). A second call is a cache hit (the separator is
    not run), and a new aggressiveness reuses the loaded separator with the
    new value, as JAX's cache does."""
    model = str(tmp_path / "HP5-vocals.pth")
    chip_smoke.write_vr_pth(model, NARROW["bins"] * 2, seed=41)
    song = signal.resample_poly(stereo(1.0, 16000, seed=5), 441, 160, axis=1).astype(np.float32)
    audio = nodes.to_audio_dict(song.mean(0), 44100)
    assert audio["waveform"].shape == (1, 1, song.shape[1])
    sep = tsep.load_separator("vr", model, 10.0, device="cpu")
    flat, row = (sep.run_inference(x, 44100) for x in (song.mean(0), song.mean(0)[None]))
    for stem in ("vocals", "instrumentals"):
        np.testing.assert_array_equal(flat[stem][0], row[stem][0])
    ref = jnodes.UVR5Node().split(audio, model, 10.0)
    runs = []
    original = tsep.VRSeparator.func.run_inference

    def counted(self, *args, **kwargs):
        runs.append(self.agg)
        return original(self, *args, **kwargs)

    monkeypatch.setattr(tsep.VRSeparator.func, "run_inference", counted)
    got = nodes.UVR5Node().split(audio, model, 10.0)
    for g, r, name in zip(got, ref, ("vocals", "instrumentals")):
        assert g["sample_rate"] == r["sample_rate"] == NARROW["sr"]  # the layout's rate
        assert g["waveform"].shape == r["waveform"].shape
        assert g["waveform"].shape[:2] == (1, 1) and g["waveform"].shape[2] > 0.9 * NARROW["sr"]
        d = np.abs(i16(g) - i16(r)).max()
        print(f"UVR5 {name}: max |diff| {d} LSB, peak {np.abs(i16(r)).max()}")
        assert np.abs(i16(r)).max() > 1000 and d <= LSB
    again = nodes.UVR5Node().split(audio, model, 10.0)
    assert runs == [10.0]
    for a, b in zip(again, got):
        assert_audio_equal(a, b)
    nodes.UVR5Node().split(audio, model, 4.0)
    seps = [v for v in nodes._CACHE.values() if isinstance(v, tsep.VRSeparator.func)]
    assert runs == [10.0, 4.0] and len(seps) == 1 and seps[0].agg == 4.0


# ---- RVCNode ----

TINY = dict(SYNTH, feature_dim=256)  # a v1 model: HuBERT layer 9 and final_proj to 256


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """Two tiny v1 16 kHz voices (``.pth`` as the reference writes them), a
    tiny HF HuBERT ``.safetensors`` (final_proj to 256), an ``rmvpe.pt`` of
    the narrowed RMVPE (``_torch_port.NARROW_RMVPE``) and a 256-wide
    retrieval bank."""
    d = tmp_path_factory.mktemp("nodes")
    path = {k: str(d / n) for k, n in (("a", "voice_a.pth"), ("b", "voice_b.pth"),
                                       ("hubert", "hubert.safetensors"), ("rmvpe", "rmvpe.pt"),
                                       ("index", "bank.npy"))}
    hcfg = thubert.HubertConfig(**dict(HUBERT, classifier_proj_size=256))
    states = {"a": chip_smoke.write_rvc_pth(path["a"], TINY, "v1", seed=51),
              "b": chip_smoke.write_rvc_pth(path["b"], TINY, "v1", seed=52),
              "hubert": chip_smoke.write_hubert_safetensors(path["hubert"], hcfg, seed=53),
              "hubert_cfg": hcfg}
    with narrow_jax_rmvpe():
        rm = jrmvpe.RMVPE()
        rp = finit(lambda x: rm.init(jax.random.PRNGKey(3), x), jnp.zeros((1, 16000)), seed=54)
    states["rmvpe"] = weights.rmvpe_state_dict(rp)
    torch.save({k: torch.tensor(v) for k, v in states["rmvpe"].items()}, path["rmvpe"])
    bank = np.random.default_rng(55).standard_normal((200, 256)).astype(np.float32)
    np.save(path["index"], bank)
    return path, states, bank


@pytest.fixture
def narrow_rmvpe(monkeypatch):
    monkeypatch.setattr(trmvpe, "RMVPE", functools.partial(trmvpe.RMVPE, **NARROW_RMVPE))
    with narrow_jax_rmvpe():
        yield


def pitch_params(path: dict, **kw) -> dict:
    (pp,) = nodes.PitchExtractionParamsNode().load(**{
        "f0_method": "rmvpe", "f0_autotune": False, "merge_type": "median", "index_rate": 0.75,
        "filter_radius": 3, "resample_sr": 0, "rms_mix_rate": 0.25, "protect": 0.33,
        "crepe_hop_length": 160, "rmvpe_path": path["rmvpe"], **kw})
    return pp


def loaded(mod, path: dict, voice: str):
    (model,) = mod.RVCModelLoaderNode().load(path[voice], path["index"])
    (hubert,) = mod.HubertLoaderNode().load(path["hubert"])
    return model, hubert


def clip_audio() -> dict:
    return nodes.to_audio_dict(speech(1.2, 25.0), 16000)


def test_rvc_node_is_the_converter_and_caches(model_files, narrow_rmvpe, monkeypatch):
    """RVCNode's output is VoiceConverter.convert's on the file's arrays
    (the same weights, draws and math: equal) as float32 / 32768. A repeated
    call is a cache hit; a second clip reuses the converter (one build); the
    other voice on the same clip gives another output (its key holds the
    model's), where JAX's node returns the first voice's (its key omits
    the model, ``rvc_tpu/graph/nodes.py:443``)."""
    path, states, bank = model_files
    rm = trmvpe.RMVPE()
    from rvc_tpu_torch.models.layers import load_numpy_state_dict

    load_numpy_state_dict(rm.model, states["rmvpe"])
    version_hubert = thubert.HubertEncoder(states["hubert_cfg"], "v1")
    used = version_hubert.state_dict()
    load_numpy_state_dict(version_hubert, {k: v for k, v in states["hubert"].items() if k in used})
    vc = tconv.VoiceConverter(
        load_numpy_state_dict(tconv.Synthesizer(**TINY), states["a"]), TINY, version_hubert,
        tconv.PitchExtractor(rm), index_bank=bank, device="cpu")
    settings = tconv.ConvertSettings(f0_up_key=2, index_rate=0.75, protect=0.33)
    want, want_sr = vc.convert(speech(1.2, 25.0), 16000, settings)

    builds, converts = [], []
    init, convert = tconv.VoiceConverter.__init__, tconv.VoiceConverter.convert
    monkeypatch.setattr(tconv.VoiceConverter, "__init__",
                        lambda self, *a, **k: builds.append(1) or init(self, *a, **k))
    monkeypatch.setattr(tconv.VoiceConverter, "convert",
                        lambda self, *a, **k: converts.append(1) or convert(self, *a, **k))
    model, hubert = loaded(nodes, path, "a")
    pp = pitch_params(path)
    (got,) = nodes.RVCNode().convert(clip_audio(), model, hubert, 2, pp)
    assert got["sample_rate"] == want_sr == 16000 and got["waveform"].dtype == np.float32
    np.testing.assert_array_equal(got["waveform"], (want.astype(np.float32) / 32768.0)[None, None])
    assert np.abs(want).max() > 1000
    (again,) = nodes.RVCNode().convert(clip_audio(), model, hubert, 2, pp)
    assert again is got and converts == [1]
    other_clip = nodes.to_audio_dict(speech(1.0, 40.0), 16000)
    nodes.RVCNode().convert(other_clip, model, hubert, 2, pp)
    assert builds == [1] and converts == [1, 1]
    (other,) = nodes.RVCNode().convert(clip_audio(), loaded(nodes, path, "b")[0], hubert, 2, pp)
    assert builds == [1, 1] and np.abs(i16(other) - i16(got)).max() > 1000

    ja, jh = loaded(jnodes, path, "a")
    jb, _ = loaded(jnodes, path, "b")
    (first,) = jnodes.RVCNode().convert(clip_audio(), ja, jh, 2, pp)
    (second,) = jnodes.RVCNode().convert(clip_audio(), jb, jh, 2, pp)
    assert second is first  # JAX's collision


def test_rvc_node_matches_jax(model_files, narrow_rmvpe, monkeypatch):
    """RVCNode on the same files within 2 LSB of JAX's node, with RMVPE f0,
    the file bank at index_rate 0.75, protect, the RMS mix and a stereo
    44.1 kHz input (downmixed, remixed to 16 kHz); the port's converter
    takes the JAX run's draws (eps, the sine source's phase and noise)."""
    path, _, _ = model_files
    mono = signal.resample_poly(speech(1.2, 25.0), 441, 160).astype(np.float32)
    audio = nodes.to_audio_dict(np.stack([mono, 0.6 * np.roll(mono, 200)]), 44100)
    pp = pitch_params(path, f0_method="rmvpe", rms_mix_rate=0.5)
    ja, jh = loaded(jnodes, path, "a")
    with recorded_draws(monkeypatch) as draws:
        (ref,) = jnodes.RVCNode().convert(audio, ja, jh, -3, pp, sid=1)
    jax.effects_barrier()
    eps, rand_ini, noise = draws
    replay = dict(eps=torch.from_numpy(eps).transpose(1, 2), rand_ini=torch.from_numpy(rand_ini),
                  noise=torch.from_numpy(noise))
    monkeypatch.setattr(tconv.VoiceConverter, "draws", lambda self, n, frames: replay)
    (got,) = nodes.RVCNode().convert(audio, *loaded(nodes, path, "a"), -3, pp, sid=1)
    assert got["sample_rate"] == ref["sample_rate"] == 16000
    assert got["waveform"].shape == ref["waveform"].shape
    d = np.abs(i16(got) - i16(ref)).max()
    print(f"RVCNode against JAX's: max |diff| {d} LSB, peak {np.abs(i16(ref)).max()}")
    assert np.abs(i16(ref)).max() > 1000 and d <= LSB


# ---- the dataset nodes ----

def _clips(root, n: int = 1) -> str:
    """``n`` files of voiced bursts at 40 kHz (``test_torch_preprocess._source``)."""
    from test_torch_preprocess import _source

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(61)
    for i in range(n):
        wavfile.write(os.path.join(root, f"in{i}.wav"), 40000, _source([2.2], 1.5 * i, rng))
    return str(root)


def test_dataset_nodes_pass_what_jax_passes(tmp_path, model_files, monkeypatch):
    """ProcessDataset, TrainModel and TrainIndex on both sides with the
    pipelines' entry points captured (no training or extraction runs):
    the same f0 method and version to extract_features (the port's HuBERT
    encoder of that version holding the file's weights), the same dataset
    payload, the same config and run config to train_model (the port's
    run on the nodes' device), and the same index file. ``use_multiscale``
    and ``use_balancer`` are dropped on both sides
    (``rvc_tpu/graph/nodes.py:560-561``): the run keeps the multi-scale
    mel off and the balancer on."""
    path, states, _ = model_files
    src = _clips(tmp_path / "src")
    calls = {}

    def capture(side, name, result=None):
        def fn(*args, **kwargs):
            calls[(side, name)] = (args, kwargs)
            return result
        return fn

    def extract(side):
        def fn(exp_dir, *args, **kwargs):  # the directories the real one makes, left empty
            capture(side, "extract")(exp_dir, *args, **kwargs)
            for sub in ("2a_f0", "2b-f0nsf", "3_feature256"):
                os.makedirs(os.path.join(exp_dir, sub), exist_ok=True)
        return fn

    monkeypatch.setattr(jpre, "extract_features", extract("j"))
    monkeypatch.setattr(tpre, "extract_features", extract("t"))
    datasets = {}
    for side, m in (("t", nodes), ("j", jnodes)):
        (hubert,) = m.HubertLoaderNode().load(path["hubert"])
        (datasets[side],) = m.ProcessDatasetNode().process(
            src, str(tmp_path / side), "32k", hubert, "dio", "v1")
    (targs, tkw), (jargs, jkw) = calls[("t", "extract")], calls[("j", "extract")]
    assert targs[0] == str(tmp_path / "t") and jargs[0] == str(tmp_path / "j")
    assert tkw == dict(jkw, device="cpu") == dict(f0_method="dio", version="v1", device="cpu")
    encoder = targs[1]
    assert isinstance(encoder, thubert.HubertEncoder) and encoder.version == "v1"
    assert dataclasses.asdict(encoder.cfg) == dataclasses.asdict(jargs[2])
    for k, v in encoder.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), states["hubert"][k])
    t, j = datasets["t"], datasets["j"]
    assert {k: v for k, v in t.items() if k not in ("exp_dir", "filelist")} == {
        k: v for k, v in j.items() if k not in ("exp_dir", "filelist")}
    for sub in ("0_gt_wavs", "1_16k_wavs"):
        names = sorted(os.listdir(os.path.join(t["exp_dir"], sub)))
        assert names and names == sorted(os.listdir(os.path.join(j["exp_dir"], sub)))
    rows = [open(d["filelist"]).read().replace(d["exp_dir"], "EXP").splitlines()
            for d in (t, j)]
    assert rows[0] == rows[1]

    monkeypatch.setattr(jtrain, "train_model", capture("j", "train", "j.pth"))
    monkeypatch.setattr(ttrain, "train_model", capture("t", "train", "t.pth"))
    params = nodes.TrainParamsNode().init(batch_size=6, c_gp=1.5, c_mel=40.0, learning_rate=2e-4,
                                          use_multiscale=True, use_balancer=True,
                                          not_a_field=1)[0]
    for side, m in (("t", nodes), ("j", jnodes)):
        out = m.TrainModelNode().train(datasets[side], "voice", epochs=3, batch_size=2,
                                       save_every_epoch=2, train_params=params)
        assert out == (f"{side}.pth",)
    (tcfg, trun), _ = calls[("t", "train")]
    (jcfg, jrun), _ = calls[("j", "train")]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.train.batch_size == 6 and tcfg.train.c_gp == 1.5 and tcfg.model.version == "v1"
    trun, jrun = dataclasses.asdict(trun), dataclasses.asdict(jrun)
    assert trun.pop("device") == "cpu"
    for run, d in ((trun, t), (jrun, j)):
        assert run.pop("model_dir") == os.path.join(d["exp_dir"], "voice")
        assert run.pop("filelist") == d["filelist"]
    assert trun == jrun and trun["use_multiscale"] is False and trun["balancer_active"] is True

    feats = np.random.default_rng(62).standard_normal((40, 256)).astype(np.float32)
    for d in (t, j):
        os.makedirs(os.path.join(d["exp_dir"], "3_feature256"), exist_ok=True)
        for i in range(2):
            np.save(os.path.join(d["exp_dir"], "3_feature256", f"dio,{i}.npy"),
                    feats[20 * i: 20 * i + 20])
    (tout,), (jout,) = nodes.TrainIndexNode().train_index(t), jnodes.TrainIndexNode().train_index(j)
    assert tout == os.path.join(t["exp_dir"], "index.npy")
    np.testing.assert_array_equal(np.load(tout), np.load(jout))


def test_nodes_train_and_convert_on_the_cpu(tmp_path, model_files, monkeypatch):
    """The port's nodes from clips to a converted clip, on the CPU: Load
    HuBERT -> ProcessDataset (dio) -> TrainModel (the tiny config in place
    of the preset, 1 epoch of 1 step) -> TrainIndex -> LoadRVCModel with
    the exported .pth and the index -> Convert (dio) -> PreviewAudio."""
    path, _, _ = model_files
    cfg = dataclasses.replace(tiny_config(), model=dataclasses.replace(
        tiny_config().model, version="v1"))
    monkeypatch.setattr(nodes, "preset", lambda name: cfg)
    steps = []
    step = ttrain.Trainer.step
    monkeypatch.setattr(ttrain.Trainer, "step",
                        lambda self, *a, **k: steps.append(1) or step(self, *a, **k))
    (hubert,) = nodes.HubertLoaderNode().load(path["hubert"])
    (dataset,) = nodes.ProcessDatasetNode().process(_clips(tmp_path / "src"),
                                                    str(tmp_path / "exp"), "32k", hubert,
                                                    "dio", "v1")
    (pth,) = nodes.TrainModelNode().train(dataset, "voice", epochs=1, batch_size=2,
                                          save_every_epoch=1)
    assert steps == [1] and os.path.isfile(pth)
    (index,) = nodes.TrainIndexNode().train_index(dataset)
    (model,) = nodes.RVCModelLoaderNode().load(pth, index)
    assert model()["index_bank"].shape[1] == 256 and model()["meta"]["version"] == "v1"
    (out,) = nodes.RVCNode().convert(clip_audio(), model, hubert, 0,
                                     pitch_params(path, f0_method="dio", rmvpe_path=""))
    assert out["sample_rate"] == 32000 and np.isfinite(out["waveform"]).all()
    n = out["waveform"].shape[-1]  # the input's 10 ms frames at the model's rate
    assert abs(n / 32000 - 1.2) < 0.03 and np.abs(out["waveform"]).max() > 0
    saved = nodes.PreviewAudioNode().save_audio(out, "voice", "wav",
                                                output_dir=str(tmp_path / "out"))
    back, sr = load_input_audio(saved["result"][0])
    assert sr == 32000 and back.shape == (n,)
