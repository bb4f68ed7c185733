"""The host-side helpers of the port's node layer against the JAX package's,
on the CPU: ``io.audio``'s codecs, ``merge_audio``, ``autotune_f0``,
``hz_to_mel`` and ``AudioProcessor``; ``utils``' hashes and namespace;
``i18n``; the downloader (its ``urlopen`` replaced: no network); the
utility nodes; ``utils.profiling``; ``bench.parity``. Equal results are
asked for everywhere but the mel distance (float32 STFTs in another
order)."""
import dataclasses
import io
import os
import time
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes  # noqa: F401
from rvc_tpu import i18n as ji18n
from rvc_tpu import utils as jutils
from rvc_tpu.bench import parity as jparity
from rvc_tpu.graph import downloader as jdl
from rvc_tpu.graph import utility_nodes as jun
from rvc_tpu.io import audio as jaudio
from rvc_tpu.utils import profiling as jprof
from rvc_tpu_torch import i18n as ti18n
from rvc_tpu_torch import utils as tutils
from rvc_tpu_torch.bench import parity as tparity
from rvc_tpu_torch.graph import downloader as tdl
from rvc_tpu_torch.graph import utility_nodes as tun
from rvc_tpu_torch.io import audio as taudio
from rvc_tpu_torch.utils import profiling as tprof


def clip(seconds: float = 1.0, sr: int = 16000, seed: int = 0) -> np.ndarray:
    """A tone with seeded noise, a click every 0.1 s and a silent second
    half: every branch of AudioProcessor has work."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.standard_normal(t.size)
    x[:: sr // 10] += 0.9
    x[t.size // 2:] *= 1e-4
    return x.astype(np.float32)


@dataclasses.dataclass
class Settings:
    x: int = 1


HASH_ARGS = [  # a dataclass and an object hash by their str
    ("a", 1, 2.5, None, True),
    (np.arange(6, dtype=np.float32).reshape(2, 3), "x"),
    (sorted({"f0_method": "rmvpe", "index_rate": 0.75, "rmvpe_path": ""}.items()), 3),
    ({"b": [1, 2], "a": {"c": np.ones(3)}},),
    (Settings(), jutils.ObjectNamespace(a=np.zeros(2))),
]


@pytest.mark.parametrize("args", HASH_ARGS, ids=range(len(HASH_ARGS)))
def test_get_hash_gives_jax_digests(args):
    assert tutils.get_hash(*args) == jutils.get_hash(*args)


def test_file_hash_and_namespace_match_jax(tmp_path):
    small, big = tmp_path / "small.bin", tmp_path / "big.bin"
    rng = np.random.default_rng(1)
    small.write_bytes(rng.bytes(1000))
    big.write_bytes(rng.bytes(3000))
    for path in (small, big):
        for tail in (10000 * 1024, 512):
            assert tutils.file_hash(str(path), tail) == jutils.file_hash(str(path), tail)
    ns, jns = tutils.ObjectNamespace(a=1), jutils.ObjectNamespace(a=1)
    ns.b, jns.b = 2, 2
    del ns.a, jns.a
    assert dict(ns) == dict(jns) == {"b": 2}
    with pytest.raises(AttributeError):
        ns.a


@pytest.mark.parametrize("to_int16", [False, True])
def test_transport_codecs_match_jax(to_int16):
    mono = 1.5 * clip(0.2)  # a peak above 1: the int16 route scales it down
    stereo = np.stack([mono, 0.5 * mono])
    for x in (mono, stereo):
        data = taudio.audio_to_bytes(x, 16000, to_int16=to_int16)
        assert data == jaudio.audio_to_bytes(x, 16000, to_int16=to_int16)
        got, ref = taudio.bytes_to_audio(data), jaudio.bytes_to_audio(data)
        assert got[1] == ref[1] == 16000
        np.testing.assert_array_equal(got[0], ref[0])
    for x in (mono, stereo.astype(np.float64), (mono * 1000).astype(np.int16)):
        s = taudio.audio2str(x, 22050)
        assert s == jaudio.audio2str(x, 22050)
        back, sr = taudio.str2audio(s)
        assert sr == 22050 and back.dtype == x.dtype
        np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("kwargs", [{}, {"merge_type": "mean", "norm": True},
                                    {"to_int16": True}], ids=["median", "mean-norm", "int16"])
def test_merge_audio_matches_jax(kwargs):
    a = (np.stack([clip(0.5, 16000, 2), clip(0.5, 16000, 3)]), 16000)
    b = (clip(0.3, 44100, 4), 44100)
    for sr in (40000, None):
        got, ref = taudio.merge_audio(a, b, sr=sr, **kwargs), jaudio.merge_audio(a, b, sr=sr,
                                                                                **kwargs)
        assert got[1] == ref[1]
        np.testing.assert_array_equal(got[0], ref[0])


def test_autotune_and_hz_to_mel_match_jax():
    f0 = np.random.default_rng(5).uniform(0, 1200, (3, 50)).astype(np.float32)
    f0[0, :10] = 0.0
    for threshold in (0.0, 5.0):
        np.testing.assert_array_equal(taudio.autotune_f0(f0, threshold),
                                      jaudio.autotune_f0(f0, threshold))
    np.testing.assert_array_equal(taudio.hz_to_mel(f0), jaudio.hz_to_mel(f0))
    np.testing.assert_array_equal(taudio.AUTOTUNE_NOTES, jaudio.AUTOTUNE_NOTES)


@pytest.mark.parametrize("settings", [
    dict(),
    dict(fill_method="interpolation", sample_size=400, kernel_size=7),
    dict(normalize=False, threshold_silence=False, multiplier=1.5),
    dict(dynamic_threshold=False, silence_threshold_db=-30, normalize_threshold_db=-3),
], ids=["median", "interpolation", "clicks-only", "gate-and-normalize"])
def test_audio_processor_matches_jax(settings):
    """Both fill methods, each stage on and off: equal samples, and the same
    settings hash (the node layer's cache key)."""
    x = clip(2.0, 16000, 6)
    proc, jproc = taudio.AudioProcessor(**settings), jaudio.AudioProcessor(**settings)
    assert str(proc) == str(jproc)
    got, ref = proc((x, 16000)), jproc((x, 16000))
    assert got[1] == ref[1] == 16000
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(proc(x)[0], jproc(x)[0])  # bare samples: 44.1 kHz
    with pytest.raises(ValueError):
        taudio.AudioProcessor.replace_clicks(x, x > 0.5, "nearest")


@pytest.mark.parametrize("language", ["en_US", "es_ES", "zh_CN", "xx_YY", "auto", None])
def test_i18n_reads_the_same_maps(language):
    got, ref = ti18n.I18nAuto(language), ji18n.I18nAuto(language)
    assert got.language == ref.language and got.language_map == ref.language_map
    assert got.language_map, "the port's locale files are missing"
    for key in list(ref.language_map)[:5] + ["not a key"]:
        assert got(key) == ref(key)
    assert sorted(os.listdir(ti18n.I18N_DIR)) == sorted(os.listdir(ji18n.I18N_DIR))


class _Response(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def test_downloader_without_the_network(tmp_path, monkeypatch):
    """The catalogs equal JAX's. ``urlopen`` is replaced: a served file is
    streamed into place, an existing file is not fetched again, a failure
    leaves no partial file and returns False; ``model_downloader`` resolves
    under ``BASE_MODELS_DIR``; zips flatten as JAX's do."""
    for name in ("RVC_DOWNLOAD_LINK", "MDX_MODELS", "KARAFAN_MODELS", "VR_MODELS", "RVC_MODELS",
                 "RVC_INDEX", "BASE_MODELS", "VITS_MODELS", "PRETRAINED_MODELS_G",
                 "PRETRAINED_MODELS_D", "UVR_MODELS", "PRETRAINED_MODELS"):
        assert getattr(tdl, name) == getattr(jdl, name), name
    payload = np.random.default_rng(7).bytes(5000)
    fetched = []

    def urlopen(url):
        fetched.append(url)
        if "missing" in url:
            raise urllib.error.HTTPError(url, 404, "not found", None, None)
        return _Response(payload)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    dest = str(tmp_path / "m" / "a.pth")
    assert tdl.download_file((dest, "https://host/a.pth"), chunk_size=1024)
    assert open(dest, "rb").read() == payload and not os.path.exists(dest + ".part")
    assert tdl.download_file((dest, "https://host/a.pth")) and len(fetched) == 1
    bad = str(tmp_path / "m" / "missing.pth")
    assert not tdl.download_file((bad, "https://host/missing.pth"))
    assert not os.path.exists(bad) and not os.path.exists(bad + ".part")
    monkeypatch.setattr(tdl, "BASE_MODELS_DIR", str(tmp_path / "zoo"))
    got = tdl.model_downloader("RVC/Claire.pth")
    assert got == str(tmp_path / "zoo" / "RVC" / "Claire.pth") and fetched[-1] == (
        tdl.RVC_DOWNLOAD_LINK + "RVC/Claire.pth")
    assert tdl.model_downloader("RVC/missing.pth") is None

    zpath = str(tmp_path / "z.zip")
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.writestr("deep/dir/a.pth", b"A")
        zf.writestr("b.index", b"B")
        zf.writestr("empty/", b"")
    got = tdl.extract_zip_without_structure(zpath, str(tmp_path / "t"))
    ref = jdl.extract_zip_without_structure(zpath, str(tmp_path / "j"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref] == [
        "a.pth", "b.index"]
    assert open(got[0], "rb").read() == b"A"


def _utility_cases():
    rng = np.random.default_rng(8)
    img = rng.uniform(size=(3, 4, 4, 3)).astype(np.float32)
    lat = {"samples": rng.standard_normal((3, 4, 2, 2)).astype(np.float32),
           "noise_mask": np.ones((3, 2, 2), np.float32)}
    return {
        "RVC_TPU_Any2List": ("abc",),
        "RVC_TPU_List2Any": ([1, 2, 3],),
        "RVC_TPU_MergeImageBatches": (img, torch.from_numpy(img[:1])),
        "RVC_TPU_MergeLatentBatches": ([lat, {"samples": lat["samples"][:2]}],),
        "RVC_TPU_ImageRepeatInterleaved": (img, [0.4, 2.6], 5),
        "RVC_TPU_LatentRepeatInterleaved": (lat, [1.0, 3.0, 0.0]),
        "RVC_TPU_Math": ([1.0, 2.0], 3.0, "pow"),
        "RVC_TPU_Slice": ([1, 2, 3, 4], 1, -1),
        "RVC_TPU_Zip": ([1, 2], "ab"),
        "RVC_TPU_Sort": ([3, 1, 2], True),
    }


@pytest.mark.parametrize("key", list(_utility_cases()))
def test_utility_node_matches_jax(key):
    args = _utility_cases()[key]
    cls, jcls = tun.UTILITY_NODE_CLASS_MAPPINGS[key], jun.UTILITY_NODE_CLASS_MAPPINGS[key]
    got = getattr(cls(), cls.FUNCTION)(*args)
    ref = getattr(jcls(), jcls.FUNCTION)(*args)
    assert type(got) is type(ref) and len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(r, dict):
            assert g.keys() == r.keys()
            for k in r:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(r[k]))
        elif isinstance(r, np.ndarray):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
        else:
            assert g == r


def test_profiling_matches_jax(tmp_path):
    """StageTimer's report and JSON from the same stage times equal JAX's;
    the stage context adds time and counts; EpochRecorder's line; the
    torch.profiler trace lands in its directory."""
    stages = {"f0": 0.25, "hubert": 0.5, "synth": 1.25}
    timers = [tprof.StageTimer(), jprof.StageTimer()]
    for t in timers:
        for name, secs in stages.items():
            t.times[name] += secs
            t.counts[name] += 2
    assert timers[0].report(6.0) == timers[1].report(6.0)
    assert timers[0].to_json(6.0) == timers[1].to_json(6.0)
    assert timers[0].report() == timers[1].report()
    t = tprof.StageTimer()
    with t.stage("x"):
        time.sleep(0.01)
    assert t.counts["x"] == 1 and t.times["x"] >= 0.01
    line = tprof.EpochRecorder().record()
    assert line.startswith("[") and line.endswith("s/epoch)")
    logdir = str(tmp_path / "trace")
    with tprof.device_trace(logdir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(logdir))


def test_parity_matches_jax(tmp_path):
    """mel_distance_db of two different clips and of a clip against itself
    within 1e-3 dB of JAX's (float32 STFTs summed in another order);
    compare_wavs on two files at two rates: the same SDR, rate and length."""
    a, b = clip(1.0, 16000, 9), clip(1.2, 16000, 10)
    b[:8000] += 0.1 * a[:8000]
    got = tparity.mel_distance_db(a, b, 16000, device="cpu")
    ref = jparity.mel_distance_db(a, b, 16000)
    assert ref > 1.0 and abs(got - ref) <= 1e-3, (got, ref)
    assert tparity.mel_distance_db(a, a, 16000, device="cpu") == 0.0
    pa, pb = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    taudio.save_input_audio(pa, (a, 16000))
    taudio.save_input_audio(pb, (b[:12000], 24000))
    got, ref = tparity.compare_wavs(pa, pb, 16000, device="cpu"), jparity.compare_wavs(pa, pb)
    assert abs(got.pop("mel_distance_db") - ref.pop("mel_distance_db")) <= 1e-3
    assert got == ref

