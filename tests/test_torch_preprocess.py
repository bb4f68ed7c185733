"""The port's dataset build against the JAX package's on the CPU: the
silence slicer, ``Preprocess.run_dir``, ``extract_features`` (a tiny HuBERT
and the narrowed RMVPE on clips of unequal length), ``build_filelist`` and
``generate_mute_fixtures``."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.io import wavfile

import rvc_tpu.native as jnative
from _torch_port import (NARROW_RMVPE, finit, narrow_jax_rmvpe, no_compile_cache_writes,  # noqa: F401
                         one_thread)
from rvc_tpu.models.hubert import HubertConfig, HubertEncoder
from rvc_tpu.models.rmvpe import RMVPE
from rvc_tpu.ops import slicer as jslicer
from rvc_tpu.pipelines import preprocess as jpre
from rvc_tpu.pitch.extractor import PitchExtractor
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import hubert as thubert
from rvc_tpu_torch.models import rmvpe as trmvpe
from rvc_tpu_torch.models.layers import load_numpy_state_dict
from rvc_tpu_torch.ops import slicer as tslicer
from rvc_tpu_torch.pipelines import preprocess as tpre
from rvc_tpu_torch.pitch.extractor import PitchExtractor as TPitchExtractor
from test_torch_convert import HUBERT

pytestmark = pytest.mark.usefixtures("one_thread")

SR = 40000


def _source(seconds, offset, rng):
    """Voiced bursts at 40 kHz (harmonic tones of a gliding pitch, never near
    silence inside a burst) between silences of seeded noise at -80 dB, far
    below the slicer's -50 dB gate: no frame's RMS sits near the gate, so
    float32 and double RMS make the same cuts. (Speech has pauses near it.)"""
    parts = []
    for i, sec in enumerate(seconds):
        t = np.arange(int(sec * SR)) / SR
        f0 = 150.0 + 60.0 * np.sin(2 * np.pi * (0.3 + 0.1 * i) * t + offset)
        phase = 2 * np.pi * np.cumsum(f0) / SR
        tone = sum(np.sin(h * phase) / h for h in range(1, 6))
        parts.append(0.2 * (0.8 + 0.2 * np.sin(2 * np.pi * 2.0 * t)) * tone)
        parts.append(1e-4 * rng.standard_normal(int(0.9 * SR)))
    return np.concatenate(parts).astype(np.float32)


def test_slicer_matches_jax(rng):
    """The same cuts, sample for sample, as the JAX slicer's, on both of its
    RMS routes: the native library's float32 RMS summed in double with its
    C++ scan (when the library builds) and its numpy fallback; the route
    taken is printed."""
    x = _source([2.5, 0.8, 4.0], 3.0, rng)
    got = tslicer.Slicer(sr=SR, threshold=-50, min_length=1500, min_interval=400,
                         hop_size=15, max_sil_kept=500).slice(x)
    assert len(got) >= 3
    routes = ["numpy"] + (["native"] if jnative.lib() is not None else [])
    for route in routes:
        with pytest.MonkeyPatch.context() as mp:
            if route == "numpy":
                mp.setattr(jnative, "lib", lambda: None)
            ref = jslicer.Slicer(sr=SR, threshold=-50, min_length=1500, min_interval=400,
                                 hop_size=15, max_sil_kept=500).slice(x)
        print(f"JAX slicer route {route}: {len(ref)} chunks")
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Two source files cut by the JAX and by the port's Preprocess into
    two experiment directories."""
    root = tmp_path_factory.mktemp("pre")
    src = root / "src"
    src.mkdir()
    rng = np.random.default_rng(5)
    for i, secs in enumerate(([4.1, 2.2], [3.6, 1.3])):
        wavfile.write(str(src / f"in{i}.wav"), SR, _source(secs, 10.0 + 20 * i, rng))
    out = {}
    for key, cls in (("jax", jpre.Preprocess), ("port", tpre.Preprocess)):
        out[key] = str(root / key)
        out[f"n_{key}"] = cls(SR, out[key]).run_dir(str(src))
    return out


def _wavs(exp, sub):
    d = os.path.join(exp, sub)
    return {n: wavfile.read(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def test_preprocess_run_dir_matches_jax(dirs):
    """The same clip count and file names; the target-rate clips equal, the
    16 kHz ones within test_torch_audio.py's resampling bar (1e-5)."""
    assert dirs["n_port"] == dirs["n_jax"] >= 6
    for sub, atol in (("0_gt_wavs", 0.0), ("1_16k_wavs", 1e-5)):
        got, ref = _wavs(dirs["port"], sub), _wavs(dirs["jax"], sub)
        assert got.keys() == ref.keys() and len(got) >= 6
        for n in ref:
            assert got[n][0] == ref[n][0] == (SR if sub == "0_gt_wavs" else 16000)
            assert got[n][1].dtype == ref[n][1].dtype == np.float32
            np.testing.assert_allclose(got[n][1], ref[n][1], atol=atol, rtol=0, err_msg=n)


@pytest.fixture(scope="module")
def extracted(dirs):
    """extract_features on both directories (batches of 4 clips sorted by
    length, padded to whole seconds), the same weights on both sides."""
    hcfg = HubertConfig(**HUBERT)
    hub = HubertEncoder(hcfg)
    hp = finit(lambda x: hub.init(jax.random.PRNGKey(2), x, output_layer=12),
               jnp.zeros((1, 3200)), seed=31)
    with narrow_jax_rmvpe():
        rm = RMVPE()
        rp = finit(lambda x: rm.init(jax.random.PRNGKey(3), x), jnp.zeros((1, 16000)), seed=32)
        n_jax = jpre.extract_features(dirs["jax"], hp, hcfg, pitch=PitchExtractor(rmvpe_params=rp),
                                      f0_method="rmvpe", version="v2", batch_size=4)
    rmvpe = trmvpe.RMVPE(**NARROW_RMVPE)
    load_numpy_state_dict(rmvpe.model, weights.rmvpe_state_dict(rp))
    hubert = tpre.hubert_from_state(weights.hubert_state_dict(hp), thubert.HubertConfig(**HUBERT),
                                    "v2", device="cpu")
    n_port = tpre.extract_features(dirs["port"], hubert, TPitchExtractor(rmvpe),
                                   f0_method="rmvpe", version="v2", batch_size=4, device="cpu")
    assert tpre.extract_features(dirs["port"], hubert, TPitchExtractor(rmvpe),
                                 device="cpu") == 0  # every clip done already
    return n_jax, n_port


def test_extract_features_matches_jax(dirs, extracted):
    """Features within test_torch_hubert_rmvpe.py's 1e-4; f0 within its
    rtol 1e-5 with no frame flipped (voicing or bin; the share is printed);
    the coarse bins equal; the same file names, shapes and dtypes."""
    n_jax, n_port = extracted
    assert n_port == n_jax == dirs["n_jax"]
    lens = {len(v[1]) for v in _wavs(dirs["port"], "1_16k_wavs").values()}
    assert len({int(np.ceil(n / 16000)) for n in lens}) >= 2  # clips padded differently
    flipped = 0
    for sub in ("3_feature768", "2a_f0", "2b-f0nsf"):
        names = sorted(os.listdir(os.path.join(dirs["jax"], sub)))
        assert names == sorted(os.listdir(os.path.join(dirs["port"], sub)))
        assert names and all(n.startswith("rmvpe,") for n in names)
        for n in names:
            ref = np.load(os.path.join(dirs["jax"], sub, n))
            got = np.load(os.path.join(dirs["port"], sub, n))
            assert got.shape == ref.shape and got.dtype == ref.dtype, (sub, n)
            if sub == "3_feature768":
                np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0, err_msg=n)
            elif sub == "2a_f0":
                np.testing.assert_array_equal(got, ref, err_msg=n)
            else:
                flipped += int(np.sum(np.abs(got - ref) > 1e-2))
                np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=n)
    print(f"f0 frames flipped: {flipped}")
    assert flipped == 0


def test_filelist_and_mute_fixtures_match_jax(dirs, extracted, tmp_path):
    """generate_mute_fixtures writes the same files; build_filelist the same
    text (its rows shuffled with default_rng(1234)) once the directory
    names are mapped, with and without f0."""
    for key, mod in (("jax", jpre), ("port", tpre)):
        mod.generate_mute_fixtures(os.path.join(dirs[key], "mute"), SR, "v2", feat_dim=32)
    for dirpath, _, files in os.walk(os.path.join(dirs["jax"], "mute")):
        for f in files:
            a = os.path.join(dirpath, f)
            b = a.replace(dirs["jax"], dirs["port"])
            if f.endswith(".wav"):
                assert wavfile.read(a)[1].tobytes() == wavfile.read(b)[1].tobytes()
            else:
                ra, rb = np.load(a), np.load(b)
                assert ra.dtype == rb.dtype
                np.testing.assert_array_equal(ra, rb)
    for if_f0 in (True, False):
        texts = {}
        for key, mod in (("jax", jpre), ("port", tpre)):
            path = mod.build_filelist(dirs[key], SR, "v2", if_f0=if_f0,
                                      mute_dir=os.path.join(dirs[key], "mute"))
            with open(path) as f:
                texts[key] = f.read()
        assert texts["port"] == texts["jax"].replace(dirs["jax"], dirs["port"])
        assert texts["port"].count("mute") >= 2 * (4 if if_f0 else 2)
    shutil.rmtree(os.path.join(dirs["port"], "mute"))


def test_extract_features_with_pm_matches_jax(dirs, tmp_path):
    """A method that needs no weights (pm) with no pitch model given on
    either side (JAX: its default PitchExtractor; the port: one without
    weights), on the port's 16 kHz clips: the same coarse bins and voicing,
    and at least 99% of the voiced frames within 1e-4 relative
    (tests/test_torch_pitch_methods.py's bars for pm on speech: its parabolic
    step divides by the ACF's curvature, which amplifies float32 rounding
    where the peak is flat)."""
    hcfg = HubertConfig(**HUBERT)
    hub = HubertEncoder(hcfg)
    hp = finit(lambda x: hub.init(jax.random.PRNGKey(2), x, output_layer=12),
               jnp.zeros((1, 3200)), seed=33)
    exp = {k: str(tmp_path / k) for k in ("jax", "port")}
    for d in exp.values():
        shutil.copytree(os.path.join(dirs["port"], "1_16k_wavs"), os.path.join(d, "1_16k_wavs"))
    n_jax = jpre.extract_features(exp["jax"], hp, hcfg, f0_method="pm", version="v2",
                                  batch_size=4)
    hubert = tpre.hubert_from_state(weights.hubert_state_dict(hp), thubert.HubertConfig(**HUBERT),
                                    "v2", device="cpu")
    n_port = tpre.extract_features(exp["port"], hubert, f0_method="pm", version="v2",
                                   batch_size=4, device="cpu")
    assert n_port == n_jax >= 6
    voiced = close = 0
    for sub in ("2a_f0", "2b-f0nsf"):
        names = sorted(os.listdir(os.path.join(exp["jax"], sub)))
        assert names == sorted(os.listdir(os.path.join(exp["port"], sub)))
        assert all(n.startswith("pm,") for n in names)
        for n in names:
            ref = np.load(os.path.join(exp["jax"], sub, n))
            got = np.load(os.path.join(exp["port"], sub, n))
            assert got.shape == ref.shape and got.dtype == ref.dtype, (sub, n)
            if sub == "2a_f0":
                np.testing.assert_array_equal(got, ref, err_msg=n)
            else:
                np.testing.assert_array_equal(got > 0, ref > 0, err_msg=n)
                v = ref > 0
                voiced += int(v.sum())
                close += int(np.sum(np.abs(got[v] - ref[v]) <= 1e-4 * ref[v]))
    print(f"pm: {close} of {voiced} voiced frames within 1e-4")
    assert voiced > 100 and close >= 0.99 * voiced
