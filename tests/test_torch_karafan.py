"""The port's Karafan recipe (``pipelines/karafan.py``, ``ops/karafan_utils.py``)
and phase vocoder (``ops/stretch.py``) against the JAX package's on the
CPU. The recipe and its utilities are numpy on the host on both sides, so
they are held to equality; the extractors are the same deterministic numpy
functions on both sides (filters, gains, a sign-independent noise), as
``tests/test_karafan.py`` builds them. The stretch is held by relative L2
over the waveform: the port's STFT is an FFT where JAX multiplies by a
DFT basis, and bins of near-zero magnitude take an arbitrary phase."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes, one_thread  # noqa: F401
from rvc_tpu.ops import karafan_utils as JKU
from rvc_tpu.ops import stretch as jstretch
from rvc_tpu.pipelines import karafan as jk
from rvc_tpu_torch.ops import karafan_utils as TKU
from rvc_tpu_torch.ops import stretch as tstretch
from rvc_tpu_torch.pipelines import karafan as tk

pytestmark = pytest.mark.usefixtures("one_thread")

SR = 44100
# relative L2 over the waveform. JAX's float32 phase advances (up to ~1608
# rad a frame at hop 512) and their running sum (~1e5 rad within a second,
# where float32's spacing is ~8e-3 rad) drift from the exact phases; the
# port does that arithmetic in float64, so the two differ by JAX's own
# rounding (4.5e-4 from the float64 result at rate 0.5 on 1 s), and the
# port must lie as close to that result as JAX
STRETCH_L2 = 2e-3


def song(seconds: float, seed: int = 0) -> np.ndarray:
    """(2, T) at 44.1 kHz: a 440 Hz "voice" with an 18 kHz partial over a
    110 Hz "instrumental", a quiet second, seeded noise."""
    t = np.arange(int(seconds * SR)) / SR
    rng = np.random.default_rng(seed)
    voice = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * np.sin(2 * np.pi * 18000 * t)
    voice[(t > 0.5) & (t < 1.6)] *= 1e-4
    music = 0.3 * np.sin(2 * np.pi * 110 * t + 0.3)
    return np.stack([voice + music + 0.01 * rng.standard_normal(t.size),
                     0.8 * voice + music + 0.01 * rng.standard_normal(t.size)]
                    ).astype(np.float32)


# extractors (2, T) -> (2, T): the same numpy functions on both sides
def vocal_model(m):  # band-limited at 14.7 kHz, as a Kim-style vocal model
    return 0.9 * JKU.pass_filter("highpass", 300, JKU.pass_filter("lowpass", 14700, m, SR, 8),
                                 SR, 8)


def music_model(m):
    return 0.8 * JKU.pass_filter("lowpass", 250, m, SR, 8) + 0.01


def bleed_model(m):
    return 0.1 * m


# ---- ops/karafan_utils.py ----

def test_karafan_utils_match_jax():
    x = song(2.0)
    y = song(2.0, seed=1)[:, : SR + 777]
    cases = {
        "normalize": lambda KU: KU.normalize(x, -1.0),
        "silent": lambda KU: KU.silent(x, SR, -50.0),
        "pass_filter low": lambda KU: KU.pass_filter("lowpass", 16000, x, SR, 8),
        "pass_filter high order 100": lambda KU: KU.pass_filter("highpass", 18, x, SR, 100),
        "pass_filter at Nyquist": lambda KU: KU.pass_filter("lowpass", 30000, x, SR, 1),
        "resample_l": lambda KU: KU.resample_l(x, SR, 48000),
        "srs_shift": lambda KU: KU.srs_shift(KU.srs_shift(x, "DOWN", 22050, 15510), "UP",
                                             22050, 15510),
        "linkwitz_riley": lambda KU: KU.linkwitz_riley("highpass", 16000, x, SR, 12),
        "stft_l": lambda KU: KU.stft_l(x),
        "istft_l": lambda KU: KU.istft_l(KU.stft_l(x)),
        "ensemble max": lambda KU: KU.make_ensemble("Max", [x, y, 0.5 * x]),
        "ensemble min": lambda KU: KU.make_ensemble("Min", [x, y]),
        "ensemble average": lambda KU: KU.make_ensemble("Average", [x, y]),
        "sdr": lambda KU: KU.sdr(x, y),
    }
    for name, f in cases.items():
        got, ref = f(TKU), f(JKU)
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


# ---- pipelines/karafan.py ----

@pytest.mark.parametrize("kind,cut_off,denoise", [("vocal", 14700.0, True),
                                                  ("music", 14700.0, True),
                                                  ("bleed", 0.0, False)])
def test_extract_with_model_matches_jax(kind, cut_off, denoise):
    """The 2-pass denoise, the high SRS pass (vocals: ensemble-max; music:
    the 16 kHz Linkwitz-Riley blend) and the vocal models' low SRS pass,
    with bigshifts 2 and the model's compensation."""
    mix = song(2.5)
    got, ref = (mod.extract_with_model(
        kind, mix, mod.KarafanModel(vocal_model, name="kim", cut_off=cut_off,
                                    compensation=1.0093),
        bigshifts=2, bigshifts_srs=1, denoise=denoise) for mod in (tk, jk))
    np.testing.assert_array_equal(got, ref)


def test_karafan_pipeline_stages_match_jax():
    """speed_preset("Fast") with every stage's models, infra-bass and the
    silence gate: every stage of ``stages`` and the int16 stems equal."""
    mix = song(2.5)
    outs, stages = [], []
    for mod in (tk, jk):
        pipe = mod.KarafanPipeline(
            music=[mod.KarafanModel(music_model, name="mdx", cut_off=14700)],
            vocal=[mod.KarafanModel(vocal_model, name="kim", cut_off=14700), bleed_model],
            bleed_music=[bleed_model], bleed_vocal=[bleed_model], remove_music=[bleed_model],
            config=mod.speed_preset("Fast", infra_bass=True, silent_db=-40.0))
        st = {}
        outs.append(pipe.separate(mix, SR, stages=st))
        stages.append(st)
    assert stages[0].keys() == stages[1].keys()
    for name in stages[1]:
        np.testing.assert_array_equal(stages[0][name], stages[1][name], err_msg=name)
    for stem in ("vocals", "instrumentals"):
        assert outs[0][stem][1] == outs[1][stem][1] == SR
        np.testing.assert_array_equal(outs[0][stem][0], outs[1][stem][0])
    np.testing.assert_array_equal(outs[0]["input_audio"][0], outs[1]["input_audio"][0])


def test_karafan_resamples_mono_and_needs_a_vocal_model():
    mono = song(2.0)[0, ::2].copy()  # 22.05 kHz
    got, ref = (mod.KarafanPipeline(vocal=[bleed_model]).separate(mono, 22050)
                for mod in (tk, jk))
    np.testing.assert_array_equal(got["vocals"][0], ref["vocals"][0])
    with pytest.raises(ValueError, match="at least one vocal extractor"):
        tk.KarafanPipeline(music=[music_model]).separate(mono, 22050)


def test_stem_cache(tmp_path):
    """The second run serves every stem from the cache (the same files as
    JAX's pipeline writes, by name); other settings extract again."""
    mix = song(1.0)
    calls = {"n": 0}

    def counted(m):
        calls["n"] += 1
        return 0.5 * m

    cfg = dict(high_pass=0, low_pass=22050, normalize_db=0, denoise=False)
    pipe = tk.KarafanPipeline(vocal=[tk.KarafanModel(counted, name="v")],
                              config=tk.KarafanConfig(cache_dir=str(tmp_path / "port"), **cfg))
    first = pipe.separate(mix, SR)
    n = calls["n"]
    assert n >= 1
    np.testing.assert_array_equal(pipe.separate(mix, SR)["vocals"][0], first["vocals"][0])
    assert calls["n"] == n
    pipe.config.denoise = True
    pipe.separate(mix, SR)
    assert calls["n"] > n
    jk.KarafanPipeline(vocal=[jk.KarafanModel(counted, name="v")],
                       config=jk.KarafanConfig(cache_dir=str(tmp_path / "jax"), **cfg)
                       ).separate(mix, SR)
    assert set(os.listdir(tmp_path / "jax")) <= set(os.listdir(tmp_path / "port"))


def test_bigshifts_and_presets_match_jax():
    mix = song(4.0)
    got = tk.bigshifts_demix(mix, vocal_model, 3)
    np.testing.assert_array_equal(got, jk.bigshifts_demix(mix, vocal_model, 3))
    assert tk.SPEED_PRESETS == jk.SPEED_PRESETS
    for name in tk.SPEED_PRESETS:
        assert vars(tk.speed_preset(name)) == vars(jk.speed_preset(name))
    with pytest.raises(ValueError, match="unknown speed"):
        tk.speed_preset("Turbo")


# ---- ops/stretch.py ----

def assert_stretch_close(got: torch.Tensor, ref: np.ndarray, exact: torch.Tensor,
                         label: str) -> None:
    """``got`` (the port) within STRETCH_L2 of ``ref`` (JAX), and as close as
    JAX to ``exact``, the same function evaluated in float64."""
    err, own = rel_l2(got.numpy(), ref), rel_l2(ref, exact.numpy())
    port = rel_l2(got.numpy(), exact.numpy())
    print(f"{label}: relative L2 to JAX {err:.3g}; to float64, the port {port:.3g}, JAX {own:.3g}")
    assert got.shape == ref.shape and err <= STRETCH_L2 and port <= 1.05 * own + 1e-6


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def tone(sr: int, seconds: float, batched: bool) -> np.ndarray:
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(5)
    y = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 660 * t)
         + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    return np.stack([y, 0.7 * y[::-1]]) if batched else y


@pytest.mark.parametrize("rate,batched", [(2.0, False), (0.5, True), (1.25, True)])
def test_time_stretch_matches_jax(rate, batched):
    y = tone(16000, 1.0, batched)
    ref = np.asarray(jstretch.time_stretch(jnp.asarray(y), 16000, rate))
    got = tstretch.time_stretch(torch.from_numpy(y), 16000, rate)
    assert got.shape[-1] == round(y.shape[-1] / rate)
    exact = tstretch.time_stretch(torch.from_numpy(y).double(), 16000, rate)
    assert_stretch_close(got, ref, exact, f"time_stretch rate {rate}")


@pytest.mark.parametrize("n_steps,sr", [(12.0, 16000), (-5.0, 44100), (0.0, 16000)])
def test_pitch_shift_matches_jax(n_steps, sr):
    y = tone(sr, 1.0, batched=sr == 44100)
    ref = np.asarray(jstretch.pitch_shift(jnp.asarray(y), sr, n_steps))
    got = tstretch.pitch_shift(torch.from_numpy(y), sr, n_steps)
    assert got.shape == y.shape
    if n_steps == 0:
        np.testing.assert_array_equal(got.numpy(), ref)
        return
    # the stretch in float64 (the resampler sums in float32 either way)
    exact = tstretch.pitch_shift(torch.from_numpy(y).double(), sr, n_steps)
    assert_stretch_close(got, ref, exact, f"pitch_shift {n_steps} at {sr}")
