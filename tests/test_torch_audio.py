"""The port's audio I/O (``io.audio``) and device resampler
(``ops.resample``) against the JAX package's and scipy's, on the CPU."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal
from scipy.io import wavfile

from _torch_port import no_compile_cache_writes  # noqa: F401
from rvc_tpu.io import audio as jaudio
from rvc_tpu.ops import resample as jresample
from rvc_tpu_torch.io import audio as taudio
from rvc_tpu_torch.ops import resample as tresample

RATES = [(48000, 44100), (40000, 16000), (44100, 16000)]


@pytest.mark.parametrize("rates", RATES, ids=lambda r: f"{r[0]}-{r[1]}")
def test_resample_matches_scipy_and_jax(rates):
    """The polyphase conv against scipy.signal.resample_poly (float64) and
    against the JAX package's zero-stuffing conv (float32, HIGHEST), on two
    rows of 0.1 s of unit-variance noise plus a short row. Bar: 1e-5
    absolute (both are float32 sums of up to 3201 taps, ~1e-6 apart from
    scipy's float64), and the lengths equal."""
    src, dst = rates
    rng = np.random.default_rng(src // 100 + dst)
    g = math.gcd(src, dst)
    for n in (src // 10, 37):
        x = rng.standard_normal((2, n)).astype(np.float32)
        ref = signal.resample_poly(x.astype(np.float64), dst // g, src // g, axis=-1)
        got = tresample.resample(torch.from_numpy(x), src, dst).numpy()
        jax_out = np.asarray(jax.jit(lambda a: jresample.resample(a, src, dst))(jnp.asarray(x)))
        assert got.shape == ref.shape == jax_out.shape
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, jax_out, atol=1e-5, rtol=0)


def test_polyphase_bank_is_the_full_rate_filter():
    """Each output channel's taps are scipy's filter read at that channel's
    phase: rebuilding the zero-stuffed convolution from the bank gives
    resample_poly's output exactly (float64 rounding)."""
    up, down = 3, 7
    W, t0 = tresample.polyphase_bank(up, down)
    x = np.random.default_rng(0).standard_normal(50)
    ref = signal.resample_poly(x, up, down)
    xp = np.concatenate([np.zeros(max(0, -t0)), x, np.zeros(400)])
    got = [np.dot(xp[a * down + t0 + max(0, -t0): a * down + t0 + max(0, -t0) + W.shape[2]],
                  W[b, 0].astype(np.float64))
           for a in range(-(-len(ref) // up)) for b in range(up)][:len(ref)]
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.fixture
def stereo_wav(tmp_path):
    """A stereo 44.1 kHz int16 wav: two tones and noise, the left channel
    near full scale so the remix's 0.95 limit acts."""
    sr, n = 44100, 44100 // 2
    t = np.arange(n) / sr
    rng = np.random.default_rng(3)
    left = 0.99 * np.sin(2 * np.pi * 220 * t) + 0.01 * rng.standard_normal(n)
    right = 0.4 * np.sin(2 * np.pi * 331 * t)
    data = np.clip(np.stack([left, right], 1) * 32767, -32768, 32767).astype(np.int16)
    path = os.path.join(tmp_path, "in.wav")
    wavfile.write(path, sr, data)
    return path


def test_audio_io_matches_jax(stereo_wav, tmp_path):
    """load_input_audio (read, resample to 16 kHz, downmix, 0.95 limit),
    remix_audio with each option, pad_audio and save_input_audio against
    the JAX module: the same numpy and scipy calls, so equal arrays and
    byte-identical files."""
    for sr in (16000, None):
        got, got_sr = taudio.load_input_audio(stereo_wav, sr)
        ref, ref_sr = jaudio.load_input_audio(stereo_wav, sr)
        assert got_sr == ref_sr and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    raw, raw_sr = taudio._read_wav(stereo_wav)
    np.testing.assert_array_equal(raw, jaudio._read_wav(stereo_wav)[0])
    assert raw.shape[0] == 2 and raw_sr == 44100
    for kw in (dict(target_sr=16000), dict(norm=True, merge_type="mean"),
               dict(to_int16=True, merge_type="max", max_volume=0.5),
               dict(target_sr=48000, resample=True)):
        got, got_sr = taudio.remix_audio((raw, raw_sr), **kw)
        ref, ref_sr = jaudio.remix_audio((raw, raw_sr), **kw)
        assert got_sr == ref_sr and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(taudio.pad_audio(raw[0][:100], raw[1]),
                                  jaudio.pad_audio(raw[0][:100], raw[1]))
    mono = taudio.load_input_audio(stereo_wav, 16000)[0]
    for kw in (dict(), dict(to_int16=True, to_stereo=True)):
        for name, mod in (("port", taudio), ("jax", jaudio)):
            mod.save_input_audio(os.path.join(tmp_path, f"{name}.wav"),
                                 (mono * 3.0, 16000), **kw)
        with open(os.path.join(tmp_path, "port.wav"), "rb") as a, \
                open(os.path.join(tmp_path, "jax.wav"), "rb") as b:
            assert a.read() == b.read()
