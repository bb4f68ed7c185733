"""The port's host library (``rvc_tpu_torch/native.py`` over its own copy of
the C++ source) against the JAX package's (``rvc_tpu/native``) bit for bit,
its numpy plain versions against it, and the port's slicer against the JAX
slicer on clips of the speech fixture, whose pauses sit near the -50 dB
gate (where the numpy route, float32 sums, cuts elsewhere)."""
import numpy as np
import pytest

import rvc_tpu.native as jnative
from rvc_tpu.ops import slicer as jslicer
from rvc_tpu_torch import native
from rvc_tpu_torch.ops import filters, slicer
from test_torch_convert import speech

SLICER = dict(threshold=-50, min_length=1500, min_interval=400, hop_size=15, max_sil_kept=500)


def test_builds_the_ports_own_source():
    lib = native.library()
    assert native.SOURCE.name == "rvc_host.cpp" and "rvc_tpu_torch" in str(native.SOURCE)
    assert "_build" in lib._name and lib._name.endswith("librvc_host.so")
    assert jnative.lib() is not None  # the JAX side takes its native route too


@pytest.mark.parametrize("n", [0, 1, 123457])
def test_peak_quantize_matches_jax_bitwise(rng, n):
    x = (0.7 * rng.standard_normal(n)).astype(np.float32)
    q, peak = filters.peak_quantize_i16(x)
    jq, jpeak = jnative.peak_quantize_i16(x)
    nq, npeak = filters.peak_quantize_i16_numpy(x)
    assert q.dtype == jq.dtype == nq.dtype == np.int16
    assert peak == jpeak == npeak
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(q, nq)


@pytest.mark.parametrize("frame,hop", [(1280, 320), (960, 240), (2048, 64)])
def test_frame_rms_matches_jax_bitwise(rng, frame, hop):
    """Bit for bit with the JAX library (both sum in double); the numpy
    version, float32 sums, within float32 rounding (the JAX package's own
    bars, tests/test_native.py)."""
    y = (0.3 * rng.standard_normal(30011)).astype(np.float32)
    got = slicer.frame_rms(y, frame, hop)
    np.testing.assert_array_equal(got, jnative.frame_rms(y, frame, hop))
    ref = slicer.frame_rms_numpy(y, frame, hop)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=5e-6, atol=5e-7)
    y64 = y.astype(np.float64)  # another dtype takes numpy in its own dtype, as in JAX
    np.testing.assert_array_equal(slicer.frame_rms(y64, frame, hop),
                                  jslicer.frame_rms(y64, frame, hop))


def test_silence_tags_match_jax_and_python(rng):
    """The state machine's tags equal the JAX library's and the Python
    loop's on alternating loud and quiet RMS tracks."""
    sl = slicer.Slicer(sr=16000, threshold=-40.0, min_length=2000, min_interval=300,
                       hop_size=20, max_sil_kept=500)
    n_tags = 0
    for seed in range(6):
        r = np.random.default_rng(seed)
        rms = np.concatenate([float(r.choice([1e-4, 5e-3, 0.05, 0.2])) * (0.5 + r.random(n))
                              for n in r.integers(5, 120, 30)]).astype(np.float32)
        got = sl._silence_tags(rms)
        assert got == jnative.slicer_silence_tags(rms, sl.threshold, sl.min_interval,
                                                  sl.min_length, sl.max_sil_kept)
        assert got == sl._silence_tags_numpy(rms)
        n_tags += len(got)
    assert n_tags > 20


def test_slicer_matches_jax_on_speech():
    """The port's Slicer gives the JAX Slicer's chunks, sample for sample, on
    14 clips of 8 s of speech; the count of clips the numpy route (float32
    RMS) would cut elsewhere is printed."""
    routes_apart = 0
    for off in range(0, 56, 4):
        clip = speech(8.0, float(off))
        got = slicer.Slicer(sr=16000, **SLICER).slice(clip)
        ref = jslicer.Slicer(sr=16000, **SLICER).slice(clip)
        assert len(got) == len(ref) >= 2, off
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b, err_msg=f"clip at {off} s")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnative, "lib", lambda: None)
            plain = jslicer.Slicer(sr=16000, **SLICER).slice(clip)
        routes_apart += not (len(plain) == len(ref)
                             and all(np.array_equal(a, b) for a, b in zip(plain, ref)))
    print(f"clips the JAX slicer's numpy route cuts elsewhere: {routes_apart} of 14")
    assert routes_apart > 0
