"""The port's classical f0 methods against the JAX package's on the CPU:
``frame_signal``, ``nan_merge``, pm (``acf_pitch``), dio and harvest (WORLD,
each refined by stonemask) and ``stonemask_refine`` alone, on one batch of
synthetic signals (as tests/test_f0_golden.py builds them: a harmonic tone,
a glide, vibrato, white noise) and 1.5 s of the speech fixture."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes, one_thread  # noqa: F401
from rvc_tpu.ops.stft import frame_signal as jframe
from rvc_tpu.pitch import extractor as jext
from rvc_tpu.pitch import world as jworld
from rvc_tpu_torch.ops.stft import frame_signal
from rvc_tpu_torch.pitch import extractor as text
from test_f0_golden import harmonic_signal, vibrato_track
from test_torch_convert import speech

pytestmark = pytest.mark.usefixtures("one_thread")

SR = 16000
SECONDS = 1.5
SIGNALS = ("harmonic", "glide", "vibrato", "noise", "speech")
REL = 1e-4  # f0 on frames both voice: float32 sums in another order (XLA vs ATen)
SPEECH_AGREE = 0.99  # share of speech frames with the same voicing and f0 within REL


@pytest.fixture(scope="module")
def batch():
    """(5, 24000): the four synthetic signals and speech, one row each."""
    n = int(SECONDS * SR)
    t = np.arange(n) / SR
    rows = [harmonic_signal(np.full(n, 220.0, np.float32)),
            harmonic_signal((120.0 + 180.0 * t / t[-1]).astype(np.float32), seed=1),
            harmonic_signal(vibrato_track(SECONDS, base=180.0)[:n], seed=2),
            (0.1 * np.random.default_rng(3).standard_normal(n)).astype(np.float32),
            speech(SECONDS, offset_s=20.0)]
    return np.stack(rows)


def _agreement(got: np.ndarray, ref: np.ndarray, label: str) -> None:
    """Synthetic rows: the same voicing on every frame, f0 within REL where
    both voice. The speech row: at least SPEECH_AGREE of its frames so."""
    assert got.shape == ref.shape, (got.shape, ref.shape)
    same_voicing = (got > 0) == (ref > 0)
    close = np.abs(got - ref) <= REL * np.maximum(np.abs(ref), 1e-6)
    agree = same_voicing & (close | (ref <= 0))
    for i, name in enumerate(SIGNALS):
        n_ok, n = int(agree[i].sum()), agree.shape[1]
        print(f"{label} {name}: {n_ok}/{n} frames agree, {int((ref[i] > 0).sum())} voiced")
        if name == "speech":
            assert n_ok >= SPEECH_AGREE * n, (label, n_ok, n)
        else:
            assert same_voicing[i].all(), (label, name, np.nonzero(~same_voicing[i]))
            assert agree[i].all(), (label, name, np.max(np.abs(got[i] - ref[i])))
    assert (ref > 0).any(axis=1)[[0, 1, 2, 4]].all()  # the voiced rows voice


def test_frame_signal_is_exact(rng):
    x = rng.standard_normal((2, 3, 5000)).astype(np.float32)
    for w, hop in ((1024, 160), (3, 1), (64, 64)):
        ref = np.asarray(jframe(jnp.asarray(x), w, hop))
        got = frame_signal(torch.from_numpy(x), w, hop).numpy()
        assert got.shape == ref.shape == (2, 3, 1 + (5000 - w) // hop, w)
        np.testing.assert_array_equal(got, ref)


def _stack(rng):
    """(M, B, F) f0 stacks of 1-4 methods: voiced values, zeros, and columns
    where every method is unvoiced."""
    out = []
    for m in (1, 2, 3, 4):
        s = rng.uniform(80.0, 400.0, (m, 3, 50)).astype(np.float32)
        s[rng.random(s.shape) < 0.3] = 0.0
        s[:, :, :5] = 0.0  # all-zero columns
        out.append(s)
    return out


@pytest.mark.parametrize("merge_type", ["median", "mean", "min", "max"])
def test_nan_merge_is_exact(rng, merge_type):
    """Exact, on stacks of one to four methods: even counts of voiced values
    (the median takes the mean of the two middle ones), all-zero columns."""
    for s in _stack(rng):
        ref = np.asarray(jext.nan_merge(jnp.asarray(s), merge_type))
        got = text.nan_merge(torch.from_numpy(s), merge_type).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"{merge_type}, {s.shape[0]} methods")
        assert (got[:, :5] == 0).all()


@pytest.mark.parametrize("method", ["pm", "dio", "harvest"])
def test_method_matches_jax(batch, method):
    ref = np.asarray(jext.PitchExtractor().compute(jnp.asarray(batch), method))
    got = text.PitchExtractor().compute(torch.from_numpy(batch), method).numpy()
    _agreement(got, ref, method)


def test_stonemask_refine_matches_jax(batch):
    """On the JAX dio's raw candidates (WORLD's grid before refinement)."""
    cand = np.array(jworld.dio(jnp.asarray(batch)))
    ref = np.asarray(jext.stonemask_refine(jnp.asarray(batch), jnp.asarray(cand)))
    got = text.stonemask_refine(torch.from_numpy(batch), torch.from_numpy(cand)).numpy()
    _agreement(got, ref, "stonemask")
