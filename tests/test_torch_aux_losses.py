"""The port's aux losses, multi-scale mel loss and reflect pad against the
JAX package's.

Each function of ``rvc_tpu_torch/train/losses.py`` that the generator's
losses reach with a weight above 0 (``compute_tefs``, ``compute_tsi_loss``
on both axes, ``hpss``, ``compute_harmonics``, ``combined_aux_loss`` with
each weight alone and all three, ``MultiScaleMelLoss``) against its
``rvc_tpu/train/losses.py`` counterpart on the same seeded numpy inputs:
the value, and the gradient with respect to every input (``jax.grad``
against autograd; a function with array outputs through a fixed random
projection of them). Inputs are speech-like (a few harmonics and noise) at
the lengths the training step gives: the segments of 48k_v2, 40k and 32k
(17280, 12800, 12800 samples), and ``tiny_config()``'s 640 samples at 6400
Hz, where the median filters' and the 4096-sample mel window's reflect pads
run past the signal (JAX reflects again). ``ops.stft.reflect_pad`` against
``np.pad(mode="reflect")`` for pads from 0 to 3x the length.

JAX's own ``_max_pool_lastdim`` frames its -inf-padded input through
``frame_signal``'s conv-patches lowering, whose identity kernel multiplies
the pad's -inf by 0: every window that touches the pad is NaN, so the TSI
envelope's edge values become eps (``nan_to_num``) and every gradient of
``compute_tsi_loss`` is NaN (JAX's max rule divides a zero cotangent by a
zero count of maxima). The port takes the max of the window's samples, as
the -inf pad means (and as the reference's ``max_pool1d`` does); these
tests hold it against the JAX function through ``frame_signal``'s other
lowering, its gather (``_max_pool_gather``), patched in where TSI runs,
and ``test_jax_max_pool_conv_lowering_is_nan`` pins the difference.

Bars: values within 1e-5 of max(1, |value|) for the losses and of the
largest magnitude for array outputs; gradients within 1e-4 of the largest
magnitude of JAX's gradient (the step test's bar), and within 3e-4
(``GRAD_TOL_MEL``) for the two functions that take log-mels of a waveform
themselves (``combined_aux_loss``, ``MultiScaleMelLoss``). Both sides are
float32 summed in other orders (the DFT products, the FFTs). The log-mel's
backward divides by each bin's energy, so the sides' rounding of the DFT
sums, ~1e-7 of a frame's energy, grows at the quiet bins: on the same
log-mel values the harmonic loss's gradient alone lies 6.2e-5 of its
largest from JAX's at 40 kHz, and the three losses under random weights
1.5e-4 (the first run, where 1e-4 was the only bar). A rounding-level
difference of the mels themselves would also flip a median's pick or an
L1 term's sign, so those two functions' gradients are taken on the same
log-mel values (``_port_mel_on_jax_values``); their values are not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes, one_thread  # noqa: F401
from rvc_tpu.train import losses as jl
from rvc_tpu_torch.ops.stft import reflect_pad
from rvc_tpu_torch.train import losses as tl

pytestmark = pytest.mark.usefixtures("one_thread")

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_TOL_MEL = 3e-4
SEGMENTS = {48000: 17280, 40000: 12800, 32000: 12800, 6400: 640}


def _max_pool_gather(x, k=3):
    """``rvc_tpu/train/losses.py::_max_pool_lastdim`` with its frames taken by
    a gather, ``frame_signal``'s lowering for long frames
    (rvc_tpu/ops/stft.py:71-73)."""
    pad = k // 2
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], constant_values=-jnp.inf)
    n = x.shape[-1]
    idx = jnp.arange(k)[None, :] + jnp.arange(n)[:, None]
    return xp[..., idx].max(axis=-1)


@pytest.fixture
def max_pool_gather(monkeypatch):
    monkeypatch.setattr(jl, "_max_pool_lastdim", _max_pool_gather)


def _jax_mel(wav, n_fft, n_mels, sr, hop, win, fmin, fmax):
    """``rvc_tpu/ops/mel.py::mel_spectrogram``, where its pad (n_fft - hop)/2
    is negative (``jnp.pad`` raises) on the signal trimmed by as much, as
    the port does; the JAX function itself elsewhere."""
    from rvc_tpu.ops import mel as jmel
    from rvc_tpu.ops.stft import stft

    pad = int((n_fft - hop) / 2)
    if pad >= 0:
        return jmel.mel_spectrogram(wav, n_fft, n_mels, sr, hop, win, fmin, fmax)
    real, imag = stft(wav[..., -pad:wav.shape[-1] + pad], n_fft, hop, win, center=False)
    mag = jnp.sqrt(real * real + imag * imag + 1e-9)
    fb = jnp.asarray(jmel._mel_filterbank_np(sr, n_fft, n_mels, fmin, fmax), mag.dtype)
    return jmel.dynamic_range_compression(
        jnp.matmul(mag, fb, precision=jax.lax.Precision.HIGHEST))


@pytest.fixture
def jax_mel_trimmed(monkeypatch):
    monkeypatch.setattr(jl, "mel_spectrogram", _jax_mel)


def _port_mel_on_jax_values(monkeypatch):
    """The port's losses take their log-mels with JAX's values and the
    port's gradient (value substituted, gradient kept): a rounding-level
    difference of the two mels cannot then flip a median's pick or the
    sign of an L1 term between the sides."""
    from rvc_tpu_torch.ops.mel import mel_spectrogram

    def mel(wav, *args):
        out = mel_spectrogram(wav, *args)
        ref = torch.from_numpy(np.asarray(_jax_mel(jnp.asarray(wav.detach().numpy()), *args)))
        return out + (ref - out).detach()

    monkeypatch.setattr(tl, "mel_spectrogram", mel)


def _signals(sr: int, n: int, seed: int, batch: int = 2) -> np.ndarray:
    """(batch, n) float32: a few harmonics of a random f0 with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    out = []
    for _ in range(batch):
        f0 = rng.uniform(90.0, 250.0)
        wave = sum(rng.uniform(0.02, 0.2) * np.sin(2 * np.pi * h * f0 * t + rng.uniform(0, 6))
                   for h in range(1, 6))
        out.append(wave + 0.02 * rng.standard_normal(n))
    return np.asarray(out, np.float32)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.max(np.abs(ref)))) if ref.ndim == 0 else float(
        np.max(np.abs(ref)))
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol * scale, (err, tol * scale)


def _projection(shapes, seed: int):
    """Fixed random weights for each output, so that a function with array
    outputs has one scalar to differentiate."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(o.shape).astype(np.float32) for o in shapes]


def _check(jfn, tfn, inputs, seed: int = 0, same_mel=None, grad_tol: float = GRAD_TOL):
    """jfn/tfn take the inputs and return a tuple of outputs (arrays or
    scalars). Values at VALUE_TOL, input gradients of a fixed random
    projection of the outputs at ``grad_tol``; with ``same_mel`` (a monkeypatch)
    the gradients with the port's log-mels on JAX's values
    (``_port_mel_on_jax_values``). The JAX side runs as one jitted function."""
    jin = [jnp.asarray(a) for a in inputs]
    proj = _projection(jax.eval_shape(jfn, *jin), seed)

    def both(*xs):
        out, pullback = jax.vjp(jfn, *xs)
        return out, pullback(tuple(jnp.asarray(p) for p in proj))

    jout, jgrads = jax.jit(both)(*jin)
    tin = [torch.from_numpy(a.copy()).requires_grad_() for a in inputs]
    tout = tfn(*tin)
    assert len(jout) == len(tout)
    for a, r in zip(tout, jout):
        _close(a.detach().numpy(), np.asarray(r), VALUE_TOL)
    if same_mel is not None:
        _port_mel_on_jax_values(same_mel)
        tout = tfn(*tin)
    total = sum(torch.sum(o * torch.from_numpy(p)) for o, p in zip(tout, proj))
    tgrads = torch.autograd.grad(total, tin, allow_unused=True)
    for g, r in zip(tgrads, jgrads):
        g = torch.zeros(r.shape) if g is None else g
        _close(g.numpy(), np.asarray(r), grad_tol)


def _log_mel(sr: int, seed: int) -> np.ndarray:
    """A (2, frames, 128) log-mel of a segment at sr, as the aux losses take it."""
    from rvc_tpu.ops.mel import mel_spectrogram

    hop = sr // 100
    mel = mel_spectrogram(jnp.asarray(_signals(sr, SEGMENTS[sr], seed)), 4 * hop, 128, sr, hop,
                          4 * hop, 0.0, None)
    return np.asarray(mel, np.float32)


@pytest.mark.parametrize("n", [1, 2, 5, 14])
def test_reflect_pad_matches_numpy(n):
    """Every pad from 0 to 3n on each side, alone and together, on (2, n)."""
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    for left in range(3 * n + 1):
        for right in (0, left, 3 * n - left):
            got = reflect_pad(torch.from_numpy(x), left, right).numpy()
            np.testing.assert_array_equal(got, np.pad(x, ((0, 0), (left, right)), mode="reflect"))


@pytest.mark.parametrize("sr", [48000, 6400])
def test_compute_tefs_matches_jax(sr):
    wave = _signals(sr, SEGMENTS[sr], 1)
    _check(lambda a: jl.compute_tefs(a, 1e-9), lambda a: tl.compute_tefs(a, 1e-9), [wave])


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.usefixtures("max_pool_gather")
def test_compute_tsi_loss_matches_jax(axis):
    org, gen = _log_mel(40000, 2), _log_mel(40000, 3)
    _check(lambda a, b: (jl.compute_tsi_loss(a, b, axis),),
           lambda a, b: (tl.compute_tsi_loss(a, b, axis),), [org, gen])


def test_jax_max_pool_conv_lowering_is_nan():
    """The JAX package's own pool is NaN exactly in the windows that touch
    the pad and equals the gather's elsewhere, and its TSI gradients are
    NaN; the port's pool equals the gather's everywhere."""
    x = jnp.asarray(np.random.default_rng(3).standard_normal((2, 6, 9)).astype(np.float32))
    own = np.asarray(jl._max_pool_lastdim(x))
    ref = np.asarray(_max_pool_gather(x))
    assert np.isnan(own[..., [0, -1]]).all() and not np.isnan(own[..., 1:-1]).any()
    np.testing.assert_array_equal(own[..., 1:-1], ref[..., 1:-1])
    grads = jax.grad(jl.compute_tsi_loss, argnums=(0, 1))(x, x[::-1])
    assert all(np.isnan(np.asarray(g)).all() for g in grads)
    np.testing.assert_array_equal(tl._max_pool_lastdim(torch.from_numpy(np.asarray(x))), ref)


@pytest.mark.parametrize("k", [3, 29])
def test_hpss_matches_jax(k):
    """k = 29 pads 14 frames on each side of a 10-frame mel (the tiny
    config's): the reflect pad runs past the signal."""
    mag = np.abs(_log_mel(32000, 4))
    _check(lambda a: jl.hpss(a, k), lambda a: tl.hpss(a, k), [mag])
    small = np.abs(np.random.default_rng(5).standard_normal((2, 10, 16)).astype(np.float32))
    _check(lambda a: jl.hpss(a, k), lambda a: tl.hpss(a, k), [small])


def test_compute_harmonics_matches_jax():
    mel = _log_mel(48000, 6)
    _check(lambda a: jl.compute_harmonics(a, eps=1e-9),
           lambda a: tl.compute_harmonics(a, eps=1e-9), [mel])


TINY_DATA = dict(n_mels=16, sample_rate=6400, n_fft=64, hop_length=64, win_length=64)
DATA_48K = dict(n_mels=128, sample_rate=48000, n_fft=2048, hop_length=480, win_length=2048)


@pytest.mark.usefixtures("max_pool_gather")
@pytest.mark.parametrize("sr,weights", [
    (6400, (1.0, 0.0, 0.0)), (6400, (0.0, 1.0, 0.0)), (6400, (0.0, 0.0, 1.0)),
    (6400, (1.0, 1.0, 1.0)), (48000, (1.0, 1.0, 1.0)), (40000, None)])
def test_combined_aux_loss_matches_jax(monkeypatch, sr, weights):
    """(c_tefs, c_hd, c_tsi), each alone and all three, with the training
    step's data arguments and eps (tiny_config()'s 64-sample frames and 16
    mels; 48k_v2's); at 40 kHz (``None``) JAX's defaults: every weight 1,
    128 mels, eps 1e-8. The gradients on the same log-mel values
    (``_check``'s ``same_mel``)."""
    if weights is None:
        kw = {}
    else:
        c_tefs, c_hd, c_tsi = weights
        kw = dict(c_tefs=c_tefs, c_hd=c_hd, c_tsi=c_tsi, fmin=0.0, fmax=None, eps=1e-9,
                  **(TINY_DATA if sr == 6400 else DATA_48K))
    org, gen = _signals(sr, SEGMENTS[sr], 7), _signals(sr, SEGMENTS[sr], 8)
    _check(lambda a, b: jl.combined_aux_loss(a, b, **kw),
           lambda a, b: tl.combined_aux_loss(a, b, **kw), [org, gen], same_mel=monkeypatch,
           grad_tol=GRAD_TOL_MEL)


@pytest.mark.parametrize("sr,loss", [(48000, "l1"), (40000, "l1"), (32000, "l2"),
                                     (6400, "l1")])
@pytest.mark.usefixtures("jax_mel_trimmed")
def test_multiscale_mel_loss_matches_jax(monkeypatch, sr, loss):
    """The six banks at sr on segment-length signals; at 6400 Hz the
    2048- and 4096-sample windows pad 992 and 2016 samples on 640; at 32-48
    kHz the 256-sample window is shorter than the hop, where JAX's pad
    raises and both sides trim (``_jax_mel``). The gradients on the same
    log-mel values (``_check``'s ``same_mel``)."""
    jm, tm = jl.MultiScaleMelLoss(sr, loss=loss), tl.MultiScaleMelLoss(sr, loss=loss)
    assert tm.windows == jm.windows and tm.n_mels == jm.n_mels and tm.hop == jm.hop
    x, y = _signals(sr, SEGMENTS[sr], 11), _signals(sr, SEGMENTS[sr], 12)
    _check(lambda a, b: (jm(a, b),), lambda a, b: (tm(a, b),), [x, y], same_mel=monkeypatch,
           grad_tol=GRAD_TOL_MEL)


def test_jax_multiscale_mel_loss_raises_below_the_hop():
    """The JAX package's loss at a real rate: its 256-sample window is
    shorter than the 480-sample hop, and ``jnp.pad`` refuses the negative
    pad (the reason for ``_jax_mel``)."""
    x = jnp.zeros((1, 17280), jnp.float32)
    with pytest.raises(ValueError):
        jl.MultiScaleMelLoss(48000)(x, x)
