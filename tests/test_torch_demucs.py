"""The port's Demucs modules against the JAX package's on the CPU: the
BLSTM (plain and framed), LocalState, DConv, the encoder and decoder layers
of both branches, the cross-domain transformer, HDemucs (CaC, Wiener,
naive mask), HTDemucs (bottom channels, the training segment), Demucs v2,
Conv-TasNet, the Wiener filter and the chunked, shifted apply. Shapes are
those of ``tests/test_htdemucs_parity.py`` and ``tests/test_demucs.py``;
weights are the JAX initializers' shapes with ``chip_smoke.lively_array``
values, carried over by ``compat.weights``; the JAX side is channels-last,
the port the reference's (B, C, [F,] T)."""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import finit, no_compile_cache_writes, one_thread  # noqa: F401
from test_torch_separation import lively
from rvc_tpu.models import demucs as jdm
from rvc_tpu.models import htdemucs as jht
from rvc_tpu.models import tasnet as jts
from rvc_tpu.ops import stft as jstft
from rvc_tpu.ops import wiener as jwiener
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import demucs as tdm
from rvc_tpu_torch.models import htdemucs as tht
from rvc_tpu_torch.models import tasnet as tts
from rvc_tpu_torch.models.layers import load_numpy_state_dict
from rvc_tpu_torch.ops import stft as tstft
from rvc_tpu_torch.ops import wiener as twiener

pytestmark = pytest.mark.usefixtures("one_thread")

MODULE_TOL = 1e-5  # of the largest magnitude: float32 summed in another order
NET_TOL = 1e-4     # whole nets (an STFT, dozens of layers, the EM filter)


def jax_and_port(jmod, tmod, x, seed: int = 0):
    """Init ``jmod`` on ``x`` (JAX layout), draw lively weights, load them
    into ``tmod`` (eval mode); returns (params, tmod). ``Module.init`` is
    called through the class: ``DConv`` has a field named ``init``."""
    init = functools.partial(fnn.Module.init, jmod)
    p = lively(finit(init, jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    load_numpy_state_dict(tmod, weights.demucs_state_dict(p))
    return p, tmod.eval()


def assert_close(got: np.ndarray, ref: np.ndarray, tol: float, label: str = "") -> None:
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    print(f"{label} max |diff| {err:.3g} of largest {scale:.3g} (bar {tol:g} relative)")
    assert np.isfinite(got).all() and scale > 0 and err <= tol * scale


def ncw(x: np.ndarray) -> torch.Tensor:
    """(B, T, C) -> (B, C, T)."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def nchw(x: np.ndarray) -> torch.Tensor:
    """(B, F, T, C) -> (B, C, F, T)."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def randn(*shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---- building blocks ----

@pytest.mark.parametrize("framed", [False, True])
def test_blstm_matches_jax(framed):
    """BiLSTM (2 layers, torch's gate order) with its linear merge; framed:
    T = 450 over 200-step frames at stride 100, centres stitched, input
    added."""
    x = randn(2, 450 if framed else 30, 8)
    if framed:
        jmod, tmod = jht.FramedBLSTM(8), tdm.BLSTM(8, layers=2, max_steps=200, skip=True)
    else:
        jmod, tmod = jdm.BiLSTM(8, 2), tdm.BLSTM(8, layers=2)
    p, tmod = jax_and_port(jmod, tmod, x)
    ref = np.asarray(jmod.apply(p, jnp.asarray(x))).transpose(0, 2, 1)
    with torch.no_grad():
        got = tmod(ncw(x)).numpy()
    assert_close(got, ref, MODULE_TOL, f"BLSTM framed={framed}")


def test_local_state_matches_jax():
    x = randn(2, 40, 16, seed=1)
    jmod = jht.LocalState(16, heads=4, ndecay=4)
    p, tmod = jax_and_port(jmod, tht.LocalState(16, heads=4, ndecay=4), x)
    ref = np.asarray(jmod.apply(p, jnp.asarray(x))).transpose(0, 2, 1)
    with torch.no_grad():
        got = tmod(ncw(x)).numpy()
    assert_close(got, ref, MODULE_TOL, "LocalState")


def test_dconv_matches_jax():
    """Two dilated layers, GroupNorm, GELU, the framed BLSTM (T 260 > 200)
    and LocalState, LayerScale."""
    x = randn(2, 260, 16, seed=2)
    jmod = jht.DConv(16, compress=2, depth=2, init=0.1, lstm=True, attn=True)
    p, tmod = jax_and_port(jmod, tht.DConv(16, compress=2, depth=2, init=0.1, lstm=True,
                                           attn=True), x)
    ref = np.asarray(jmod.apply(p, jnp.asarray(x))).transpose(0, 2, 1)
    with torch.no_grad():
        got = tmod(ncw(x)).numpy()
    assert_close(got, ref, MODULE_TOL, "DConv")


@pytest.mark.parametrize("freq", [True, False])
def test_enc_dec_layers_match_jax(freq):
    """HEncLayer with an injected time tensor (frequency branch) or an
    unpadded length (time branch), GroupNorm, DConv, rewrite; HDecLayer with
    its skip, DConv, transposed conv and crop, returning (z, pre)."""
    kw = dict(norm_groups=2, norm=True, dconv_comp=2.0, dconv_init=0.1)
    if freq:
        x = randn(2, 16, 10, 4, seed=3)  # (B, F, T, C)
        inject = randn(2, 10, 8, seed=4)  # (B, T, C)
        enc_j = jht.HEncLayer(4, 8, freq=True, context=1, **kw)
        enc_t = tht.HEncLayer(4, 8, freq=True, context=1, **kw)
        p, enc_t = jax_and_port(enc_j, enc_t, x)
        ref = np.asarray(enc_j.apply(p, jnp.asarray(x), jnp.asarray(inject)))
        with torch.no_grad():
            got = enc_t(nchw(x), ncw(inject)).numpy()
        assert_close(got, ref.transpose(0, 3, 1, 2), MODULE_TOL, "HEncLayer freq")
        y = ref  # (B, 4, T, 8)
        dec_j = jht.HDecLayer(8, 4, freq=True, **kw)
        dec_t = tht.HDecLayer(8, 4, freq=True, **kw)
        skip = randn(*y.shape, seed=5)
        jp = lively(finit(dec_j.init, jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(skip),
                          10), seed=1)
        load_numpy_state_dict(dec_t, weights.demucs_state_dict(jp))
        zj, prej = (np.asarray(a) for a in dec_j.apply(jp, jnp.asarray(y), jnp.asarray(skip), 10))
        with torch.no_grad():
            zt, pret = dec_t.eval()(nchw(y), nchw(skip), 10)
        assert_close(zt.numpy(), zj.transpose(0, 3, 1, 2), MODULE_TOL, "HDecLayer freq z")
        assert_close(pret.numpy(), prej.transpose(0, 3, 1, 2), MODULE_TOL, "HDecLayer freq pre")
    else:
        x = randn(2, 37, 4, seed=3)  # 37 % 4 != 0: the encoder pads
        enc_j = jht.HEncLayer(4, 8, freq=False, context=1, **kw)
        p, enc_t = jax_and_port(enc_j, tht.HEncLayer(4, 8, freq=False, context=1, **kw), x)
        ref = np.asarray(enc_j.apply(p, jnp.asarray(x)))
        with torch.no_grad():
            got = enc_t(ncw(x)).numpy()
        assert_close(got, ref.transpose(0, 2, 1), MODULE_TOL, "HEncLayer time")
        dec_j = jht.HDecLayer(8, 4, freq=False, **kw)
        dec_t = tht.HDecLayer(8, 4, freq=False, **kw)
        skip = randn(*ref.shape, seed=5)
        init = functools.partial(dec_j.init, length=37)  # static, not traced
        jp = lively(finit(init, jax.random.PRNGKey(0), jnp.asarray(ref), jnp.asarray(skip)),
                    seed=1)
        load_numpy_state_dict(dec_t, weights.demucs_state_dict(jp))
        zj, prej = (np.asarray(a) for a in dec_j.apply(jp, jnp.asarray(ref), jnp.asarray(skip),
                                                       37))
        with torch.no_grad():
            zt, pret = dec_t.eval()(ncw(ref), ncw(skip), 37)
        assert_close(zt.numpy(), zj.transpose(0, 2, 1), MODULE_TOL, "HDecLayer time z")
        assert_close(pret.numpy(), prej.transpose(0, 2, 1), MODULE_TOL, "HDecLayer time pre")


@pytest.mark.parametrize("cross_first", [False, True])
def test_cross_transformer_matches_jax(cross_first):
    """Self and cross layers over F = 3 x T1 = 5 frequency tokens (time-major)
    and T2 = 7 time tokens; a wrong token order shows only here."""
    x, xt = randn(2, 3, 5, 16, seed=6), randn(2, 7, 16, seed=7)
    jmod = jht.CrossTransformerEncoder(16, num_heads=2, num_layers=3, cross_first=cross_first)
    p = lively(finit(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(xt)))
    tmod = tht.CrossTransformerEncoder(16, num_heads=2, num_layers=3, cross_first=cross_first)
    load_numpy_state_dict(tmod, weights.demucs_state_dict(p))
    rx, rxt = (np.asarray(a) for a in jmod.apply(p, jnp.asarray(x), jnp.asarray(xt)))
    with torch.no_grad():
        gx, gxt = tmod.eval()(nchw(x), ncw(xt))
    assert_close(gx.numpy(), rx.transpose(0, 3, 1, 2), MODULE_TOL, "transformer x")
    assert_close(gxt.numpy(), rxt.transpose(0, 2, 1), MODULE_TOL, "transformer xt")


# ---- whole nets ----

HDEMUCS = {
    "cac": dict(channels=16, depth=3, nfft=64, norm_starts=2, dconv_lstm=2, dconv_attn=2),
    "wiener": dict(channels=16, depth=2, nfft=64, norm_starts=1, cac=False, wiener_iters=1,
                   end_iters=1),
    "naive": dict(channels=16, depth=2, nfft=64, norm_starts=1, cac=False, wiener_iters=-1,
                  end_iters=-1),
}


def run_net(jmod, tmod, x: np.ndarray, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(JAX output as (B, S, C, T), port output) for mix x (B, T, C)."""
    p, tmod = jax_and_port(jmod, tmod, x, seed)
    ref = np.asarray(jax.jit(jmod.apply)(p, jnp.asarray(x))).transpose(0, 1, 3, 2)
    with torch.no_grad():
        got = tmod(ncw(x)).numpy()
    return got, ref


@pytest.mark.parametrize("form", list(HDEMUCS))
def test_hdemucs_matches_jax(form):
    """HDemucs v3: the time/frequency merge, the frequency embedding, GroupNorm
    from norm_starts, DConv with BLSTM and LocalState (CaC); without CaC the
    magnitudes through the Wiener EM or the mixture's phase."""
    kw = dict(sources=("a", "b"), audio_channels=2, **HDEMUCS[form])
    x = 0.3 * randn(1, 640, 2, seed=8)
    got, ref = run_net(jht.HDemucs(**kw), tht.HDemucs(**kw), x)
    assert_close(got, ref, NET_TOL, f"HDemucs {form}")


def test_hdemucs_framed_blstm_matches_jax():
    """The BLSTM on 200-step frames inside the nets: the time branch's first
    layer sees 2048 steps."""
    kw = dict(sources=("a", "b"), audio_channels=1, channels=8, depth=2, nfft=64,
              norm_starts=1, dconv_lstm=0, dconv_attn=6)
    x = 0.3 * randn(1, 8192, 1, seed=9)
    got, ref = run_net(jht.HDemucs(**kw), tht.HDemucs(**kw), x)
    assert_close(got, ref, NET_TOL, "HDemucs framed BLSTM")


@pytest.mark.parametrize("form", ["bottom_channels", "train_segment"])
def test_htdemucs_matches_jax(form):
    """HTDemucs v4: the cross-domain transformer with bottom-channel up/down
    samplers; or a mix shorter than the training segment, padded to it and
    the output cropped back."""
    if form == "bottom_channels":
        kw = dict(sources=("a", "b"), audio_channels=2, channels=16, depth=2, nfft=512,
                  norm_starts=1, t_layers=3, t_heads=2, bottom_channels=8,
                  use_train_segment=False)
        x = 0.3 * randn(1, 2048, 2, seed=10)
    else:
        kw = dict(sources=("a",), audio_channels=1, channels=16, depth=2, nfft=128,
                  norm_starts=1, t_layers=2, t_heads=2, use_train_segment=True,
                  samplerate=1024, segment=2.0)
        x = 0.3 * randn(1, 1500, 1, seed=11)
    got, ref = run_net(jht.HTDemucs(**kw), tht.HTDemucs(**kw), x)
    assert got.shape[-1] == x.shape[1]
    assert_close(got, ref, NET_TOL, f"HTDemucs {form}")


def test_demucs_v2_matches_jax():
    """The v2 waveform U-Net with its 2x resampling, GELU, GLU and BiLSTM."""
    kw = dict(sources=("vocals", "other"), channels=4, depth=3, lstm_layers=1, resample=True)
    jmod, tmod = jdm.Demucs(**kw), tdm.Demucs(**kw)
    T = jmod.valid_length(1000)
    assert tmod.valid_length(1000) == T
    got, ref = run_net(jmod, tmod, randn(2, T, 2, seed=12))
    assert_close(got, ref, NET_TOL, "Demucs v2")


TINY_TASNET = dict(N=16, L=8, B=8, H=16, P=3, X=3, R=2)  # tests/test_tasnet.py:18


@pytest.mark.parametrize("norm", ["gLN", "cLN"])
def test_tasnet_matches_jax(norm):
    """Conv-TasNet through ``compat.weights.tasnet_state_dict``: encoder, cLN,
    the temporal blocks' depthwise dilated convs (the shifted form and the
    grouped conv), masks, the decoder's half-frame overlap-add."""
    x = randn(2, TINY_TASNET["L"] * 40 + 3, 2, seed=13)
    jmod = jts.ConvTasNet(norm_type=norm, **TINY_TASNET)
    p = lively(finit(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)))
    tmod = tts.ConvTasNet(norm_type=norm, **TINY_TASNET)
    load_numpy_state_dict(tmod, weights.tasnet_state_dict(p, TINY_TASNET))
    ref = np.asarray(jax.jit(jmod.apply)(p, jnp.asarray(x))).transpose(0, 1, 3, 2)
    with torch.no_grad():
        got = tmod.eval()(ncw(x)).numpy()
    assert_close(got, ref, NET_TOL, f"ConvTasNet {norm}")
    y, w = torch.from_numpy(randn(2, 16, 50)), torch.from_numpy(randn(16, 1, 3, seed=1))
    for d in (1, 4, 16):
        np.testing.assert_allclose(tts.depthwise(y, w, d).numpy(),
                                   tts.depthwise_conv1d(y, w, d).numpy(), atol=1e-5)


@pytest.mark.parametrize("iterations,residual", [(1, False), (2, True), (0, True)])
def test_wiener_matches_jax(iterations, residual):
    """The EM filter over 300-frame windows (T = 430: a padded second
    window), 2 channels, 3 sources, complex64; the 2x2 inverse by
    determinant and the scale-down by the window's peak."""
    rng = np.random.default_rng(14)
    T, Fr, C, S = 430, 9, 2, 3
    mix = (rng.standard_normal((T, Fr, C)) + 1j * rng.standard_normal((T, Fr, C))) * 30
    mix = mix.astype(np.complex64)
    mag = np.abs(rng.standard_normal((T, Fr, C, S)) * 20).astype(np.float32)
    ref = np.asarray(jwiener.wiener(jnp.asarray(mag), jnp.asarray(mix), iterations,
                                    residual=residual))
    got = twiener.wiener(torch.from_numpy(mag), torch.from_numpy(mix), iterations,
                         residual=residual).numpy()
    assert got.dtype == np.complex64
    assert_close(np.stack([got.real, got.imag]), np.stack([ref.real, ref.imag]), MODULE_TOL,
                 f"wiener {iterations} {residual}")


def test_apply_model_shifts_matches_jax():
    """Chunks at stride 3/4 segment, the last one aligned to the end, shifts
    drawn from np.random.default_rng(0) as JAX draws them, triangular
    overlap-add: a fixed nonlinear 'model' gives the same stems."""
    mix = randn(2, 5000, seed=15)

    def jax_fn(batch):  # (N, T, C) -> (N, 2, T, C)
        b = np.asarray(batch)
        return np.stack([np.tanh(b), b * b[..., ::-1]], axis=1)

    def port_fn(batch, events=None):  # (N, C, T) -> (N, 2, C, T)
        return torch.stack([torch.tanh(batch), batch * batch.flip(1)], dim=1)

    for shifts in (1, 2):
        ref = jdm.apply_model(jax_fn, mix, segment_samples=1024, shifts=shifts, max_shift=300)
        got = tdm.apply_model(port_fn, torch.from_numpy(mix), 1024, shifts=shifts,
                              max_shift=300).numpy()
        assert_close(got, ref, MODULE_TOL, f"apply_model shifts={shifts}")


def test_istft_ignores_imaginary_dc_and_nyquist():
    """The CaC masks give the DC and Nyquist bins imaginary parts; the JAX
    inverse basis ignores them, and so does the port's istft (on the card
    too, where cuFFT's C2R would read them)."""
    rng = np.random.default_rng(16)
    re, im = (rng.standard_normal((2, 12, 129)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jstft.istft(jnp.asarray(re), jnp.asarray(im), 256, 64))
    got = tstft.istft(torch.from_numpy(re), torch.from_numpy(im), 256, 64).numpy()
    assert_close(got, ref, MODULE_TOL, "istft with imaginary DC")
    im[..., 0] = im[..., -1] = 0
    np.testing.assert_array_equal(
        tstft.istft(torch.from_numpy(re), torch.from_numpy(im), 256, 64).numpy(), got)
