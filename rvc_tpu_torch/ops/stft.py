"""Framing, reflect padding, and the STFT / iSTFT of the separation routes.

Counterpart of ``rvc_tpu/ops/stft.py``. The JAX package's two framing
lowerings (conv patches, gather) are one ``Tensor.unfold`` here.
``reflect_pad`` is ``jnp.pad(mode="reflect")`` on the last axis, which
reflects again where the pad is as long as the signal or longer (numpy's
rule); ``F.pad(mode="reflect")`` raises there.

``stft``/``istft`` keep the JAX package's frame-major layout: a spectrum is
``(..., frames, bins)`` and comes as its real and imaginary parts. The JAX
package multiplies frames by a window-folded DFT basis (a product for the
TPU's matrix unit); here the frames are windowed and go through
``torch.fft.rfft``/``irfft``, the same transform. ``istft`` divides the
overlap-added frames by the overlap-added squared window floored at 1e-11,
as JAX does: ``torch.istft`` raises where that sum is small (its NOLA
check), so it is not used.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., 1 + (T - frame_length) // hop, frame_length), no
    padding; a view of ``x``."""
    return x.unfold(-1, frame_length, hop)


def reflect_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """x (..., T) padded on the last axis by ``left`` and ``right`` samples,
    reflected about the end samples (not repeating them) and reflected again
    for as long as the pad lasts: the periodic extension of period 2(T - 1),
    or the one sample repeated when T = 1. A gather, so its gradient sums
    over every copy of a sample."""
    T = x.shape[-1]
    idx = torch.arange(-left, T + right, device=x.device)
    if T == 1:
        return x[..., torch.zeros_like(idx)]
    period = 2 * (T - 1)
    idx = torch.remainder(idx, period)
    return x[..., torch.where(idx >= T, period - idx, idx)]


def _hann_np(win_length: int) -> np.ndarray:
    n = np.arange(win_length)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))


def hann_window(win_length: int, dtype=torch.float32) -> torch.Tensor:
    """Periodic Hann window, ``torch.hann_window(win_length)``'s values
    computed in float64 and rounded, as the JAX package computes them."""
    return torch.as_tensor(_hann_np(win_length), dtype=dtype)


@functools.lru_cache(maxsize=None)
def _window_np(n_fft: int, win_length: int) -> np.ndarray:
    """The Hann window of ``win_length`` centred in ``n_fft`` zeros
    (torch.stft's rule for win_length < n_fft)."""
    w = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    w[off: off + win_length] = _hann_np(win_length)
    return w


def _window(n_fft: int, win_length: int, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(_window_np(n_fft, win_length), dtype=x.dtype, device=x.device)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int | None = None,
         center: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Real STFT of x (..., T): (real, imag), each (..., frames, n_fft//2 + 1).
    ``center`` reflect-pads n_fft // 2 samples on each side first."""
    win_length = win_length or n_fft
    if center:
        x = reflect_pad(x, n_fft // 2, n_fft // 2)
    frames = frame_signal(x, n_fft, hop_length) * _window(n_fft, win_length, x)
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real, spec.imag


@functools.lru_cache(maxsize=64)
def _ola_norm_np(n_fft: int, win_length: int, hop: int, n_frames: int) -> np.ndarray:
    """The squared window overlap-added over ``n_frames`` frames, floored at
    1e-11 (the JAX package's normalization), float32."""
    k = -(-n_fft // hop)
    pieces = np.pad(_window_np(n_fft, win_length) ** 2, (0, k * hop - n_fft)).reshape(k, hop)
    norm = np.zeros((n_frames + k - 1) * hop)
    for j in range(k):
        norm[j * hop: (j + n_frames) * hop] += np.tile(pieces[j], n_frames)
    norm = norm[: (n_frames - 1) * hop + n_fft]
    return np.maximum(norm, 1e-11).astype(np.float32)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., n_frames, frame_len) -> (..., (n_frames - 1) * hop + frame_len):
    each frame's hop-long pieces, as one contiguous stream per piece index,
    summed at their shifts (no scatter)."""
    *lead, n_frames, frame_len = frames.shape
    k = -(-frame_len // hop)
    frames = torch.nn.functional.pad(frames, (0, k * hop - frame_len))
    pieces = frames.reshape(*lead, n_frames, k, hop)
    out = frames.new_zeros(*lead, (n_frames + k - 1) * hop)
    for j in range(k):
        out[..., j * hop: j * hop + n_frames * hop] += pieces[..., j, :].reshape(
            *lead, n_frames * hop)
    return out[..., : (n_frames - 1) * hop + frame_len]


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop_length: int,
          win_length: int | None = None, center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """Inverse of ``stft``: real, imag (..., frames, bins) -> (..., T). The
    imaginary parts of the DC and Nyquist bins are ignored, as the JAX
    package's inverse basis and the CPU's ``irfft`` ignore them; cuFFT's
    C2R transform reads them, so they are zeroed first."""
    win_length = win_length or n_fft
    imag = imag.clone()
    imag[..., 0] = 0
    if n_fft % 2 == 0 and imag.shape[-1] == n_fft // 2 + 1:
        imag[..., -1] = 0
    frames = torch.fft.irfft(torch.complex(real, imag), n=n_fft, dim=-1)
    frames = frames * _window(n_fft, win_length, frames)
    sig = _overlap_add(frames, hop_length)
    norm = _ola_norm_np(n_fft, win_length, hop_length, frames.shape[-2])
    sig = sig / torch.as_tensor(norm, dtype=sig.dtype, device=sig.device)
    if center:
        sig = sig[..., n_fft // 2: sig.shape[-1] - n_fft // 2]
    if length is not None:
        sig = sig[..., :length]
    return sig


def spectrogram(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int,
                center: bool = False) -> torch.Tensor:
    """Linear magnitude spectrogram (the reference's ``spectrogram_torch``):
    clipped to [-1.05, 1.05], reflect-padded by (n_fft - hop) / 2, magnitude
    with 1e-8 under the root. y (..., T) -> (..., frames, bins)."""
    y = torch.clamp(y, -1.05, 1.05)
    pad = int((n_fft - hop_size) / 2)
    y = reflect_pad(y, pad, pad)
    real, imag = stft(y, n_fft, hop_size, win_size, center=center)
    return torch.sqrt(real * real + imag * imag + 1e-8)
