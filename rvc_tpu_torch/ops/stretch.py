"""Time stretching and pitch shifting by a phase vocoder.

Counterpart of ``rvc_tpu/ops/stretch.py`` (which stands in for the
reference's rubberband wrappers, ``lib/uvr5_pack/pyrb.py``): the STFT of
``ops.stft``, magnitudes interpolated linearly between analysis frames,
phases advanced by each bin's instantaneous frequency, the iSTFT, and for
a pitch shift ``ops.resample.resample_poly`` back to the input's length.
JAX computes the phase advances and sums them with a float32 ``lax.scan``;
here the advances are float64 and the running sum is one ``cumsum`` over
the initial phase followed by the advances (the initial phase plus an
exclusive cumsum), brought into [0, 2 pi) before the cast back to float32.
A bin advances up to ~1608 rad a frame at hop 512, where float32's spacing
is 1.2e-4 rad, so a stationary partial's advance rounds the same way every
frame and its float32 sum drifts; the sum reaches 1e5-1e6 rad within
seconds, where the spacing is 0.008-0.06 rad and the rounding depends on
the order of the sum (the card's cumsum is a parallel scan). A silent
frame's ``atan2`` phase is its rounding's, and the vocoder carries it into
every later frame of the bin, so two roundings of a signal with digital
silence give unrelated phases after it: compare waveforms, on signals
without it.
"""
from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from .resample import resample_poly
from .stft import istft, stft


def phase_vocoder(re: torch.Tensor, im: torch.Tensor, rate: float, hop: int,
                  n_fft: int) -> tuple[torch.Tensor, torch.Tensor]:
    """An STFT (..., frames, bins) stretched by ``rate`` (> 1: shorter);
    synthesis frame k reads analysis position k * rate (librosa's rule)."""
    n_frames, n_bins = re.shape[-2:]
    steps = np.arange(0, n_frames, rate)
    idx0 = np.minimum(steps.astype(np.int64), n_frames - 1)
    idx1 = np.minimum(idx0 + 1, n_frames - 1)
    frac = torch.as_tensor((steps - idx0).astype(np.float32), device=re.device)[:, None]
    idx0, idx1 = (torch.as_tensor(i, device=re.device) for i in (idx0, idx1))

    mag = torch.sqrt(re * re + im * im)
    mag_out = (1.0 - frac) * mag[..., idx0, :] + frac * mag[..., idx1, :]

    # the phase advance between consecutive analysis frames, its deviation
    # from the bin's expected advance wrapped to +-pi; in float64 from here,
    # the running phase brought into [0, 2 pi) before the cast back
    phase = torch.atan2(im, re).double()
    expected = torch.as_tensor(2.0 * math.pi * hop * np.arange(n_bins) / n_fft,
                               dtype=torch.float64, device=re.device)
    dev = phase[..., idx1, :] - phase[..., idx0, :] - expected
    dev = dev - 2.0 * math.pi * torch.round(dev / (2.0 * math.pi))
    advance = expected + dev  # (..., K, bins)
    ph_out = torch.cat([phase[..., :1, :], advance[..., :-1, :]], dim=-2).cumsum(dim=-2)
    ph_out = torch.remainder(ph_out, 2.0 * math.pi).to(re.dtype)
    return mag_out * torch.cos(ph_out), mag_out * torch.sin(ph_out)


def time_stretch(y: torch.Tensor, sr: int, rate: float, n_fft: int = 2048,
                 hop: int = 512) -> torch.Tensor:
    """(..., T) -> (..., round(T / rate)); rate > 1 speeds up."""
    if rate == 1.0:
        return y
    re, im = stft(y, n_fft, hop, center=True)
    re2, im2 = phase_vocoder(re, im, rate, hop, n_fft)
    out_len = int(round(y.shape[-1] / rate))
    out = istft(re2, im2, n_fft, hop, center=True, length=out_len)
    return F.pad(out, (0, out_len - out.shape[-1]))  # the iSTFT may fall short


def pitch_shift(y: torch.Tensor, sr: int, n_steps: float, n_fft: int = 2048,
                hop: int = 512) -> torch.Tensor:
    """(..., T) shifted by ``n_steps`` semitones, the duration kept: stretched
    by 2^(-n/12), then resampled by the nearest fraction with a denominator
    of at most 1000 and cut or zero-padded to T."""
    if n_steps == 0:
        return y
    rate = 2.0 ** (-float(n_steps) / 12.0)
    stretched = time_stretch(y, sr, rate, n_fft=n_fft, hop=hop)
    frac = Fraction(rate).limit_denominator(1000)
    out = resample_poly(stretched, frac.numerator, frac.denominator)[..., : y.shape[-1]]
    return F.pad(out, (0, y.shape[-1] - out.shape[-1]))
