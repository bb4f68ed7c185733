"""STFT and log-mel frontends: RMVPE's, and the training losses'.

Counterparts of ``rvc_tpu/ops/stft.py::stft`` (periodic Hann, as a
window-folded DFT matmul) and ``rvc_tpu/ops/mel.py``. Two mel scales:
RMVPE's ``log_mel`` uses an HTK-scale filterbank on a centered STFT; the
training losses' ``mel_spectrogram`` and ``spec_to_mel`` (the reference's
``mel_spectrogram_torch`` / ``spec_to_mel_torch``) use the Slaney scale
(librosa's default) on an uncentered STFT reflect-padded by
(n_fft - hop) / 2. Both filterbanks are Slaney-normalized and both logs
floor at 1e-5. Frame-major layout: (..., frames, bins).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def dft_basis_np(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) bases (n_fft, n_fft//2 + 1) with the centered periodic Hann
    window folded in: frame @ cos = Re rfft(frame * window)."""
    n_bins = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_bins)[None, :] / n_fft
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    wfull = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    wfull[off:off + win_length] = w
    return ((np.cos(ang) * wfull[:, None]).astype(np.float32),
            (-np.sin(ang) * wfull[:, None]).astype(np.float32))


def stft(x: torch.Tensor, n_fft: int, hop_length: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Centered (reflect-padded) STFT with an n_fft-long window:
    x (B, T) -> (real, imag), each (B, frames, n_fft//2 + 1)."""
    x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop_length)
    cos_b, sin_b = dft_basis_np(n_fft, n_fft)
    real = torch.matmul(frames, torch.as_tensor(cos_b, device=x.device))
    imag = torch.matmul(frames, torch.as_tensor(sin_b, device=x.device))
    return real, imag


def hz_to_mel_htk(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank_np(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float
                      ) -> np.ndarray:
    """Slaney-normalized triangular filterbank (n_bins, n_mels) on the HTK mel
    scale (RMVPE's; the Slaney-scale variant is not ported)."""
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mels = np.linspace(hz_to_mel_htk(fmin), hz_to_mel_htk(fmax), n_mels + 2)
    mel_f = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (np.maximum(m, min_log_mel) - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=None)
def mel_filterbank_slaney_np(sr: int, n_fft: int, n_mels: int, fmin: float,
                             fmax: float | None) -> np.ndarray:
    """Slaney-normalized triangular filterbank (n_bins, n_mels) on the
    Slaney mel scale, librosa.filters.mel's default (rvc_tpu/ops/mel.py:66)."""
    fmax = sr / 2.0 if fmax is None else fmax
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_f = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                                          n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


def dynamic_range_compression(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=clip_val))


def log_mel(audio: torch.Tensor, sr: int, n_fft: int, hop: int, n_mels: int,
            fmin: float, fmax: float) -> torch.Tensor:
    """(B, T) -> (B, frames, n_mels): |STFT| (with a 1e-12 floor under the
    square root), HTK mel, log."""
    real, imag = stft(audio, n_fft, hop)
    mag = torch.sqrt(real * real + imag * imag + 1e-12)
    fb = torch.as_tensor(mel_filterbank_np(sr, n_fft, n_mels, fmin, fmax), device=audio.device)
    return dynamic_range_compression(torch.matmul(mag, fb))


def spec_to_mel(spec: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int,
                fmin: float, fmax: float | None) -> torch.Tensor:
    """Linear spectrogram (..., T, n_bins) -> log-mel (..., T, n_mels)
    (rvc_tpu/ops/mel.py:112, the reference's spec_to_mel_torch)."""
    fb = torch.as_tensor(mel_filterbank_slaney_np(sampling_rate, n_fft, num_mels, fmin, fmax),
                         device=spec.device)
    return dynamic_range_compression(torch.matmul(spec, fb))


def mel_spectrogram(wav: torch.Tensor, n_fft: int, n_mels: int, sampling_rate: int,
                    hop_length: int, win_length: int, fmin: float,
                    fmax: float | None) -> torch.Tensor:
    """Waveform (B, N) -> log-mel (B, frames, n_mels), differentiable
    (rvc_tpu/ops/mel.py:125, the reference's mel_spectrogram_torch): reflect
    pad by (n_fft - hop) / 2, uncentered frames, a win_length Hann window
    centered in n_fft, |STFT| with 1e-9 under the square root."""
    pad = int((n_fft - hop_length) / 2)
    x = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop_length)
    cos_b, sin_b = dft_basis_np(n_fft, win_length)
    real = torch.matmul(frames, torch.as_tensor(cos_b, device=wav.device))
    imag = torch.matmul(frames, torch.as_tensor(sin_b, device=wav.device))
    mag = torch.sqrt(real * real + imag * imag + 1e-9)
    return spec_to_mel(mag, n_fft, n_mels, sampling_rate, fmin, fmax)
