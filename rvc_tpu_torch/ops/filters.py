"""Envelopes and filters of the conversion path.

Counterpart of ``rvc_tpu/ops/filters.py`` (``rms_envelope``,
``change_rms``, ``median_filter_1d``, ``butter_highpass_host``) and of the
numpy branch of ``rvc_tpu/native.peak_quantize_i16``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as _ss


def rms_envelope(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """librosa.feature.rms semantics: zero center-padded frame RMS over the
    last axis."""
    pad = frame_length // 2
    frames = F.pad(x, (pad, pad)).unfold(-1, frame_length, hop_length)
    return torch.sqrt(torch.mean(frames * frames, dim=-1))


def _linear_interp_to(env: torch.Tensor, out_len: int) -> torch.Tensor:
    """Resize the last axis with F.interpolate(mode='linear',
    align_corners=False) semantics, written out."""
    n = env.shape[-1]
    pos = (torch.arange(out_len, device=env.device, dtype=torch.float32) + 0.5) * (n / out_len) - 0.5
    pos = torch.clamp(pos, 0.0, n - 1.0)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.clamp(lo + 1, max=n - 1)
    w = pos - lo
    return env[..., lo] * (1.0 - w) + env[..., hi] * w


def change_rms(source: torch.Tensor, source_sr: int, target: torch.Tensor, target_sr: int,
               rate: float) -> torch.Tensor:
    """Blend target's loudness envelope toward the source's: rate 1 keeps the
    target, rate 0 imposes the source's RMS."""
    rms1 = rms_envelope(source, source_sr // 2 * 2, source_sr // 2)
    rms2 = rms_envelope(target, target_sr // 2 * 2, target_sr // 2)
    T = target.shape[-1]
    rms1 = _linear_interp_to(rms1, T)
    rms2 = torch.clamp(_linear_interp_to(rms2, T), min=1e-6)
    return target * (torch.pow(rms1, 1.0 - rate) * torch.pow(rms2, rate - 1.0))


def median_filter_1d(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Median over the last axis with zero padding (scipy.signal.medfilt)."""
    if kernel_size <= 1:
        return x
    pad = kernel_size // 2
    frames = F.pad(x, (pad, pad)).unfold(-1, kernel_size, 1)
    # torch.median returns the lower middle; take the mean of both middles
    # for even sizes, as jnp.median does
    s = torch.sort(frames, dim=-1).values
    mid = kernel_size // 2
    return s[..., mid] if kernel_size % 2 else 0.5 * (s[..., mid - 1] + s[..., mid])


def butter_highpass_host(x: np.ndarray, cutoff_hz: float = 48.0, fs: int = 16000) -> np.ndarray:
    """5th-order Butterworth high-pass, zero-phase (filtfilt), on the host."""
    bh, ah = _ss.butter(N=5, Wn=cutoff_hz, btype="high", fs=fs)
    return _ss.filtfilt(bh, ah, x).astype(np.float32)


def peak_quantize_i16(x: np.ndarray) -> tuple[np.ndarray, float]:
    """|x|.max() and rint(x * 32766 / peak) as int16 -> (int16 array, peak)."""
    x = np.ascontiguousarray(x, np.float32)
    peak = float(np.abs(x).max()) if x.size else 0.0
    scale = 32766.0 / max(peak, 1e-9)
    return np.rint(x * scale).astype(np.int16), peak
