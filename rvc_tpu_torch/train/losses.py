"""GAN, reconstruction and aux losses of the training step.

Counterpart of ``rvc_tpu/train/losses.py`` (the reference's
lib/train/losses.py), every loss reduced in float32: LSGAN discriminator and
generator losses, feature matching, the VITS prior KL, the mel L1;
``MultiScaleMelLoss`` (log-mel L1 or L2 at six static mel banks); and the
aux losses of ``combined_aux_loss``: TEFS (Hilbert envelope and phase
cosine), TSI (envelope correlation along both axes of the log-mel) and the
harmonic/percussive L1 of a median-filter HPSS. These keep the JAX
package's (B, frames, n_mels) mel layout and its reductions: one min and
max over the whole batch in ``_minmax_scale``, ties of a max sharing its
gradient equally (``amax``), the median as the middle of a stable sort.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops.mel import mel_spectrogram
from ..ops.stft import frame_signal, reflect_pad


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.float() - gl.float()))
    return loss


def discriminator_loss(disc_real, disc_gen):
    loss, per_disc = 0.0, []
    for dr, dg in zip(disc_real, disc_gen):
        part = torch.mean((1.0 - dr.float()) ** 2) + torch.mean(dg.float() ** 2)
        per_disc.append(part)
        loss = loss + part
    return loss, per_disc


def generator_loss(disc_gen):
    loss, per_disc = 0.0, []
    for dg in disc_gen:
        part = torch.mean((1.0 - dg.float()) ** 2)
        per_disc.append(part)
        loss = loss + part
    return loss, per_disc


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask) -> torch.Tensor:
    """VITS prior KL; tensors (B, C, T), mask (B, 1, T). The numerator sums
    over channels, the denominator counts each valid frame once."""
    z_p, logs_q, m_p, logs_p = (t.float() for t in (z_p, logs_q, m_p, logs_p))
    m = z_mask.float()
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * m) / torch.sum(m)


def mel_l1(y_mel, y_hat_mel) -> torch.Tensor:
    return torch.mean(torch.abs(y_mel.float() - y_hat_mel.float()))


# ---- the multi-scale mel loss ----


def _window_length(n_mels: int, sample_rate: int) -> int:
    w = int(8 * n_mels / (sample_rate / 2) * sample_rate)
    return 2 ** (w.bit_length() - 1)


class MultiScaleMelLoss:
    """Static-bank multi-scale log-mel loss (rvc_tpu/train/losses.py:88): per
    bank, hop ``sr // 100`` and ``n_fft = win_length`` from ``_window_length``;
    the mean over banks of the L1 (or ``"l2"``) of the log-mels."""

    def __init__(self, sampling_rate: int, n_mels: Sequence[int] = (20, 64, 80, 128, 160, 256),
                 fmin: float = 50.0, fmax: float | None = None, loss: str = "l1"):
        self.sampling_rate = sampling_rate
        self.n_mels = sorted(n_mels)
        self.windows = [_window_length(m, sampling_rate) for m in self.n_mels]
        self.hop = sampling_rate // 100
        self.fmin = fmin
        self.fmax = fmax if fmax is not None else sampling_rate / 2
        self.loss = loss

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y (B, T) waveforms."""
        total = 0.0
        for n_mels, win in zip(self.n_mels, self.windows):
            xm, ym = (mel_spectrogram(w.float(), win, n_mels, self.sampling_rate, self.hop, win,
                                      self.fmin, self.fmax) for w in (x, y))
            d = xm - ym
            total = total + (torch.mean(d * d) if self.loss == "l2" else torch.mean(torch.abs(d)))
        return total / len(self.n_mels)


# ---- the aux losses: TEFS, TSI, harmonic ----


def _minmax_scale(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """One min and one max over the whole tensor (the batch included)."""
    lo = torch.amin(x)
    return (x - lo) / (torch.amax(x) - lo + eps)


def compute_tefs(audio: torch.Tensor, eps: float = 1e-8):
    """(B, T) -> the Hilbert envelope min-max scaled, and the cosine of the
    instantaneous phase's steps (rvc_tpu/train/losses.py:128)."""
    x = audio.float()
    n = x.shape[-1]
    h = torch.zeros(n, dtype=torch.float32, device=x.device)
    h[0] = 1
    if n % 2 == 0:
        h[1:n // 2] = 2
        h[n // 2] = 1
    else:
        h[1:(n + 1) // 2] = 2
    analytic = torch.fft.ifft(torch.fft.fft(x, dim=-1) * h, dim=-1)
    env = _minmax_scale(torch.abs(analytic), eps)
    phase = torch.cos(torch.diff(torch.angle(analytic), dim=-1))
    return torch.nan_to_num(env, nan=eps), torch.nan_to_num(phase, nan=eps)


def _l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def _max_pool_lastdim(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """A max over windows of k along the last axis, padded with -inf."""
    pad = k // 2
    xp = F.pad(x, (pad, pad), value=-math.inf)
    return torch.amax(frame_signal(xp, k, 1), dim=-1)


def _envelope(log_mag: torch.Tensor, axis: int, eps: float = 1e-8) -> torch.Tensor:
    """The peak envelope summed along ``axis`` (-1 or -2) of (B, frames,
    n_mels) (the reference's compute_envelope)."""
    x = _l2_normalize(log_mag, axis)
    if axis in (-2, log_mag.ndim - 2):
        pooled = _max_pool_lastdim(x.transpose(-1, -2), 3).transpose(-1, -2)
        return torch.nan_to_num(pooled, nan=eps).sum(dim=-2)
    return torch.nan_to_num(_max_pool_lastdim(x, 3), nan=eps).sum(dim=-1)


def _pearson(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    xc = x - x.mean(-1, keepdim=True)
    yc = y - y.mean(-1, keepdim=True)
    cov = torch.sum(xc * yc, -1)
    sx = torch.sqrt(torch.sum(xc * xc, -1) + eps)
    sy = torch.sqrt(torch.sum(yc * yc, -1) + eps)
    return torch.nan_to_num(cov / (sx * sy + eps), nan=eps)


def compute_tsi_loss(org_log_mag: torch.Tensor, gen_log_mag: torch.Tensor, axis: int = -1,
                     eps: float = 1e-8) -> torch.Tensor:
    eo = _envelope(org_log_mag, axis, eps)
    eg = _envelope(gen_log_mag, axis, eps)
    return torch.mean(1.0 - _pearson(eo, eg, eps))


def _median_pool(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """A median filter of k along ``axis``, reflect-padded (reflecting again
    where k // 2 reaches past the axis, as ``jnp.pad`` does). The median is
    the middle of a stable sort, so its gradient goes where JAX's does."""
    x = torch.movedim(x, axis, -1)
    xp = reflect_pad(x, k // 2, k // 2)
    out = torch.sort(frame_signal(xp, k, 1), dim=-1, stable=True).values[..., k // 2]
    return torch.movedim(out, -1, axis)


def hpss(spec: torch.Tensor, kernel_size: int = 31, power: float = 2.0, eps: float = 1e-10):
    """Median-filter harmonic/percussive separation with soft masks
    (librosa.decompose.hpss with margin 1) of a (..., frames, F) magnitude:
    the harmonic part smooth along frames, the percussive along F."""
    harm = _median_pool(spec, kernel_size, axis=-2)
    perc = _median_pool(spec, kernel_size, axis=-1)
    hp = torch.pow(torch.clamp(harm, min=0.0), power)
    pp = torch.pow(torch.clamp(perc, min=0.0), power)
    total = hp + pp
    denom = torch.clamp(total, min=eps)
    mask_h = torch.where(total > eps, hp / denom, 0.5)
    mask_p = torch.where(total > eps, pp / denom, 0.5)
    return spec * mask_h, spec * mask_p


def compute_harmonics(mag: torch.Tensor, kernel_sizes=(3, 7, 13, 19, 29), eps: float = 1e-8):
    """HPSS at each kernel size, concatenated on the last axis and min-max
    scaled; ``eps`` is the scaling's (``hpss`` keeps its own)."""
    spec = torch.abs(mag.float())
    hs, ps = zip(*(hpss(spec, k) for k in kernel_sizes))
    harmonic = _minmax_scale(torch.cat(hs, dim=-1), eps)
    percussive = _minmax_scale(torch.cat(ps, dim=-1), eps)
    return torch.nan_to_num(harmonic, nan=eps), torch.nan_to_num(percussive, nan=eps)


def combined_aux_loss(original_audio: torch.Tensor, generated_audio: torch.Tensor,
                      c_tefs: float = 1.0, c_hd: float = 1.0, c_tsi: float = 1.0,
                      n_mels: int = 128, sample_rate: int = 40000, n_fft: int = 1024,
                      hop_length: int = 320, win_length: int = 1024, fmin: float = 0.0,
                      fmax: float | None = None, eps: float = 1e-8):
    """(harmonic, tefs, tsi) losses of (B, T) waveforms; a loss whose weight
    is 0 is not computed and is 0 (rvc_tpu/train/losses.py:229)."""
    zero = generated_audio.new_zeros((), dtype=torch.float32)
    harmonic_loss = tefs_loss = tsi_loss = zero
    if c_hd + c_tsi > 0:
        org_mag, gen_mag = (mel_spectrogram(w.float(), n_fft, n_mels, sample_rate, hop_length,
                                            win_length, fmin, fmax)
                            for w in (original_audio, generated_audio))
    if c_hd > 0:
        oh, op = compute_harmonics(org_mag, eps=eps)
        gh, gp = compute_harmonics(gen_mag, eps=eps)
        harmonic_loss = torch.mean(torch.abs(gh - oh)) + torch.mean(torch.abs(gp - op))
    if c_tsi > 0:
        tsi_loss = (compute_tsi_loss(org_mag, gen_mag, -1, eps)
                    + compute_tsi_loss(org_mag, gen_mag, -2, eps))
    if c_tefs > 0:
        ge, gph = compute_tefs(generated_audio, eps)
        oe, oph = compute_tefs(original_audio, eps)
        tefs_loss = torch.mean(torch.abs(ge - oe)) + torch.mean(torch.abs(gph - oph))
    return harmonic_loss, tefs_loss, tsi_loss
