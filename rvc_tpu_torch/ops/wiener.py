"""Multichannel Wiener filtering by expectation-maximization, in complex64.

Counterpart of ``rvc_tpu/ops/wiener.py`` (the reference's OpenUnmix-derived
``demucs/filtering.py``), used by the non-CaC Demucs checkpoints to refine
magnitude estimates against the mixture's complex STFT. The same formulas:
the 1x1 and 2x2 covariance inverses written out (the 2x2 by its
determinant), the same einsums, the 300-frame windows of the reference's
``_wiener`` (hdemucs.py:655-668) and the scale-down by the window's peak
over ``scale_factor``. The JAX package maps over the windows one at a
time; here every window of every batch row is one leading batch axis.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _invert_hermitian(M: torch.Tensor) -> torch.Tensor:
    """(..., C, C) complex matrices, C in {1, 2}, inverted analytically."""
    C = M.shape[-1]
    if C == 1:
        return 1.0 / M
    if C == 2:
        det = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
        inv_det = 1.0 / det
        row0 = torch.stack([M[..., 1, 1], -M[..., 0, 1]], dim=-1)
        row1 = torch.stack([-M[..., 1, 0], M[..., 0, 0]], dim=-1)
        return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]
    raise NotImplementedError("only 1 or 2 channels supported")


def expectation_maximization(y: torch.Tensor, x: torch.Tensor, iterations: int,
                             eps: float = 1e-10) -> torch.Tensor:
    """EM refinement of source estimates (reference filtering.py:152).
    y: (N, T, F, C, S) complex initial source STFTs, x: (N, T, F, C) complex
    mixture, N independent windows. Returns the refined y."""
    C = x.shape[-1]
    reg = math.sqrt(torch.tensor(eps, dtype=torch.float32).item()) * torch.eye(
        C, dtype=y.dtype, device=y.device)
    for _ in range(iterations):
        v = torch.mean(y.abs() ** 2, dim=-2)                      # (N, T, F, S)
        R = torch.einsum("ntfcs,ntfds->nfcds", y, y.conj())
        R = R / (eps + v.sum(dim=1))[:, :, None, None, :]         # (N, F, C, C, S)
        Cxx = reg + torch.einsum("ntfs,nfcds->ntfcd", v.to(y.dtype), R)
        inv_Cxx = _invert_hermitian(Cxx)
        gain = torch.einsum("nfces,ntfed->ntfcds", R, inv_Cxx)
        gain = gain * v[:, :, :, None, None, :].to(y.dtype)
        y = torch.einsum("ntfcds,ntfd->ntfcs", gain, x)
    return y


def wiener(mag: torch.Tensor, mix: torch.Tensor, iterations: int, residual: bool = False,
           win_len: int = 300, scale_factor: float = 10.0, eps: float = 1e-10) -> torch.Tensor:
    """Wiener separation in ``win_len``-frame windows (reference
    filtering.py:336 with hdemucs.py's windowing; the JAX package's
    ``softmask`` start has no caller and is not ported). mag (..., T, F, C,
    S) float magnitudes, mix (..., T, F, C) complex64 -> (..., T, F, C, S)
    complex64: the magnitudes with the mixture's phase, refined by
    ``iterations`` of EM. The residual source, when asked for, is refined
    with the others and not returned (hdemucs.py:668)."""
    *lead, T, Fr, C, S = mag.shape
    n_win = max(1, -(-T // win_len))
    pad = n_win * win_len - T
    # windows of every leading row on one axis: (N, win_len, F, C[, S])
    mag_w = F.pad(mag.float(), (0, 0, 0, 0, 0, 0, 0, pad)).reshape(-1, win_len, Fr, C, S)
    mix_w = torch.view_as_complex(F.pad(torch.view_as_real(mix), (0, 0, 0, 0, 0, 0, 0, pad))
                                  .reshape(-1, win_len, Fr, C, 2).contiguous())
    norm = mix_w.abs()
    unit = torch.where(norm > 0, mix_w / norm.clamp(min=1e-30), torch.ones_like(mix_w))
    y = mag_w * unit[..., None]
    if residual:
        y = torch.cat([y, mix_w[..., None] - y.sum(dim=-1, keepdim=True)], dim=-1)
    if iterations:
        max_abs = torch.clamp(norm.amax(dim=(1, 2, 3)) / scale_factor, min=1.0)
        m = max_abs[:, None, None, None]
        y = expectation_maximization(y / m[..., None], mix_w / m, iterations, eps=eps)
        y = y * m[..., None]
    y = y.reshape(*lead, n_win * win_len, Fr, C, -1)[..., :T, :, :, :S]
    return y
