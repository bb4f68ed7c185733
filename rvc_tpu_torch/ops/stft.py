"""Framing of a signal into overlapping windows, and a reflect pad of any width.

Counterpart of ``rvc_tpu/ops/stft.py::frame_signal``; the JAX package's two
lowerings (conv patches, gather) are one ``Tensor.unfold`` here.
``reflect_pad`` is ``jnp.pad(mode="reflect")`` on the last axis, which
reflects again where the pad is as long as the signal or longer (numpy's
rule); ``F.pad(mode="reflect")`` raises there.
"""
from __future__ import annotations

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
