"""Framing of a signal into overlapping windows.

Counterpart of ``rvc_tpu/ops/stft.py::frame_signal``; the JAX package's two
lowerings (conv patches, gather) are one ``Tensor.unfold`` here.
"""
from __future__ import annotations

import torch


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., 1 + (T - frame_length) // hop, frame_length), no
    padding; a view of ``x``."""
    return x.unfold(-1, frame_length, hop)
