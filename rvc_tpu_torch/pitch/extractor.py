"""Pitch extraction on the conversion path: the RMVPE route.

Counterpart of ``rvc_tpu/pitch/extractor.py``: ``coarse_f0``,
``shift_semitones``, ``autotune``, the ``filter_radius`` median pass (which
the rmvpe route does not apply, as in JAX) and the method function of
``rmvpe`` / ``rmvpe+``. The other methods (pm, dio, harvest, crepe) are
not ported yet and raise.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.layers import set_dtype_
from ..models.rmvpe import RMVPE
from ..ops.filters import median_filter_1d

F0_BINS = 256
METHODS = ("rmvpe", "rmvpe+")


def coarse_f0(f0: torch.Tensor, f0_min: float = 50.0, f0_max: float = 1100.0) -> torch.Tensor:
    """f0 Hz -> 1..255 mel bins (int64)."""
    mel_min = 2595.0 * np.log10(1.0 + f0_min / 700.0)
    mel_max = 2595.0 * np.log10(1.0 + f0_max / 700.0)
    mel = 2595.0 * torch.log10(1.0 + f0 / 700.0)
    mel = (mel - mel_min) * (F0_BINS - 2) / (mel_max - mel_min) + 1.0
    return torch.round(torch.clamp(mel, 1.0, F0_BINS - 1)).to(torch.int64)


def shift_semitones(f0: torch.Tensor, semitones: float) -> torch.Tensor:
    return f0 * (2.0 ** (semitones / 12.0))


def autotune(f0: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Snap to the 72-note equal-tempered table."""
    notes = torch.as_tensor(440.0 * 2.0 ** ((np.arange(72) - 33) / 12.0),
                            dtype=f0.dtype, device=f0.device)
    diff = torch.abs(notes - f0[..., None])
    best, idx = torch.min(diff, dim=-1)
    return torch.where(best < threshold, f0, notes[idx])


def median_pass(f0: torch.Tensor, radius: int) -> torch.Tensor:
    """The optional f0 median filter (applied where radius > 2)."""
    return median_filter_1d(f0, radius) if radius > 2 else f0


class PitchExtractor:
    """Holds the pitch models; ``method_fn`` builds one method's f0 function.
    ``dtype`` is the pitch models' compute dtype, as JAX's
    ``PitchExtractor(dtype=)`` (rvc_tpu/pitch/extractor.py:270); f0 comes
    out in float32 either way."""

    def __init__(self, rmvpe: RMVPE | None = None, dtype: torch.dtype = torch.float32):
        self.rmvpe = rmvpe
        self.dtype = dtype
        if rmvpe is not None:
            set_dtype_(rmvpe, dtype)

    def method_fn(self, method: str, f0_min: float, f0_max: float
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
        """(B, T) 16 kHz -> f0 Hz (B, T // 160 + 1)."""
        if method not in METHODS:
            raise NotImplementedError(f"pitch method {method!r} is not ported yet")
        if self.rmvpe is None:
            raise KeyError("rmvpe weights are not loaded")
        model = self.rmvpe

        @torch.no_grad()
        def fn(audio: torch.Tensor) -> torch.Tensor:
            f0 = model(audio, 0.03)
            if method == "rmvpe+":
                f0 = torch.clamp(f0, f0_min, f0_max)
            return f0

        return fn
