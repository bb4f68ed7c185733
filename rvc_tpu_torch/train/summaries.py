"""TensorBoard summaries: spectrogram images, audio and scalars in one call.

The port's copy of ``rvc_tpu/train/summaries.py`` (the reference's
lib/train/utils.py ``plot_spectrogram_to_numpy`` and ``summarize``, used by
training_cli.py:604-663). The reference renders through matplotlib; here the
mel matrix is colour-mapped directly through a small numpy table.
"""
from __future__ import annotations

import numpy as np

# 16-anchor approximations of matplotlib's viridis / hot, linearly
# interpolated to 256 entries at import time.
_VIRIDIS16 = np.array([
    (68, 1, 84), (72, 26, 108), (71, 47, 125), (65, 68, 135),
    (57, 86, 140), (49, 104, 142), (42, 120, 142), (35, 136, 142),
    (31, 152, 139), (34, 168, 132), (53, 183, 121), (84, 197, 104),
    (122, 209, 81), (165, 219, 54), (210, 226, 27), (253, 231, 37),
], np.float32)
_HOT16 = np.array([
    (11, 0, 0), (58, 0, 0), (105, 0, 0), (152, 0, 0),
    (199, 0, 0), (246, 0, 0), (255, 38, 0), (255, 85, 0),
    (255, 132, 0), (255, 179, 0), (255, 226, 0), (255, 255, 32),
    (255, 255, 93), (255, 255, 149), (255, 255, 202), (255, 255, 255),
], np.float32)


def _lut(anchors: np.ndarray) -> np.ndarray:
    x = np.linspace(0.0, len(anchors) - 1.0, 256)
    i0 = np.clip(np.floor(x).astype(int), 0, len(anchors) - 2)
    f = (x - i0)[:, None]
    return ((1 - f) * anchors[i0] + f * anchors[i0 + 1]).astype(np.uint8)


_LUTS = {"viridis": _lut(_VIRIDIS16), "hot": _lut(_HOT16)}


def plot_spectrogram_to_numpy(spec: np.ndarray, cmap: str = "viridis") -> np.ndarray:
    """(n_mels, T) float → (n_mels, T, 3) uint8 RGB, low frequencies at the
    bottom (same orientation as the reference's origin='lower' imshow)."""
    s = np.asarray(spec, np.float32)
    lo, hi = float(s.min()), float(s.max())
    norm = (s - lo) / (hi - lo) if hi > lo else np.zeros_like(s)
    idx = np.clip((norm * 255).astype(int), 0, 255)
    return _LUTS[cmap][idx][::-1]


def summarize(writer, global_step: int, scalars: dict | None = None,
              images: dict | None = None, audios: dict | None = None,
              audio_sampling_rate: int = 22050) -> None:
    """Mirror of reference utils.summarize: one call logs every kind."""
    for k, v in (scalars or {}).items():
        writer.add_scalar(k, v, global_step)
    for k, v in (images or {}).items():
        writer.add_image(k, v, global_step, dataformats="HWC")
    for k, v in (audios or {}).items():
        a = np.asarray(v, np.float32).reshape(-1)
        peak = np.max(np.abs(a))
        if peak > 1.0:  # tensorboardX expects [-1, 1]
            a = a / peak
        writer.add_audio(k, a[:, None], global_step,
                         sample_rate=audio_sampling_rate)
