"""RMS-threshold silence slicer, for cutting a user's recordings into clips.

Counterpart of ``rvc_tpu/ops/slicer.py`` (the reference's Slicer state
machine, lib/slicer2.py:38-183): an IIR high-pass (``lfilter``, causal, not
``filtfilt``, to avoid pre-ringing) feeds a frame-RMS gate; runs of silent
frames long enough to matter are cut at their minimum-RMS position, with up
to ``max_sil_kept`` frames of silence kept on each side.

Host work in the port's host library (``native.py``), as the JAX package
runs it: the frame RMS of float32 input summed in double, and the scan of
``Slicer._silence_tags``. The plain versions are numpy's
``frame_rms_numpy`` (in the input's dtype; float64 input takes it, as in
JAX) and the Python scan ``Slicer._silence_tags_numpy``.
"""
from __future__ import annotations

import numpy as np
from scipy import signal as _ss

from .. import native


def frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Center-padded frame RMS (librosa.feature.rms semantics): float32
    input in the host library, other dtypes in numpy in their own dtype."""
    y = np.asarray(y)
    if y.dtype == np.float32:
        return native.frame_rms(y, frame_length, hop_length)
    return frame_rms_numpy(y, frame_length, hop_length)


def frame_rms_numpy(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """The plain version of ``frame_rms``, in the input's dtype."""
    y = np.asarray(y)
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad), mode="constant")
    n_frames = 1 + (len(yp) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = yp[idx]
    return np.sqrt(np.mean(frames * frames, axis=-1))


class Slicer:
    """Silence-based slicer; thresholds in dB, times in milliseconds."""

    def __init__(
        self,
        sr: int,
        threshold: float = -40.0,
        min_length: int = 5000,
        min_interval: int = 300,
        hop_size: int = 20,
        max_sil_kept: int = 5000,
    ):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("need min_length >= min_interval >= hop_size")
        if not max_sil_kept >= hop_size:
            raise ValueError("need max_sil_kept >= hop_size")
        min_interval_samples = sr * min_interval / 1000
        self.threshold = 10 ** (threshold / 20.0)
        self.hop_size = round(sr * hop_size / 1000)
        self.win_size = min(round(min_interval_samples), 4 * self.hop_size)
        self.min_length = round(sr * min_length / 1000 / self.hop_size)
        self.min_interval = round(min_interval_samples / self.hop_size)
        self.max_sil_kept = round(sr * max_sil_kept / 1000 / self.hop_size)
        self._bh, self._ah = _ss.butter(N=5, Wn=48, btype="high", fs=sr)

    def _cut(self, waveform: np.ndarray, begin: int, end: int) -> np.ndarray:
        lo = begin * self.hop_size
        hi = min(waveform.shape[-1], end * self.hop_size)
        return waveform[..., lo:hi]

    def _silence_tags(self, rms: np.ndarray) -> list[tuple[int, int]]:
        """Scan the RMS track and emit (start, end) frame ranges to delete, in
        the host library."""
        return native.slicer_silence_tags(rms, self.threshold, self.min_interval,
                                          self.min_length, self.max_sil_kept)

    def _silence_tags_numpy(self, rms: np.ndarray) -> list[tuple[int, int]]:
        """The plain version of ``_silence_tags``, a Python loop."""
        tags: list[tuple[int, int]] = []
        sil_start: int | None = None
        clip_start = 0
        K = self.max_sil_kept
        for i, r in enumerate(rms):
            if r < self.threshold:
                if sil_start is None:
                    sil_start = i
                continue
            if sil_start is None:
                continue
            leading = sil_start == 0 and i > K
            middle = i - sil_start >= self.min_interval and i - clip_start >= self.min_length
            if not leading and not middle:
                sil_start = None
                continue
            run = i - sil_start
            if run <= K:
                pos = int(rms[sil_start : i + 1].argmin()) + sil_start
                tags.append((0, pos) if sil_start == 0 else (pos, pos))
                clip_start = pos
            elif run <= 2 * K:
                pos = int(rms[i - K : sil_start + K + 1].argmin()) + i - K
                pos_l = int(rms[sil_start : sil_start + K + 1].argmin()) + sil_start
                pos_r = int(rms[i - K : i + 1].argmin()) + i - K
                if sil_start == 0:
                    tags.append((0, pos_r))
                    clip_start = pos_r
                else:
                    tags.append((min(pos_l, pos), max(pos_r, pos)))
                    clip_start = max(pos_r, pos)
            else:
                pos_l = int(rms[sil_start : sil_start + K + 1].argmin()) + sil_start
                pos_r = int(rms[i - K : i + 1].argmin()) + i - K
                tags.append((0, pos_r) if sil_start == 0 else (pos_l, pos_r))
                clip_start = pos_r
            sil_start = None
        total = len(rms)
        if sil_start is not None and total - sil_start >= self.min_interval:
            sil_end = min(total, sil_start + K)
            pos = int(rms[sil_start : sil_end + 1].argmin()) + sil_start
            tags.append((pos, total + 1))
        return tags

    def slice(self, waveform: np.ndarray) -> list[np.ndarray]:
        filtered = _ss.lfilter(self._bh, self._ah, waveform)
        mono = filtered.mean(axis=0) if filtered.ndim > 1 else filtered
        if mono.shape[0] <= self.min_length:
            return [filtered]
        rms = frame_rms(mono.astype(np.float32), self.win_size, self.hop_size)
        tags = self._silence_tags(rms)
        if not tags:
            return [filtered]
        chunks = []
        if tags[0][0] > 0:
            chunks.append(self._cut(filtered, 0, tags[0][0]))
        for (_, end), (start, _) in zip(tags[:-1], tags[1:]):
            chunks.append(self._cut(filtered, end, start))
        if tags[-1][1] < len(rms):
            chunks.append(self._cut(filtered, tags[-1][1], len(rms)))
        return chunks
