"""Host-side audio I/O: read, resample, downmix and write waveforms.

Counterpart of the file and remix half of ``rvc_tpu/io/audio.py``
(``_read_wav``, ``_write_wav``, ``_resample_host``, ``load_input_audio``,
``remix_audio``, ``save_input_audio``, ``pad_audio``), numpy and scipy
only. A ``.wav`` file, or any file when no ``ffmpeg`` is on the path, is
read by scipy's wav reader; other containers are decoded by the ffmpeg
command line. Resampling here is scipy's polyphase ``resample_poly``, the
same function as the device resampler of ``ops.resample``.
"""
from __future__ import annotations

import math
import os
import shutil
import subprocess

import numpy as np
from scipy import signal as _ss
from scipy.io import wavfile as _wavfile

from ..utils import get_merge_func

MAX_INT16 = 32768


def _resample_host(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return audio
    g = math.gcd(int(orig_sr), int(target_sr))
    return _ss.resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def _read_wav(path: str) -> tuple[np.ndarray, int]:
    """float32 samples in [-1, 1), (channels, frames) when multichannel."""
    sr, data = _wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:  # (frames, channels) -> (channels, frames)
        data = data.T
    return data, int(sr)


def _write_wav(path_or_buf, audio: np.ndarray, sr: int) -> None:
    if audio.ndim > 1 and audio.shape[0] < audio.shape[1]:
        audio = audio.T  # wavfile expects frames x channels
    if audio.dtype not in (np.int16, np.float32):
        audio = audio.astype(np.float32)
    _wavfile.write(path_or_buf, sr, audio)


def _ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _load_via_ffmpeg(path: str, sr: int) -> tuple[np.ndarray, int]:
    cmd = ["ffmpeg", "-nostdin", "-threads", "0", "-i", path,
           "-f", "f32le", "-acodec", "pcm_f32le", "-ac", "1", "-ar", str(sr), "-"]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, np.float32).copy(), sr


def load_input_audio(path: str, sr: int | None = None, **kwargs) -> tuple[np.ndarray, int]:
    """Decode a file to float32 PCM at ``sr`` (the file's rate if None),
    then ``remix_audio`` with ``kwargs`` (downmix, peak limit)."""
    path = path.strip().strip('"').strip()
    if path.lower().endswith(".wav") or not _ffmpeg_available():
        audio, file_sr = _read_wav(path)
        if sr is not None and file_sr != sr:
            audio = _resample_host(audio, file_sr, sr)
            file_sr = sr
        return remix_audio((audio, file_sr), **kwargs)
    audio, file_sr = _load_via_ffmpeg(path, sr or 44100)
    return remix_audio((audio, file_sr), **kwargs)


def remix_audio(input_audio, target_sr: int | None = None, norm: bool = False,
                to_int16: bool = False, resample: bool = False, axis: int = 0,
                merge_type: str | None = None, max_volume: float = 0.95,
                **kwargs) -> tuple[np.ndarray, int]:
    """Resample to ``target_sr``, merge channels along ``axis`` (nan-aware
    median by default), optionally peak-normalize, then scale down to a
    peak of ``max_volume`` if above it; int16 with ``to_int16``."""
    audio = np.asarray(input_audio[0], dtype=np.float32)
    in_sr = int(input_audio[1])
    if target_sr is None:
        target_sr = in_sr
    if resample or in_sr != target_sr:
        audio = _resample_host(audio, in_sr, target_sr)
    if audio.ndim > 1:
        audio = get_merge_func(merge_type)(audio, axis=axis)
    if norm:
        peak = np.max(np.abs(audio)) or 1.0
        audio = audio / peak
    audio_max = np.abs(audio).max() / max_volume
    if audio_max > 1:
        audio = audio / audio_max
    if to_int16:
        audio = np.clip(audio * MAX_INT16, 1 - MAX_INT16, MAX_INT16 - 1).astype(np.int16)
    return audio, target_sr


def save_input_audio(fname: str, input_audio, sr: int | None = None, to_int16: bool = False,
                     to_stereo: bool = False, max_volume: float = 0.99) -> str:
    """Write ``(audio, sr)`` to a WAV file: scaled down to a peak of
    ``max_volume`` where above it, int16 if the values still exceed 1
    (``to_int16`` scales to int16 first), else float32."""
    d = os.path.dirname(fname)
    if d:
        os.makedirs(d, exist_ok=True)
    audio = np.asarray(input_audio[0], dtype=np.float32)
    audio_max = np.abs(audio).max() / max_volume
    if audio_max > 1:
        audio = audio / audio_max
    if to_int16:
        audio = np.clip(audio * MAX_INT16, 1 - MAX_INT16, MAX_INT16 - 1)
    if to_stereo and audio.ndim < 2:
        audio = np.stack([audio, audio], axis=-1)
    out = audio.astype(np.int16 if np.abs(audio).max() > 1 else np.float32)
    _write_wav(fname, out, sr if sr else int(input_audio[1]))
    return f"File saved to {fname}"


def pad_audio(*audios, axis: int = 0) -> np.ndarray:
    """Zero-pad to equal length along the last axis and stack on ``axis``."""
    arrs = [np.asarray(a) for a in audios if a is not None]
    maxlen = max((a.shape[-1] for a in arrs), default=0)
    fixed = [np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, maxlen - a.shape[-1])]) for a in arrs]
    return np.stack(fixed, axis=axis)
