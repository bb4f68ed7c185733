"""Host-side audio I/O: read, resample, downmix, mix and write waveforms.

Counterpart of ``rvc_tpu/io/audio.py``, numpy and scipy only: the file and
remix functions (``load_input_audio``, ``remix_audio``, ``save_input_audio``,
``pad_audio``), the transport codecs of the node layer (``audio_to_bytes``,
``bytes_to_audio``, ``audio2str``, ``str2audio``), ``merge_audio``,
``autotune_f0``, ``hz_to_mel`` and the click and silence cleaner
``AudioProcessor``. A ``.wav`` file, or any file when no ``ffmpeg`` is on
the path, is read by scipy's wav reader; other containers are decoded by
the ffmpeg command line. Resampling here is scipy's polyphase ``resample_poly``, the
same function as the device resampler of ``ops.resample``.
"""
from __future__ import annotations

import base64
import io as _io
import math
import os
import shutil
import subprocess
import zlib

import numpy as np
from scipy import signal as _ss
from scipy.io import wavfile as _wavfile

from ..utils import get_merge_func

MAX_INT16 = 32768
SUPPORTED_AUDIO = ["mp3", "flac", "wav"]

# the equal-tempered notes C2..B7 that autotune snaps to
AUTOTUNE_NOTES = 440.0 * 2.0 ** ((np.arange(72) - 33) / 12.0)


def hz_to_mel(hz):
    """HTK mel of ``hz``, in float64."""
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


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


def audio_to_bytes(audio, sr: int, to_int16: bool = False) -> bytes:
    """A WAV file's bytes: float32, or with ``to_int16`` int16 after scaling
    down to a peak of 0.99 where above it."""
    audio = np.asarray(audio, dtype=np.float32)
    if to_int16:
        audio_max = np.abs(audio).max() / 0.99
        if audio_max > 1:
            audio = audio / audio_max
        audio = np.clip(audio * MAX_INT16, -MAX_INT16 + 1, MAX_INT16 - 1).astype(np.int16)
    buf = _io.BytesIO()
    _write_wav(buf, audio, sr)
    buf.seek(0)
    return buf.read()


def bytes_to_audio(data: bytes) -> tuple[np.ndarray, int]:
    """A WAV file's bytes -> (audio, sr): int16 scaled to float32,
    (channels, frames) when multichannel."""
    sr, audio = _wavfile.read(_io.BytesIO(data))
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 32768.0
    if audio.ndim > 1 and audio.shape[1] < audio.shape[0]:
        audio = audio.T
    return audio, int(sr)


def audio2str(audio: np.ndarray, sr: int) -> str:
    """A string that carries an array exactly: its dtype, base64 of its
    zlib-compressed bytes, its shape and ``sr``, joined by colons."""
    data = zlib.compress(np.ascontiguousarray(audio).tobytes())
    enc = base64.b64encode(data).decode()
    return ":".join([audio.dtype.name, enc, ",".join(map(str, audio.shape)), str(sr)])


def str2audio(s: str) -> tuple[np.ndarray, int]:
    """The inverse of ``audio2str``."""
    dtype, data, shape, sr = s.split(":")
    arr = np.frombuffer(zlib.decompress(base64.b64decode(data)), dtype=dtype)
    return arr.reshape(tuple(map(int, shape.split(",")))).copy(), int(sr)


def merge_audio(audio1, audio2, sr: int = 40000, **kwargs):
    """Two (audio, sr) clips remixed to ``sr`` (the lower rate if None),
    zero-padded to one length and merged by ``remix_audio`` (its
    ``merge_type`` reducer over the pair; ``kwargs`` go to each remix)."""
    if sr is None:
        sr = min(audio1[-1], audio2[-1])
    m1, _ = remix_audio(audio1, target_sr=sr, axis=0, **kwargs)
    m2, _ = remix_audio(audio2, target_sr=sr, axis=0, **kwargs)
    mixed = pad_audio(m1, m2, axis=0)
    return remix_audio((mixed, sr), axis=0, **kwargs)


def autotune_f0(f0: np.ndarray, threshold: float = 0.0) -> np.ndarray:
    """f0 snapped to the nearest of ``AUTOTUNE_NOTES``, kept where it lies
    within ``threshold`` Hz of it."""
    f0 = np.asarray(f0, dtype=np.float32)
    diff = np.abs(AUTOTUNE_NOTES[None, :] - f0[..., None])
    idx = np.argmin(diff, axis=-1)
    nearest = AUTOTUNE_NOTES[idx].astype(np.float32)
    keep = np.take_along_axis(diff, idx[..., None], axis=-1)[..., 0] < threshold
    return np.where(keep, f0, nearest)


class AudioProcessor:
    """Click and silence cleaner: an RMS silence gate
    (``ops.karafan_utils.silent``), clicks above ``multiplier`` times the
    local RMS replaced by a median or by linear interpolation, and peak
    normalization (``ops.karafan_utils.normalize``). ``str()`` is a hash of
    the settings in use, for the node layer's caches."""

    def __init__(self, normalize=True, threshold_silence=True, dynamic_threshold=True,
                 sample_size=16000, multiplier=2.0, fill_method="median",
                 kernel_size=5, silence_threshold_db=-50, normalize_threshold_db=-1):
        self.normalize = normalize
        self.threshold_silence = threshold_silence
        self.dynamic_threshold = dynamic_threshold
        self.sample_size = sample_size
        self.multiplier = multiplier
        self.fill_method = fill_method
        self.kernel_size = kernel_size
        self.silence_threshold_db = silence_threshold_db
        self.normalize_threshold_db = normalize_threshold_db

    def __str__(self) -> str:
        from ..utils import get_hash

        values = [self.normalize, self.threshold_silence, self.dynamic_threshold]
        if self.normalize:
            values.append(self.normalize_threshold_db)
        if self.threshold_silence:
            values.append(self.silence_threshold_db)
        if self.dynamic_threshold:
            values.extend([self.sample_size, self.multiplier, self.fill_method,
                           self.kernel_size])
        return get_hash(*values)

    def __call__(self, audio) -> tuple[np.ndarray, int]:
        """(samples, sr), or samples alone at 44.1 kHz -> (cleaned, sr)."""
        from ..ops.karafan_utils import normalize as _norm
        from ..ops.karafan_utils import silent

        samples, sr = audio if isinstance(audio, tuple) else (audio, 44100)
        samples = np.asarray(samples, np.float32)
        if self.threshold_silence:
            samples = np.squeeze(
                silent(np.atleast_2d(samples), sr, self.silence_threshold_db), 0)
        if self.dynamic_threshold:
            samples = self.dynamic_thresholding(
                samples, self.multiplier, self.sample_size, self.fill_method,
                self.kernel_size)
        if self.normalize:
            samples = _norm(samples, self.normalize_threshold_db)
        return samples, sr

    @staticmethod
    def dynamic_thresholding(samples, multiplier=2.0, sample_size=16000,
                             method="median", kernel_size=5):
        from scipy.ndimage import uniform_filter1d

        local_rms = np.sqrt(uniform_filter1d(np.square(samples), size=int(sample_size)))
        clicks = np.abs(samples) > multiplier * local_rms
        return AudioProcessor.replace_clicks(samples, clicks, method, kernel_size)

    @staticmethod
    def replace_clicks(samples, clicks, method="median", kernel_size=5):
        from scipy.interpolate import interp1d
        from scipy.ndimage import median_filter

        cleaned = samples.copy()
        if method == "median":
            cleaned[clicks] = median_filter(samples, size=kernel_size)[clicks]
        elif method == "interpolation":
            good = np.where(~clicks)[0]
            bad = np.where(clicks)[0]
            if len(good) > 1 and len(bad):
                f = interp1d(good, cleaned[good], kind="linear", bounds_error=False,
                             fill_value="extrapolate")
                cleaned[bad] = f(bad)
        else:
            raise ValueError("Method must be 'median' or 'interpolation'")
        return cleaned
