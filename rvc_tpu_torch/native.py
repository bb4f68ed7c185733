"""The port's host library: ctypes bindings for ``csrc/host/rvc_host.cpp``.

Counterpart of ``rvc_tpu/native/__init__.py``, over the port's own copy of
the source. ``library()`` builds it at first use with ``g++ -O3 -shared
-fPIC`` into ``rvc_tpu_torch/_build/host-<hash>/`` (the hash of the source
and the flags, so an edit rebuilds) and loads it. A build or load failure
raises: no caller falls back to numpy on its own. The numpy versions are
the plain versions (``ops/filters.peak_quantize_i16_numpy``,
``ops/slicer.frame_rms_numpy``, ``ops/slicer.Slicer._silence_tags_numpy``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent
SOURCE = PKG / "csrc" / "host" / "rvc_host.cpp"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build() -> Path:
    """The shared object, compiled unless a build of this source exists. It
    is written under a temporary name and renamed, so that processes
    building at once never load a half-written file."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    out = PKG / "_build" / f"host-{digest}" / "librvc_host.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        r = subprocess.run(["g++", *FLAGS, "-o", tmp, str(SOURCE)], capture_output=True,
                           text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            i64, f32p, i16p, i64p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                                     ctypes.POINTER(ctypes.c_int16),
                                     ctypes.POINTER(ctypes.c_int64))
            lib.peak_quantize_i16.argtypes = [f32p, i64, i16p]
            lib.peak_quantize_i16.restype = ctypes.c_double
            lib.frame_rms.argtypes = [f32p, i64, i64, i64, f32p]
            lib.frame_rms.restype = i64
            lib.slicer_silence_tags.argtypes = [f32p, i64, ctypes.c_double, i64, i64, i64,
                                                i64p, i64]
            lib.slicer_silence_tags.restype = i64
            _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def peak_quantize_i16(x: np.ndarray) -> tuple[np.ndarray, float]:
    """|x|.max() and rint(x * 32766 / max(peak, 1e-9)) as int16 -> (int16
    array, peak), in two streaming passes."""
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.int16)
    peak = library().peak_quantize_i16(_ptr(x, ctypes.c_float), x.size,
                                       _ptr(out, ctypes.c_int16))
    return out, float(peak)


def frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Centre-padded frame RMS of float32 ``y`` (librosa.feature.rms
    semantics), each frame's sum of squares in double, as float32."""
    y = np.ascontiguousarray(y, np.float32)
    n_frames = 1 + (len(y) + 2 * (frame_length // 2) - frame_length) // hop_length
    out = np.empty(max(n_frames, 0), np.float32)
    got = library().frame_rms(_ptr(y, ctypes.c_float), len(y), frame_length, hop_length,
                              _ptr(out, ctypes.c_float))
    return out[:got]


def slicer_silence_tags(rms: np.ndarray, threshold: float, min_interval: int,
                        min_length: int, max_sil_kept: int) -> list[tuple[int, int]]:
    """The slicer's state machine over an RMS track: the (start, end) frame
    ranges to cut."""
    rms = np.ascontiguousarray(rms, np.float32)
    cap = 64
    while True:
        tags = np.empty(2 * cap, np.int64)
        n = library().slicer_silence_tags(
            _ptr(rms, ctypes.c_float), len(rms), float(threshold), int(min_interval),
            int(min_length), int(max_sil_kept), _ptr(tags, ctypes.c_int64), cap)
        if n >= 0:
            return [(int(tags[2 * i]), int(tags[2 * i + 1])) for i in range(n)]
        cap *= 4

