"""Output parity of two renditions: the mel-spectral distance
(``rvc_tpu/bench/parity.py``).

``mel_distance_db`` is the mean absolute difference of 20 log10 mel
magnitudes, in dB, over aligned frames of the two signals, each scaled to
its peak first; ``compare_wavs`` adds an SDR. The STFT and the Slaney mel
filterbank are the port's (``ops.stft``, ``ops.mel``).

    python -m rvc_tpu_torch.bench.parity ours.wav reference.wav --sr 48000 [--device cpu]
"""
from __future__ import annotations

import math

import numpy as np


def mel_distance_db(a: np.ndarray, b: np.ndarray, sr: int, n_fft: int = 2048,
                    hop: int = 512, n_mels: int = 128, device=None) -> float:
    """Mean |difference| of 20 log10 mel magnitudes (dB) over the common
    length, computed on ``device`` (the card unless "cpu")."""
    import torch

    from ..device import resolve_device, set_float32_math
    from ..ops.mel import mel_filterbank_slaney_np
    from ..ops.stft import stft

    dev = resolve_device(device)
    set_float32_math()
    n = min(len(a), len(b))
    a = np.asarray(a[:n], np.float32)
    b = np.asarray(b[:n], np.float32)
    pa = np.abs(a).max() or 1.0
    pb = np.abs(b).max() or 1.0
    a, b = a / pa, b / pb
    fb = torch.from_numpy(mel_filterbank_slaney_np(sr, n_fft, n_mels, 0.0, None)).to(dev)

    def logmel(x):
        real, imag = stft(torch.from_numpy(x).to(dev)[None], n_fft, hop, n_fft, center=True)
        mag = torch.sqrt(real**2 + imag**2 + 1e-9)
        return 20.0 * torch.log10(torch.clamp(mag @ fb, min=1e-5))

    return float((logmel(a) - logmel(b)).abs().mean())


def _at(audio: np.ndarray, from_sr: int, to_sr: int) -> np.ndarray:
    if from_sr == to_sr:
        return audio
    from scipy.signal import resample_poly

    g = math.gcd(from_sr, to_sr)
    return resample_poly(audio, to_sr // g, from_sr // g)


def compare_wavs(path_a: str, path_b: str, sr: int | None = None, device=None) -> dict:
    """Two audio files' downmixes at ``sr`` (the first file's rate if None):
    their mel distance (dB), the SDR of the first against the second, the
    rate and the common length in seconds."""
    from ..io.audio import load_input_audio
    from ..ops.karafan_utils import sdr

    a, sra = load_input_audio(path_a)
    b, srb = load_input_audio(path_b)
    if sr is None:
        sr = sra
    a, b = _at(a, sra, sr), _at(b, srb, sr)
    n = min(len(a), len(b))
    return {
        "mel_distance_db": mel_distance_db(a, b, sr, device=device),
        "sdr_db": float(sdr(a[:n], b[:n]).mean()),
        "sr": sr,
        "seconds": n / sr,
    }


if __name__ == "__main__":
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument("ours")
    p.add_argument("reference")
    p.add_argument("--sr", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()
    print(json.dumps(compare_wavs(args.ours, args.reference, args.sr, args.device), indent=2))
