"""Karafan's host audio utilities: normalize, the silence gate, Butterworth
and Linkwitz-Riley filters, sample-rate shifting (SRS), the spectral
ensemble and SDR.

The port's own copy of ``rvc_tpu/ops/karafan_utils.py`` (the reference's
``lib/karafan/audio_utils.py`` and ``compare.py``), in numpy and scipy on
the host, as in JAX: these run a few times a song around the separators,
which take the card's time.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import signal as _ss


def normalize(audio: np.ndarray, threshold_db: float = -1.0) -> np.ndarray:
    """DC-remove + peak-normalize to threshold dBFS (reference
    audio_utils.Normalize:89-107 — the DC suppression is part of the
    contract: 'every process is based on RMS dB levels'). The in-place
    op order (subtract, divide, multiply) mirrors the reference so float32
    results are bit-identical."""
    audio = np.asarray(audio).copy()
    audio -= np.mean(audio)
    peak = np.max(np.abs(audio))
    if peak > 0.0:
        audio /= peak
        audio *= 10 ** (threshold_db / 20)
    return audio


def _window_rms_db(chunk: np.ndarray, frame: int) -> float:
    """max RMS of a chunk in dB, librosa-framing semantics (centered frames
    of ``frame`` samples at hop ``frame``, zero pad, amin 1e-5) — what the
    reference Silent measures per window (audio_utils.py:132)."""
    mono2 = np.atleast_2d(chunk) ** 2
    padded = np.pad(mono2, [(0, 0), (frame // 2, frame // 2)])
    n_frames = 1 + (padded.shape[-1] - frame) // frame
    vals = [np.sqrt(np.mean(padded[:, k * frame : k * frame + frame], axis=-1))
            for k in range(max(n_frames, 1))]
    return float(20 * np.log10(np.maximum(1e-5, np.max(vals))))


def silent(audio_in: np.ndarray, sample_rate: int,
           threshold_db: float = -50.0) -> np.ndarray:
    """Zero sustained below-threshold regions with fades — behavior-exact
    port of reference audio_utils.Silent:109-167 (window 500 ms, min size
    1 s, 300 ms linear fades, max-RMS-in-dB gate, including its quirk of
    anchoring the region at the last loud window)."""
    sr = sample_rate
    min_size = int(1.000 * sr)
    window = int(0.500 * sr)
    fade_len = int(0.300 * sr)
    fade_out = np.linspace(1.0, 0.0, fade_len)
    fade_in = np.linspace(0.0, 1.0, fade_len)

    audio = np.atleast_2d(audio_in).copy()
    n = audio.shape[-1]
    start = end = 0
    for i in range(0, n, window):
        rms_db = _window_rms_db(audio[:, i : i + window], window)
        if rms_db < threshold_db:
            end = i + window
            if i >= n - window:  # trailing silence
                if end - start > min_size:
                    if start > fade_len:
                        audio[:, start : start + fade_len] *= fade_out
                        start += fade_len
                    audio[:, start:n] = 0.0
                    break
        else:
            if end - start > min_size:
                if start > fade_len:
                    audio[:, start : start + fade_len] *= fade_out
                    start += fade_len
                if end < n - fade_len:
                    audio[:, end - fade_len : end] *= fade_in
                    end -= fade_len
                audio[:, start:end] = 0.0
            start = i
    return audio


def pass_filter(kind: str, cutoff: float, audio: np.ndarray, sample_rate: int,
                order: int = 16) -> np.ndarray:
    """Butterworth (odd order) / Linkwitz-Riley-style (even order, cascaded)
    zero-phase filter (reference audio_utils.Pass_filter)."""
    btype = "highpass" if kind == "highpass" else "lowpass"
    if cutoff >= sample_rate / 2:
        cutoff = sample_rate / 2 - 1
    sos = _ss.butter(order // 2 if order > 1 else 1, cutoff, btype=btype,
                     fs=sample_rate, output="sos")
    # padlen=0: the reference filters without edge padding
    # (audio_utils.Pass_filter:228)
    return _ss.sosfiltfilt(sos, audio, padlen=0, axis=-1).astype(np.float32)


def resample_l(y: np.ndarray, orig_sr: float, target_sr: float,
               axis: int = -1) -> np.ndarray:
    """Rate conversion with librosa.resample's call shape (kaiser-windowed
    polyphase via scipy stands in for kaiser_best)."""
    up, down = int(round(target_sr)), int(round(orig_sr))
    g = math.gcd(up, down)
    return _ss.resample_poly(y, up // g, down // g, axis=axis).astype(np.float32)


def srs_shift(audio: np.ndarray, way: str, current_cutoff: float,
              target_cutoff: float) -> np.ndarray:
    """Cutoff-expressed SRS resample (reference audio_utils.Change_sample_rate
    :237-244): resample from 2·current_cutoff to 2·target_cutoff WITHOUT
    relabeling the sample rate, which shifts the spectral content so a
    band-limited model sees the band it was trained on. way='DOWN' swaps the
    cutoffs (content moves down / signal gets longer); 'UP' restores it."""
    if way == "DOWN":
        current_cutoff, target_cutoff = target_cutoff, current_cutoff
    return resample_l(audio, current_cutoff * 2, target_cutoff * 2)


def linkwitz_riley(kind: str, cutoff: float, audio: np.ndarray,
                   sample_rate: int, order: int = 8) -> np.ndarray:
    """Linkwitz-Riley crossover leg (reference audio_utils.Linkwitz_Riley_filter
    :191-201): an order//2 Butterworth applied zero-phase (sosfiltfilt), so the
    lowpass+highpass pair sums flat at the crossover."""
    sos = _ss.butter(order // 2, cutoff, btype=kind, fs=sample_rate, output="sos")
    return _ss.sosfiltfilt(sos, audio, padlen=0, axis=-1).astype(np.float32)


def stft_l(y: np.ndarray, n_fft: int = 6144, hop: int = 1024) -> np.ndarray:
    """Host STFT with librosa.stft semantics (center=True, zero pad,
    periodic hann, win_length=n_fft): (..., T) -> (..., 1+n_fft//2, frames)
    complex64. Used by the spectral ensemble (reference
    audio_utils.Make_Ensemble:339 'wave_to_spectrogram_no_mp')."""
    y = np.asarray(y, np.float32)
    pad = [(0, 0)] * (y.ndim - 1) + [(n_fft // 2, n_fft // 2)]
    ypad = np.pad(y, pad)
    frames = np.lib.stride_tricks.sliding_window_view(
        ypad, n_fft, axis=-1)[..., ::hop, :]
    win = _ss.get_window("hann", n_fft, fftbins=True).astype(np.float32)
    spec = np.fft.rfft(frames * win, axis=-1).astype(np.complex64)
    return np.swapaxes(spec, -2, -1)


def istft_l(spec: np.ndarray, n_fft: int = 6144, hop: int = 1024) -> np.ndarray:
    """Inverse of :func:`stft_l` (librosa.istft semantics, center=True,
    length=None): returns hop*(frames-1) samples, windowed overlap-add with
    squared-window normalization."""
    frames = np.fft.irfft(np.swapaxes(spec, -2, -1), n=n_fft,
                          axis=-1).astype(np.float32)
    win = _ss.get_window("hann", n_fft, fftbins=True).astype(np.float32)
    frames *= win
    n_frames = frames.shape[-2]
    total = n_fft + hop * (n_frames - 1)
    out = np.zeros(frames.shape[:-2] + (total,), np.float32)
    wsum = np.zeros(total, np.float32)
    win_sq = win * win
    for k in range(n_frames):
        out[..., k * hop : k * hop + n_fft] += frames[..., k, :]
        wsum[k * hop : k * hop + n_fft] += win_sq
    out /= np.maximum(wsum, np.finfo(np.float32).tiny)
    return out[..., n_fft // 2 : total - n_fft // 2]


def make_ensemble(algorithm: str, audios: list[np.ndarray]) -> np.ndarray:
    """Combine stems (reference audio_utils.Make_Ensemble:305-354).

    'Max'/'Min' select per TF-bin by magnitude in the STFT domain
    (n_fft=6144, hop=1024) with an iterative fold where later inputs win
    ties (reference ensembling:357-371), then iSTFT and zero-pad to the
    longest input. 'Average' zero-pads everything to the longest input and
    means in the time domain (:311-331)."""
    if len(audios) == 1:
        return audios[0]
    audios = [np.atleast_2d(a) for a in audios]
    n_max = max(a.shape[-1] for a in audios)

    def pad_to(a: np.ndarray, size: int) -> np.ndarray:
        if a.shape[-1] >= size:
            return a
        pad = [(0, 0)] * (a.ndim - 1) + [(0, size - a.shape[-1])]
        return np.pad(a, pad)

    if algorithm.lower() == "average":
        return sum(pad_to(a, n_max) for a in audios) / len(audios)

    spec = stft_l(audios[0])
    for a in audios[1:]:
        s_i = stft_l(a)
        ln = min(spec.shape[-1], s_i.shape[-1])
        spec, s_i = spec[..., :ln], s_i[..., :ln]
        if algorithm.lower() == "min":
            spec = np.where(np.abs(s_i) <= np.abs(spec), s_i, spec)
        else:
            spec = np.where(np.abs(s_i) >= np.abs(spec), s_i, spec)
    return pad_to(istft_l(spec), n_max)


def sdr(references: np.ndarray, estimates: np.ndarray) -> np.ndarray:
    """Signal-to-distortion ratio per source (reference compare.py:35-55)."""
    references = np.atleast_2d(references)
    estimates = np.atleast_2d(estimates)
    n = min(references.shape[-1], estimates.shape[-1])
    references, estimates = references[..., :n], estimates[..., :n]
    delta = 1e-7
    num = np.sum(np.square(references), axis=-1)
    den = np.sum(np.square(references - estimates), axis=-1)
    return 10 * np.log10((num + delta) / (den + delta))
