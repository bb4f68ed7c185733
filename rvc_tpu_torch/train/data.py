"""Training data pipeline: filelists, alignment, bucketed batches (numpy).

A copy of ``rvc_tpu/train/data.py``, so that one numpy batch (the JAX keys
and layouts) feeds both packages. Its notes follow.

Reference semantics (lib/train/data_utils.py:10-137):
  * filelist rows ``wav|feature.npy|f0coarse.npy|f0nsf.npy|sid`` (f0 mode)
    or ``wav|feature.npy|sid``;
  * HuBERT features stored at 50 Hz are repeated ×2 to the 100 Hz grid,
    capped at 900 frames; spec/wave/phone/pitch truncated to equal frames;
  * linear spectrograms computed once and cached next to the wav
    (``.spec.npy`` here vs the reference's ``.spec.pt``).

TPU-first batching: the reference's DistributedBucketSampler
(data_utils.py:392-608) buckets by length then zero-pads each batch to its
own max — dynamic shapes. Here every batch is padded to its bucket's
*upper boundary* ([100, 200, ..., 900] frames), so the jitted train step
compiles at most ``len(boundaries)`` shapes, ever. Rank-sharding is
replaced by the dp-mesh batch sharding (parallel/mesh.py).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..config import DataConfig

BUCKETS = (100, 200, 300, 400, 500, 600, 700, 800, 900)
MAX_FRAMES = 900


def _np_hann(n):
    return 0.5 * (1 - np.cos(2 * np.pi * np.arange(n) / n))


def spectrogram_np(y: np.ndarray, n_fft: int, hop: int, win: int) -> np.ndarray:
    """Host (numpy) twin of ops.stft.spectrogram — used for dataset caching."""
    y = np.clip(y, -1.05, 1.05)
    pad = int((n_fft - hop) / 2)
    y = np.pad(y, pad, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    w = np.zeros(n_fft)
    off = (n_fft - win) // 2
    w[off : off + win] = _np_hann(win)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * w
    spec = np.abs(np.fft.rfft(frames, axis=-1))
    return np.sqrt(spec**2 + 1e-8).astype(np.float32)  # (T, n_bins)


@dataclass
class Sample:
    wav_path: str
    feat_path: str
    pitch_path: str | None
    pitchf_path: str | None
    sid: int
    frames: int  # spec frames (for bucketing)


class RVCDataset:
    """Filelist-backed dataset with on-disk spec caching."""

    def __init__(self, filelist: str | list[str], data: DataConfig, use_f0: bool = True):
        self.data = data
        self.use_f0 = use_f0
        rows = (
            open(filelist).read().strip().split("\n")
            if isinstance(filelist, str)
            else list(filelist)
        )
        self.samples: list[Sample] = []
        for row in rows:
            parts = row.split("|")
            if use_f0:
                wav, feat, pitch, pitchf, sid = parts
            else:
                wav, feat, sid = parts
                pitch = pitchf = None
            frames = self._estimate_frames(wav)
            if frames < 1:
                continue
            self.samples.append(Sample(wav, feat, pitch, pitchf, int(sid), min(frames, MAX_FRAMES)))

    def _estimate_frames(self, wav_path: str) -> int:
        # reference estimates from file size (data_utils.py:40); we read the
        # header-accurate size the same cheap way
        return os.path.getsize(wav_path) // (3 * self.data.hop_length)

    def __len__(self):
        return len(self.samples)

    def load(self, i: int):
        from scipy.io import wavfile

        s = self.samples[i]
        d = self.data
        sr, audio = wavfile.read(s.wav_path)
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32)  # reference trains on raw int16 range
        assert sr == d.sampling_rate, f"{s.wav_path}: {sr} != {d.sampling_rate}"
        spec_path = s.wav_path.replace(".wav", ".spec.npy")
        if os.path.exists(spec_path):
            spec = np.load(spec_path)
        else:
            spec = spectrogram_np(audio, d.filter_length, d.hop_length, d.win_length)
            # written whole, then renamed: the ranks of a data-parallel run
            # read the same files while one of them may be writing
            tmp = f"{spec_path}.{os.getpid()}.npy"
            np.save(tmp, spec)
            os.replace(tmp, spec_path)
        phone = np.repeat(np.load(s.feat_path), 2, axis=0).astype(np.float32)
        n = min(phone.shape[0], MAX_FRAMES)
        phone = phone[:n]
        if self.use_f0:
            pitch = np.load(s.pitch_path)[:n].astype(np.int32)
            pitchf = np.load(s.pitchf_path)[:n].astype(np.float32)
        else:
            pitch = pitchf = None
        len_min = min(phone.shape[0], spec.shape[0])
        spec = spec[:len_min]
        wav = audio[: len_min * d.hop_length].astype(np.float32)
        phone = phone[:len_min]
        if self.use_f0:
            pitch, pitchf = pitch[:len_min], pitchf[:len_min]
        return dict(spec=spec, wave=wav, phone=phone, pitch=pitch, pitchf=pitchf, sid=s.sid)


class BucketBatcher:
    """Length-bucketed batches padded to static bucket boundaries."""

    def __init__(self, dataset: RVCDataset, batch_size: int, seed: int = 1234,
                 min_segment_frames: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.min_frames = min_segment_frames
        self.buckets: dict[int, list[int]] = {b: [] for b in BUCKETS}
        for i, s in enumerate(dataset.samples):
            if s.frames < max(self.min_frames, 1):
                continue
            for b in BUCKETS:
                if s.frames <= b:
                    self.buckets[b].append(i)
                    break
            else:
                self.buckets[BUCKETS[-1]].append(i)

    def epoch(self, epoch_idx: int) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + epoch_idx)
        order: list[tuple[int, list[int]]] = []
        for b, idxs in self.buckets.items():
            if not idxs:
                continue
            idxs = list(idxs)
            rng.shuffle(idxs)
            # drop ragged tail to keep shapes static (pad-batch alternative
            # would waste a compile on a one-off batch size)
            for k in range(0, len(idxs) - self.batch_size + 1, self.batch_size):
                order.append((b, idxs[k : k + self.batch_size]))
        rng.shuffle(order)
        for b, batch_idx in order:
            yield self._collate(b, batch_idx)

    def _collate(self, boundary: int, idxs: list[int]) -> dict:
        d = self.ds.data
        items = [self.ds.load(i) for i in idxs]
        B = len(items)
        T = boundary
        spec = np.zeros((B, T, d.spec_channels), np.float32)
        phone = np.zeros((B, T, items[0]["phone"].shape[-1]), np.float32)
        wave = np.zeros((B, T * d.hop_length), np.float32)
        pitch = np.zeros((B, T), np.int32)
        pitchf = np.zeros((B, T), np.float32)
        lens = np.zeros((B,), np.int32)
        sid = np.zeros((B,), np.int32)
        for j, it in enumerate(items):
            n = min(it["spec"].shape[0], T)
            spec[j, :n] = it["spec"][:n]
            phone[j, :n] = it["phone"][:n]
            wave[j, : n * d.hop_length] = it["wave"][: n * d.hop_length]
            if self.ds.use_f0:
                pitch[j, :n] = it["pitch"][:n]
                pitchf[j, :n] = it["pitchf"][:n]
            lens[j] = n
            sid[j] = it["sid"]
        batch = dict(
            phone=phone, phone_lengths=lens, spec=spec, spec_lengths=lens,
            wave=wave, wave_lengths=lens * d.hop_length, sid=sid,
        )
        if self.ds.use_f0:
            batch["pitch"] = pitch
            batch["pitchf"] = pitchf
        return batch


def write_filelist(path: str, rows: list[str]) -> None:
    with open(path, "w") as f:
        f.write("\n".join(rows))
