"""The dataset build: slice, window, write at two rates, features and f0,
filelist.

Counterpart of ``rvc_tpu/pipelines/preprocess.py`` (the reference's
preprocessing_utils.py and rvc_nodes.py:241-340), with the reference's
experiment-directory layout, so that datasets are interchangeable:

    0_gt_wavs/            {idx0}_{idx1}.wav at the target sample rate
    1_16k_wavs/           the same clips at 16 kHz
    2a_f0/                coarse (256-bin) pitch .npy
    2b-f0nsf/             f0 Hz .npy
    3_feature{256,768}/   HuBERT features .npy (50 Hz)
    filelist.txt          "gt|feat|f0|f0nsf|sid" rows, mute samples mixed in

Feature and f0 extraction batches the clips sorted by length, each batch
zero-padded to whole seconds as the JAX code pads it: HuBERT masks the pad
through ``lengths``, but the pitch model runs on the padded batch (its
BiGRU reads the pad backwards), so the same pad gives the same last frames.
f0 comes from ``PitchExtractor.get_f0`` with any method (or a list), as in
JAX; only the methods that need weights ask for them.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from scipy.io import wavfile

from ..device import resolve_device, set_float32_math
from ..io.audio import load_input_audio, remix_audio
from ..models.hubert import HubertConfig, HubertEncoder
from ..models.layers import load_numpy_state_dict
from ..ops.slicer import Slicer
from ..pitch.extractor import PitchExtractor


class Preprocess:
    """Slice source audio into 3 s clips overlapping by 0.3 s (reference
    preprocessing_utils.py:13-98)."""

    def __init__(self, sr: int, exp_dir: str, period: float = 3.0,
                 overlap: float = 0.3, max_volume: float = 0.95):
        self.slicer = Slicer(sr=sr, threshold=-50, min_length=1500,
                             min_interval=400, hop_size=15, max_sil_kept=500)
        self.sr = sr
        self.per = period
        self.overlap = overlap
        self.tail = period + overlap
        self.max_volume = max_volume
        self.exp_dir = exp_dir
        self.gt_wavs_dir = os.path.join(exp_dir, "0_gt_wavs")
        self.wavs16k_dir = os.path.join(exp_dir, "1_16k_wavs")
        os.makedirs(self.gt_wavs_dir, exist_ok=True)
        os.makedirs(self.wavs16k_dir, exist_ok=True)

    def _norm_write(self, clip: np.ndarray, idx0: int, idx1: int) -> None:
        if len(clip) <= self.overlap * self.sr * 2:
            return
        wavfile.write(os.path.join(self.gt_wavs_dir, f"{idx0}_{idx1}.wav"),
                      self.sr, clip.astype(np.float32))
        clip16, _ = remix_audio((clip, self.sr), target_sr=16000, max_volume=self.max_volume)
        wavfile.write(os.path.join(self.wavs16k_dir, f"{idx0}_{idx1}.wav"),
                      16000, clip16.astype(np.float32))

    def run_file(self, path: str, idx0: int) -> int:
        audio, _ = load_input_audio(path, self.sr)
        idx1 = 0
        for piece in self.slicer.slice(audio):
            i = 0
            while True:
                start = int(self.sr * (self.per - self.overlap) * i)
                i += 1
                if len(piece[start:]) > self.tail * self.sr:
                    self._norm_write(piece[start : start + int(self.per * self.sr)], idx0, idx1)
                    idx1 += 1
                else:
                    self._norm_write(piece[start:], idx0, idx1)
                    idx1 += 1
                    break
        return idx1

    def run_dir(self, inp_root: str) -> int:
        total = 0
        for idx, name in enumerate(sorted(os.listdir(inp_root))):
            total += self.run_file(os.path.join(inp_root, name), idx)
        return total


def hubert_from_state(state: dict, cfg: HubertConfig | None, version: str,
                      device=None) -> HubertEncoder:
    """A ``HubertEncoder`` of ``version`` from HF-named arrays (the layers it
    does not run left out), on ``device``, in eval mode."""
    hubert = HubertEncoder(cfg, version)
    used = hubert.state_dict()
    load_numpy_state_dict(hubert, {k: v for k, v in state.items() if k in used})
    return hubert.to(resolve_device(device)).eval()


@torch.no_grad()
def extract_features(exp_dir: str, hubert: HubertEncoder, pitch: PitchExtractor | None = None,
                     f0_method: str = "rmvpe", version: str = "v2", if_f0: bool = True,
                     batch_size: int = 8, device=None) -> int:
    """HuBERT features and f0 of every 16 kHz clip not done yet (reference
    FeatureInput.go, preprocessing_utils.py:155-193), a batch at a time on
    ``device`` (the card unless "cpu"), with ``hubert`` and ``pitch`` moved
    there; ``pitch`` None: a ``PitchExtractor`` without weights, which runs
    pm, dio and harvest. Returns the number of clips done."""
    dev = resolve_device(device)
    set_float32_math()
    hubert = hubert.to(dev).eval()
    pitch = (pitch or PitchExtractor()).to(dev)
    inp_root = os.path.join(exp_dir, "1_16k_wavs")
    f0_dir = os.path.join(exp_dir, "2a_f0")
    f0nsf_dir = os.path.join(exp_dir, "2b-f0nsf")
    feat_dir = os.path.join(exp_dir, "3_feature256" if version == "v1" else "3_feature768")
    for p in (f0_dir, f0nsf_dir, feat_dir):
        os.makedirs(p, exist_ok=True)

    todo = []
    for name in sorted(os.listdir(inp_root)):
        if "spec" in name or os.path.exists(os.path.join(feat_dir, f"{f0_method},{name}.npy")):
            continue
        _, x = wavfile.read(os.path.join(inp_root, name))
        todo.append((name, np.asarray(x, np.float32)))
    if not todo:
        return 0

    # sorted by length, each batch padded to whole seconds (the clips are at
    # most 3.3 s, so one or two padded lengths)
    todo.sort(key=lambda kv: len(kv[1]))
    done = 0
    for k in range(0, len(todo), batch_size):
        group = todo[k : k + batch_size]
        maxlen = int(np.ceil(max(len(x) for _, x in group) / 16000) * 16000)
        batch = np.zeros((len(group), maxlen), np.float32)
        lens = np.zeros((len(group),), np.int64)
        for j, (_, x) in enumerate(group):
            batch[j, : len(x)] = x
            lens[j] = len(x)
        audio = torch.from_numpy(batch).to(dev)
        feats = hubert.extract_features(audio, torch.from_numpy(lens).to(dev)).float()
        feats = feats.cpu().numpy()
        if if_f0:
            coarse, f0 = pitch.get_f0(audio, method=f0_method)
            coarse = coarse.to(torch.int32).cpu().numpy()
            f0 = f0.float().cpu().numpy()
        for j, (name, _) in enumerate(group):
            n_frames = (lens[j] - 400) // 320 + 1
            np.save(os.path.join(feat_dir, f"{f0_method},{name}"), feats[j, :n_frames])
            if if_f0:
                nf0 = lens[j] // 160
                np.save(os.path.join(f0_dir, f"{f0_method},{name}"), coarse[j, :nf0])
                np.save(os.path.join(f0nsf_dir, f"{f0_method},{name}"), f0[j, :nf0])
            done += 1
    return done


def build_filelist(exp_dir: str, sr: int, version: str = "v2", if_f0: bool = True,
                   sid: int = 0, mute_dir: str | None = None, mute_ratio: float = 0.01,
                   seed: int = 1234) -> str:
    """The filelist, with mute samples mixed in (reference
    rvc_nodes.py:269-340), shuffled with ``np.random.default_rng(seed)``."""
    gt_dir = os.path.join(exp_dir, "0_gt_wavs")
    feat_dim = 256 if version == "v1" else 768
    feat_dir = os.path.join(exp_dir, f"3_feature{feat_dim}")
    f0_dir = os.path.join(exp_dir, "2a_f0")
    f0nsf_dir = os.path.join(exp_dir, "2b-f0nsf")

    names = {os.path.splitext(n)[0] for n in os.listdir(feat_dir)}
    if if_f0:
        names &= {os.path.splitext(n)[0] for n in os.listdir(f0_dir)}
        names &= {os.path.splitext(n)[0] for n in os.listdir(f0nsf_dir)}
    rows = []
    for name in sorted(names):
        gt_file = os.path.join(gt_dir, name.split(",")[-1])
        if not os.path.isfile(gt_file):
            continue
        if if_f0:
            rows.append("|".join([gt_file, os.path.join(feat_dir, f"{name}.npy"),
                                  os.path.join(f0_dir, f"{name}.npy"),
                                  os.path.join(f0nsf_dir, f"{name}.npy"), str(sid)]))
        else:
            rows.append("|".join([gt_file, os.path.join(feat_dir, f"{name}.npy"), str(sid)]))

    if mute_dir and os.path.isdir(mute_dir):
        mute = [os.path.join(mute_dir, "0_gt_wavs", f"mute{sr}.wav"),
                os.path.join(mute_dir, f"3_feature{feat_dim}", "mute.npy")]
        if if_f0:
            mute += [os.path.join(mute_dir, "2a_f0", "mute.wav.npy"),
                     os.path.join(mute_dir, "2b-f0nsf", "mute.wav.npy")]
        for _ in range(max(2, int(len(rows) * mute_ratio))):
            rows.append("|".join([*mute, str(sid)]))
    rng = np.random.default_rng(seed)
    rng.shuffle(rows)
    path = os.path.join(exp_dir, "filelist.txt")
    with open(path, "w") as f:
        f.write("\n".join(rows))
    return path


def generate_mute_fixtures(mute_dir: str, sr: int, version: str = "v2",
                           feat_dim: int | None = None) -> None:
    """The silent training fixtures the reference ships as data
    (dataset/mute/*): a 3 s mute wav at ``sr`` with zero features and f0.
    ``feat_dim`` overrides the stored feature width (the directory's name
    still follows the version, as the filelist expects)."""
    dir_dim = 256 if version == "v1" else 768
    if feat_dim is None:
        feat_dim = dir_dim
    for sub in ("0_gt_wavs", f"3_feature{dir_dim}", "2a_f0", "2b-f0nsf"):
        os.makedirs(os.path.join(mute_dir, sub), exist_ok=True)
    wavfile.write(os.path.join(mute_dir, "0_gt_wavs", f"mute{sr}.wav"), sr,
                  np.zeros(sr * 3, np.float32))
    n50 = 149  # 3 s of 16 kHz audio: (48000 - 400) // 320 + 1 frames
    np.save(os.path.join(mute_dir, f"3_feature{dir_dim}", "mute.npy"),
            np.zeros((n50, feat_dim), np.float32))
    np.save(os.path.join(mute_dir, "2a_f0", "mute.wav.npy"), np.ones(300, np.int32))
    np.save(os.path.join(mute_dir, "2b-f0nsf", "mute.wav.npy"), np.zeros(300, np.float32))
