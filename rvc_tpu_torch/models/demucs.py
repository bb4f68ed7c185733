"""Demucs v2's waveform U-Net, the bidirectional LSTM of every Demucs, and
the chunked, shifted apply of a separation model.

Counterpart of ``rvc_tpu/models/demucs.py`` (the reference's
``demucs/demucs.py`` and ``demucs/apply.py``), on the reference's (B, C, T)
layout with its state_dict names:

  * ``BLSTM``: ``nn.LSTM(bidirectional=True)`` and a ``linear`` merge
    (``lstm.weight_ih_l0``, ``linear.weight``); with ``max_steps`` it runs
    on overlapping frames of that many steps and stitches their centres, and
    with ``skip`` it adds its input (the DConv branches of HDemucs).
  * ``Demucs``: the v2 waveform U-Net as the JAX package writes it (GELU
    after each encoder conv and between decoder layers, the BiLSTM
    bottleneck, 2x resampling through ``ops.resample.resample_poly``).
  * ``apply_model``: the song cut into ``segment``-sample chunks at a stride
    of ``segment (1 - overlap)``, the chunks through the model
    ``CHUNKS_PER_CALL`` at a time, and their outputs overlap-added under a
    triangular weight; with ``shifts`` > 1 the song is also shifted by
    offsets drawn from ``np.random.default_rng(seed)``, the JAX package's
    draws, and the results averaged. The JAX package runs all chunks in one
    batch; each chunk is its own sample (every norm is per sample), so the
    groups give the same stems.

In a compute dtype below float32 (``layers.set_dtype_``) the convs and the
merge round their products, GELU and GLU round each op, the LSTM steps
through ``layers.lstm`` as JAX's scan does (rvc_tpu/models/demucs.py:29-73),
and the v2 net's 2x downsampling and the stems are float32, as JAX's
``resample_poly`` and the normalization's float32 statistics leave them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import mark
from ..ops.resample import resample_poly
from .layers import GELU, GLU, Conv1d, ConvTranspose1d, Linear, lstm

CHUNKS_PER_CALL = 8  # chunks a model call (a 5-minute song is 47 chunks of 7.8 s)


class BLSTM(nn.Module):
    """Bidirectional LSTM over (B, C, T) with a linear merge of the two
    directions (reference ``demucs.BLSTM``). ``max_steps``: frames of that
    many steps at half-frame stride, the centres kept (a quarter frame
    dropped at each inner edge); ``skip``: the input added."""

    def __init__(self, dim: int, layers: int = 1, max_steps: int | None = None,
                 skip: bool = False):
        super().__init__()
        self.max_steps = max_steps
        self.skip = skip
        self.lstm = nn.LSTM(input_size=dim, hidden_size=dim, num_layers=layers,
                            bidirectional=True)
        self.linear = Linear(2 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        y = x
        framed = self.max_steps is not None and T > self.max_steps
        if framed:
            width = self.max_steps
            stride = width // 2
            n_frames = math.ceil(T / stride)
            xp = F.pad(x, (0, (n_frames - 1) * stride + width - T))
            x = xp.unfold(2, width, stride).permute(0, 2, 1, 3).reshape(-1, C, width)
        dt = getattr(self, "dtype", torch.float32)
        x = x.permute(2, 0, 1)
        out = self.lstm(x)[0] if dt == torch.float32 else lstm(self.lstm, x, dt)
        out = self.linear(out).permute(1, 2, 0)
        if framed:
            frames = out.reshape(B, n_frames, C, width)
            limit = stride // 2
            parts = [frames[:, 0, :, : width - limit]]
            parts += [frames[:, k, :, limit: width - limit] for k in range(1, n_frames - 1)]
            parts.append(frames[:, n_frames - 1, :, limit:])
            out = torch.cat(parts, dim=-1)[..., :T]
        return out + y if self.skip else out


class Demucs(nn.Module):
    """Demucs v2 waveform U-Net: mix (B, audio_channels, T) -> stems (B,
    n_sources, audio_channels, T). Names: ``encoder.{i}.0`` / ``.2``,
    ``lstm.lstm.*``, ``lstm.linear``, ``decoder.{i}.0`` / ``.2``."""

    def __init__(self, sources=("drums", "bass", "other", "vocals"), audio_channels: int = 2,
                 channels: int = 64, growth: float = 2.0, depth: int = 6,
                 kernel_size: int = 8, stride: int = 4, context: int = 3,
                 lstm_layers: int = 2, resample: bool = True, normalize: bool = True):
        super().__init__()
        self.sources = tuple(sources)
        self.audio_channels = audio_channels
        self.depth, self.kernel_size, self.stride = depth, kernel_size, stride
        self.resample, self.normalize = resample, normalize
        self.encoder = nn.ModuleList()
        self.decoder = nn.ModuleList()
        cin, ch = audio_channels, channels
        widths = []
        for _ in range(depth):
            self.encoder.append(nn.Sequential(
                Conv1d(cin, ch, kernel_size, stride=stride), GELU(),
                Conv1d(ch, 2 * ch, 1), GLU(1)))
            widths.append(ch)
            cin, ch = ch, int(ch * growth)
        self.lstm = BLSTM(cin, lstm_layers) if lstm_layers else None
        ch = cin
        for i in range(depth):
            last = i == depth - 1
            cout = len(self.sources) * audio_channels if last else int(ch / growth)
            self.decoder.append(nn.Sequential(
                Conv1d(ch, 2 * ch, context, padding=(context - 1) // 2), GLU(1),
                ConvTranspose1d(ch, cout, kernel_size, stride=stride),
                *([] if last else [GELU()])))
            ch = cout

    def valid_length(self, length: int) -> int:
        """The nearest length >= ``length`` that survives the conv chain exactly."""
        L = length * 2 if self.resample else length
        for _ in range(self.depth):
            L = max(math.ceil((L - self.kernel_size) / self.stride) + 1, 1)
        for _ in range(self.depth):
            L = (L - 1) * self.stride + self.kernel_size
        return int(math.ceil(L / 2) if self.resample else L)

    def forward(self, mix: torch.Tensor, events: list | None = None) -> torch.Tensor:
        B, C, T = mix.shape
        x = mix
        if self.normalize:
            mono = mix.mean(dim=1, keepdim=True)
            mean = mono.mean(dim=-1, keepdim=True)
            std = mono.std(dim=-1, keepdim=True, unbiased=False) + 1e-5
            x = (x - mean) / std
        if self.resample:
            x = resample_poly(x, 2, 1)
        skips = []
        for enc in self.encoder:
            x = enc(x)
            skips.append(x)
        if self.lstm is not None:
            x = self.lstm(x)
        for dec in self.decoder:
            x = dec(x + skips.pop()[..., : x.shape[-1]])
        if self.resample:
            x = resample_poly(x.float(), 1, 2)
        out = x[..., :T].reshape(B, len(self.sources), self.audio_channels, -1)
        if self.normalize:
            out = out * std[:, None] + mean[:, None]
        mark(events, "network")
        return out


def apply_model(model, mix: torch.Tensor, segment_samples: int, overlap: float = 0.25,
                shifts: int = 1, max_shift: int = 22050, seed: int = 0,
                events: list | None = None) -> torch.Tensor:
    """Chunked inference with random shifts and triangular overlap-add
    (reference demucs/apply.py:124-230). ``model``: (N, C, T) -> (N, S, C,
    T), called as ``model(batch, events)``; mix (C, T) on the model's device
    -> (S, C, T)."""
    rng = np.random.default_rng(seed)
    T = mix.shape[-1]
    results = []
    for _ in range(max(shifts, 1)):
        offset = int(rng.integers(0, max_shift)) if shifts > 1 else 0
        shifted = F.pad(mix, (max_shift - offset, offset))
        out = _apply_chunks(model, shifted, segment_samples, overlap, events)
        results.append(out[..., max_shift - offset: max_shift - offset + T])
    return results[0] if len(results) == 1 else torch.stack(results).mean(dim=0)


def _triangle(segment: int) -> np.ndarray:
    tri = np.concatenate([np.arange(1, segment // 2 + 1),
                          np.arange(segment - segment // 2, 0, -1)]).astype(np.float32)
    return tri / tri.max()


def _apply_chunks(model, mix: torch.Tensor, segment: int, overlap: float,
                  events: list | None) -> torch.Tensor:
    C, T = mix.shape
    stride = int(segment * (1 - overlap))
    starts = list(range(0, max(T - segment, 0) + 1, stride)) or [0]
    if starts[-1] + segment < T:
        starts.append(T - segment)
    batch = torch.stack([F.pad(mix[:, s: s + segment], (0, max(0, s + segment - T)))
                         for s in starts])
    mark(events, "chunking")
    outs = torch.cat([model(batch[i: i + CHUNKS_PER_CALL], events)
                      for i in range(0, len(starts), CHUNKS_PER_CALL)])
    tri = torch.from_numpy(_triangle(segment)).to(mix.device)
    acc = mix.new_zeros(outs.shape[1], C, T)
    weight_sum = mix.new_zeros(T)
    for i, s in enumerate(starts):
        n = min(segment, T - s)
        acc[..., s: s + n] += outs[i, ..., :n] * tri[:n]
        weight_sum[s: s + n] += tri[:n]
    out = acc / weight_sum.clamp(min=1e-8)
    mark(events, "overlap-add")
    return out
