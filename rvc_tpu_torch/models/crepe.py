"""CREPE pitch network (full and tiny) and its decoders.

Counterpart of ``rvc_tpu/models/crepe.py`` with torchcrepe's parameter
names (``conv1..conv6``, ``conv{i}_BN``, ``classifier``), so a torchcrepe
state_dict loads as it is (``compat/torch_import.load_crepe``). Six stages
of pad, conv, ReLU, BatchNorm (the JAX package's folded inference form,
eps 1e-5) and a (2, 1) max pool over 1024-sample frames, then a 360-bin
sigmoid classifier. The pads are asymmetric, (254, 256) and then (31, 32)
samples, so they are ``F.pad`` and not the conv's own padding; the flatten
is torchcrepe's (N, C, H, W) -> (N, W, H, C).

The network computes in its ``dtype`` (``models.layers.set_dtype_``, as
JAX's ``CrepeNet(dtype=)``). The decoders run in float32 on the salience:
in bfloat16 the JAX package's Viterbi cannot run (its scan's carry turns
float32) and its weighted argmax rounds f0 to bfloat16. The Viterbi is a
Python loop of two launches a frame on the card, its backtrace a loop on
the host.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import frame_signal
from .layers import BatchNorm, Conv2d, Linear, sigmoid

PITCH_BINS = 360
WINDOW = 1024
CENTS_PER_BIN = 20.0
CENTS_OFFSET = 1997.3794084376191
FRAME_BATCH = 1024  # frames through the network at once (conv1's output: 1 MB a frame)

_SIZES = {
    "full": dict(in_ch=(1, 1024, 128, 128, 128, 256), out_ch=(1024, 128, 128, 128, 256, 512),
                 in_features=2048),
    "tiny": dict(in_ch=(1, 128, 16, 16, 16, 32), out_ch=(128, 16, 16, 16, 32, 64),
                 in_features=256),
}
_KERNELS = [(512, 1)] + [(64, 1)] * 5
_STRIDES = [(4, 1)] + [(1, 1)] * 5
_PADS = [(254, 256)] + [(31, 32)] * 5


class CrepeNet(nn.Module):
    """frames (N, 1024), normalized -> (N, 360) salience in the compute
    dtype."""

    dtype = torch.float32

    def __init__(self, capacity: str = "full"):
        super().__init__()
        self.capacity = capacity
        sz = _SIZES[capacity]
        for i in range(6):
            co = sz["out_ch"][i]
            setattr(self, f"conv{i + 1}",
                    Conv2d(sz["in_ch"][i], co, _KERNELS[i], stride=_STRIDES[i]))
            setattr(self, f"conv{i + 1}_BN", BatchNorm(co))
        self.classifier = Linear(sz["in_features"], PITCH_BINS)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames[:, None, :, None].to(self.dtype)  # (N, C=1, H=1024, W=1)
        for i in range(6):
            x = F.pad(x, (0, 0) + _PADS[i])
            x = torch.relu(_conv(getattr(self, f"conv{i + 1}"), x))
            x = getattr(self, f"conv{i + 1}_BN")(x)
            x = F.max_pool2d(x, (2, 1), (2, 1))
        x = x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)
        return sigmoid(self.classifier(x))


def _conv(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on (N, C, H, 1). Where its output is short (H_out <= 32:
    conv4-6) it is one product of the unfolded windows (N H_out, C K) with
    the weight, the bias added after it in the compute dtype as the layer
    adds it: cuDNN's float32 route for those shapes is an FFT that ran at
    0.2-0.4 TFLOP/s on the H100 (conv5 and conv6 took 806 of 932 ms of 1024
    frames)."""
    k, stride = conv.kernel_size[0], conv.stride[0]
    N, C, H, _ = x.shape
    h_out = (H - k) // stride + 1
    if h_out > 32:
        return conv(x)
    cols = x[..., 0].unfold(2, k, stride).transpose(1, 2).reshape(N * h_out, C * k)
    w = conv.weight.reshape(conv.out_channels, C * k)
    y = conv._affine(torch.matmul(cols.to(conv.dtype), w.to(conv.dtype).T), channels_last=True)
    return y.reshape(N, h_out, -1).permute(0, 2, 1)[..., None]


def random_state_dict(capacity: str = "full", seed: int = 0) -> dict[str, np.ndarray]:
    """Random torchcrepe-named weights from ``seed`` (numpy) whose salience
    moves with the input: conv and classifier weights N(0, 1 / fan_in),
    biases N(0, 0.1), BatchNorm gains U(0.5, 1.5), shifts and running means
    N(0, 0.1), running variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in CrepeNet(capacity).state_dict().items():
        name, leaf = key.rsplit(".", 1)
        if leaf == "weight" and not name.endswith("_BN"):
            fan_in = int(np.prod(t.shape[1:]))
            arr = rng.standard_normal(t.shape) / np.sqrt(fan_in)
        elif leaf in ("weight", "running_var"):
            arr = rng.uniform(0.5, 1.5, t.shape)
        else:
            arr = 0.1 * rng.standard_normal(t.shape)
        out[key] = arr.astype(np.float32)
    return out


def preprocess_frames(audio: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, T) 16 kHz -> (B, F, 1024): zero-padded by 512 a side, framed, each
    frame normalized by its mean and its standard deviation (ddof 0)."""
    pad = WINDOW // 2
    frames = frame_signal(F.pad(audio, (pad, pad)), WINDOW, hop_length)
    mu = frames.mean(-1, keepdim=True)
    std = torch.clamp(frames.std(-1, keepdim=True, correction=0), min=1e-10)
    return (frames - mu) / std


@functools.lru_cache(maxsize=None)
def _viterbi_transition() -> np.ndarray:
    xx, yy = np.meshgrid(np.arange(PITCH_BINS), np.arange(PITCH_BINS))
    transition = np.maximum(12 - abs(xx - yy), 0).astype(np.float64)
    return (transition / transition.sum(axis=1, keepdims=True)).astype(np.float32)


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """Over the last axis, written as ``jax.nn.logsumexp`` writes it."""
    amax = torch.amax(x, -1, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, 0.0)
    return torch.log(torch.sum(torch.exp(x - amax), -1, keepdim=True)) + amax


def viterbi_decode(probs: torch.Tensor) -> torch.Tensor:
    """(B, T, 360) salience -> (B, T) bins: max-product Viterbi over a
    |delta bin| < 12 triangular transition (torchcrepe's), the emissions
    normalized as librosa's. Ties go to the lowest bin."""
    probs = probs.float()
    log_t = torch.log(torch.from_numpy(_viterbi_transition()).to(probs.device) + 1e-12)
    logp = torch.log(torch.clamp(probs, min=1e-12))
    logp = logp - _logsumexp(logp)
    score = logp[:, 0] + torch.log(torch.tensor(1.0 / PITCH_BINS))
    backs = []
    for t in range(1, logp.shape[1]):
        best, back = torch.max(score[:, :, None] + log_t, 1)
        score = best + logp[:, t]
        backs.append(back)
    idx = torch.argmax(score, -1).cpu()
    path = [idx]
    for back in reversed(torch.stack(backs).cpu() if backs else []):
        idx = torch.gather(back, 1, idx[:, None])[:, 0]
        path.append(idx)
    return torch.stack(path[::-1], 1).to(probs.device)


def weighted_argmax_decode(probs: torch.Tensor) -> torch.Tensor:
    """(B, T, 360) -> (B, T) fractional bins: the salience-weighted mean of
    the nine bins around the argmax."""
    probs = probs.float()
    center = torch.argmax(probs, -1, keepdim=True)
    idx = torch.clamp(center + torch.arange(-4, 5, device=probs.device), 0, PITCH_BINS - 1)
    w = torch.gather(probs, -1, idx)
    return _sum9(w * idx) / torch.clamp(_sum9(w), min=1e-9)


def _sum9(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis added left to right, as XLA adds it."""
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def bins_to_hz(bins: torch.Tensor) -> torch.Tensor:
    cents = CENTS_PER_BIN * bins + CENTS_OFFSET
    return 10.0 * torch.pow(2.0, cents / 1200.0)


@torch.no_grad()
def salience(net: CrepeNet, audio: torch.Tensor, hop_length: int = 160) -> torch.Tensor:
    """(B, T) -> (B, F, 360), the frames through ``net`` ``FRAME_BATCH`` at
    a time."""
    frames = preprocess_frames(audio, hop_length)
    B, n, _ = frames.shape
    flat = frames.reshape(B * n, WINDOW)
    probs = torch.cat([net(flat[i: i + FRAME_BATCH])
                       for i in range(0, B * n, FRAME_BATCH)]) if B * n else flat[:, :0]
    return probs.reshape(B, n, PITCH_BINS)


def predict(net: CrepeNet, audio: torch.Tensor, hop_length: int = 160, fmin: float = 50.0,
            fmax: float = 1100.0, decoder: str = "viterbi") -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T) -> (f0 Hz (B, F), periodicity (B, F)), float32; bins outside
    [fmin, fmax] masked out as torchcrepe.predict masks them."""
    probs = salience(net, audio, hop_length).float()
    bins_hz = bins_to_hz(torch.arange(PITCH_BINS, dtype=torch.float32))
    mask = ((bins_hz >= fmin) & (bins_hz <= fmax)).to(probs.device)
    probs = torch.where(mask, probs, 0.0)
    if decoder == "viterbi":
        bins = viterbi_decode(probs)
        periodicity = torch.gather(probs, -1, bins[..., None])[..., 0]
        return bins_to_hz(bins.float()), periodicity
    return bins_to_hz(weighted_argmax_decode(probs)), torch.amax(probs, -1)
