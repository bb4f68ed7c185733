"""Conv-TasNet, the time-domain separator of the demucs v2 family.

Counterpart of ``rvc_tpu/models/tasnet.py`` (the reference's
``demucs/tasnet_v2.py``, Luo and Mesgarani's Conv-TasNet; a model whose
file name holds "tasnet"), with the reference's modules and names, so a
``.th`` state dict loads as it is: ``encoder.conv1d_U`` (a strided conv at
half-frame stride, ReLU), ``separator.network`` = [cLN, bottleneck 1x1,
R x X temporal blocks, mask 1x1], ``decoder.basis_signals`` (a linear to
``audio_channels x L`` samples a frame, overlap-added at half a frame).
A temporal block is 1x1 conv, PReLU, norm, depthwise conv of P taps at
dilation 2^x, PReLU, norm, 1x1 conv, with the block's input added.

The depthwise conv runs as one grouped ``conv1d`` (``depthwise_conv1d``,
cuDNN on the card). The JAX package writes it as P shifted multiply-adds
(``depthwise``, the same sums in tap order); at the full model's shape,
(5, 512, 35279) over dilations 1-512, cuDNN's grouped conv took 8.63 ms a
repeat of 10 blocks against the shifted form's 20.22 (chip_smoke phase 23
on an NVIDIA H100 80GB HBM3 at 700 W), so chip_smoke times both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import mark
from .layers import Conv1d, Linear

EPS = 1e-8


def depthwise(y: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """The depthwise conv of y (B, H, K) by w (H, 1, P) at ``dilation``,
    'same' padding, as P shifted multiply-adds summed in tap order (the JAX
    package's form; chip_smoke's yardstick)."""
    P = w.shape[-1]
    pad = (P - 1) * dilation // 2
    K = y.shape[-1]
    yp = F.pad(y, (pad, pad))
    acc = yp[..., :K] * w[:, :, 0]
    for t in range(1, P):
        acc = acc + yp[..., t * dilation: t * dilation + K] * w[:, :, t]
    return acc


def depthwise_conv1d(y: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """The same function as one grouped ``conv1d`` (cuDNN on the card), the
    temporal blocks' form."""
    P = w.shape[-1]
    return F.conv1d(y, w, padding=(P - 1) * dilation // 2, dilation=dilation,
                    groups=y.shape[1])


class ChannelNorm(nn.Module):
    """gLN (over channels and time) or cLN (over channels at each step) of
    (B, N, K), statistics in float32, parameters (1, N, 1) as the
    reference's ``gamma``/``beta``."""

    def __init__(self, channels: int, kind: str):
        super().__init__()
        self.dims = (1, 2) if kind == "gLN" else (1,)
        self.gamma = nn.Parameter(torch.ones(1, channels, 1))
        self.beta = nn.Parameter(torch.zeros(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=self.dims, keepdim=True)
        var = (x - mean).square().mean(dim=self.dims, keepdim=True)
        return self.gamma * ((x - mean) * torch.rsqrt(var + EPS)) + self.beta


def _norm(kind: str, channels: int) -> nn.Module:
    if kind in ("gLN", "cLN"):
        return ChannelNorm(channels, kind)
    if kind == "id":
        return nn.Identity()
    raise NotImplementedError(f"Conv-TasNet norm {kind!r} (BatchNorm checkpoints)")


class _DepthwiseSeparable(nn.Module):
    def __init__(self, hidden: int, bottleneck: int, kernel: int, dilation: int, norm: str):
        super().__init__()
        depthwise_conv = Conv1d(hidden, hidden, kernel, padding=(kernel - 1) * dilation // 2,
                                dilation=dilation, groups=hidden, bias=False)
        self.net = nn.Sequential(depthwise_conv, nn.PReLU(),
                                 _norm(norm, hidden), Conv1d(hidden, bottleneck, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class TemporalBlock(nn.Module):
    def __init__(self, bottleneck: int, hidden: int, kernel: int, dilation: int, norm: str):
        super().__init__()
        self.net = nn.Sequential(Conv1d(bottleneck, hidden, 1, bias=False), nn.PReLU(),
                                 _norm(norm, hidden),
                                 _DepthwiseSeparable(hidden, bottleneck, kernel, dilation, norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.net(x)


class _Encoder(nn.Module):
    def __init__(self, L: int, N: int, audio_channels: int):
        super().__init__()
        self.conv1d_U = Conv1d(audio_channels, N, L, stride=L // 2, bias=False)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv1d_U(mix))


class _Separator(nn.Module):
    def __init__(self, N: int, B: int, H: int, P: int, X: int, R: int, C: int, norm: str):
        super().__init__()
        blocks = nn.Sequential(*[nn.Sequential(*[TemporalBlock(B, H, P, 2 ** x, norm)
                                                 for x in range(X)]) for _ in range(R)])
        self.network = nn.Sequential(ChannelNorm(N, "cLN"), Conv1d(N, B, 1, bias=False),
                                     blocks, Conv1d(B, C * N, 1, bias=False))


class _Decoder(nn.Module):
    def __init__(self, N: int, L: int, audio_channels: int):
        super().__init__()
        self.basis_signals = Linear(N, audio_channels * L, bias=False)


class ConvTasNet(nn.Module):
    """mix (B, audio_channels, T) -> stems (B, n_sources, audio_channels, T).
    The defaults are the demucs v2 ``tasnet`` checkpoints' (X = 10)."""

    def __init__(self, sources=("drums", "bass", "other", "vocals"), audio_channels: int = 2,
                 N: int = 256, L: int = 20, B: int = 256, H: int = 512, P: int = 3,
                 X: int = 10, R: int = 4, norm_type: str = "gLN",
                 mask_nonlinear: str = "relu", samplerate: int = 44100):
        super().__init__()
        self.sources = tuple(sources)
        self.audio_channels, self.N, self.L = audio_channels, N, L
        self.mask_nonlinear = mask_nonlinear
        self.samplerate = samplerate
        self.encoder = _Encoder(L, N, audio_channels)
        self.separator = _Separator(N, B, H, P, X, R, len(self.sources), norm_type)
        self.decoder = _Decoder(N, L, audio_channels)

    def forward(self, mix: torch.Tensor, events: list | None = None) -> torch.Tensor:
        Bt, ac, T = mix.shape
        C, N, L = len(self.sources), self.N, self.L
        step = L // 2
        w = self.encoder(mix)  # (B, N, K)
        K = w.shape[-1]
        score = self.separator.network(w).view(Bt, C, N, K)
        mask = torch.softmax(score, dim=1) if self.mask_nonlinear == "softmax" else F.relu(score)
        src = (w[:, None] * mask).transpose(2, 3)  # (B, C, K, N)
        frames = self.decoder.basis_signals(src).view(Bt, C, K, ac, L).permute(0, 1, 3, 2, 4)
        out = F.pad(frames[..., :step], (0, 0, 0, 1)) + F.pad(frames[..., step:], (0, 0, 1, 0))
        out = out.reshape(Bt, C, ac, (K + 1) * step)[..., :T]
        if out.shape[-1] < T:
            out = F.pad(out, (0, T - out.shape[-1]))
        mark(events, "network")
        return out
