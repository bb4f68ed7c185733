"""GAN discriminators: one scale discriminator and eight period ones (v2).

Counterpart of ``rvc_tpu/models/discriminator.py`` (DiscriminatorS,
DiscriminatorP, MultiPeriodDiscriminator); activations (B, C, T), and
(B, C, T/p, p) once a period folds the waveform. Every conv is weight-
normed and trained in its (weight_v, weight_g) form, under the reference's
``D_*.pth`` names. ``scale`` shrinks every inner width for tiny test
configurations (grouped convs then collapse to groups=1), as in the JAX
module; 1.0 is the reference topology. The JAX package's period-packed
ensemble (``packed_mpd_apply``, off by default there) is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LRELU_SLOPE, Conv1d, Conv2d, leaky_relu, live_weight_norm_

PERIODS_V1 = (2, 3, 5, 7, 11, 17)
PERIODS_V2 = (2, 3, 5, 7, 11, 17, 23, 37)


def _width(scale: float):
    return lambda n: n if n == 1 or scale == 1.0 else max(1, int(n * scale))


class DiscriminatorS(nn.Module):
    SPECS = ((1, 16, 15, 1, 1, 7), (16, 64, 41, 4, 4, 20), (64, 256, 41, 4, 16, 20),
             (256, 1024, 41, 4, 64, 20), (1024, 1024, 41, 4, 256, 20),
             (1024, 1024, 5, 1, 1, 2))

    def __init__(self, scale: float = 1.0):
        super().__init__()
        c = _width(scale)
        self.convs = nn.ModuleList(
            Conv1d(c(ci), c(co), k, stride=s, groups=g if scale == 1.0 else 1, padding=p,
                   weight_norm=True)
            for ci, co, k, s, g, p in self.SPECS)
        self.conv_post = Conv1d(c(1024), 1, 3, padding=1, weight_norm=True)

    def forward(self, x: torch.Tensor):
        """x (B, 1, T) -> (logits (B, -1), feature maps)."""
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 scale: float = 1.0):
        super().__init__()
        self.period = period
        c = _width(scale)
        pad = (kernel_size - 1) // 2
        chans = ((1, 32, stride), (32, 128, stride), (128, 512, stride), (512, 1024, stride),
                 (1024, 1024, 1))
        self.convs = nn.ModuleList(
            Conv2d(c(ci), c(co), (kernel_size, 1), (s, 1), (pad, 0), weight_norm=True)
            for ci, co, s in chans)
        self.conv_post = Conv2d(c(1024), 1, (3, 1), (1, 1), (1, 0), weight_norm=True)

    def forward(self, x: torch.Tensor):
        """x (B, 1, T) -> (logits (B, -1), feature maps (B, C, T/p, p))."""
        B, C, T = x.shape
        if T % self.period:
            x = F.pad(x, (0, self.period - T % self.period), mode="reflect")
        x = x.view(B, C, -1, self.period)
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """The scale discriminator and one per period; v2 adds periods 23, 37."""

    def __init__(self, version: str = "v2", scale: float = 1.0):
        super().__init__()
        periods = PERIODS_V2 if version == "v2" else PERIODS_V1
        self.discriminators = nn.ModuleList(
            [DiscriminatorS(scale)] + [DiscriminatorP(p, scale=scale) for p in periods])
        live_weight_norm_(self)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat (B, 1, T). Real and generated ride one batched pass per
        discriminator, as in the JAX module. Returns (y_d_rs, y_d_gs,
        fmap_rs, fmap_gs)."""
        B = y.shape[0]
        both = torch.cat([y, y_hat], dim=0)
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            logits, fmap = d(both)
            y_d_rs.append(logits[:B])
            y_d_gs.append(logits[B:])
            fmap_rs.append([m[:B] for m in fmap])
            fmap_gs.append([m[B:] for m in fmap])
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
