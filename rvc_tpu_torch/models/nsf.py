"""NSF-HiFiGAN decoder: harmonic source + upsampling resblock stack.

Counterpart of ``rvc_tpu/models/nsf.py`` (sine_source, SourceModuleHnNSF,
ResBlock1/2, GeneratorNSF, and Generator, the no-f0 variants' decoder
without the source), activations (B, C, T). The sample-rate
ResBlock1 stages run through ``ops.resblock``: at inference with
``fuse_group`` (the default) each stage is one kernel-1 call, as the JAX
package's ``fuse_group`` path does; without it each ResBlock is one chain
call (kernel 8 in bfloat16, kernel 4 in float32) and the chains are added
in order and divided in the compute dtype, as the JAX package's
``fuse_resblocks`` path does (rvc_tpu/models/nsf.py:337-342). When
gradients are wanted each chain is a ``fused_resblock1_train`` call
(kernels 4 and 5 in float32; in bfloat16 the bf16 unit kernel, then kernels
4 and 5 at bf16(0.1)) and the chains are averaged the same way, as the JAX
package's training path does (rvc_tpu/models/nsf.py:162-190). ResBlock2
presets stay plain, as there. The source's sine runs in float32 and is
cast at ``l_linear`` (rvc_tpu/models/nsf.py:110-120).

The sine source draws a start phase per harmonic and Gaussian noise; both
can be passed in (``rand_ini``, ``noise``) so a test can hand over another
framework's draws, and are otherwise drawn from ``generator``.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops.resblock import (fused_resblock1, fused_resblock1_train, fused_resblock1_v2,
                            fused_resblock_group, wants_grad)
from .layers import LRELU_SLOPE, Conv1d, ConvTranspose1d, Linear, leaky_relu


def wrapped_cumsum(x: torch.Tensor, block: int = 64) -> torch.Tensor:
    """Exclusive cumulative sum modulo 1 along dim 1 of (B, T, C), blockwise
    so no partial sum exceeds ~block (keeps float32 resolution)."""
    B, T, C = x.shape
    pad = (-T) % block
    if pad:
        x = torch.cat([x, x.new_zeros(B, pad, C)], dim=1)
    nb = x.shape[1] // block
    xb = x.reshape(B, nb, block, C)
    within = torch.cumsum(xb, dim=2) - xb
    totals = torch.remainder(torch.sum(xb, dim=2), 1.0)
    prefix = torch.remainder(torch.cumsum(totals, dim=1) - totals, 1.0)
    out = torch.remainder(within + prefix[:, :, None, :], 1.0)
    return out.reshape(B, nb * block, C)[:, :T]


def sine_source(f0: torch.Tensor, upp: int, sampling_rate: int,
                harmonic_num: int = 0, sine_amp: float = 0.1,
                noise_std: float = 0.003, voiced_threshold: float = 0.0, *,
                rand_ini: torch.Tensor | None = None,
                noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
    """f0 (B, F) at frame rate -> (sine (B, F*upp, dim), uv (B, F*upp, 1)).

    rand_ini (B, dim) start phases (column 0 is forced to 0) and noise
    (B, F*upp, dim) standard normal; drawn from ``generator`` when absent."""
    B, F = f0.shape
    dim = harmonic_num + 1
    dev = f0.device
    mult = torch.arange(1, dim + 1, dtype=f0.dtype, device=dev)
    rad = torch.remainder(f0[..., None] * mult / sampling_rate, 1.0)  # (B, F, dim)
    if rand_ini is None:
        rand_ini = torch.rand(B, dim, generator=generator, device=dev, dtype=f0.dtype)
    rand_ini = rand_ini.clone()
    rand_ini[:, 0] = 0.0
    d = torch.remainder(rad * upp, 1.0)
    frame_phase = torch.remainder(wrapped_cumsum(d) + rand_ini[:, None, :], 1.0)
    j = torch.arange(1, upp + 1, dtype=f0.dtype, device=dev)
    phase = frame_phase[:, :, None, :] + rad[:, :, None, :] * j[None, None, :, None]
    phase = phase.reshape(B, F * upp, dim)
    sine = torch.sin(2.0 * math.pi * phase) * sine_amp
    uv = (f0 > voiced_threshold).to(f0.dtype)
    uv = uv[:, :, None, None].expand(B, F, upp, 1).reshape(B, F * upp, 1)
    noise_amp = uv * noise_std + (1.0 - uv) * (sine_amp / 3.0)
    if noise is None:
        noise = torch.randn(sine.shape, generator=generator, device=dev, dtype=sine.dtype)
    return sine * uv + noise_amp * noise, uv


class SourceModuleHnNSF(nn.Module):
    """Merge harmonics into one excitation (B, F*upp, 1)."""

    def __init__(self, sampling_rate: int, harmonic_num: int = 0, sine_amp: float = 0.1,
                 add_noise_std: float = 0.003, voiced_threshold: float = 0.0):
        super().__init__()
        self.sampling_rate = sampling_rate
        self.harmonic_num = harmonic_num
        self.sine_amp = sine_amp
        self.noise_std = add_noise_std
        self.voiced_threshold = voiced_threshold
        self.l_linear = Linear(harmonic_num + 1, 1)

    def forward(self, f0: torch.Tensor, upp: int, **draws) -> torch.Tensor:
        sine, _ = sine_source(f0.float(), upp, self.sampling_rate, self.harmonic_num,
                              self.sine_amp, self.noise_std, self.voiced_threshold,
                              **draws)
        return torch.tanh(self.l_linear(sine))


class ResBlock1(nn.Module):
    """3 x (dilated conv + conv) residual units (modules.ResBlock1)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=(kernel_size * d - d) // 2, weight_norm=True)
            for d in self.dilation)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2,
                   weight_norm=True)
            for _ in self.dilation)

    def chain(self):
        """The convs in order as (weight, bias, k, dilation), the weights
        folded, for the kernels of ``ops.resblock``."""
        out = []
        for c1, c2, d in zip(self.convs1, self.convs2, self.dilation):
            out.append((c1.folded_weight(), c1.bias, self.kernel_size, d))
            out.append((c2.folded_weight(), c2.bias, self.kernel_size, 1))
        return out


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=(kernel_size * d - d) // 2, weight_norm=True)
            for d in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = conv(leaky_relu(x, LRELU_SLOPE)) + x
        return x


def mean_of(ys: Sequence[torch.Tensor]) -> torch.Tensor:
    """((y0 + y1) + ...) / n in the tensors' dtype, the division a true one
    on every device (torch divides a CUDA tensor by a Python scalar through
    its reciprocal, which kernel 1's in-kernel division does not)."""
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc / torch.full((), float(len(ys)), dtype=acc.dtype, device=acc.device)


def resblock_stage(dec: nn.Module, i: int, x: torch.Tensor) -> torch.Tensor:
    """Stage ``i``'s ResBlocks of a decoder (``dec.resblocks``,
    ``num_kernels`` a stage, ``resblock`` "1" or "2", ``fuse_group``) on
    x (B, C, T): the mean of the stage's blocks, by the route the module
    docstring gives."""
    nk = dec.num_kernels
    blocks = dec.resblocks[i * nk:(i + 1) * nk]
    if dec.resblock != "1":
        xs = None
        for rb in blocks:
            r = rb(x)
            xs = r if xs is None else xs + r
        return xs / nk
    xt = x.transpose(1, 2).contiguous()
    chains = [rb.chain() for rb in blocks]
    if wants_grad(xt, chains):
        y = mean_of([fused_resblock1_train(xt, chain) for chain in chains])
    elif dec.fuse_group:
        y = fused_resblock_group(xt, chains)
    else:
        one = fused_resblock1_v2 if xt.dtype == torch.bfloat16 else fused_resblock1
        y = mean_of([one(xt, chain) for chain in chains])
    return y.transpose(1, 2)


class GeneratorNSF(nn.Module):
    """NSF-HiFiGAN decoder (reference models.GeneratorNSF). ``fuse_group``
    picks the inference route of the ResBlock1 stages (module docstring)."""

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gin_channels: int, sr: int,
                 fuse_group: bool = True):
        super().__init__()
        self.fuse_group = fuse_group
        self.upsample_rates = tuple(upsample_rates)
        self.upp = int(np.prod(upsample_rates))
        self.num_kernels = len(resblock_kernel_sizes)
        self.resblock = resblock
        self.m_source = SourceModuleHnNSF(sampling_rate=sr, harmonic_num=0)
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7, padding=3)
        self.cond = Conv1d(gin_channels, upsample_initial_channel, 1)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        rb_cls = ResBlock1 if resblock == "1" else ResBlock2
        n = len(upsample_rates)
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            c_in = upsample_initial_channel // (2 ** i)
            c_cur = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(c_in, c_cur, k, stride=u, padding=(k - u) // 2,
                                            weight_norm=True))
            if i + 1 < n:
                sf = int(np.prod(upsample_rates[i + 1:]))
                self.noise_convs.append(Conv1d(1, c_cur, sf * 2, stride=sf, padding=sf // 2))
            else:
                self.noise_convs.append(Conv1d(1, c_cur, 1))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(rb_cls(c_cur, rk, tuple(rd)))
        self.conv_post = Conv1d(c_cur, 1, 7, padding=3, bias=False)

    def forward(self, x: torch.Tensor, f0: torch.Tensor, g: torch.Tensor | None = None,
                **draws) -> torch.Tensor:
        """x (B, C_in, T) latent; f0 (B, T) Hz; g (B, gin, 1) -> (B, 1, T*upp)."""
        har = self.m_source(f0, self.upp, **draws).transpose(1, 2)  # (B, 1, T*upp)
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
        for i, (up, noise_conv) in enumerate(zip(self.ups, self.noise_convs)):
            x = up(leaky_relu(x, LRELU_SLOPE))
            x = x + noise_conv(har)[..., :x.shape[-1]]
            x = resblock_stage(self, i, x)
        x = self.conv_post(leaky_relu(x, 0.01))
        return torch.tanh(x)


class Generator(nn.Module):
    """HiFiGAN decoder of the no-f0 variants (reference models.Generator,
    rvc_tpu/models/nsf.py:356): GeneratorNSF without the harmonic source and
    its noise convs; the same stages, through the same kernels."""

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gin_channels: int,
                 fuse_group: bool = True):
        super().__init__()
        self.fuse_group = fuse_group
        self.upp = int(np.prod(upsample_rates))
        self.num_kernels = len(resblock_kernel_sizes)
        self.resblock = resblock
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7, padding=3)
        self.cond = Conv1d(gin_channels, upsample_initial_channel, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        rb_cls = ResBlock1 if resblock == "1" else ResBlock2
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            c_in = upsample_initial_channel // (2 ** i)
            c_cur = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(c_in, c_cur, k, stride=u, padding=(k - u) // 2,
                                            weight_norm=True))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(rb_cls(c_cur, rk, tuple(rd)))
        self.conv_post = Conv1d(c_cur, 1, 7, padding=3, bias=False)

    def forward(self, x: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, C_in, T) latent; g (B, gin, 1) -> (B, 1, T*upp)."""
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
        for i, up in enumerate(self.ups):
            x = resblock_stage(self, i, up(leaky_relu(x, LRELU_SLOPE)))
        x = self.conv_post(leaky_relu(x, 0.01))
        return torch.tanh(x)
