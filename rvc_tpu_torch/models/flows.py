"""Normalizing flows: the residual coupling of RVC's synthesizer, and the
spline flows of the VITS duration predictor.

Counterpart of ``rvc_tpu/models/flows.py`` (the reference's
lib/infer_pack/modules.py:362-518 and transforms.py). The residual
coupling is mean-only, so its forward direction's log-determinant is zero
and is not returned. ``Log``, ``ElementwiseAffine`` and ``ConvFlow``
return (y, logdet) forward and (x, None) in reverse, as the JAX modules
do; ``ConvFlow`` couples through ``rational_quadratic_spline`` (linear
tails beyond ``tail_bound``). Layout (B, C, T), masks (B, 1, T); the
parameters carry the reference's names and shapes (``ElementwiseAffine``'s
``m`` and ``logs`` are (C, 1)).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv1d, LayerNorm
from .wavenet import WN

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


class Flip(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.flip(x, dims=[1])


class ResidualCouplingLayer(nn.Module):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.post = Conv1d(hidden_channels, self.half, 1)

    def _mean(self, x0: torch.Tensor, x_mask: torch.Tensor, g) -> torch.Tensor:
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        return self.post(h) * x_mask

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g=None) -> torch.Tensor:
        x0, x1 = x[:, :self.half], x[:, self.half:]
        return torch.cat([x0, (self._mean(x0, x_mask, g) + x1) * x_mask], dim=1)

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor, g=None) -> torch.Tensor:
        x0, x1 = x[:, :self.half], x[:, self.half:]
        return torch.cat([x0, (x1 - self._mean(x0, x_mask, g)) * x_mask], dim=1)


class ResidualCouplingBlock(nn.Module):
    """n_flows couplings interleaved with Flips (reference module ids 0, 2, ...)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate, n_layers,
                gin_channels=gin_channels))
            self.flows.append(Flip())

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g=None) -> torch.Tensor:
        for flow in self.flows:
            x = flow(x) if isinstance(flow, Flip) else flow(x, x_mask, g=g)
        return x

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor, g=None) -> torch.Tensor:
        for flow in reversed(self.flows):
            x = flow(x) if isinstance(flow, Flip) else flow.reverse(x, x_mask, g=g)
        return x


class Log(nn.Module):
    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, reverse: bool = False):
        if not reverse:
            y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
            return y, torch.sum(-y, dim=(1, 2))
        return torch.exp(x) * x_mask, None


class ElementwiseAffine(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, reverse: bool = False):
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * x_mask
            return y, torch.sum(self.logs * x_mask, dim=(1, 2))
        return (x - self.m) * torch.exp(-self.logs) * x_mask, None


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack (the reference's modules.DDSConv);
    dropout is off, as at inference."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int, p_dropout: float = 0.0):
        super().__init__()
        self.convs_sep = nn.ModuleList()
        self.convs_1x1 = nn.ModuleList()
        self.norms_1 = nn.ModuleList()
        self.norms_2 = nn.ModuleList()
        for i in range(n_layers):
            dilation = kernel_size ** i
            padding = (kernel_size * dilation - dilation) // 2
            self.convs_sep.append(Conv1d(channels, channels, kernel_size, groups=channels,
                                         dilation=dilation, padding=padding))
            self.convs_1x1.append(Conv1d(channels, channels, 1))
            self.norms_1.append(LayerNorm(channels))
            self.norms_2.append(LayerNorm(channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g=None) -> torch.Tensor:
        if g is not None:
            x = x + g
        for sep, n1, c1, n2 in zip(self.convs_sep, self.norms_1, self.convs_1x1, self.norms_2):
            y = F.gelu(n1(sep(x * x_mask)))
            x = x + F.gelu(n2(c1(y)))
        return x * x_mask


def rational_quadratic_spline(inputs: torch.Tensor, unnormalized_widths: torch.Tensor,
                              unnormalized_heights: torch.Tensor,
                              unnormalized_derivatives: torch.Tensor, inverse: bool = False,
                              tail_bound: float = 5.0,
                              min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
                              min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
                              min_derivative: float = DEFAULT_MIN_DERIVATIVE):
    """Piecewise rational-quadratic transform with linear tails (Durkan et
    al. 2019), its bin found by a one-hot over the knots, as the JAX
    package's. ``inputs`` (...); the unnormalized parameters (..., bins),
    the derivatives (..., bins - 1). Returns (outputs, log|det|)."""
    num_bins = unnormalized_widths.shape[-1]
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - min_derivative) - 1)
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1), value=constant)

    def knots(unnormalized, min_bin):
        size = torch.softmax(unnormalized, dim=-1)
        size = min_bin + (1 - min_bin * num_bins) * size
        cum = F.pad(torch.cumsum(size, dim=-1), (1, 0))
        cum = (2 * tail_bound) * cum - tail_bound
        cum = torch.cat([torch.full_like(cum[..., :1], -tail_bound), cum[..., 1:-1],
                         torch.full_like(cum[..., :1], tail_bound)], dim=-1)
        return cum, cum[..., 1:] - cum[..., :-1]

    cumwidths, bin_widths = knots(unnormalized_widths, min_bin_width)
    cumheights, bin_heights = knots(unnormalized_heights, min_bin_height)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    x = torch.clamp(inputs, -tail_bound, tail_bound)
    grid = cumheights if inverse else cumwidths
    ge = (x[..., None] >= grid[..., :-1]).to(x.dtype)  # bin k holds [grid[k], grid[k+1])
    onehot = ge * (1.0 - F.pad(ge[..., 1:], (0, 1)))

    def pick(t):
        return torch.sum(t * onehot, dim=-1)

    in_cumwidths, in_bin_widths = pick(cumwidths[..., :-1]), pick(bin_widths)
    in_cumheights, in_bin_heights = pick(cumheights[..., :-1]), pick(bin_heights)
    delta = in_bin_heights / in_bin_widths
    d0, d1 = pick(derivatives[..., :-1]), pick(derivatives[..., 1:])

    if inverse:
        a = (x - in_cumheights) * (d0 + d1 - 2 * delta) + in_bin_heights * (delta - d0)
        b = in_bin_heights * d0 - (x - in_cumheights) * (d0 + d1 - 2 * delta)
        c = -delta * (x - in_cumheights)
        disc = b * b - 4 * a * c
        root = (2 * c) / (-b - torch.sqrt(torch.clamp(disc, min=0.0)))
        outputs = root * in_bin_widths + in_cumwidths
        theta_1m = root * (1 - root)
        denom = delta + (d0 + d1 - 2 * delta) * theta_1m
        dnum = delta ** 2 * (d1 * root ** 2 + 2 * delta * theta_1m + d0 * (1 - root) ** 2)
        logabsdet = -(torch.log(dnum) - 2 * torch.log(denom))
    else:
        theta = (x - in_cumwidths) / in_bin_widths
        theta_1m = theta * (1 - theta)
        num = in_bin_heights * (delta * theta ** 2 + d0 * theta_1m)
        denom = delta + (d0 + d1 - 2 * delta) * theta_1m
        outputs = in_cumheights + num / denom
        dnum = delta ** 2 * (d1 * theta ** 2 + 2 * delta * theta_1m + d0 * (1 - theta) ** 2)
        logabsdet = torch.log(dnum) - 2 * torch.log(denom)
    outputs = torch.where(inside, outputs, inputs)
    logabsdet = torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
    return outputs, logabsdet


class ConvFlow(nn.Module):
    """Spline coupling (the reference's modules.ConvFlow): the first half
    of the channels parameterizes a rational-quadratic spline of the second."""

    def __init__(self, in_channels: int, filter_channels: int, kernel_size: int,
                 n_layers: int, num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half = in_channels // 2
        self.filter_channels = filter_channels
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.pre = Conv1d(self.half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers)
        self.proj = Conv1d(filter_channels, self.half * (num_bins * 3 - 1), 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g=None, reverse: bool = False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.proj(self.convs(self.pre(x0), x_mask, g=g)) * x_mask
        B, C, T = x0.shape
        h = h.reshape(B, C, -1, T).permute(0, 1, 3, 2)  # (B, half, T, 3 bins - 1)
        nb, denom = self.num_bins, math.sqrt(self.filter_channels)
        x1, logabsdet = rational_quadratic_spline(
            x1, h[..., :nb] / denom, h[..., nb:2 * nb] / denom, h[..., 2 * nb:],
            inverse=reverse, tail_bound=self.tail_bound)
        x = torch.cat([x0, x1], dim=1) * x_mask
        if reverse:
            return x, None
        return x, torch.sum(logabsdet * x_mask, dim=(1, 2))
