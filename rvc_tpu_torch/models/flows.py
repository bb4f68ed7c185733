"""Residual coupling flows: the reverse (inference) and forward (training)
directions.

Counterpart of ``rvc_tpu/models/flows.py::ResidualCouplingLayer`` /
``ResidualCouplingBlock`` (mean-only couplings with channel flips). Being
mean-only, the forward direction's log-determinant is zero and is not
returned.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import Conv1d
from .wavenet import WN


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
