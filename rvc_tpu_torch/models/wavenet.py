"""Gated dilated-conv WaveNet block (the VITS "WN"), unfused.

Counterpart of ``rvc_tpu/models/wavenet.py::WN``; activations (B, C, T).
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import Conv1d


class WN(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        if gin_channels:
            self.cond_layer = Conv1d(gin_channels, 2 * hidden_channels * n_layers, 1,
                                     weight_norm=True)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            d = dilation_rate ** i
            self.in_layers.append(Conv1d(hidden_channels, 2 * hidden_channels, kernel_size,
                                         dilation=d, padding=(kernel_size * d - d) // 2,
                                         weight_norm=True))
            out = 2 * hidden_channels if i < n_layers - 1 else hidden_channels
            self.res_skip_layers.append(Conv1d(hidden_channels, out, 1, weight_norm=True))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None
                ) -> torch.Tensor:
        """x (B, H, T); x_mask (B, 1, T); g (B, gin, 1) or None."""
        H = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g) if g is not None else None
        for i, (in_layer, rs_layer) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            s = in_layer(x)
            if g_all is not None:
                s = s + g_all[:, i * 2 * H:(i + 1) * 2 * H]
            acts = torch.tanh(s[:, :H]) * torch.sigmoid(s[:, H:])
            rs = rs_layer(acts)
            if i < self.n_layers - 1:
                x = (x + rs[:, :H]) * x_mask
                output = output + rs[:, H:]
            else:
                output = output + rs
        return output * x_mask
