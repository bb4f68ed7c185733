"""Relative-position transformer encoder (the VITS text-encoder core).

Counterpart of ``rvc_tpu/models/attention.py``: post-norm blocks, window-10
relative-position attention shared across heads, masked conv FFN.
Activations are (B, C, T); Q/K/V/O are 1x1 convs under the reference's
names. In a compute dtype below float32 (``layers.set_dtype_``) the
relative tables are cast to it, as the JAX module casts them. The attention itself is kernel 2 (``ops.attention``) at inference;
in training (gradients wanted) it is the plain version, the JAX
``Trainer``'s own XLA path (the kernel has no backward, there or here).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.attention import banded_rel_attention, banded_rel_attention_plain
from .layers import Conv1d, LayerNorm


class MultiHeadAttention(nn.Module):
    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int = 10):
        super().__init__()
        self.n_heads = n_heads
        self.window_size = window_size
        self.k_channels = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        W = 2 * window_size + 1
        self.emb_rel_k = nn.Parameter(torch.zeros(1, W, self.k_channels))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, W, self.k_channels))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        return x.view(B, self.n_heads, self.k_channels, T).transpose(2, 3).contiguous()

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Self-attention over x (B, C, T); ``lengths`` (B,) valid frames."""
        q, k, v = (self._heads(conv(x)) for conv in (self.conv_q, self.conv_k, self.conv_v))
        train = torch.is_grad_enabled() and (q.requires_grad or self.emb_rel_k.requires_grad)
        attend = banded_rel_attention_plain if train else banded_rel_attention
        out = attend(
            q, k, v, self.emb_rel_k[0].to(q.dtype).contiguous(),
            self.emb_rel_v[0].to(q.dtype).contiguous(),
            lengths, window=self.window_size, scale=1.0 / math.sqrt(self.k_channels))
        B, H, T, D = out.shape
        return self.conv_o(out.transpose(2, 3).reshape(B, H * D, T))


class FFN(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size, padding=pad)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size, padding=pad)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.conv_1(x * x_mask))
        return self.conv_2(h * x_mask) * x_mask


class Encoder(nn.Module):
    """Stack of post-norm relative-attention blocks (reference attentions.Encoder)."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, window_size: int = 10):
        super().__init__()
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden_channels, hidden_channels, n_heads, window_size)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden_channels, hidden_channels, filter_channels, kernel_size)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hidden_channels) for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        """x (B, C, T); x_mask (B, 1, T), a prefix mask."""
        lengths = x_mask[:, 0].sum(dim=1).to(torch.int32)
        x = x * x_mask
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1,
                                           self.ffn_layers, self.norm_layers_2):
            x = norm1(x + attn(x, lengths))
            x = norm2(x + ffn(x, x_mask))
        return x * x_mask
