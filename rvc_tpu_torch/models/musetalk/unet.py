"""MuseTalk's lip-sync UNet: Stable Diffusion 1.5's UNet2DConditionModel
topology with cross-attention on 384-wide Whisper rows.

Counterpart of ``rvc_tpu/models/musetalk/unet.py``: a sinusoidal time
embedding, ``conv_in``, three CrossAttnDownBlock2D and a DownBlock2D, a mid
block of resnet, transformer and resnet, the mirrored up path over the skip
stack (nearest x2 upsampling), ``conv_out``. ``attention_head_dim`` is the
head count (8), as in SD 1.5's configs: heads of 40, 80 and 160 at full
width. GroupNorm takes float32 statistics (eps 1e-5 in the resnets and
``conv_norm_out``, 1e-6 before each transformer); the feed-forward is an
exact-GELU GEGLU; attention is ``scaled_dot_product_attention`` (the JAX
module's einsum and softmax, no Pallas kernel behind it). The modules carry
diffusers' state_dict names, so MuseTalk's ``pytorch_model.bin`` loads
with ``load_state_dict``. Layout NCHW; ``encoder_hidden_states`` (B, S, 384).
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device, set_float32_math
from ..layers import GroupNorm, Linear, TorchLayerNorm
from .vae import conv1, conv3


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 384
    attention_head_dim: int = 8
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Sequence[str] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    norm_num_groups: int = 32

    @classmethod
    def from_json(cls, path: str) -> "UNetConfig":
        """The fields of a diffusers ``config.json`` (MuseTalk's
        ``musetalk.json``) that this config has; the rest are ignored."""
        with open(path) as f:
            d = json.load(f)
        keys = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in keys})


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' ``Timesteps(flip_sin_to_cos=True, downscale_freq_shift=0)``:
    (B,) -> (B, dim), cosines first."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=timesteps.device) / half
    emb = timesteps[:, None].float() * torch.exp(exponent)[None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=1e-5)
        self.conv1 = conv3(cin, cout)
        self.time_emb_proj = Linear(temb, cout)
        self.norm2 = GroupNorm(groups, cout, eps=1e-5)
        self.conv2 = conv3(cout, cout)
        self.conv_shortcut = conv1(cin, cout) if cin != cout else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        context = x if context is None else context
        B, T, _ = x.shape
        q, k, v = (t.unflatten(-1, (self.heads, -1)).transpose(1, 2)
                   for t in (self.to_q(x), self.to_k(context), self.to_v(context)))
        o = F.scaled_dot_product_attention(q, k, v)  # (B, heads, T, dim_head)
        return self.to_out[0](o.transpose(1, 2).reshape(B, T, -1))


class LayerNormT(TorchLayerNorm):
    """LayerNorm over the last axis (eps 1e-5) with float32 statistics."""


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, g = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(g)


class _FeedForward(nn.Module):
    """diffusers' ``FeedForward``: ``net.0`` the GEGLU, ``net.2`` the output
    (``net.1`` is a dropout, no parameters)."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm1 = LayerNormT(dim)
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.norm2 = LayerNormT(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = LayerNormT(dim)
        self.ff = _FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, channels: int, context_dim: int, heads: int, groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = conv1(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, context_dim, heads, channels // heads)])
        self.proj_out = conv1(channels, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)
        h = self.transformer_blocks[0](h, context)
        return self.proj_out(h.transpose(1, 2).reshape(B, C, H, W)) + x


class _TimeEmbedding(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear_1 = Linear(cin, cout)
        self.linear_2 = Linear(cout, cout)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t)))


class _Stage(nn.Module):
    """A down or up block: ``resnets``, ``attentions`` when it cross-attends,
    and a ``downsamplers`` / ``upsamplers`` conv but for the last."""

    def __init__(self, resnets: list, attentions: list | None, sampler: nn.Module | None,
                 kind: str):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if sampler is not None:
            holder = nn.Module()
            holder.conv = sampler
            setattr(self, f"{kind}samplers", nn.ModuleList([holder]))


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        chans, g = list(cfg.block_out_channels), cfg.norm_num_groups
        temb, heads, ctx = chans[0] * 4, cfg.attention_head_dim, cfg.cross_attention_dim
        self.time_embedding = _TimeEmbedding(chans[0], temb)
        self.conv_in = conv3(cfg.in_channels, chans[0])

        skips = [chans[0]]
        self.down_blocks = nn.ModuleList()
        cin = chans[0]
        for i, (btype, cout) in enumerate(zip(cfg.down_block_types, chans)):
            cross = btype == "CrossAttnDownBlock2D"
            n = cfg.layers_per_block
            res = [ResnetBlock2D(cin if j == 0 else cout, cout, temb, g) for j in range(n)]
            att = [Transformer2D(cout, ctx, heads, g) for _ in range(n)] if cross else None
            skips += [cout] * n
            last = i == len(chans) - 1
            if not last:
                skips.append(cout)
            self.down_blocks.append(_Stage(res, att, None if last else conv3(cout, cout, 2, 1),
                                           "down"))
            cin = cout

        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(ResnetBlock2D(cin, cin, temb, g) for _ in range(2))
        self.mid_block.attentions = nn.ModuleList([Transformer2D(cin, ctx, heads, g)])

        self.up_blocks = nn.ModuleList()
        for i, (btype, cout) in enumerate(zip(cfg.up_block_types, reversed(chans))):
            cross = btype == "CrossAttnUpBlock2D"
            n = cfg.layers_per_block + 1
            res = []
            for j in range(n):
                res.append(ResnetBlock2D((cin if j == 0 else cout) + skips.pop(), cout, temb, g))
            att = [Transformer2D(cout, ctx, heads, g) for _ in range(n)] if cross else None
            last = i == len(chans) - 1
            self.up_blocks.append(_Stage(res, att, None if last else conv3(cout, cout), "up"))
            cin = cout
        self.conv_norm_out = GroupNorm(g, cin, eps=1e-5)
        self.conv_out = conv3(cin, cfg.out_channels)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """sample (B, in_channels, H, W), timesteps (B,) or a scalar,
        encoder_hidden_states (B, S, cross_attention_dim) -> (B, out_channels, H, W)."""
        t = torch.as_tensor(timesteps, device=sample.device).reshape(-1)
        temb = self.time_embedding(timestep_embedding(t, self.cfg.block_out_channels[0]))
        ctx = encoder_hidden_states
        h = self.conv_in(sample)
        skips = [h]
        for block in self.down_blocks:
            for j, r in enumerate(block.resnets):
                h = r(h, temb)
                if hasattr(block, "attentions"):
                    h = block.attentions[j](h, ctx)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0].conv(h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb), ctx), temb)
        for block in self.up_blocks:
            for j, r in enumerate(block.resnets):
                h = r(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(block, "attentions"):
                    h = block.attentions[j](h, ctx)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


def positional_encoding(x: torch.Tensor, d_model: int = 384) -> torch.Tensor:
    """x (B, T, d_model) plus the sinusoidal table of the reference's
    ``PositionalEncoding`` (sines on even channels, cosines on odd), the
    table computed in numpy float32 as the JAX package computes it."""
    T = x.shape[1]
    position = np.arange(T)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, d_model, 2).astype(np.float32) * (-math.log(10000.0) / d_model))
    pe = np.zeros((T, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return x + torch.from_numpy(pe).to(x.device, x.dtype)[None]


def load_unet(path: str, config: UNetConfig | str | None = None,
              device=None) -> UNet2DCondition:
    """MuseTalk's UNet from a ``pytorch_model.bin`` state_dict (float16 or
    float32 on disk; the parameters are float32), on ``device`` (None: the
    card) in eval mode. ``config``: a ``UNetConfig``, a diffusers JSON
    (MuseTalk's ``musetalk.json``), or None for ``UNetConfig()``."""
    dev = resolve_device(device)
    set_float32_math()
    if isinstance(config, str):
        config = UNetConfig.from_json(config)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = UNet2DCondition(config or UNetConfig())
    model.load_state_dict(sd, strict=True)  # copied into the float32 parameters
    return model.to(dev).eval()
