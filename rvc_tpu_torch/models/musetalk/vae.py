"""Stable Diffusion's VAE (AutoencoderKL at the sd-vae-ft-mse widths), the
image codec of lip sync.

Counterpart of ``rvc_tpu/models/musetalk/vae.py``: a conv stem, 4 down
stages of 2 resnets (an asymmetric (0, 1, 0, 1) pad before each stride-2
conv), a mid block of resnet, single-head attention and resnet, the
moments; the decoder mirrors it with nearest x2 upsampling. GroupNorm
(32 groups, eps 1e-6) takes float32 statistics. The modules carry
diffusers' state_dict names, so a ``diffusion_pytorch_model.bin`` loads
with ``load_state_dict`` (``load_vae`` also takes the older attention names
``query``, ``key``, ``value`` and ``proj_attn``). Layout NCHW.

``encode`` returns the posterior's mean times 0.18215: the JAX package
takes the mode where the reference samples (rvc_tpu/models/musetalk/
vae.py:185-190), and so does the port.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device, set_float32_math
from ...ops.image import INTER_LANCZOS4, resize
from ..layers import Conv2d, GroupNorm, Linear


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


def conv3(cin: int, cout: int, stride: int = 1, padding: int = 1) -> Conv2d:
    return Conv2d(cin, cout, (3, 3), (stride, stride), (padding, padding))


def conv1(cin: int, cout: int) -> Conv2d:
    return Conv2d(cin, cout, (1, 1))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps=eps)
        self.conv1 = conv3(cin, cout)
        self.norm2 = GroupNorm(groups, cout, eps=eps)
        self.conv2 = conv3(cout, cout)
        self.conv_shortcut = conv1(cin, cout) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class AttentionBlock(nn.Module):
    """Single-head self-attention over the H W positions (diffusers'
    ``Attention`` of the VAE's mid block)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.group_norm(x).flatten(2).transpose(1, 2)  # (B, HW, C)
        q, k, v = (p(h)[:, None] for p in (self.to_q, self.to_k, self.to_v))
        o = F.scaled_dot_product_attention(q, k, v)[:, 0]
        return x + self.to_out[0](o).transpose(1, 2).reshape(B, C, H, W)


class _Sampler(nn.Module):
    def __init__(self, channels: int, stride: int, padding: int):
        super().__init__()
        self.conv = conv3(channels, channels, stride, padding)


class _Block(nn.Module):
    """A down or up stage: ``resnets`` and, but for the last, a
    ``downsamplers`` / ``upsamplers`` conv."""

    def __init__(self, cin: int, cout: int, n: int, groups: int, sampler: str | None):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(cin if j == 0 else cout, cout, groups)
                                     for j in range(n))
        if sampler == "down":
            self.downsamplers = nn.ModuleList([_Sampler(cout, 2, 0)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([_Sampler(cout, 1, 1)])


class _MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(channels, channels, groups) for _ in range(2))
        self.attentions = nn.ModuleList([AttentionBlock(channels, groups)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = list(cfg.block_out_channels), cfg.norm_num_groups
        self.conv_in = conv3(cfg.in_channels, chans[0])
        cins = [chans[0]] + chans[:-1]
        self.down_blocks = nn.ModuleList(
            _Block(ci, co, cfg.layers_per_block, g, "down" if i < len(chans) - 1 else None)
            for i, (ci, co) in enumerate(zip(cins, chans)))
        self.mid_block = _MidBlock(chans[-1], g)
        self.conv_norm_out = GroupNorm(g, chans[-1], eps=1e-6)
        self.conv_out = conv3(chans[-1], 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            for r in block.resnets:
                h = r(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = conv3(cfg.latent_channels, chans[0])
        self.mid_block = _MidBlock(chans[0], g)
        cins = [chans[0]] + chans[:-1]
        self.up_blocks = nn.ModuleList(
            _Block(ci, co, cfg.layers_per_block + 1, g, "up" if i < len(chans) - 1 else None)
            for i, (ci, co) in enumerate(zip(cins, chans)))
        self.conv_norm_out = GroupNorm(g, chans[-1], eps=1e-6)
        self.conv_out = conv3(chans[-1], cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            for r in block.resnets:
                h = r(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = conv1(2 * cfg.latent_channels, 2 * cfg.latent_channels)
        self.post_quant_conv = conv1(cfg.latent_channels, cfg.latent_channels)

    def encode_moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, 3, H, W) in [-1, 1] -> (mean, logvar), each (B, 4, H/8, W/8);
        logvar clipped to [-30, 20]."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The posterior's mean times the scaling factor."""
        return self.encode_moments(x)[0] * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, 4, h, w) -> an image (B, 3, 8h, 8w) in [-1, 1]."""
        return self.decoder(self.post_quant_conv(z / self.cfg.scaling_factor))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def preprocess_image(img: np.ndarray, half_mask: bool = False, size: int = 256) -> np.ndarray:
    """uint8 RGB (H, W, 3) -> (1, 3, size, size) float32 in [-1, 1]: a
    Lanczos-4 resize (``ops.image``), the top half kept with ``half_mask``
    (the bottom half zeroed before the shift to [-1, 1])."""
    x = resize(img, (size, size), INTER_LANCZOS4).astype(np.float32) / 255.0
    if half_mask:
        x[size // 2:] = 0.0
    x = (x - 0.5) / 0.5
    return np.ascontiguousarray(x.transpose(2, 0, 1)[None])


def postprocess_image(x) -> np.ndarray:
    """(B, 3, H, W) in [-1, 1] (a tensor or an array) -> uint8 RGB (B, H, W, 3)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    x = np.clip(np.asarray(x, np.float32) / 2 + 0.5, 0, 1)
    return (x * 255).round().astype(np.uint8).transpose(0, 2, 3, 1)


_OLD_NAMES = [(r"\.query\.", ".to_q."), (r"\.key\.", ".to_k."), (r"\.value\.", ".to_v."),
              (r"\.proj_attn\.", ".to_out.0.")]


def vae_state_dict_from_checkpoint(sd: dict) -> dict:
    """A diffusers AutoencoderKL state_dict with the attention under its
    current or its older names (``query``/``key``/``value``/``proj_attn``)."""
    out = {}
    for k, v in sd.items():
        for pat, rep in _OLD_NAMES:
            k = re.sub(pat, rep, k)
        out[k] = v
    return out


def load_vae(path: str, config: VAEConfig | None = None, device=None) -> AutoencoderKL:
    """An AutoencoderKL from a diffusers ``.bin`` (or ``.pt``) state_dict,
    on ``device`` (None: the card) in eval mode."""
    dev = resolve_device(device)
    set_float32_math()
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = AutoencoderKL(config or VAEConfig())
    model.load_state_dict(vae_state_dict_from_checkpoint(sd), strict=True)
    return model.to(dev).eval()
