"""HuBERT / ContentVec content encoder.

Counterpart of ``rvc_tpu/models/hubert.py`` with HF ``HubertModel``
parameter names: 7-layer conv feature extractor (per-channel group norm on
layer 0, masked by the valid length), feature projection, grouped conv
positional embedding, post-norm transformer layers. Attention is written
out as matmul + softmax, as the JAX package writes it. Activations of the
transformer are (B, T, C); the conv stack runs in (B, C, T). In a compute
dtype below float32 the norms take their statistics in float32 and the
softmax runs in float32 (rvc_tpu/models/hubert.py:63-103, :165).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from .layers import Conv1d, Linear, TorchLayerNorm, gelu, rounded, set_dtype_


@dataclass(frozen=True)
class HubertConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    classifier_proj_size: int = 256
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "group"


def conv_output_lengths(cfg: HubertConfig, lengths: torch.Tensor) -> torch.Tensor:
    out = lengths
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        out = torch.div(out - k, s, rounding_mode="floor") + 1
    return out


class GroupNormPerChannel(nn.Module):
    """GroupNorm with one group per channel over time, (B, C, T), with an
    optional (B, 1, T) validity mask so zero-padded tails do not shift the
    statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        dt, x = x.dtype, x.float()
        if mask is None:
            mu = x.mean(dim=2, keepdim=True)
            var = torch.mean(torch.square(x - mu), dim=2, keepdim=True)
        else:
            mask = mask.float()
            denom = torch.clamp(mask.sum(dim=2, keepdim=True), min=1.0)
            mu = (x * mask).sum(dim=2, keepdim=True) / denom
            var = (torch.square(x - mu) * mask).sum(dim=2, keepdim=True) / denom
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return (y * self.weight[:, None] + self.bias[:, None]).to(dt)


class ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int, norm: bool):
        super().__init__()
        self.conv = Conv1d(cin, cout, k, stride=s, bias=False)
        if norm:
            self.layer_norm = GroupNormPerChannel(cout)


class FeatureExtractor(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            ConvLayer(dims[i], dims[i + 1], k, s,
                      norm=i == 0 and cfg.feat_extract_norm == "group")
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        """(B, T) waveform -> (B, C, frames)."""
        h = x[:, None]
        cur = lengths
        for i, layer in enumerate(self.conv_layers):
            h = layer.conv(h)
            if cur is not None:
                k, s = layer.conv.kernel_size[0], layer.conv.stride[0]
                cur = torch.div(cur - k, s, rounding_mode="floor") + 1
            if hasattr(layer, "layer_norm"):
                mask = None
                if cur is not None:
                    t = torch.arange(h.shape[2], device=h.device)
                    mask = (t[None, None, :] < cur[:, None, None]).to(h.dtype)
                h = layer.layer_norm(h, mask)
            h = gelu(h)
        return h


class FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.layer_norm = TorchLayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor | None = None) -> torch.Tensor:
        B, T, C = x.shape
        dk = C // self.heads
        split = lambda t: t.reshape(B, T, self.heads, dk).transpose(1, 2)  # noqa: E731
        q = self.q_proj(x)
        q = split(q / rounded(math.sqrt(dk), q.dtype))
        k = split(self.k_proj(x))
        v = split(self.v_proj(x))
        scores = torch.matmul(q, k.transpose(-1, -2))
        if attn_bias is not None:
            scores = scores + attn_bias
        p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(B, T, C)
        return self.out_proj(o)


class FeedForward(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.attention = SelfAttention(cfg.hidden_size, cfg.num_attention_heads)
        self.layer_norm = TorchLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg)
        self.final_layer_norm = TorchLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, attn_bias=None) -> torch.Tensor:
        x = self.layer_norm(x + self.attention(x, attn_bias))
        return self.final_layer_norm(x + self.feed_forward(x))


class PosConvEmbed(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                           groups=cfg.num_conv_pos_embedding_groups, weight_norm=True)
        self.trim = 1 if k % 2 == 0 else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T) -> (B, C, T)."""
        pos = self.conv(x)
        if self.trim:
            pos = pos[..., :-1]
        return gelu(pos)


class Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig, n_layers: int):
        super().__init__()
        self.pos_conv_embed = PosConvEmbed(cfg)
        self.layer_norm = TorchLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(n_layers))


class HubertEncoder(nn.Module):
    """HuBERT up to the layer that ``extract_features`` reads.

    ``version`` "v2" keeps the output after 11 transformer layers (the
    reference's output_layer 12); "v1" the output after 8, through
    ``final_proj``. Only the layers that run are built. ``dtype`` is the
    compute dtype (``layers.set_dtype_``)."""

    def __init__(self, cfg: HubertConfig | None = None, version: str = "v2",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg = cfg or HubertConfig()
        self.version = version
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.encoder = Encoder(cfg, 8 if version == "v1" else 11)
        if version == "v1":
            self.final_proj = Linear(cfg.hidden_size, cfg.classifier_proj_size)
        set_dtype_(self, dtype)

    def extract_features(self, source: torch.Tensor,
                         lengths: torch.Tensor | None = None) -> torch.Tensor:
        """source (B, T) 16 kHz -> (B, frames, C); ``lengths`` (B,) valid
        samples mask the group norm and the attention keys."""
        feats = self.feature_extractor(source, lengths).transpose(1, 2)
        attn_bias = None
        if lengths is not None:
            frame_len = conv_output_lengths(self.cfg, lengths)
            t = torch.arange(feats.shape[1], device=feats.device)
            valid = t[None, :] < frame_len[:, None]
            attn_bias = torch.where(valid, 0.0, -1e9)[:, None, None, :].to(feats.dtype)
        h = self.feature_projection(feats)
        h = h + self.encoder.pos_conv_embed(h.transpose(1, 2)).transpose(1, 2)
        h = self.encoder.layer_norm(h)
        for layer in self.encoder.layers:
            h = layer(h, attn_bias)
        if self.version == "v1":
            h = self.final_proj(h)
        return h
