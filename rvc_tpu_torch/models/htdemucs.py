"""Hybrid Demucs v3 (``HDemucs``) and v4 (``HTDemucs``, the cross-domain
transformer): UVR's Demucs family (htdemucs, htdemucs_ft, htdemucs_6s,
hdemucs_mmi).

Counterpart of ``rvc_tpu/models/htdemucs.py`` (the reference's
``demucs/hdemucs.py``, ``htdemucs.py``, ``transformer.py`` and
``demucs.py``'s ``DConv`` and ``LocalState``). The JAX package runs
channels-last; here every tensor has the reference's layout: the
frequency branch (B, C, F, T), the time branch (B, C, T), a DConv of the
frequency branch on (B F, C, T). The state_dict names are the reference's,
so a released ``.th`` package loads as it is
(``compat.torch_import.load_demucs_v4``; ``compat.weights.
demucs_state_dict`` carries a JAX tree).

The spectrogram is the reference's: the mix reflect-padded by 3/2 hop a
side (``reflect_pad_1d`` zero-extends a signal shorter than the pad), an
STFT of ``nfft`` at hop ``nfft // 4`` scaled by 1/sqrt(nfft) (torch's
``normalized=True``), the two context frames a side and the Nyquist bin
dropped; ``_ispec`` undoes each step through ``ops.stft.istft`` (not
``torch.istft``, which refuses the squared-window normalization where the
window sum is small). The transformer takes the frequency branch's tokens
time-major (token ``t F + f``), as the reference's ``rearrange`` and the
JAX package's flatten do; attention is softmax(q k^T / sqrt(d)) v through
``torch.matmul``, with no Pallas kernel behind it in the JAX package.
MultiWrap frequency splitting and any positional embedding but ``sin``
(CAPE) raise, as in JAX.

``forward(mix, events=None)`` takes (B, audio_channels, T) and returns
(B, n_sources, audio_channels, T); ``events`` gets the CUDA stage marks
"stft", "network" and "istft" (``device.mark``).
"""
from __future__ import annotations

import functools
import inspect
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import mark
from ..ops.stft import istft, reflect_pad, stft
from ..ops.wiener import wiener
from .demucs import BLSTM
from .layers import Conv1d, Conv2d, ConvTranspose1d, ConvTranspose2d, Embedding, Linear, \
    TorchLayerNorm


def reflect_pad_1d(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the last axis, zero-extending first where the signal is
    not longer than the pad (reference hdemucs.pad1d)."""
    length = x.shape[-1]
    max_pad = max(left, right)
    if length <= max_pad:
        extra = max_pad - length + 1
        extra_r = min(right, extra)
        extra_l = extra - extra_r
        x = F.pad(x, (extra_l, extra_r))
        left, right = left - extra_l, right - extra_r
    return reflect_pad(x, left, right)


def _norm(groups: int, channels: int, on: bool) -> nn.Module:
    return nn.GroupNorm(groups, channels) if on else nn.Identity()


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

class LayerScale(nn.Module):
    """Per-channel rescaling of a residual branch, on axis 1 or, with
    ``channel_last``, the last axis."""

    def __init__(self, channels: int, init: float = 0.0, channel_last: bool = False):
        super().__init__()
        self.channel_last = channel_last
        self.scale = nn.Parameter(torch.full((channels,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * (self.scale if self.channel_last else self.scale[:, None])


class LocalState(nn.Module):
    """Local attention with learned decay windows over (B, C, T): keys t,
    queries s, each step's own key masked by -100, the softmax over keys."""

    def __init__(self, channels: int, heads: int = 4, ndecay: int = 4):
        super().__init__()
        self.heads, self.ndecay = heads, ndecay
        self.content = Conv1d(channels, channels, 1)
        self.query = Conv1d(channels, channels, 1)
        self.key = Conv1d(channels, channels, 1)
        if ndecay:
            self.query_decay = Conv1d(channels, heads * ndecay, 1)
        self.proj = Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        H = self.heads
        q = self.query(x).view(B, H, -1, T)
        k = self.key(x).view(B, H, -1, T)
        dots = torch.einsum("bhct,bhcs->bhts", k, q) / math.sqrt(k.shape[2])
        if self.ndecay:
            decays = torch.arange(1, self.ndecay + 1, device=x.device, dtype=x.dtype)
            dq = torch.sigmoid(self.query_decay(x).view(B, H, -1, T)) / 2
            idx = torch.arange(T, device=x.device, dtype=x.dtype)
            delta = (idx[:, None] - idx[None, :]).abs()
            kernel = -decays[:, None, None] * delta[None] / math.sqrt(self.ndecay)
            dots = dots + torch.einsum("fts,bhfs->bhts", kernel, dq)
        dots = dots.masked_fill(torch.eye(T, device=x.device, dtype=torch.bool), -100.0)
        w = torch.softmax(dots, dim=2)
        content = self.content(x).view(B, H, -1, T)
        out = torch.einsum("bhts,bhct->bhcs", w, content).reshape(B, C, T)
        return x + self.proj(out)


class DConv(nn.Module):
    """Residual branches of dilated convs over (B, C, T) (reference
    demucs.DConv): per layer conv, GroupNorm(1), GELU, [BLSTM on 200-step
    frames], [LocalState], 1x1 conv, GroupNorm(1), GLU, LayerScale, each at
    its ``nn.Sequential`` index."""

    def __init__(self, channels: int, compress: float = 4.0, depth: int = 2,
                 init: float = 1e-4, norm: bool = True, attn: bool = False, heads: int = 4,
                 ndecay: int = 4, lstm: bool = False, gelu: bool = True, kernel: int = 3):
        super().__init__()
        dilate = depth > 0
        hidden = int(channels / compress)
        self.layers = nn.ModuleList()
        for d in range(abs(depth)):
            dilation = 2 ** d if dilate else 1
            mods = [Conv1d(channels, hidden, kernel, dilation=dilation,
                           padding=dilation * (kernel // 2)),
                    _norm(1, hidden, norm), nn.GELU() if gelu else nn.ReLU()]
            if lstm:
                mods.append(BLSTM(hidden, layers=2, max_steps=200, skip=True))
            if attn:
                mods.append(LocalState(hidden, heads=heads, ndecay=ndecay))
            mods += [Conv1d(hidden, 2 * channels, 1), _norm(1, 2 * channels, norm),
                     nn.GLU(1), LayerScale(channels, init)]
            self.layers.append(nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = x + layer(x)
        return x


def _dconv_over_freq(dconv: DConv, y: torch.Tensor) -> torch.Tensor:
    """A DConv over each frequency row of (B, C, F, T): run on (B F, C, T)."""
    B, C, Fr, T = y.shape
    y = dconv(y.permute(0, 2, 1, 3).reshape(-1, C, T))
    return y.view(B, Fr, C, T).permute(0, 2, 1, 3)


class HEncLayer(nn.Module):
    """Encoder layer of either branch: frequency (a (k, 1) conv over F of
    (B, C, F, T)) or time (a strided conv over (B, C, T))."""

    def __init__(self, chin: int, chout: int, kernel_size: int = 8, stride: int = 4,
                 norm_groups: int = 1, empty: bool = False, freq: bool = True,
                 dconv: bool = True, norm: bool = True, context: int = 0, pad: bool = True,
                 rewrite: bool = True, dconv_depth: int = 2, dconv_comp: float = 4.0,
                 dconv_init: float = 1e-4, dconv_lstm: bool = False, dconv_attn: bool = False):
        super().__init__()
        pad_amt = kernel_size // 4 if pad else 0
        self.freq, self.empty, self.stride = freq, empty, stride
        if freq:
            self.conv = Conv2d(chin, chout, (kernel_size, 1), (stride, 1), (pad_amt, 0))
        else:
            self.conv = Conv1d(chin, chout, kernel_size, stride=stride, padding=pad_amt)
        if empty:
            return
        self.norm1 = _norm(norm_groups, chout, norm)
        self.rewrite = None
        if rewrite:
            c = context
            self.rewrite = (Conv2d(chout, 2 * chout, (1 + 2 * c, 1 + 2 * c), (1, 1), (c, c))
                            if freq else Conv1d(chout, 2 * chout, 1 + 2 * c, padding=c))
            self.norm2 = _norm(norm_groups, 2 * chout, norm)
        self.dconv = (DConv(chout, dconv_comp, dconv_depth, dconv_init, attn=dconv_attn,
                            lstm=dconv_lstm) if dconv else None)

    def forward(self, x: torch.Tensor, inject: torch.Tensor | None = None) -> torch.Tensor:
        if self.freq:
            if x.dim() == 3:  # a time tensor entering the frequency stack: F == 1
                x = x[:, :, None]
        else:
            if x.dim() == 4:  # the frequency tensor entering the time stack
                x = x.reshape(x.shape[0], -1, x.shape[-1])
            le = x.shape[-1]
            if le % self.stride:
                x = F.pad(x, (0, self.stride - le % self.stride))
        y = self.conv(x)
        if self.empty:
            return y
        if inject is not None:
            y = y + (inject[:, :, None] if y.dim() == 4 and inject.dim() == 3 else inject)
        y = F.gelu(self.norm1(y))
        if self.dconv is not None:
            y = _dconv_over_freq(self.dconv, y) if self.freq else self.dconv(y)
        if self.rewrite is None:
            return y
        return F.glu(self.norm2(self.rewrite(y)), dim=1)


class HDecLayer(nn.Module):
    """Decoder layer of either branch; returns (output, the activation
    before the transposed conv)."""

    def __init__(self, chin: int, chout: int, last: bool = False, kernel_size: int = 8,
                 stride: int = 4, norm_groups: int = 1, empty: bool = False, freq: bool = True,
                 dconv: bool = True, norm: bool = True, context: int = 1, pad: bool = True,
                 context_freq: bool = True, rewrite: bool = True, dconv_depth: int = 2,
                 dconv_comp: float = 4.0, dconv_init: float = 1e-4, dconv_lstm: bool = False,
                 dconv_attn: bool = False):
        super().__init__()
        self.pad = kernel_size // 4 if pad else 0
        self.last, self.freq, self.empty = last, freq, empty
        if freq:
            self.conv_tr = ConvTranspose2d(chin, chout, (kernel_size, 1), (stride, 1))
        else:
            self.conv_tr = ConvTranspose1d(chin, chout, kernel_size, stride=stride)
        self.norm2 = _norm(norm_groups, chout, norm)
        if empty:
            return
        self.rewrite = None
        if rewrite:
            c = context
            if not freq:
                self.rewrite = Conv1d(chin, 2 * chin, 1 + 2 * c, padding=c)
            elif context_freq:
                self.rewrite = Conv2d(chin, 2 * chin, (1 + 2 * c, 1 + 2 * c), (1, 1), (c, c))
            else:
                self.rewrite = Conv2d(chin, 2 * chin, (1, 1 + 2 * c), (1, 1), (0, c))
            self.norm1 = _norm(norm_groups, 2 * chin, norm)
        self.dconv = (DConv(chin, dconv_comp, dconv_depth, dconv_init, attn=dconv_attn,
                            lstm=dconv_lstm) if dconv else None)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None,
                length: int) -> tuple[torch.Tensor, torch.Tensor]:
        if self.freq and x.dim() == 3:
            x = x[:, :, None]  # the time -> frequency transition: F == 1
        if self.empty:
            y = x
        else:
            x = x + skip
            y = x if self.rewrite is None else F.glu(self.norm1(self.rewrite(x)), dim=1)
            if self.dconv is not None:
                y = _dconv_over_freq(self.dconv, y) if self.freq else self.dconv(y)
        z = self.norm2(self.conv_tr(y))
        if self.freq:
            if self.pad:
                z = z[:, :, self.pad: -self.pad]
        else:
            z = z[..., self.pad: self.pad + length]
        if not self.last:
            z = F.gelu(z)
        return z, y


class ScaledEmbedding(nn.Module):
    """The frequency embedding: rows of ``embedding`` times ``scale``."""

    def __init__(self, num_embeddings: int, dim: int, scale: float = 10.0):
        super().__init__()
        self.scale = scale
        self.embedding = Embedding(num_embeddings, dim)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding(ids) * self.scale


# ---------------------------------------------------------------------------
# the cross-domain transformer (v4)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _sin_embedding_np(length: int, dim: int, max_period: float) -> np.ndarray:
    """(length, dim) = cat[cos(phase), sin(phase)] (reference
    transformer.create_sin_embedding)."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    adim = np.arange(dim // 2, dtype=np.float64)[None, :]
    phase = pos / (max_period ** (adim / (dim // 2 - 1)))
    return np.concatenate([np.cos(phase), np.sin(phase)], -1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _sin_embedding_2d_np(d_model: int, height: int, width: int,
                         max_period: float) -> np.ndarray:
    """(height, width, d_model): sin/cos interleaved over width in the first
    half of the channels, over height in the second (reference
    transformer.create_2d_sin_embedding)."""
    pe = np.zeros((d_model, height, width), np.float64)
    d = d_model // 2
    div = np.exp(np.arange(0.0, d, 2) * -(math.log(max_period) / d))
    pos_w = np.arange(width, dtype=np.float64)[:, None]
    pos_h = np.arange(height, dtype=np.float64)[:, None]
    pe[0:d:2] = np.sin(pos_w * div).T[:, None, :]
    pe[1:d:2] = np.cos(pos_w * div).T[:, None, :]
    pe[d::2] = np.sin(pos_h * div).T[:, :, None]
    pe[d + 1:: 2] = np.cos(pos_h * div).T[:, :, None]
    return pe.transpose(1, 2, 0).astype(np.float32)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (``in_proj_weight`` packs q, k,
    v as (3 C, C); ``out_proj``) on (B, T, C)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        C, H = self.dim, self.heads
        dh = C // H
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        B, Tq, _ = q.shape
        Tk = k.shape[1]
        qh = F.linear(q, wq, bq).view(B, Tq, H, dh).transpose(1, 2) / math.sqrt(dh)
        kh = F.linear(k, wk, bk).view(B, Tk, H, dh).transpose(1, 2)
        vh = F.linear(v, wv, bv).view(B, Tk, H, dh).transpose(1, 2)
        attn = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)), dim=-1)
        out = torch.matmul(attn, vh).transpose(1, 2).reshape(B, Tq, C)
        return self.out_proj(out)


class _TransformerBase(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, norm_first: bool, norm_out: bool,
                 layer_scale: bool, init_values: float, gelu: bool, n_norms: int):
        super().__init__()
        self.norm_first = norm_first
        self.act = F.gelu if gelu else F.relu
        self.linear1 = Linear(dim, hidden)
        self.linear2 = Linear(hidden, dim)
        for i in range(1, n_norms + 1):
            setattr(self, f"norm{i}", TorchLayerNorm(dim))
        self.norm_out = nn.GroupNorm(1, dim) if norm_first and norm_out else None
        self.gamma_1 = LayerScale(dim, init_values, True) if layer_scale else nn.Identity()
        self.gamma_2 = LayerScale(dim, init_values, True) if layer_scale else nn.Identity()

    def _ff(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.act(self.linear1(x)))

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_out is None:
            return x
        return self.norm_out(x.transpose(1, 2)).transpose(1, 2)


class TransformerLayer(_TransformerBase):
    """Self-attention layer, norm first, LayerScale, GroupNorm out
    (reference transformer.MyTransformerEncoderLayer)."""

    def __init__(self, dim: int, heads: int, hidden: int, norm_first: bool = True,
                 norm_out: bool = False, layer_scale: bool = True, init_values: float = 1e-4,
                 gelu: bool = True):
        super().__init__(dim, heads, hidden, norm_first, norm_out, layer_scale, init_values,
                         gelu, 2)
        self.self_attn = MultiheadAttention(dim, heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_first:
            h = self.norm1(x)
            x = x + self.gamma_1(self.self_attn(h, h, h))
            x = x + self.gamma_2(self._ff(self.norm2(x)))
            return self._out(x)
        x = self.norm1(x + self.gamma_1(self.self_attn(x, x, x)))
        return self.norm2(x + self.gamma_2(self._ff(x)))


class CrossTransformerLayer(_TransformerBase):
    """Cross-attention layer (reference
    transformer.CrossTransformerEncoderLayer)."""

    def __init__(self, dim: int, heads: int, hidden: int, norm_first: bool = True,
                 norm_out: bool = False, layer_scale: bool = True, init_values: float = 1e-4,
                 gelu: bool = True):
        super().__init__(dim, heads, hidden, norm_first, norm_out, layer_scale, init_values,
                         gelu, 3)
        self.cross_attn = MultiheadAttention(dim, heads)

    def forward(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        if self.norm_first:
            kk = self.norm2(k)
            x = q + self.gamma_1(self.cross_attn(self.norm1(q), kk, kk))
            x = x + self.gamma_2(self._ff(self.norm3(x)))
            return self._out(x)
        x = self.norm1(q + self.gamma_1(self.cross_attn(q, k, k)))
        return self.norm2(x + self.gamma_2(self._ff(x)))


class CrossTransformerEncoder(nn.Module):
    """Self and cross attention layers interleaved over the two branches
    (reference transformer.CrossTransformerEncoder), ``sin`` embedding
    only. x (B, C, F, T1) and xt (B, C, T2) in, the same shapes out."""

    def __init__(self, dim: int, hidden_scale: float = 4.0, num_heads: int = 8,
                 num_layers: int = 5, cross_first: bool = False, emb: str = "sin",
                 norm_in: bool = True, norm_first: bool = True, norm_out: bool = True,
                 max_period: float = 10000.0, layer_scale: bool = True, gelu: bool = True,
                 weight_pos_embed: float = 1.0):
        super().__init__()
        if emb != "sin":
            raise NotImplementedError(f"positional embedding {emb!r}")
        self.max_period = max_period
        self.weight_pos_embed = weight_pos_embed
        self.norm_in = TorchLayerNorm(dim) if norm_in else nn.Identity()
        self.norm_in_t = TorchLayerNorm(dim) if norm_in else nn.Identity()
        self.classic_parity = 1 if cross_first else 0
        kw = dict(dim=dim, heads=num_heads, hidden=int(dim * hidden_scale),
                  norm_first=norm_first, norm_out=norm_out, layer_scale=layer_scale, gelu=gelu)
        self.layers = nn.ModuleList()
        self.layers_t = nn.ModuleList()
        for idx in range(num_layers):
            klass = TransformerLayer if idx % 2 == self.classic_parity else CrossTransformerLayer
            self.layers.append(klass(**kw))
            self.layers_t.append(klass(**kw))

    def forward(self, x: torch.Tensor, xt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        B, C, Fr, T1 = x.shape
        pos2d = _sin_embedding_2d_np(C, Fr, T1, self.max_period)  # (F, T1, C)
        pos2d = torch.as_tensor(pos2d.transpose(1, 0, 2).reshape(T1 * Fr, C), device=x.device)
        x = x.permute(0, 3, 2, 1).reshape(B, T1 * Fr, C)  # time-major tokens
        x = self.norm_in(x) + self.weight_pos_embed * pos2d
        T2 = xt.shape[-1]
        pos1d = torch.as_tensor(_sin_embedding_np(T2, C, self.max_period), device=xt.device)
        xt = self.norm_in_t(xt.transpose(1, 2)) + self.weight_pos_embed * pos1d
        for idx, (layer, layer_t) in enumerate(zip(self.layers, self.layers_t)):
            if idx % 2 == self.classic_parity:
                x, xt = layer(x), layer_t(xt)
            else:
                x, xt = layer(x, xt), layer_t(xt, x)
        x = x.reshape(B, T1, Fr, C).permute(0, 3, 2, 1)
        return x, xt.transpose(1, 2)


# ---------------------------------------------------------------------------
# the hybrid models
# ---------------------------------------------------------------------------

def _layer_plan(cfg) -> list[dict]:
    """The reference constructors' channel and stride bookkeeping
    (hdemucs.py:492-581, htdemucs.py:258-363) as a list of per-layer dicts."""
    plan = []
    chin = cfg.audio_channels
    chin_z = chin * (2 if cfg.cac else 1)
    chout = cfg.channels_time or cfg.channels
    chout_z = cfg.channels
    freqs = cfg.nfft // 2
    for index in range(cfg.depth):
        freq = freqs > 1
        stri, ker = cfg.stride, cfg.kernel_size
        if not freq:
            ker, stri = cfg.time_stride * 2, cfg.time_stride
        pad, last_freq = True, False
        if freq and freqs <= cfg.kernel_size:
            ker, pad, last_freq = freqs, False, True
        if last_freq:
            chout_z = max(chout, chout_z)
            chout = chout_z
        entry = dict(index=index, chin=chin, chin_z=chin_z, chout=chout, chout_z=chout_z,
                     ker=ker, stri=stri, freq=freq, pad=pad, norm=index >= cfg.norm_starts,
                     last_freq=last_freq, lstm=index >= cfg.dconv_lstm,
                     attn=index >= cfg.dconv_attn, freqs=freqs)
        plan.append(entry)
        if index == 0:
            chin = cfg.audio_channels * len(cfg.sources)
            chin_z = chin * (2 if cfg.cac else 1)
            entry["dec_chout"] = chin
            entry["dec_chout_z"] = chin_z
        chin, chin_z = chout, chout_z
        chout, chout_z = int(cfg.growth * chout), int(cfg.growth * chout_z)
        if freq:
            freqs = 1 if freqs <= cfg.kernel_size else freqs // cfg.stride
        entry["freqs_after"] = freqs
    return plan


class _HybridBase(nn.Module):
    """The machinery HDemucs and HTDemucs share: both encoders, both
    decoders, the spectrogram, the masks."""

    def _setup(self, frame) -> None:
        """Keep the subclass constructor's keywords (``frame``: its
        ``locals()``) and build the encoders and decoders from the plan."""
        names = inspect.signature(type(self).__init__).parameters
        for k in names:
            if k != "self":
                setattr(self, k if k != "freq_emb" else "freq_emb_scale", frame[k])
        self.sources = tuple(self.sources)
        if self.multi_freqs:
            raise NotImplementedError("MultiWrap frequency splitting")
        plan = _layer_plan(self)
        self.encoder, self.decoder = nn.ModuleList(), nn.ModuleList()
        self.tencoder, self.tdecoder = nn.ModuleList(), nn.ModuleList()
        self.freq_emb = None
        n_tenc = sum(1 for p in plan if p["freq"])
        for p in plan:
            if p["index"] < n_tenc:
                self.tencoder.append(self._enc_layer(p, True, empty=p["last_freq"]))
            self.encoder.append(self._enc_layer(p, False))
            if p["index"] == 0 and self.freq_emb_scale:
                self.freq_emb = ScaledEmbedding(p["freqs_after"], p["chout_z"], self.emb_scale)
        offset = self.depth - n_tenc
        for di, p in enumerate(reversed(plan)):
            self.decoder.append(self._dec_layer(p, False))
            if di >= offset:
                tp = plan[n_tenc - 1 - (di - offset)]
                self.tdecoder.append(self._dec_layer(tp, True, empty=tp["last_freq"]))

    @property
    def hop_length(self) -> int:
        return self.nfft // 4

    def _enc_layer(self, p: dict, time_branch: bool, empty: bool = False) -> HEncLayer:
        return HEncLayer(
            chin=p["chin"] if time_branch else p["chin_z"],
            chout=p["chout"] if time_branch else p["chout_z"],
            kernel_size=self.kernel_size if time_branch else p["ker"],
            stride=self.stride if time_branch else p["stri"],
            norm_groups=self.norm_groups, empty=empty,
            freq=False if time_branch else p["freq"], dconv=bool(self.dconv_mode & 1),
            norm=p["norm"], context=self.context_enc,
            pad=True if time_branch else p["pad"], rewrite=self.rewrite,
            dconv_depth=self.dconv_depth, dconv_comp=self.dconv_comp,
            dconv_init=self.dconv_init, dconv_lstm=p["lstm"], dconv_attn=p["attn"])

    def _dec_layer(self, p: dict, time_branch: bool, empty: bool = False) -> HDecLayer:
        first = p["index"] == 0
        if time_branch:
            cin, cout = p["chout"], (p["dec_chout"] if first else p["chin"])
        else:
            cin, cout = p["chout_z"], (p["dec_chout_z"] if first else p["chin_z"])
        return HDecLayer(
            chin=cin, chout=cout, last=first,
            kernel_size=self.kernel_size if time_branch else p["ker"],
            stride=self.stride if time_branch else p["stri"],
            norm_groups=self.norm_groups, empty=empty,
            freq=False if time_branch else p["freq"], dconv=bool(self.dconv_mode & 2),
            norm=p["norm"], context=self.context, pad=True if time_branch else p["pad"],
            rewrite=self.rewrite, dconv_depth=self.dconv_depth, dconv_comp=self.dconv_comp,
            dconv_init=self.dconv_init, dconv_lstm=p["lstm"], dconv_attn=p["attn"])

    def _spec(self, mix: torch.Tensor) -> torch.Tensor:
        """mix (B, C, T) -> complex (B, C, nfft // 2, ceil(T / hop))."""
        hl, nfft = self.hop_length, self.nfft
        le = int(math.ceil(mix.shape[-1] / hl))
        pad = hl // 2 * 3
        x = reflect_pad_1d(mix, pad, pad + le * hl - mix.shape[-1])
        re, im = stft(x, nfft, hl, center=True)  # (B, C, frames, bins)
        scale = 1.0 / math.sqrt(nfft)
        z = torch.complex(re[..., 2: 2 + le, :-1] * scale, im[..., 2: 2 + le, :-1] * scale)
        return z.transpose(-1, -2)

    def _ispec(self, z: torch.Tensor, length: int) -> torch.Tensor:
        """complex (..., nfft // 2, frames) -> (..., length)."""
        hl, nfft = self.hop_length, self.nfft
        scale = math.sqrt(nfft)
        re = F.pad(z.real.transpose(-1, -2), (0, 1, 2, 2)) * scale
        im = F.pad(z.imag.transpose(-1, -2), (0, 1, 2, 2)) * scale
        pad = hl // 2 * 3
        le = hl * int(math.ceil(length / hl)) + 2 * pad
        x = istft(re, im, nfft, hl, center=True, length=le)
        return x[..., pad: pad + length]

    def _magnitude(self, z: torch.Tensor) -> torch.Tensor:
        """CaC: (B, C, F, T) complex -> (B, 2 C, F, T), channel 2 c + (re, im);
        else the magnitude."""
        if not self.cac:
            return z.abs()
        B, C, Fr, T = z.shape
        return torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(B, 2 * C, Fr, T)

    def _mask(self, z: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """The network's spectrogram output m -> complex (B, S, C, F, T):
        CaC, m read as (re, im) pairs; else magnitudes given the mixture's
        phase (``wiener_iters`` < 0) or refined by ``ops.wiener`` in
        300-frame windows."""
        S = len(self.sources)
        B, _, Fr, T = m.shape
        if self.cac:
            out = m.view(B, S, -1, 2, Fr, T).permute(0, 1, 2, 4, 5, 3)
            return torch.view_as_complex(out.contiguous())
        m = m.view(B, S, self.audio_channels, Fr, T)
        if self.wiener_iters < 0:
            unit = z / (1e-8 + z.abs())
            return unit[:, None] * m
        y = wiener(m.permute(0, 4, 3, 2, 1), z.permute(0, 3, 2, 1), self.wiener_iters,
                   residual=self.wiener_residual)  # (B, T, F, C, S)
        return y.permute(0, 4, 3, 2, 1)

    def _run_hybrid(self, mix: torch.Tensor, transformer, events: list | None) -> torch.Tensor:
        """Both encoders, the transformer (v4) or zeros (v3) at the bottom,
        both decoders, the masks and the iSTFT: (B, C, T) -> (B, S, C, T)."""
        B, _, length = mix.shape
        z = self._spec(mix)
        x = self._magnitude(z)
        mark(events, "stft")
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) / (1e-5 + std)
        meant = mix.mean(dim=(1, 2), keepdim=True)
        stdt = mix.std(dim=(1, 2), keepdim=True)
        xt = (mix - meant) / (1e-5 + stdt)

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, enc in enumerate(self.encoder):
            lengths.append(x.shape[-1])
            inject = None
            if idx < len(self.tencoder):
                lengths_t.append(xt.shape[-1])
                tenc = self.tencoder[idx]
                xt = tenc(xt)
                if tenc.empty:
                    inject = xt
                else:
                    saved_t.append(xt)
            x = enc(x, inject)
            if idx == 0 and self.freq_emb is not None:
                frs = torch.arange(x.shape[-2], device=x.device)
                x = x + self.freq_emb_scale * self.freq_emb(frs).t()[None, :, :, None]
            saved.append(x)

        if transformer is None:
            x = torch.zeros_like(x)
        else:
            x, xt = transformer(x, xt)

        offset = self.depth - len(self.tdecoder)
        for di, dec in enumerate(self.decoder):
            x, pre = dec(x, saved.pop(-1), lengths.pop(-1))
            if di >= offset:
                tdec = self.tdecoder[di - offset]
                length_t = lengths_t.pop(-1)
                if tdec.empty:
                    xt, _ = tdec(pre[:, :, 0], None, length_t)  # F == 1 at the merge
                else:
                    xt, _ = tdec(xt, saved_t.pop(-1), length_t)
        mark(events, "network")

        x = x * std + mean
        wave_spec = self._ispec(self._mask(z, x), length)  # (B, S, C, length)
        xt = xt.view(B, len(self.sources), self.audio_channels, length)
        out = xt * stdt[:, None] + meant[:, None] + wave_spec
        mark(events, "istft")
        return out


class HDemucs(_HybridBase):
    """Hybrid Demucs v3 (reference hdemucs.HDemucs): a frequency U-net and
    a time U-net merged at the layer where the frequency axis collapses;
    DConv branches with BLSTM and LocalState from ``dconv_lstm`` /
    ``dconv_attn`` on (hdemucs_mmi)."""

    def __init__(self, sources=("drums", "bass", "other", "vocals"), audio_channels: int = 2,
                 channels: int = 48, channels_time: int | None = None, growth: float = 2.0,
                 nfft: int = 4096, cac: bool = True, depth: int = 6, rewrite: bool = True,
                 multi_freqs=None, multi_freqs_depth: int = 2, freq_emb: float = 0.2,
                 emb_scale: float = 10.0, emb_smooth: bool = True, kernel_size: int = 8,
                 time_stride: int = 2, stride: int = 4, context: int = 1, context_enc: int = 0,
                 norm_starts: int = 4, norm_groups: int = 4, dconv_mode: int = 1,
                 dconv_depth: int = 2, dconv_comp: float = 4.0, dconv_attn: int = 4,
                 dconv_lstm: int = 4, dconv_init: float = 1e-4, wiener_iters: int = 0,
                 end_iters: int = 0, wiener_residual: bool = False, samplerate: int = 44100,
                 segment: float = 40.0):
        super().__init__()
        self._setup(locals())

    def forward(self, mix: torch.Tensor, events: list | None = None) -> torch.Tensor:
        return self._run_hybrid(mix, None, events)


class HTDemucs(_HybridBase):
    """Hybrid Transformer Demucs v4 (reference htdemucs.HTDemucs): the two
    branches stay apart through the encoders and meet in the cross-domain
    transformer. With ``use_train_segment`` a mix shorter than the training
    segment is padded to it and the output cropped back."""

    def __init__(self, sources=("drums", "bass", "other", "vocals"), audio_channels: int = 2,
                 channels: int = 48, channels_time: int | None = None, growth: float = 2.0,
                 nfft: int = 4096, cac: bool = True, depth: int = 4, rewrite: bool = True,
                 multi_freqs=None, multi_freqs_depth: int = 3, freq_emb: float = 0.2,
                 emb_scale: float = 10.0, emb_smooth: bool = True, kernel_size: int = 8,
                 time_stride: int = 2, stride: int = 4, context: int = 1, context_enc: int = 0,
                 norm_starts: int = 4, norm_groups: int = 4, dconv_mode: int = 1,
                 dconv_depth: int = 2, dconv_comp: float = 8.0, dconv_attn: int = 10 ** 9,
                 dconv_lstm: int = 10 ** 9, dconv_init: float = 1e-3, wiener_iters: int = 0,
                 end_iters: int = 0, wiener_residual: bool = False, samplerate: int = 44100,
                 segment: float = 10.0, bottom_channels: int = 0, t_layers: int = 5,
                 t_emb: str = "sin", t_hidden_scale: float = 4.0, t_heads: int = 8,
                 t_dropout: float = 0.0, t_norm_in: bool = True, t_norm_first: bool = True,
                 t_norm_out: bool = True, t_max_period: float = 10000.0,
                 t_layer_scale: bool = True, t_gelu: bool = True,
                 t_weight_pos_embed: float = 1.0, t_cross_first: bool = False,
                 use_train_segment: bool = True):
        super().__init__()
        self._setup(locals())
        self.tr_channels = int(channels * growth ** (depth - 1))
        self.crosstransformer = None
        if t_layers > 0:
            ch = self.tr_channels
            if bottom_channels:
                self.channel_upsampler = Conv1d(ch, bottom_channels, 1)
                self.channel_downsampler = Conv1d(bottom_channels, ch, 1)
                self.channel_upsampler_t = Conv1d(ch, bottom_channels, 1)
                self.channel_downsampler_t = Conv1d(bottom_channels, ch, 1)
                ch = bottom_channels
            self.crosstransformer = CrossTransformerEncoder(
                dim=ch, hidden_scale=t_hidden_scale, num_heads=t_heads, num_layers=t_layers,
                cross_first=t_cross_first, emb=t_emb, norm_in=t_norm_in,
                norm_first=t_norm_first, norm_out=t_norm_out, max_period=t_max_period,
                layer_scale=t_layer_scale, gelu=t_gelu, weight_pos_embed=t_weight_pos_embed)

    def _transformer(self, x: torch.Tensor, xt: torch.Tensor):
        if self.crosstransformer is None:
            return x, xt
        if self.bottom_channels:
            B, C, Fr, T = x.shape
            x = self.channel_upsampler(x.reshape(B, C, Fr * T)).view(B, -1, Fr, T)
            xt = self.channel_upsampler_t(xt)
        x, xt = self.crosstransformer(x, xt)
        if self.bottom_channels:
            B, C, Fr, T = x.shape
            x = self.channel_downsampler(x.reshape(B, C, Fr * T)).view(B, -1, Fr, T)
            xt = self.channel_downsampler_t(xt)
        return x, xt

    def forward(self, mix: torch.Tensor, events: list | None = None) -> torch.Tensor:
        length = mix.shape[-1]
        if self.use_train_segment:
            training_length = int(self.segment * self.samplerate)
            if length < training_length:
                mix = F.pad(mix, (0, training_length - length))
        return self._run_hybrid(mix, self._transformer, events)[..., :length]
