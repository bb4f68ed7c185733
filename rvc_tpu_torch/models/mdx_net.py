"""MDX-Net separation: the complex-as-channels spectrogram and the Conv-TDF nets.

Counterpart of ``rvc_tpu/models/mdx_net.py``. ``MDXSpectrogram`` packs a
stereo window's STFT into 4 channels (L.re, L.im, R.re, R.im) cropped to
``dim_f`` bins and back (the reference's ``MDXParams.stft/istft``,
lib/mdx.py:36-52). ``ConvTDFNetTrim`` is the single-target U-net the UVR
MDX ``.onnx`` graphs hold (``compat.onnx_import`` reads their weights);
``TFCTDFNet`` the MDX23C-style net with subbands folded into channels; the
mixer is UVR's "mixer mode" linear. The JAX package keeps activations
(B, T, F, C); here they are (B, C, T, F), so that the TDF bottleneck, a
``Linear`` along frequency, applies to the last axis, and the conv kernels
(O, I, kT, kF) are the JAX package's and the ``.onnx`` file's as they are.
Module names follow the JAX package's paths with ``_N`` read as ``.N``
(``compat.weights.convtdf_state_dict``). In a compute dtype below float32
(``layers.set_dtype_``) the nets compute in it, the norms' statistics in
float32, as the JAX modules' ``dtype``; ``unpack`` takes the spectrogram
up to float32 first (the JAX package's iSTFT would run in the input's
dtype: ROADMAP §3).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import istft, stft
from .layers import GELU, BatchNorm, Conv2d, ConvTranspose2d, GroupNorm, InstanceNorm2d, Linear


class MDXSpectrogram:
    """Complex-as-channels STFT pack/unpack (reference MDXParams)."""

    def __init__(self, dim_f: int, dim_t: int, n_fft: int, hop: int = 1024):
        self.dim_f = dim_f
        self.dim_t = dim_t
        self.dim_c = 4
        self.n_fft = n_fft
        self.hop = hop
        self.n_bins = n_fft // 2 + 1
        self.trim = n_fft // 2
        self.chunk_size = hop * (dim_t - 1)
        self.gen_size = self.chunk_size - 2 * self.trim

    def pack(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 2, chunk_size) stereo -> (B, 4, dim_t, dim_f)."""
        B = x.shape[0]
        real, imag = stft(x.reshape(-1, self.chunk_size), self.n_fft, self.hop, center=True)
        real = real.reshape(B, 2, self.dim_t, self.n_bins)
        imag = imag.reshape(B, 2, self.dim_t, self.n_bins)
        spec = torch.stack([real[:, 0], imag[:, 0], real[:, 1], imag[:, 1]], dim=1)
        return spec[..., : self.dim_f]

    def unpack(self, spec: torch.Tensor) -> torch.Tensor:
        """(B, 4, dim_t, dim_f) -> (B, 2, chunk_size), in float32."""
        B, _, T, _ = spec.shape
        spec = F.pad(spec.float(), (0, self.n_bins - spec.shape[-1]))
        real = spec[:, 0::2].reshape(-1, T, self.n_bins)
        imag = spec[:, 1::2].reshape(-1, T, self.n_bins)
        return istft(real, imag, self.n_fft, self.hop, center=True).reshape(B, 2, -1)


def make_norm(norm_type: str, channels: int) -> nn.Module:
    """The norm a Conv-TDF block names: ``BatchNorm`` (inference statistics),
    ``InstanceNorm`` (affine), ``GroupNorm<g>``, or none."""
    if norm_type == "BatchNorm":
        return BatchNorm(channels)
    if norm_type == "InstanceNorm":
        return InstanceNorm2d(channels, affine=True)
    if norm_type.startswith("GroupNorm"):
        return GroupNorm(int(norm_type.replace("GroupNorm", "")), channels)
    return nn.Identity()


def make_act(act_type: str) -> nn.Module:
    if act_type == "gelu":
        return GELU()
    if act_type == "relu":
        return nn.ReLU()
    if act_type.startswith("elu"):
        return nn.ELU(float(act_type.replace("elu", "") or 1.0))
    raise ValueError(act_type)


class TFCTDFBlock(nn.Module):
    """TFC conv -> TDF frequency bottleneck (added) -> TFC conv, plus a 1x1
    shortcut (reference karafan/tfc_tdf.py:125-146)."""

    def __init__(self, cin: int, c: int, f: int, bn: int, norm: str, act: str):
        super().__init__()
        self.tfc1 = nn.Sequential(make_norm(norm, cin), make_act(act),
                                  Conv2d(cin, c, 3, 1, 1, bias=False))
        self.tdf = nn.Sequential(make_norm(norm, c), make_act(act),
                                 Linear(f, f // bn, bias=False),
                                 make_norm(norm, c), make_act(act),
                                 Linear(f // bn, f, bias=False))
        self.tfc2 = nn.Sequential(make_norm(norm, c), make_act(act),
                                  Conv2d(c, c, 3, 1, 1, bias=False))
        self.shortcut = Conv2d(cin, c, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.shortcut(x)
        h = self.tfc1(x)
        h = h + self.tdf(h)
        return self.tfc2(h) + s


class TFCTDF(nn.Module):
    """``l`` TFC-TDF blocks at ``f`` bins; the first takes ``in_c`` channels."""

    def __init__(self, in_c: int, c: int, l: int, f: int, bn: int, norm: str, act: str):
        super().__init__()
        self.blocks = nn.ModuleList(
            [TFCTDFBlock(in_c if i == 0 else c, c, f, bn, norm, act) for i in range(l)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class _Down(nn.Module):
    def __init__(self, c: int, g: int, f: int, nb: int, bn: int, scale, norm: str, act: str):
        super().__init__()
        self.tfc_tdf = TFCTDF(c, c, nb, f, bn, norm, act)
        self.downscale = nn.Sequential(make_norm(norm, c), make_act(act),
                                       Conv2d(c, c + g, scale, scale, bias=False))


class _Up(nn.Module):
    def __init__(self, c: int, g: int, f: int, nb: int, bn: int, scale, norm: str, act: str):
        super().__init__()
        self.upscale = nn.Sequential(make_norm(norm, c), make_act(act),
                                     ConvTranspose2d(c, c - g, scale, scale, bias=False))
        self.tfc_tdf = TFCTDF(2 * (c - g), c - g, nb, f, bn, norm, act)


class TFCTDFNet(nn.Module):
    """Full-band MDX23C-style U-net (reference TFC_TDF_net,
    karafan/tfc_tdf.py:148-235). ``forward`` takes the packed spectrogram
    (B, channels_audio * 2, T, dim_f) and returns the targets
    (B, num_targets, channels_audio * 2, T, dim_f); subbands fold into
    channels on the way in and out."""

    def __init__(self, num_targets: int = 1, num_subbands: int = 4,
                 num_channels_audio: int = 2, num_scales: int = 5, scale=(2, 2),
                 num_blocks_per_scale: int = 2, c: int = 32, g: int = 32, bn: int = 4,
                 dim_f: int = 2048, norm: str = "InstanceNorm", act: str = "gelu"):
        super().__init__()
        self.num_targets = num_targets
        self.k = num_subbands
        dim_c = num_subbands * num_channels_audio * 2
        f = dim_f // num_subbands
        self.first_conv = Conv2d(dim_c, c, 1, bias=False)
        self.encoder_blocks = nn.ModuleList()
        for _ in range(num_scales):
            self.encoder_blocks.append(
                _Down(c, g, f, num_blocks_per_scale, bn, scale, norm, act))
            f //= scale[1]
            c += g
        self.bottleneck_block = TFCTDF(c, c, num_blocks_per_scale, f, bn, norm, act)
        self.decoder_blocks = nn.ModuleList()
        for _ in range(num_scales):
            f *= scale[1]
            self.decoder_blocks.append(_Up(c, g, f, num_blocks_per_scale, bn, scale, norm, act))
            c -= g
        self.final_conv = nn.Sequential(Conv2d(c + dim_c, c, 1, bias=False), make_act(act),
                                        Conv2d(c, num_targets * dim_c, 1, bias=False))

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        B, C, T, Fq = spec.shape
        k = self.k
        x = spec.reshape(B, C, T, k, Fq // k).permute(0, 1, 3, 2, 4).reshape(B, C * k, T, Fq // k)
        mix = x
        x = first_out = self.first_conv(x)
        skips = []
        for block in self.encoder_blocks:
            x = block.tfc_tdf(x)
            skips.append(x)
            x = block.downscale(x)
        x = self.bottleneck_block(x)
        for block in self.decoder_blocks:
            x = torch.cat([block.upscale(x), skips.pop()], dim=1)
            x = block.tfc_tdf(x)
        x = self.final_conv(torch.cat([mix, x * first_out], dim=1))
        nt = self.num_targets
        Ck, Fk = x.shape[1], x.shape[3]
        x = x.reshape(B, nt, Ck // nt // k, k, T, Fk).permute(0, 1, 2, 4, 3, 5)
        return x.reshape(B, nt, Ck // nt // k, T, k * Fk)


class ConvTDFNetTrim(nn.Module):
    """The MDX v2 single-target net (KUIELab Conv-TDF, the UVR ``.onnx``
    architecture): a first 1x1 conv, ``num_blocks // 2`` scales down with
    TFC-TDF blocks and stride-2 convs, a middle block, the mirrored path up
    with skips added, a final 1x1 conv to 4 channels. (B, 4, T, dim_f) ->
    (B, 4, T, dim_f)."""

    def __init__(self, num_blocks: int = 11, l: int = 3, g: int = 32, bn: int = 8,
                 dim_f: int = 3072, norm: str = "GroupNorm2", act: str = "relu"):
        super().__init__()
        self.num_blocks, self.l, self.g, self.bn = num_blocks, l, g, bn
        self.dim_f, self.norm, self.act_type = dim_f, norm, act
        self.act = make_act(act)
        n = num_blocks // 2
        f, c = dim_f, g
        self.first_conv = Conv2d(4, c, 1, bias=False)
        self.ds_dense, self.ds = nn.ModuleList(), nn.ModuleList()
        for _ in range(n):
            self.ds_dense.append(TFCTDF(c, c, l, f, bn, norm, act))
            self.ds.append(Conv2d(c, c + g, 2, 2, bias=False))
            f //= 2
            c += g
        self.mid_dense = TFCTDF(c, c, l, f, bn, norm, act)
        self.us, self.us_dense = nn.ModuleList(), nn.ModuleList()
        for _ in range(n):
            self.us.append(ConvTranspose2d(c, c - g, 2, 2, bias=False))
            f *= 2
            c -= g
            self.us_dense.append(TFCTDF(c, c, l, f, bn, norm, act))
        self.final_conv = Conv2d(c, 4, 1, bias=False)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        x = self.first_conv(spec)
        skips = []
        for dense, ds in zip(self.ds_dense, self.ds):
            x = dense(x)
            skips.append(x)
            x = self.act(ds(x))
        x = self.mid_dense(x)
        for us, dense in zip(self.us, self.us_dense):
            x = self.act(us(x)) + skips.pop()
            x = dense(x)
        return self.final_conv(x)


# ---- UVR "mixer mode" (reference lib/uvr5_pack/mdxnet.py:126-140 Mixer) ----


def load_mixer(path: str) -> np.ndarray:
    """The pretrained stem mixer (mixer.ckpt): one bias-free linear from 4
    stems and the original, 2 channels each, to 4 stems x 2 channels. Returns
    its (8, 10) weight."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    w = sd["linear.weight"].float().numpy()
    if w.shape != (8, 10):
        raise ValueError(f"unexpected mixer weight shape {w.shape}")
    return w


def apply_mixer(weight, stems: torch.Tensor, original: torch.Tensor) -> torch.Tensor:
    """stems (4, 2, T) and the original mix (2, T) -> remixed stems (4, 2, T):
    one (8, 10) x (10, T) product, float32."""
    T = stems.shape[-1]
    x = torch.cat([stems.reshape(8, T), original], dim=0)
    w = torch.as_tensor(weight, dtype=x.dtype, device=x.device)
    return (w @ x).reshape(4, 2, T)
