"""UVR5 "VR architecture" magnitude-mask networks, in the reference's layout.

Counterpart of ``rvc_tpu/models/vr_network.py`` (the reference's
``lib/uvr5_pack/vr_network/{nets,layers,nets_new,layers_new}.py``):
``CascadedASPPNet``, the 4-band separator (two half-band ASPP U-nets
cascaded into full-band refiners, a sigmoid mask, the aggressiveness
exponent), and ``CascadedNet``, the "new" family (DeEcho / DeReverb) with
its BiLSTM branch. The JAX package runs them time-major (B, T, F, C) with
each conv kernel's spatial axes swapped (``compat.weights.vr_state_dict``
swaps them back); here activations are (B, C, F, T) and every module and
parameter has the reference's state_dict name, so a UVR5 ``.pth`` loads as
it is (``compat.torch_import.load_vr_pth``). Dropout and the training-only
auxiliary outputs are left out. Convolutions and the LSTM are PyTorch's
(cuDNN on the card): the JAX package runs them outside any Pallas kernel.

In a compute dtype below float32 (``layers.set_dtype_``) every conv rounds
its product, the leaky slope and the upsampling's weights are rounded, the
2x upsampling is JAX's two 1-D passes (time, then bins) with each op
rounded, as the JAX modules compute; the aggressiveness
exponent is taken in float32, as the JAX separator's float32 ``value``
promotes it (rvc_tpu/pipelines/separate.py:58-62). The "new" cascade
(``CascadedNet``), which no separator builds, has no bf16 form: its LSTM
stays ``nn.LSTM``, as JAX's bf16 form of it cannot trace.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bands import crop_center
from .layers import BatchNorm, Conv2d, LeakyReLU, Linear, low_precision, sigmoid


def _activ(name: str) -> nn.Module:
    return nn.ReLU() if name == "relu" else LeakyReLU(0.01)


class Conv2DBNActiv(nn.Module):
    """Conv (no bias), inference BatchNorm, ReLU or leaky ReLU (0.01)."""

    def __init__(self, nin: int, nout: int, ksize: int = 3, stride: int = 1, pad=1,
                 dilation=1, activ: str = "relu"):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(nin, nout, ksize, stride, pad, bias=False, dilation=dilation),
            BatchNorm(nout), _activ(activ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class SeperableConv2DBNActiv(nn.Module):
    """Depthwise dilated conv, 1x1 conv, BatchNorm, ReLU (the reference's
    spelling of the name)."""

    def __init__(self, nin: int, nout: int, ksize: int = 3, stride: int = 1, pad=1,
                 dilation=1):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(nin, nin, ksize, stride, pad, bias=False, dilation=dilation, groups=nin),
            Conv2d(nin, nout, 1, bias=False), BatchNorm(nout), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Encoder(nn.Module):
    """layers.Encoder: a refine conv, then a strided conv; returns (h, skip)."""

    def __init__(self, nin: int, nout: int, stride: int = 2):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, 3, 1, 1, activ="leaky")
        self.conv2 = Conv2DBNActiv(nout, nout, 3, stride, 1, activ="leaky")

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        skip = self.conv1(x)
        return self.conv2(skip), skip


def _interp_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Linear 2x interpolation along ``dim`` with align_corners=True, as the
    JAX package writes it (``_interp_axis_align``): float32 positions, the
    weights cast to x's dtype, x_lo (1 - w) + x_hi w."""
    n = x.shape[dim]
    if n == 1:
        return x.repeat_interleave(2, dim)
    pos = torch.arange(2 * n, device=x.device, dtype=torch.float32) * ((n - 1) / (2 * n - 1))
    lo = pos.floor()
    w = (pos - lo).to(x.dtype).view((-1,) + (1,) * (x.dim() - 1 - dim))
    lo = lo.long()
    hi = (lo + 1).clamp(max=n - 1)
    return x.index_select(dim, lo) * (1 - w) + x.index_select(dim, hi) * w


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling of (B, C, F, T), align_corners=True; below
    float32 along the frames, then the bins, as the JAX package's
    ``_bilinear_2x`` on its (B, T, F, C)."""
    if not low_precision(x.dtype):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
    return _interp_axis(_interp_axis(x, 3), 2)


def _upsample_cat(x: torch.Tensor, skip: torch.Tensor | None) -> torch.Tensor:
    """2x bilinear upsampling (align_corners=True), then the skip cropped to
    x's frames (centred) and both cut to the fewer bins (an odd bin count
    halves down), concatenated on the channels."""
    x = upsample2x(x)
    if skip is None:
        return x
    skip = crop_center(skip, x.shape[3])
    f = min(x.shape[2], skip.shape[2])
    return torch.cat([x[:, :, :f], skip[:, :, :f]], dim=1)


class Decoder(nn.Module):
    """layers.Decoder: upsample, join the skip, Conv2DBNActiv (ReLU)."""

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv = Conv2DBNActiv(nin, nout, 3, 1, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None) -> torch.Tensor:
        return self.conv(_upsample_cat(x, skip))


class ASPPModule(nn.Module):
    """layers.ASPPModule: a frequency-pooled branch, a 1x1 branch and three
    separable dilated branches, joined by a 1x1 bottleneck."""

    def __init__(self, nin: int, nout: int, dilations=(4, 8, 16)):
        super().__init__()
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d((1, None)),
                                   Conv2DBNActiv(nin, nin, 1, 1, 0))
        self.conv2 = Conv2DBNActiv(nin, nin, 1, 1, 0)
        self.conv3 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[0], dilations[0])
        self.conv4 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[1], dilations[1])
        self.conv5 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[2], dilations[2])
        self.bottleneck = nn.Sequential(Conv2DBNActiv(nin * 5, nout, 1, 1, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat1 = self.conv1(x).expand(-1, -1, x.shape[2], -1)
        feats = [feat1, self.conv2(x), self.conv3(x), self.conv4(x), self.conv5(x)]
        return self.bottleneck(torch.cat(feats, dim=1))


class BaseASPPNet(nn.Module):
    def __init__(self, nin: int, ch: int, dilations=(4, 8, 16)):
        super().__init__()
        self.enc1 = Encoder(nin, ch)
        self.enc2 = Encoder(ch, ch * 2)
        self.enc3 = Encoder(ch * 2, ch * 4)
        self.enc4 = Encoder(ch * 4, ch * 8)
        self.aspp = ASPPModule(ch * 8, ch * 16, dilations)
        self.dec4 = Decoder(ch * (8 + 16), ch * 8)
        self.dec3 = Decoder(ch * (4 + 8), ch * 4)
        self.dec2 = Decoder(ch * (2 + 4), ch * 2)
        self.dec1 = Decoder(ch * (1 + 2), ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, e1 = self.enc1(x)
        h, e2 = self.enc2(h)
        h, e3 = self.enc3(h)
        h, e4 = self.enc4(h)
        h = self.aspp(h)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        return self.dec1(h, e1)


def _replicate_bins(mask: torch.Tensor, output_bin: int) -> torch.Tensor:
    """The mask's last bin repeated up to ``output_bin`` bins."""
    return F.pad(mask, (0, 0, 0, output_bin - mask.shape[2]), mode="replicate")


class CascadedASPPNet(nn.Module):
    """The 4-band VR separator (reference nets.py). Input (B, 2, bins, T),
    the magnitude spectrogram with the stereo channels; returns the sigmoid
    mask of the same shape. ``aggressiveness`` ({"split_bin", "value"})
    raises the mask to ``1 + value / 3`` below ``split_bin`` and to
    ``1 + value`` above it."""

    offset = 128

    def __init__(self, n_fft: int):
        super().__init__()
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        self.stg1_low_band_net = BaseASPPNet(2, 32)
        self.stg1_high_band_net = BaseASPPNet(2, 32)
        self.stg2_bridge = Conv2DBNActiv(34, 16, 1, 1, 0)
        self.stg2_full_band_net = BaseASPPNet(16, 32)
        self.stg3_bridge = Conv2DBNActiv(66, 32, 1, 1, 0)
        self.stg3_full_band_net = BaseASPPNet(32, 64)
        self.out = Conv2d(64, 2, 1, bias=False)

    def forward(self, x: torch.Tensor, aggressiveness: dict | None = None) -> torch.Tensor:
        x = x[:, :, : self.max_bin]
        bandw = x.shape[2] // 2
        aux1 = torch.cat([self.stg1_low_band_net(x[:, :, :bandw]),
                          self.stg1_high_band_net(x[:, :, bandw:])], dim=2)
        h = torch.cat([x, aux1], dim=1)
        aux2 = self.stg2_full_band_net(self.stg2_bridge(h))
        h = torch.cat([x, aux1, aux2], dim=1)
        h = self.stg3_full_band_net(self.stg3_bridge(h))
        mask = _replicate_bins(sigmoid(self.out(h)), self.output_bin)
        if aggressiveness is not None:
            sb, v = aggressiveness["split_bin"], aggressiveness["value"]
            mask = mask.float()
            mask = torch.cat([torch.pow(mask[:, :, :sb], 1 + v / 3),
                              torch.pow(mask[:, :, sb:], 1 + v)], dim=2)
        return mask


# ---- the "new" family (nets_new, layers_new): DeEcho / DeReverb ----


class EncoderNew(nn.Module):
    """layers_new.Encoder: the strided conv first, then the refine conv."""

    def __init__(self, nin: int, nout: int, stride: int = 2):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, 3, stride, 1, activ="leaky")
        self.conv2 = Conv2DBNActiv(nout, nout, 3, 1, 1, activ="leaky")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class DecoderNew(nn.Module):
    """layers_new.Decoder: as ``Decoder``, its conv named ``conv1``."""

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, 3, 1, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None) -> torch.Tensor:
        return self.conv1(_upsample_cat(x, skip))


class ASPPModuleNew(nn.Module):
    """layers_new.ASPPModule: dense dilated branches, dilations given as
    (frequency, time)."""

    def __init__(self, nin: int, nout: int, dilations=((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d((1, None)),
                                   Conv2DBNActiv(nin, nout, 1, 1, 0))
        self.conv2 = Conv2DBNActiv(nin, nout, 1, 1, 0)
        self.conv3 = Conv2DBNActiv(nin, nout, 3, 1, dilations[0], dilations[0])
        self.conv4 = Conv2DBNActiv(nin, nout, 3, 1, dilations[1], dilations[1])
        self.conv5 = Conv2DBNActiv(nin, nout, 3, 1, dilations[2], dilations[2])
        self.bottleneck = Conv2DBNActiv(nout * 5, nout, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat1 = self.conv1(x).expand(-1, -1, x.shape[2], -1)
        feats = [feat1, self.conv2(x), self.conv3(x), self.conv4(x), self.conv5(x)]
        return self.bottleneck(torch.cat(feats, dim=1))


class LSTMModule(nn.Module):
    """layers_new.LSTMModule: a 1-channel conv summary of the bins, a BiLSTM
    over the frames, a dense layer back to the bins. (B, C, F, T) ->
    (B, 1, nin_lstm, T)."""

    def __init__(self, nin_conv: int, nin_lstm: int, nout_lstm: int):
        super().__init__()
        self.conv = Conv2DBNActiv(nin_conv, 1, 1, 1, 0)
        self.lstm = nn.LSTM(input_size=nin_lstm, hidden_size=nout_lstm // 2,
                            bidirectional=True)
        self.dense = nn.Sequential(Linear(nout_lstm, nin_lstm), BatchNorm(nin_lstm), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, _, T = x.shape
        h = self.conv(x)[:, 0].permute(2, 0, 1)  # (T, B, F)
        h, _ = self.lstm(h)
        h = self.dense(h.reshape(-1, h.shape[-1]))  # (T * B, nin_lstm)
        return h.reshape(T, B, 1, -1).permute(1, 2, 3, 0)


class BaseNet(nn.Module):
    """nets_new.BaseNet: a 5-level U-net with the dense ASPP and the LSTM
    branch joined before the last decoder."""

    def __init__(self, nin: int, nout: int, nin_lstm: int, nout_lstm: int,
                 dilations=((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.enc1 = Conv2DBNActiv(nin, nout, 3, 1, 1)
        self.enc2 = EncoderNew(nout, nout * 2)
        self.enc3 = EncoderNew(nout * 2, nout * 4)
        self.enc4 = EncoderNew(nout * 4, nout * 6)
        self.enc5 = EncoderNew(nout * 6, nout * 8)
        self.aspp = ASPPModuleNew(nout * 8, nout * 8, dilations)
        self.dec4 = DecoderNew(nout * (6 + 8), nout * 6)
        self.dec3 = DecoderNew(nout * (4 + 6), nout * 4)
        self.dec2 = DecoderNew(nout * (2 + 4), nout * 2)
        self.lstm_dec2 = LSTMModule(nout * 2, nin_lstm, nout_lstm)
        self.dec1 = DecoderNew(nout * (1 + 2) + 1, nout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        e5 = self.enc5(e4)
        h = self.aspp(e5)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        lstm = self.lstm_dec2(h)
        f = min(h.shape[2], lstm.shape[2])
        h = torch.cat([h[:, :, :f], lstm[:, :, :f, : h.shape[3]]], dim=1)
        return self.dec1(h, e1)


class CascadedNet(nn.Module):
    """The "new" VR cascade (reference nets_new.CascadedNet), the DeEcho /
    DeReverb family. Input (B, 2, bins, T); returns the sigmoid mask."""

    offset = 64

    def __init__(self, n_fft: int, nout: int = 32, nout_lstm: int = 128):
        super().__init__()
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        nin_lstm = self.max_bin // 2
        self.stg1_low_band_net = nn.Sequential(
            BaseNet(2, nout // 2, nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout // 2, nout // 4, 1, 1, 0))
        self.stg1_high_band_net = BaseNet(2, nout // 4, nin_lstm // 2, nout_lstm // 2)
        self.stg2_low_band_net = nn.Sequential(
            BaseNet(nout // 4 + 2, nout, nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout, nout // 2, 1, 1, 0))
        self.stg2_high_band_net = BaseNet(nout // 4 + 2, nout // 2, nin_lstm // 2,
                                          nout_lstm // 2)
        self.stg3_full_band_net = BaseNet(3 * nout // 4 + 2, nout, nin_lstm, nout_lstm)
        self.out = Conv2d(nout, 2, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, :, : self.max_bin]
        bandw = x.shape[2] // 2
        l1_in, h1_in = x[:, :, :bandw], x[:, :, bandw:]
        l1 = self.stg1_low_band_net(l1_in)
        h1 = self.stg1_high_band_net(h1_in)
        aux1 = torch.cat([l1, h1], dim=2)
        l2 = self.stg2_low_band_net(torch.cat([l1_in, l1], dim=1))
        h2 = self.stg2_high_band_net(torch.cat([h1_in, h1], dim=1))
        aux2 = torch.cat([l2, h2], dim=2)
        f3 = self.stg3_full_band_net(torch.cat([x, aux1, aux2], dim=1))
        return _replicate_bins(sigmoid(self.out(f3)), self.output_bin)
