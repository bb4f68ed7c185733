"""RMVPE pitch estimator: log-mel -> DeepUnet -> BiGRU -> 360-bin salience.

Counterpart of ``rvc_tpu/models/rmvpe.py`` with the reference ``E2E``
state_dict names. Layout (B, C, time, mel) for the U-net; the JAX
package's frequency space-to-depth packing is a TPU lane trick and is left
out. In a compute dtype below float32 the mel is computed in float32 and
cast (rvc_tpu/models/rmvpe.py:40-48), every layer computes in that dtype,
the BiGRU too (its weights cast, its state carried in the dtype), and the
decode runs in float32 (:322).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mel import log_mel
from .layers import Conv2d, ConvTranspose2d, Linear, set_dtype_, sigmoid

N_MELS = 128
N_CLASS = 360
SR = 16000
WIN = 1024
HOP = 160


def mel_frontend(audio: torch.Tensor) -> torch.Tensor:
    """(B, T) 16 kHz -> (B, frames, 128) log-mel (HTK, 30-8000 Hz)."""
    return log_mel(audio, SR, WIN, HOP, N_MELS, 30.0, 8000.0)


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 with loaded running statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        scale = (self.weight * inv).to(x.dtype)
        shift = (self.bias - self.running_mean * self.weight * inv).to(x.dtype)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.view(shape) + shift.view(shape)


class ConvBlockRes(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(cin, cout, 3, padding=1, bias=False), BatchNorm(cout), nn.ReLU(),
            Conv2d(cout, cout, 3, padding=1, bias=False), BatchNorm(cout), nn.ReLU())
        if cin != cout:
            self.shortcut = Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = self.shortcut(x) if hasattr(self, "shortcut") else x
        return self.conv(x) + skip


class ResEncoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_blocks: int, pool: bool):
        super().__init__()
        self.pool = pool
        self.conv = nn.ModuleList(
            ConvBlockRes(cin if i == 0 else cout, cout) for i in range(n_blocks))

    def forward(self, x: torch.Tensor):
        for block in self.conv:
            x = block(x)
        if self.pool:
            return x, F.avg_pool2d(x, 2)
        return x


class ResDecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_blocks: int):
        super().__init__()
        self.conv1 = nn.Sequential(
            ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1,
                            bias=False),
            BatchNorm(cout), nn.ReLU())
        self.conv2 = nn.ModuleList(
            ConvBlockRes(cout * 2 if i == 0 else cout, cout) for i in range(n_blocks))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.conv1(x), skip], dim=1)
        for block in self.conv2:
            x = block(x)
        return x


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DeepUnet(nn.Module):
    def __init__(self, n_blocks: int = 4, en_de_layers: int = 5, inter_layers: int = 4,
                 in_channels: int = 1, en_out_channels: int = 16):
        super().__init__()
        enc, cin, cout = [], in_channels, en_out_channels
        for _ in range(en_de_layers):
            enc.append(ResEncoderBlock(cin, cout, n_blocks, pool=True))
            cin, cout = cout, cout * 2
        self.encoder = _Layers(enc)
        self.encoder.bn = BatchNorm(in_channels)
        self.intermediate = _Layers(
            ResEncoderBlock(cin if i == 0 else cout, cout, n_blocks, pool=False)
            for i in range(inter_layers))
        dec, cin = [], cout
        for _ in range(en_de_layers):
            dec.append(ResDecoderBlock(cin, cin // 2, n_blocks))
            cin //= 2
        self.decoder = _Layers(dec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.encoder.bn(x)
        skips = []
        for layer in self.encoder.layers:
            skip, x = layer(x)
            skips.append(skip)
        for layer in self.intermediate.layers:
            x = layer(x)
        for layer, skip in zip(self.decoder.layers, reversed(skips)):
            x = layer(x, skip)
        return x


class BiGRU(nn.Module):
    """One bidirectional GRU layer (``nn.GRU``'s parameters and names); in
    a compute dtype below float32 its weights are cast and it runs in that
    dtype."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.gru = nn.GRU(input_size, hidden_size, batch_first=True, bidirectional=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = getattr(self, "dtype", torch.float32)
        if dt == torch.float32:
            return self.gru(x)[0]
        gru = self.gru
        h0 = x.new_zeros((2, x.shape[0], gru.hidden_size), dtype=dt)
        weights = [w.to(dt) for w in gru._flat_weights]
        return torch.gru(x.to(dt), h0, weights, True, 1, 0.0, False, True, True)[0]


class E2E(nn.Module):
    """Salience network (reference rmvpe.E2E, one BiGRU layer)."""

    def __init__(self, n_blocks: int = 4, en_out_channels: int = 16):
        super().__init__()
        self.unet = DeepUnet(n_blocks=n_blocks, en_out_channels=en_out_channels)
        self.cnn = Conv2d(en_out_channels, 3, 3, padding=1)
        self.fc = nn.Sequential(BiGRU(3 * N_MELS, 256), Linear(512, N_CLASS))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, 128) log-mel -> (B, T, 360) salience."""
        x = self.cnn(self.unet(mel[:, None]))  # (B, 3, T, 128)
        x = x.transpose(1, 2).flatten(-2)
        return sigmoid(self.fc(x))


_CENTS = np.pad(20 * np.arange(N_CLASS) + 1997.3794084376191, (4, 4)).astype(np.float32)


def decode_cents(salience: torch.Tensor, thred: float = 0.03) -> torch.Tensor:
    """(B, T, 360) -> f0 Hz (B, T): 9-bin local average around the argmax."""
    center = torch.argmax(salience, dim=-1) + 4
    sal = F.pad(salience, (4, 4))
    idx = center[..., None] + torch.arange(-4, 5, device=salience.device)
    win = torch.gather(sal, -1, idx)
    cwin = torch.as_tensor(_CENTS, device=salience.device)[idx]
    cents = torch.sum(win * cwin, -1) / torch.clamp(torch.sum(win, -1), min=1e-9)
    cents = torch.where(salience.max(dim=-1).values > thred, cents, 0.0)
    f0 = 10.0 * torch.pow(2.0, cents / 1200.0)
    return torch.where(f0 == 10.0, 0.0, f0)


class RMVPE(nn.Module):
    """16 kHz audio -> f0 Hz per 10 ms frame; frames padded to a multiple of
    32. ``dtype`` is the compute dtype (``layers.set_dtype_``)."""

    def __init__(self, n_blocks: int = 4, en_out_channels: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model = E2E(n_blocks, en_out_channels)
        set_dtype_(self, dtype)

    def forward(self, audio: torch.Tensor, thred: float = 0.03) -> torch.Tensor:
        mel = mel_frontend(audio).to(self.dtype)
        n = mel.shape[1]
        pad = min(32 * ((n - 1) // 32 + 1) - n, n)
        if pad:
            mel = F.pad(mel.transpose(1, 2), (0, pad), mode="reflect").transpose(1, 2)
        return decode_cents(self.model(mel)[:, :n].float(), thred)
