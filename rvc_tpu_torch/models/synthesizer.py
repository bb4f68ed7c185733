"""The RVC synthesizer: text encoder + posterior encoder + flow + NSF decoder.

Counterpart of ``rvc_tpu/models/synthesizer.py`` (TextEncoder,
PosteriorEncoder, Synthesizer.__call__ and .infer) with a ResBlock1 or
ResBlock2 decoder: the f0 variants (NSF decoder, pitch embedding) and the
no-f0 ones (``use_f0=False``: the plain HiFiGAN decoder and no pitch
embedding), for training and inference. Module names (enc_p, enc_q, flow,
dec, emb_g) are the reference state_dict prefixes. The posterior encoder
is used only in training: it is built only with ``posterior=True``, so the
inference state_dicts (without ``enc_q.*``) load as they are.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from .attention import Encoder
from .flows import ResidualCouplingBlock
from .layers import (Conv1d, Embedding, Linear, leaky_relu, rand_slice_segments, rounded,
                     sequence_mask, set_dtype_, slice_segments)
from .nsf import Generator, GeneratorNSF
from .wavenet import WN


class TextEncoder(nn.Module):
    """HuBERT-feature encoder (reference TextEncoder256/768)."""

    def __init__(self, in_dim: int, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int, kernel_size: int,
                 f0: bool = True):
        super().__init__()
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.emb_phone = Linear(in_dim, hidden_channels)
        if f0:
            self.emb_pitch = Embedding(256, hidden_channels)
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads, n_layers,
                               kernel_size)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, phone: torch.Tensor, pitch: torch.Tensor | None,
                lengths: torch.Tensor):
        """phone (B, T, in_dim); pitch (B, T) coarse bins or None; lengths (B,).
        Returns m, logs (B, out, T) and x_mask (B, 1, T)."""
        x = self.emb_phone(phone)
        if pitch is not None:
            x = x + self.emb_pitch(pitch)
        x = leaky_relu(x * rounded(math.sqrt(self.hidden_channels), x.dtype), 0.1)
        x = x.transpose(1, 2)
        x_mask = sequence_mask(lengths, x.shape[2])[:, None].to(x.dtype)
        x = self.encoder(x * x_mask, x_mask)
        stats = self.proj(x) * x_mask
        return stats[:, :self.out_channels], stats[:, self.out_channels:], x_mask


class PosteriorEncoder(nn.Module):
    """Spectrogram posterior (reference models.PosteriorEncoder)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int, dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.out_channels = out_channels
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor, g=None, *,
                eps: torch.Tensor | None = None, generator: torch.Generator | None = None):
        """x (B, in, T) spectrogram; ``eps`` (B, out, T) the sample's standard
        normal draw, from ``generator`` when absent. Returns z, m, logs
        (B, out, T) and the mask (B, 1, T)."""
        x_mask = sequence_mask(x_lengths, x.shape[2])[:, None].to(x.dtype)
        h = self.enc(self.pre(x) * x_mask, x_mask, g=g)
        stats = self.proj(h) * x_mask
        m, logs = stats[:, :self.out_channels], stats[:, self.out_channels:]
        if eps is None:
            eps = torch.randn(m.shape, generator=generator, device=m.device, dtype=m.dtype)
        return (m + eps * torch.exp(logs)) * x_mask, m, logs, x_mask


class Synthesizer(nn.Module):
    """RVC v1/v2 synthesizer, with f0 (SynthesizerTrnMs{256,768}NSFsid) or
    without (``use_f0=False``, SynthesizerTrnMs{256,768}NSFsid_nono).

    ``dtype`` is the compute dtype (``layers.set_dtype_``); ``fuse_group``
    picks the decoder's inference route (``nsf.GeneratorNSF``)."""

    def __init__(self, spec_channels: int, segment_size: int, inter_channels: int,
                 hidden_channels: int, filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], spk_embed_dim: int,
                 gin_channels: int, sr: int, feature_dim: int = 768, use_f0: bool = True,
                 posterior: bool = False, fuse_group: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.segment_size = segment_size
        self.use_f0 = use_f0
        self.enc_p = TextEncoder(feature_dim, inter_channels, hidden_channels,
                                 filter_channels, n_heads, n_layers, kernel_size, f0=use_f0)
        dec = (resblock, resblock_kernel_sizes, resblock_dilation_sizes, upsample_rates,
               upsample_initial_channel, upsample_kernel_sizes)
        if use_f0:
            self.dec = GeneratorNSF(inter_channels, *dec, gin_channels=gin_channels, sr=sr,
                                    fuse_group=fuse_group)
        else:
            self.dec = Generator(inter_channels, *dec, gin_channels=gin_channels,
                                 fuse_group=fuse_group)
        self.flow = ResidualCouplingBlock(inter_channels, hidden_channels, 5, 1, 3,
                                          gin_channels=gin_channels)
        self.emb_g = Embedding(spk_embed_dim, gin_channels)
        if posterior:
            self.enc_q = PosteriorEncoder(spec_channels, inter_channels, hidden_channels, 5, 1,
                                          16, gin_channels=gin_channels)
        set_dtype_(self, dtype)

    def forward(self, phone: torch.Tensor, phone_lengths: torch.Tensor,
                pitch: torch.Tensor | None, pitchf: torch.Tensor | None, spec: torch.Tensor,
                spec_lengths: torch.Tensor,
                sid: torch.Tensor, *, eps_q: torch.Tensor | None = None,
                u_slice: torch.Tensor | None = None,
                generator: torch.Generator | None = None, **draws):
        """Training forward (rvc_tpu/models/synthesizer.py:250-267).

        phone (B, T, feat); pitch (B, T) coarse bins and pitchf (B, T) Hz,
        both None without f0; spec (B, T, spec_channels) linear spectrogram;
        sid (B,). The draws, each from ``generator`` when absent: ``eps_q``
        (B, inter, T) the posterior sample's normal, ``u_slice`` (B,) the
        segment starts' uniform, and with f0 the sine source's ``rand_ini``
        and ``noise``.
        Returns (o (B, 1, segment·upp), ids_slice (B,), x_mask, y_mask,
        (z, z_p, m_p, logs_p, m_q, logs_q)), activations (B, C, T)."""
        g = self.emb_g(sid)[:, :, None]
        m_p, logs_p, x_mask = self.enc_p(phone, pitch, phone_lengths)
        z, m_q, logs_q, y_mask = self.enc_q(spec.transpose(1, 2), spec_lengths, g=g,
                                            eps=eps_q, generator=generator)
        z_p = self.flow(z, y_mask, g=g)
        z_slice, ids_slice = rand_slice_segments(z, spec_lengths, self.segment_size,
                                                 u=u_slice, generator=generator)
        if self.use_f0:
            pitchf_slice = slice_segments(pitchf, ids_slice, self.segment_size)
            o = self.dec(z_slice, pitchf_slice, g=g, generator=generator, **draws)
        else:
            o = self.dec(z_slice, g=g)
        return o, ids_slice, x_mask, y_mask, (z, z_p, m_p, logs_p, m_q, logs_q)

    def infer_mix(self, phone: torch.Tensor, phone_lengths: torch.Tensor,
                  pitch: torch.Tensor | None, nsff0: torch.Tensor | None,
                  spk_mix: torch.Tensor, noise_scale: float = 0.66666, *,
                  eps: torch.Tensor | None = None,
                  generator: torch.Generator | None = None, **draws):
        """``infer`` with a mixture of speakers (rvc_tpu/models/synthesizer.py:
        273-291, the reference's ONNX SynthesizerTrnMsNSFsidM): ``spk_mix``
        (B, n_spk) weights, normalized to sum 1, blend the rows of ``emb_g``'s
        table into the conditioning. The other arguments and the result are
        ``infer``'s."""
        weights = spk_mix / torch.clamp(torch.sum(spk_mix, -1, keepdim=True), min=1e-9)
        table = self.emb_g(torch.arange(self.emb_g.num_embeddings, device=spk_mix.device))
        g = torch.matmul(weights.to(table.dtype), table)[:, :, None]
        return self._infer(g, phone, phone_lengths, pitch, nsff0, noise_scale, eps, generator,
                           draws)

    def infer(self, phone: torch.Tensor, phone_lengths: torch.Tensor,
              pitch: torch.Tensor | None, nsff0: torch.Tensor | None, sid: torch.Tensor,
              noise_scale: float = 0.66666, *, eps: torch.Tensor | None = None,
              generator: torch.Generator | None = None, **draws):
        """Sample the prior, invert the flow, decode.

        phone (B, T, feat); pitch (B, T) coarse bins and nsff0 (B, T) Hz, both
        None without f0; sid (B,). ``eps`` (B, inter, T) is the prior's
        standard normal draw, used in ``m_p``'s dtype, and ``draws`` the sine
        source's (``rand_ini``, ``noise``; none without f0); each is drawn
        from ``generator`` when absent. Returns
        (o (B, 1, T*upp), x_mask, (z, z_p, m_p, logs_p))."""
        return self._infer(self.emb_g(sid)[:, :, None], phone, phone_lengths, pitch, nsff0,
                           noise_scale, eps, generator, draws)

    def _infer(self, g, phone, phone_lengths, pitch, nsff0, noise_scale, eps, generator,
               draws):
        m_p, logs_p, x_mask = self.enc_p(phone, pitch, phone_lengths)
        if eps is None:
            eps = torch.randn(m_p.shape, generator=generator, device=m_p.device,
                              dtype=m_p.dtype)
        eps = eps.to(m_p.dtype)
        z_p = (m_p + torch.exp(logs_p) * eps * rounded(noise_scale, m_p.dtype)) * x_mask
        z = self.flow.reverse(z_p, x_mask, g=g)
        if self.use_f0:
            o = self.dec(z * x_mask, nsff0, g=g, generator=generator, **draws)
        else:
            o = self.dec(z * x_mask, g=g)
        return o, x_mask, (z, z_p, m_p, logs_p)
