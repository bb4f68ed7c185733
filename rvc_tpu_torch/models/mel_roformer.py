"""Mel-Band RoFormer vocal separation (Kim et al. 2023).

Counterpart of ``rvc_tpu/models/mel_roformer.py``, in the public
lucidrains/mel-band-roformer layout (``Kim_MelBandRoformer.ckpt``,
``MelBandRoformer.ckpt``; loaded by ``compat.torch_import.
load_mel_roformer``). It differs from the band-split model only at both
ends: the bands are the supports of a Slaney mel filterbank's triangles,
so they overlap; a band's features are gathered by ``freq_indices``
(flat indices into the (bin, channel) axis), and the per-band masks are
added back onto the bins they came from (``index_add_``) and divided by
each bin's band count, in float32 (rvc_tpu/models/mel_roformer.py:160-170).
The body is ``BSRoformer``'s.

In the filterbank layouts ``mel_band_indices`` gives, a bin lies in at
most two bands, so its summed mask is 0 + a + b in either order: the
card's atomic adds give the CPU's sum exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.mel import mel_filterbank_slaney_np
from .bs_roformer import BSRoformer, BSRoformerSeparator


def mel_band_indices(sr: int, n_fft: int, num_bands: int,
                     channels: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(freq_indices, band_widths): lucidrains' layout, the support of each
    Slaney mel triangle with the DC bin forced into band 0 and the Nyquist
    bin into the last; channel slots ``bin * channels + c``. A band's width
    counts its entries (bins x channels)."""
    support = np.array(mel_filterbank_slaney_np(sr, n_fft, num_bands, 0.0, None).T > 0)
    support[0, 0] = True
    support[-1, -1] = True
    if not support.any(axis=0).all():
        raise ValueError("mel filterbank leaves uncovered frequency bins")
    indices, widths = [], []
    for b in range(num_bands):
        freqs = np.nonzero(support[b])[0]
        indices += [int(f) * channels + c for f in freqs for c in range(channels)]
        widths.append(len(freqs) * channels)
    return tuple(indices), tuple(widths)


@dataclass(frozen=True)
class MelRoformerConfig:
    dim: int = 384
    depth: int = 6
    stereo: bool = True
    num_stems: int = 1
    time_transformer_depth: int = 1
    freq_transformer_depth: int = 1
    num_bands: int = 60
    dim_head: int = 64
    heads: int = 8
    ff_mult: int = 4
    n_fft: int = 2048
    hop_length: int = 441
    win_length: int = 2048
    mask_estimator_depth: int = 1
    mlp_expansion_factor: int = 4
    rotary_theta: float = 10000.0
    sample_rate: int = 44100
    transformer_norm_output: bool = False
    # None: computed from the mel filterbank in __post_init__
    freq_indices: tuple[int, ...] | None = None
    band_widths: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.freq_indices is None or self.band_widths is None:
            idx, w = mel_band_indices(self.sample_rate, self.n_fft, self.num_bands,
                                      self.audio_channels)
            if self.freq_indices is None:
                object.__setattr__(self, "freq_indices", idx)
            if self.band_widths is None:
                object.__setattr__(self, "band_widths", w)

    @property
    def audio_channels(self) -> int:
        return 2 if self.stereo else 1

    @property
    def dims_in(self) -> tuple[int, ...]:
        return tuple(2 * w for w in self.band_widths)


class MelBandRoformer(BSRoformer):
    """``BSRoformer`` on the bands' gathered entries; the same (B, T, F S, 2)
    interface."""

    def __init__(self, cfg: MelRoformerConfig | None = None):
        super().__init__(cfg or MelRoformerConfig())
        idx = np.asarray(self.cfg.freq_indices, np.int64)
        self.register_buffer("index", torch.tensor(idx), persistent=False)
        counts = np.maximum(np.bincount(idx), 1).astype(np.float32)
        self.register_buffer("counts", torch.tensor(counts), persistent=False)

    def features(self, spec_ri: torch.Tensor) -> torch.Tensor:
        B, T = spec_ri.shape[:2]
        return spec_ri[:, :, self.index].reshape(B, T, -1)

    def masks(self, x: torch.Tensor, n_freq: int) -> torch.Tensor:
        """Each band's mask entries added onto their bins, divided by the
        bin's band count (at least 1)."""
        entries = super().masks(x, len(self.index)).float()  # (S, B, T, K, 2)
        summed = entries.new_zeros(*entries.shape[:3], n_freq, 2)
        summed.index_add_(3, self.index, entries)
        counts = F.pad(self.counts, (0, n_freq - len(self.counts)), value=1.0)
        return summed / counts[:, None]


class MelRoformerSeparator(BSRoformerSeparator):
    """``BSRoformerSeparator``'s inference around a ``MelBandRoformer``."""

    model_cls = MelBandRoformer
    config_cls = MelRoformerConfig
