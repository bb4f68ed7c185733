"""The multi-band spectrogram chain of the UVR5 VR separators, on tensors.

Counterpart of ``rvc_tpu/ops/bands.py`` (the reference's
``lib/uvr5_pack/spec_utils.py`` and ``model_param_init.py``). A VR network
sees one composite magnitude spectrogram built from per-band STFTs taken at
different sample rates: each band resampled, cropped to
``[crop_start, crop_stop)`` bins and stacked along frequency. The masked
spectrogram is split back into bands, low- and high-pass filtered at the
seams, inverted and resampled up the chain. The JAX package runs the bands'
complex arithmetic on the host in numpy; here every step stays on the
tensors' device in complex64, the band resampling through
``ops.resample.resample``. The filters' per-bin gain loops run once per
layout (``_lp_gains``, ``_hp_gains``, ``_pre_filter_gains``) and become one
multiplication. Band parameter files are the reference's JSON format.
"""
from __future__ import annotations

import copy
import functools
import json
import math
from typing import Any

import numpy as np
import torch

from .resample import resample
from .stft import istft, stft

DEFAULT_PARAM: dict[str, Any] = {
    # 2-band layout (numbers from the published UVR modelparams format)
    "bins": 768,
    "unstable_bins": 7,
    "reduction_bins": 705,
    "sr": 48000,
    "pre_filter_start": 710,
    "pre_filter_stop": 731,
    "band": {
        1: {"sr": 6000, "hl": 66, "n_fft": 512, "crop_start": 0, "crop_stop": 240,
            "lpf_start": 60, "lpf_stop": 240, "res_type": "sinc_fastest"},
        2: {"sr": 48000, "hl": 528, "n_fft": 1536, "crop_start": 22, "crop_stop": 505,
            "hpf_start": 82, "hpf_stop": 22, "res_type": "sinc_medium"},
    },
}

# The 4-band layout the reference's UVR5Base loads (modelparams/4band_v2.json)
FOURBAND_V2_PARAM: dict[str, Any] = {
    "bins": 672,
    "unstable_bins": 8,
    "reduction_bins": 637,
    "sr": 44100,
    "pre_filter_start": 668,
    "pre_filter_stop": 672,
    "band": {
        1: {"sr": 7350, "hl": 80, "n_fft": 640, "crop_start": 0, "crop_stop": 85,
            "lpf_start": 25, "lpf_stop": 53, "res_type": "polyphase"},
        2: {"sr": 7350, "hl": 80, "n_fft": 320, "crop_start": 4, "crop_stop": 87,
            "hpf_start": 25, "hpf_stop": 12, "lpf_start": 31, "lpf_stop": 62,
            "res_type": "polyphase"},
        3: {"sr": 14700, "hl": 160, "n_fft": 512, "crop_start": 17, "crop_stop": 216,
            "hpf_start": 48, "hpf_stop": 24, "lpf_start": 139, "lpf_stop": 210,
            "res_type": "polyphase"},
        4: {"sr": 44100, "hl": 480, "n_fft": 960, "crop_start": 78, "crop_stop": 383,
            "hpf_start": 130, "hpf_stop": 86, "res_type": "kaiser_fast"},
    },
}

_STEREO_KEYS = ("mid_side", "mid_side_b", "mid_side_b2", "stereo_w", "stereo_n", "reverse")


class ModelParameters:
    """Band parameter container: ``preset="4band_v2"``, a reference JSON file
    at ``config_path``, or the 2-band ``DEFAULT_PARAM``."""

    def __init__(self, config_path: str = "", preset: str | None = None):
        if preset == "4band_v2":
            self.param = _int_band_keys(FOURBAND_V2_PARAM)
        elif config_path:
            def int_keys(pairs):
                return {int(k) if k.isdigit() else k: v for k, v in pairs}

            with open(config_path) as f:
                self.param = json.load(f, object_pairs_hook=int_keys)
        else:
            self.param = _int_band_keys(DEFAULT_PARAM)
        for k in _STEREO_KEYS:
            self.param.setdefault(k, False)


def _int_band_keys(param: dict) -> dict:
    p = copy.deepcopy(param)
    p["band"] = {int(k): v for k, v in p["band"].items()}
    return p


def _stereo_encode(wave: torch.Tensor, mid_side: bool, mid_side_b2: bool,
                   reverse: bool) -> torch.Tensor:
    if reverse:
        return torch.flip(wave, dims=[-1])
    if mid_side:
        return torch.stack([(wave[0] + wave[1]) / 2, wave[0] - wave[1]])
    if mid_side_b2:
        return torch.stack([wave[1] + wave[0] * 0.5, wave[0] - wave[1] * 0.5])
    return wave


def _stereo_decode(wave: torch.Tensor, mid_side: bool, mid_side_b2: bool,
                   reverse: bool) -> torch.Tensor:
    if reverse:
        return torch.flip(wave, dims=[-1])
    if mid_side:
        return torch.stack([wave[0] + wave[1] / 2, wave[0] - wave[1] / 2])
    if mid_side_b2:
        return torch.stack([wave[1] / 1.25 + 0.4 * wave[0], wave[0] / 1.25 - 0.4 * wave[1]])
    return wave


def wave_to_spectrogram(wave: torch.Tensor, hop_length: int, n_fft: int, mid_side=False,
                        mid_side_b2=False, reverse=False) -> torch.Tensor:
    """(2, T) stereo -> complex64 (2, n_fft // 2 + 1, frames), librosa.stft's
    rule (centred, reflect pad, periodic Hann)."""
    w = _stereo_encode(wave.float(), mid_side, mid_side_b2, reverse)
    real, imag = stft(w, n_fft, hop_length, n_fft, center=True)
    return torch.complex(real, imag).transpose(1, 2)


def spectrogram_to_wave(spec: torch.Tensor, hop_length: int, mid_side=False,
                        mid_side_b2=False, reverse=False) -> torch.Tensor:
    """complex (2, bins, frames) -> (2, T) float32."""
    n_fft = (spec.shape[1] - 1) * 2
    st = spec.transpose(1, 2)
    wave = istft(st.real.contiguous(), st.imag.contiguous(), n_fft, hop_length, center=True)
    return _stereo_decode(wave, mid_side, mid_side_b2, reverse)


def _gains(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Per-bin gains as a (bins, 1) float32 tensor on ``like``'s device."""
    return torch.as_tensor(values, dtype=torch.float32, device=like.device)[:, None]


@functools.lru_cache(maxsize=None)
def _pre_filter_gains(n_bins: int, start: int, stop: int) -> np.ndarray:
    """The composite's roll-off above ``pre_filter_start`` (several bands)."""
    g = np.ones(n_bins)
    gp = 1.0
    for b in range(start + 1, stop):
        gp = math.pow(10, -(b - start) * (3.5 - gp) / 20.0)
        g[b] = gp
    return g


@functools.lru_cache(maxsize=None)
def _lp_gains(n_bins: int, bin_start: int, bin_stop: int) -> np.ndarray:
    """``fft_lp_filter``'s gains: 1 below ``bin_start``, a linear fall over
    [bin_start, bin_stop), 0 from ``bin_stop`` on."""
    g = np.ones(n_bins)
    v = 1.0
    for b in range(bin_start, bin_stop):
        v -= 1 / (bin_stop - bin_start)
        g[b] = v
    g[bin_stop:] = 0
    return g


@functools.lru_cache(maxsize=None)
def _hp_gains(n_bins: int, bin_start: int, bin_stop: int) -> np.ndarray:
    """``fft_hp_filter``'s gains: 1 above ``bin_start``, a linear fall down
    to ``bin_stop`` (exclusive), 0 from ``bin_stop`` down."""
    g = np.ones(n_bins)
    v = 1.0
    for b in range(bin_start, bin_stop, -1):
        v -= 1 / (bin_start - bin_stop)
        g[b] = v
    g[: bin_stop + 1] = 0
    return g


def fft_lp_filter(spec: torch.Tensor, bin_start: int, bin_stop: int) -> torch.Tensor:
    """spec (2, bins, frames) low-passed (a new tensor)."""
    return spec * _gains(_lp_gains(spec.shape[1], bin_start, bin_stop), spec)


def fft_hp_filter(spec: torch.Tensor, bin_start: int, bin_stop: int) -> torch.Tensor:
    """spec (2, bins, frames) high-passed (a new tensor)."""
    return spec * _gains(_hp_gains(spec.shape[1], bin_start, bin_stop), spec)


def combine_spectrograms(specs: dict[int, torch.Tensor], mp: ModelParameters) -> torch.Tensor:
    """The per-band crops stacked into the composite (2, bins + 1, frames),
    frames the fewest of the bands' (reference spec_utils.combine_spectrograms)."""
    p = mp.param
    bands_n = len(p["band"])
    n = min(s.shape[2] for s in specs.values())
    parts = [specs[d][:, p["band"][d]["crop_start"]: p["band"][d]["crop_stop"], :n]
             for d in range(1, bands_n + 1)]
    used = sum(x.shape[1] for x in parts)
    if used > p["bins"]:
        raise ValueError("Too much bins")
    first = parts[0]
    parts.append(first.new_zeros((2, p["bins"] + 1 - used, n)))
    out = torch.cat(parts, dim=1)
    if p["pre_filter_start"] > 0:
        if bands_n == 1:
            return fft_lp_filter(out, p["pre_filter_start"], p["pre_filter_stop"])
        return out * _gains(_pre_filter_gains(p["bins"] + 1, p["pre_filter_start"],
                                              p["pre_filter_stop"]), out)
    return out


def cmb_spectrogram_to_wave(spec_m: torch.Tensor, mp: ModelParameters,
                            extra_bins_h: int | None = None,
                            extra_bins: torch.Tensor | None = None) -> torch.Tensor:
    """Composite masked spectrogram -> (2, T) waveform at the top band's rate,
    through each band's iSTFT and the resample chain (reference
    spec_utils.cmb_spectrogram_to_wave). ``extra_bins`` (the mirrored high
    end) fills the top band's last ``extra_bins_h`` bins."""
    p = mp.param
    bands_n = len(p["band"])
    ms, msb2, rev = p["mid_side"], p["mid_side_b2"], p["reverse"]
    frames = spec_m.shape[2]
    offset = 0
    wave = None
    for d in range(1, bands_n + 1):
        bp = p["band"][d]
        h = bp["crop_stop"] - bp["crop_start"]
        spec_s = spec_m.new_zeros((2, bp["n_fft"] // 2 + 1, frames))
        spec_s[:, bp["crop_start"]: bp["crop_stop"]] = spec_m[:, offset: offset + h]
        offset += h
        if d == bands_n:  # the highest band
            if extra_bins_h:
                max_bin = bp["n_fft"] // 2
                spec_s[:, max_bin - extra_bins_h: max_bin] = extra_bins[:, :extra_bins_h]
            if bp.get("hpf_start", 0) > 0:
                spec_s = fft_hp_filter(spec_s, bp["hpf_start"], bp["hpf_stop"] - 1)
            band_wave = spectrogram_to_wave(spec_s, bp["hl"], ms, msb2, rev)
            wave = band_wave if bands_n == 1 else _add_trunc(wave, band_wave)
        else:
            sr_next = p["band"][d + 1]["sr"]
            if d == 1:  # the lowest band
                spec_s = fft_lp_filter(spec_s, bp["lpf_start"], bp["lpf_stop"])
                wave = resample(spectrogram_to_wave(spec_s, bp["hl"], ms, msb2, rev),
                                bp["sr"], sr_next)
            else:
                spec_s = fft_hp_filter(spec_s, bp["hpf_start"], bp["hpf_stop"] - 1)
                spec_s = fft_lp_filter(spec_s, bp["lpf_start"], bp["lpf_stop"])
                wave2 = _add_trunc(wave, spectrogram_to_wave(spec_s, bp["hl"], ms, msb2, rev))
                wave = resample(wave2, bp["sr"], sr_next)
    return wave


def _add_trunc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = min(a.shape[-1], b.shape[-1])
    return a[..., :n] + b[..., :n]


def mirroring(mode: str, spec_m: torch.Tensor, input_high_end: torch.Tensor,
              mp: ModelParameters) -> torch.Tensor:
    """High end rebuilt by mirroring the magnitudes just below the
    pre-filter, with the input's phase (reference spec_utils.mirroring)."""
    pfs = mp.param["pre_filter_start"]
    n = input_high_end.shape[1]
    mirror = torch.flip(spec_m[:, pfs - 10 - n: pfs - 10].abs(), dims=[1])
    if mode == "mirroring":
        mirror = mirror * torch.exp(1j * torch.angle(input_high_end))
        return torch.where(input_high_end.abs() <= mirror.abs(), input_high_end, mirror)
    if mode == "mirroring2":
        mi = mirror * input_high_end * 1.7
        return torch.where(input_high_end.abs() <= mi.abs(), input_high_end, mi)
    return input_high_end


def crop_center(h1: torch.Tensor, target_width: int) -> torch.Tensor:
    """Centre-crop the last (time) axis to ``target_width``."""
    w = h1.shape[-1]
    if w == target_width:
        return h1
    if w < target_width:
        raise ValueError("h1_shape[3] must be greater than h2_shape[3]")
    s = (w - target_width) // 2
    return h1[..., s: s + target_width]


def reduce_vocal_aggressively(X: torch.Tensor, y: torch.Tensor,
                              softmask: float) -> torch.Tensor:
    v = X - y
    y_mag = y.abs()
    v_mag = v.abs()
    out = torch.clamp(y_mag - v_mag * (v_mag > y_mag) * softmask, min=0)
    return out * torch.exp(1j * torch.angle(y))
