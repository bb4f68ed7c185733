"""BS-RoFormer vocal separation: the band-split axial RoPE transformer.

Counterpart of ``rvc_tpu/models/bs_roformer.py``, in the public
lucidrains/BS-RoFormer layout that the UVR and MSST checkpoints (e.g.
``model_bs_roformer_ep_317_sdr_12.9755.ckpt``) use: the module names are
lucidrains' state_dict names, so a released ``.ckpt`` loads with
``load_state_dict(strict=True)`` (``compat.torch_import.load_bs_roformer``;
``compat.weights.roformer_state_dict`` carries a JAX tree).

A complex STFT (frequency axis ordered (bin, stereo channel)) is cut into
bands, each band's features normalized and embedded (``BandSplit``), then
``depth`` layers each run a transformer along time on (B bands, T, dim)
and one along the bands on (B T, bands, dim), with rotary position
embeddings on the first half of each head's dims (as the JAX package
rotates them) and a sigmoid gate per head. A
per-band MLP ending in a GLU gives each stem's complex mask, which
multiplies the spectrogram; the iSTFT gives the stem.

Attention is softmax(q k^T / sqrt(dim_head)) v in float32 through
``scaled_dot_product_attention`` (the JAX package computes it with einsum
and softmax, no Pallas kernel): on the card in float32 it takes the
memory-efficient route and holds no (tokens x tokens) score tensor, which
for a 30 s song's time axis would be 8.9 GB. ``RMSNorm`` is lucidrains'
``x / max(|x|, 1e-12) * sqrt(dim) * gamma`` in float32, not
``F.rms_norm``.

``BSRoformerSeparator`` runs the UVR-style chunked inference: 8 s windows
at half overlap, ``max_batch`` windows a network call, each window's
output weighted by sqrt(hann) + 1e-4 and the overlap-add divided by the
summed weights, on the separator's device.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import mark, resolve_device, set_float32_math
from ..ops.mel import _on_device
from ..ops.stft import istft, stft
from .layers import load_numpy_state_dict

# the 62-band layout every public BS-RoFormer checkpoint uses (1025 bins)
DEFAULT_FREQS_PER_BANDS: tuple[int, ...] = (
    (2,) * 24 + (4,) * 12 + (12,) * 8 + (24,) * 8 + (48,) * 8 + (128, 129)
)


@dataclass(frozen=True)
class BSRoformerConfig:
    dim: int = 512
    depth: int = 12
    stereo: bool = True
    num_stems: int = 1
    time_transformer_depth: int = 1
    freq_transformer_depth: int = 1
    freqs_per_bands: tuple[int, ...] = DEFAULT_FREQS_PER_BANDS
    dim_head: int = 64
    heads: int = 8
    ff_mult: int = 4
    n_fft: int = 2048
    hop_length: int = 441
    win_length: int = 2048
    mask_estimator_depth: int = 2
    mlp_expansion_factor: int = 4
    rotary_theta: float = 10000.0
    sample_rate: int = 44100
    # lucidrains builds the axial transformers with norm_output=False: the
    # public checkpoints have no layers.L.{0,1}.norm.gamma
    transformer_norm_output: bool = False

    @property
    def audio_channels(self) -> int:
        return 2 if self.stereo else 1

    @property
    def num_bands(self) -> int:
        return len(self.freqs_per_bands)

    @property
    def dims_in(self) -> tuple[int, ...]:
        # a band's features: bins x channels x (real, imag)
        return tuple(2 * f * self.audio_channels for f in self.freqs_per_bands)


@functools.lru_cache(maxsize=64)
def rotary_tables(n: int, dim_head: int, theta: float) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin), each (n, dim_head // 2) float32: the JAX package's
    partial rotary (the first dim_head // 2 dims, each angle repeated for its
    interleaved pair as rotary-embedding-torch repeats it), computed in
    float64."""
    rot = dim_head // 2
    freqs = 1.0 / theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot)
    angles = np.repeat(np.arange(n)[:, None] * freqs[None, :], 2, axis=-1)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., n, dim_head): the first cos.shape[-1] dims rotated in
    interleaved pairs, (x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin)."""
    rot = cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    pairs = xr.unflatten(-1, (rot // 2, 2))
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return torch.cat([xr * cos + rotated * sin, xp], dim=-1)


class RMSNorm(nn.Module):
    """lucidrains' RMSNorm: x * rsqrt(max(sum x^2, 1e-24)) * sqrt(dim) * gamma,
    in float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = math.sqrt(dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        inv = torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-24))
        return x * inv * self.scale * self.gamma


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_gates = nn.Linear(dim, heads)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, bias=False))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        h, dh = self.heads, self.dim_head
        x = self.norm(x)
        B, N, _ = x.shape
        q, k, v = self.to_qkv(x).view(B, N, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        o = F.scaled_dot_product_attention(q, k, v)  # scale 1 / sqrt(dh)
        o = o * torch.sigmoid(self.to_gates(x)).transpose(1, 2)[..., None]
        return self.to_out(o.transpose(1, 2).reshape(B, N, h * dh))


class FeedForward(nn.Module):
    """``net``: RMSNorm, Linear, exact GELU, Dropout, Linear (lucidrains'
    indices 0-4)."""

    def __init__(self, dim: int, mult: int):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(RMSNorm(dim), nn.Linear(dim, inner), nn.GELU(),
                                 nn.Dropout(0.0), nn.Linear(inner, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Transformer(nn.Module):
    """``depth`` [Attention, FeedForward] blocks with residuals; the output
    RMSNorm only with ``norm_output``."""

    def __init__(self, cfg, depth: int):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([Attention(cfg.dim, cfg.heads, cfg.dim_head),
                           FeedForward(cfg.dim, cfg.ff_mult)]) for _ in range(depth)])
        self.norm = RMSNorm(cfg.dim) if cfg.transformer_norm_output else nn.Identity()

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        for attn, ff in self.layers:
            x = x + attn(x, cos, sin)
            x = x + ff(x)
        return self.norm(x)


class BandSplit(nn.Module):
    """Per band: RMSNorm (``to_features.i.0``) and Linear (``.1``) of its
    slice of the features; (B, T, sum dims_in) -> (B, T, bands, dim)."""

    def __init__(self, dims_in: tuple[int, ...], dim: int):
        super().__init__()
        self.dims_in = tuple(dims_in)
        self.to_features = nn.ModuleList(
            [nn.Sequential(RMSNorm(d), nn.Linear(d, dim)) for d in self.dims_in])

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        bands = feats.split(self.dims_in, dim=-1)
        return torch.stack([f(b) for f, b in zip(self.to_features, bands)], dim=2)


class MaskEstimator(nn.Module):
    """Per band an MLP of ``depth`` Linears with tanh between
    (``to_freqs.i.0.{0,2,...}``) and a GLU (the first half times the sigmoid
    of the second); (B, T, bands, dim) -> (B, T, sum dims_in)."""

    def __init__(self, dims_in: tuple[int, ...], dim: int, hidden: int, depth: int):
        super().__init__()
        self.to_freqs = nn.ModuleList()
        for din in dims_in:
            dims = (dim,) + (hidden,) * (depth - 1) + (din * 2,)
            mlp = []
            for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
                mlp.append(nn.Linear(a, b))
                if j < len(dims) - 2:
                    mlp.append(nn.Tanh())
            self.to_freqs.append(nn.Sequential(nn.Sequential(*mlp), nn.GLU(dim=-1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([mlp(x[:, :, i]) for i, mlp in enumerate(self.to_freqs)], dim=-1)


def complex_multiply(mask: torch.Tensor, spec_ri: torch.Tensor) -> torch.Tensor:
    """(S, B, T, F, 2) masks times the (B, T, F, 2) spectrogram, as complex
    numbers in (real, imag) pairs, float32."""
    sr, si = spec_ri[..., 0].float(), spec_ri[..., 1].float()
    mr, mi = mask[..., 0].float(), mask[..., 1].float()
    return torch.stack([mr * sr - mi * si, mr * si + mi * sr], dim=-1)


class BSRoformer(nn.Module):
    """(B, T, F S, 2) spectrogram (real, imag; the frequency axis ordered
    (bin, channel)) -> (num_stems, B, T, F S, 2) masked spectrograms."""

    def __init__(self, cfg: BSRoformerConfig | None = None):
        super().__init__()
        self.cfg = c = cfg or BSRoformerConfig()
        self.band_split = BandSplit(c.dims_in, c.dim)
        self.layers = nn.ModuleList([
            nn.ModuleList([Transformer(c, c.time_transformer_depth),
                           Transformer(c, c.freq_transformer_depth)]) for _ in range(c.depth)])
        self.final_norm = RMSNorm(c.dim)
        self.mask_estimators = nn.ModuleList([
            MaskEstimator(c.dims_in, c.dim, c.dim * c.mlp_expansion_factor,
                          c.mask_estimator_depth) for _ in range(c.num_stems)])

    def features(self, spec_ri: torch.Tensor) -> torch.Tensor:
        """The band split's input, (B, T, sum dims_in)."""
        B, T = spec_ri.shape[:2]
        return spec_ri.reshape(B, T, -1)

    def masks(self, x: torch.Tensor, n_freq: int) -> torch.Tensor:
        """(B, T, bands, dim) -> (S, B, T, n_freq, 2) complex masks."""
        B, T = x.shape[:2]
        return torch.stack([est(x).reshape(B, T, n_freq, 2) for est in self.mask_estimators])

    def forward(self, spec_ri: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        B, T, FS, _ = spec_ri.shape
        x = self.band_split(self.features(spec_ri).float())
        nb, D = x.shape[2], c.dim
        tcos, tsin = _on_device(rotary_tables, x.device, T, c.dim_head, c.rotary_theta)
        fcos, fsin = _on_device(rotary_tables, x.device, nb, c.dim_head, c.rotary_theta)
        for time_t, freq_t in self.layers:
            xt = time_t(x.transpose(1, 2).reshape(B * nb, T, D), tcos, tsin)
            x = xt.reshape(B, nb, T, D).transpose(1, 2)
            x = freq_t(x.reshape(B * T, nb, D), fcos, fsin).reshape(B, T, nb, D)
        return complex_multiply(self.masks(self.final_norm(x), FS), spec_ri)


def pack_spec(audio: torch.Tensor, cfg) -> torch.Tensor:
    """(B, S, T) -> (B, frames, F S, 2): the centred STFT, the frequency
    axis ordered (bin, channel) as the torch layout orders it."""
    B, S, T = audio.shape
    real, imag = stft(audio.reshape(B * S, T), cfg.n_fft, cfg.hop_length, cfg.win_length,
                      center=True)
    nT, nF = real.shape[-2:]
    ri = torch.stack([real, imag], dim=-1).reshape(B, S, nT, nF, 2)
    return ri.permute(0, 2, 3, 1, 4).reshape(B, nT, nF * S, 2)


def unpack_spec(spec: torch.Tensor, cfg, length: int) -> torch.Tensor:
    """(..., B, frames, F S, 2) -> (..., B, S, length) through the iSTFT."""
    *lead, B, nT, FS, _ = spec.shape
    S = cfg.audio_channels
    ri = spec.reshape(*lead, B, nT, FS // S, S, 2).movedim(-2, -4)
    flat = ri.reshape(-1, nT, FS // S, 2)
    wave = istft(flat[..., 0], flat[..., 1], cfg.n_fft, cfg.hop_length, cfg.win_length,
                 center=True, length=length)
    return wave.reshape(*lead, B, S, length)


class BSRoformerSeparator:
    """Chunked overlap-add inference (UVR's: ``segment_seconds`` windows,
    aligned to the hop, at ``overlap``; ``max_batch`` windows a network
    call). ``state_dict``: {lucidrains name: array}
    (``compat.torch_import.load_bs_roformer``). Stems: ``vocals`` for one,
    else the first ``num_stems`` of drums, bass, other, vocals (JAX's
    labels: a 2-stem model gives drums and bass)."""

    model_cls = BSRoformer
    config_cls = BSRoformerConfig

    def __init__(self, state_dict: dict, cfg=None, segment_seconds: float = 8.0,
                 overlap: float = 0.5, max_batch: int = 16, device=None):
        self.device = resolve_device(device)
        set_float32_math()
        self.cfg = cfg or type(self).config_cls()
        self.model = type(self).model_cls(self.cfg)
        load_numpy_state_dict(self.model, state_dict)
        self.model.to(self.device).eval()
        hop = self.cfg.hop_length
        self.segment = int(round(segment_seconds * self.cfg.sample_rate / hop)) * hop
        self.stride = int(self.segment * (1 - overlap))
        self.max_batch = max_batch
        self.samplerate = self.cfg.sample_rate
        self.sources = ["vocals"] if self.cfg.num_stems == 1 else [
            "drums", "bass", "other", "vocals"][: self.cfg.num_stems]

    @torch.no_grad()
    def demix(self, mix, events: list | None = None) -> torch.Tensor:
        """mix (S, T) float32 (array or tensor) -> (num_stems, S, T) on the
        separator's device. ``events``: "chunking", then per network call
        "stft", "network", "istft", and "overlap-add"."""
        x = torch.as_tensor(mix, dtype=torch.float32, device=self.device)
        S, T = x.shape
        seg, stride = self.segment, self.stride
        n_win = max(1, int(np.ceil(max(T - seg, 0) / stride)) + 1)
        total = (n_win - 1) * stride + seg
        windows = F.pad(x, (0, total - T)).unfold(-1, seg, stride).transpose(0, 1)
        mark(events, "chunking")
        outs = []
        for i in range(0, n_win, self.max_batch):
            spec = pack_spec(windows[i: i + self.max_batch].contiguous(), self.cfg)
            mark(events, "stft")
            est = self.model(spec)
            mark(events, "network")
            outs.append(unpack_spec(est, self.cfg, seg))
            mark(events, "istft")
        est = torch.cat(outs, dim=1)  # (stems, N, S, seg)
        # sqrt(hann) + 1e-4, rounded to float32 as the JAX package rounds it
        w = torch.from_numpy(np.hanning(seg).astype(np.float32) ** 0.5 + 1e-4).to(self.device)
        acc = est.new_zeros(est.shape[0], S, total)
        norm = est.new_zeros(total)
        for n in range(n_win):  # in window order, as the JAX package sums
            acc[..., n * stride: n * stride + seg] += est[:, n] * w
            norm[n * stride: n * stride + seg] += w
        out = (acc / norm)[..., :T]
        mark(events, "overlap-add")
        return out

    @torch.no_grad()
    def run_inference(self, audio: np.ndarray, sr: int, events: list | None = None) -> dict:
        """audio (T,) or (C, T) at any rate -> {"sr", "input_audio", each stem
        as stereo int16 (S, T) with its rate, and "instrumentals" = mix -
        vocals with a vocals stem}. ``events``: "start", ``demix``'s, "int16"."""
        from ..pipelines.separate import _to_stereo_44k, stereo_int16

        mix = np.atleast_2d(np.asarray(audio, np.float32))
        if sr != self.samplerate or mix.shape[0] != 2:
            mix = _to_stereo_44k(mix, sr)
        x = torch.from_numpy(np.ascontiguousarray(mix)).to(self.device)
        mark(events, "start")
        stems = self.demix(x, events)
        names = list(self.sources)
        if "vocals" in names:
            v = stems[names.index("vocals")]
            stems = torch.cat([stems, (x[:, : v.shape[1]] - v)[None]])
            names.append("instrumentals")
        ints = stereo_int16(stems)
        mark(events, "int16")
        out = {"sr": self.samplerate, "input_audio": (mix, self.samplerate)}
        out.update({name: (ints[i], self.samplerate) for i, name in enumerate(names)})
        return out
