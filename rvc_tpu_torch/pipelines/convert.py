"""Voice conversion: the port's main path.

Counterpart of ``rvc_tpu/pipelines/convert.py::VoiceConverter.convert`` on
one device with the chunks concatenated on the device. The same steps in
the same order:

  host:   48 Hz high-pass (scipy filtfilt) -> silence-seek split points ->
          reflect pad -> length bucket -> int16 peak quantization
  device: chunk slicing -> RMVPE f0 per chunk -> shift, coarse bins ->
          HuBERT (masked) -> retrieval blend (kernel 3) -> 2x frame repeat
          -> protect blend -> synthesizer (text encoder with kernel 2, flow,
          NSF decoder with kernel 1) -> per-chunk RMS mix -> pad trim,
          concat, int16 peak normalization

Chunk spans, bucketing and pad trim equal the JAX package's. The JAX
package's TPU-only tricks (int16 bit-pair upload, s2d packing, dp mesh)
are left out; outputs are kept. ``input_sr`` other than 16 kHz,
``resample_sr`` and multi-method f0 are not ported yet and raise.

``dtype`` is the compute dtype of HuBERT and the synthesizer (and of the
pitch model built by ``from_state_dicts`` / ``make_random_converter``), as
the JAX ``VoiceConverter(dtype=)``: float32 by default, or bfloat16, the
configuration the JAX package benchmarks (bench.py:52). In bfloat16 the
protect blend promotes the features to float32 as JAX does, and the
synthesizer's output goes to float32 before the RMS mix
(rvc_tpu/pipelines/convert.py:263-266). ``synth_kwargs["fuse_group"]``
(default True) picks the decoder's route (``models.nsf``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..config import RVCConfig, preset as get_preset
from ..device import resolve_device, set_float32_math
from ..models.hubert import HubertConfig, HubertEncoder
from ..models.layers import init_random_, load_numpy_state_dict, set_dtype_
from ..models.rmvpe import RMVPE
from ..models.synthesizer import Synthesizer
from ..ops.filters import butter_highpass_host, change_rms, peak_quantize_i16
from ..ops.retrieval import blend_into, blend_into_q, quantize_bank
from ..pitch.extractor import PitchExtractor, autotune, coarse_f0, shift_semitones

SR = 16000
WINDOW = 160
MAX_INT16 = 32768


def find_split_points(audio: np.ndarray, t_center: int, t_query: int,
                      window: int = WINDOW) -> list[int]:
    """Silence-seek chunk boundaries: around every t_center multiple, the
    minimum of a sliding window-sum of the waveform within ±t_query."""
    audio_pad = np.pad(audio, (window // 2, window // 2), mode="reflect")
    csum = np.cumsum(np.concatenate([[0.0], audio_pad]))
    audio_sum = (csum[window:] - csum[:-window])[: len(audio)]
    opt_ts = []
    for t in range(t_center, len(audio), t_center):
        seg = np.abs(audio_sum[t - t_query: t + t_query])
        opt_ts.append(int(t - t_query + np.argmin(seg)))
    return opt_ts


@dataclass
class ConvertSettings:
    sid: int = 0
    f0_up_key: float = 0.0
    f0_method: str | Sequence[str] = "rmvpe"
    merge_type: str = "median"
    index_rate: float = 0.75
    filter_radius: int = 3
    resample_sr: int = 0
    rms_mix_rate: float = 0.25
    protect: float = 0.33
    crepe_hop_length: int = 160
    f0_autotune: bool = False
    f0_min: float = 50.0
    f0_max: float = 1100.0


def synth_kwargs_from_config(cfg: RVCConfig) -> dict:
    m, d = cfg.model, cfg.data
    return dict(
        spec_channels=d.spec_channels, segment_size=cfg.train.segment_size // d.hop_length,
        inter_channels=m.inter_channels, hidden_channels=m.hidden_channels,
        filter_channels=m.filter_channels, n_heads=m.n_heads, n_layers=m.n_layers,
        kernel_size=m.kernel_size, p_dropout=m.p_dropout, resblock=m.resblock,
        resblock_kernel_sizes=tuple(m.resblock_kernel_sizes),
        resblock_dilation_sizes=tuple(map(tuple, m.resblock_dilation_sizes)),
        upsample_rates=tuple(m.upsample_rates),
        upsample_initial_channel=m.upsample_initial_channel,
        upsample_kernel_sizes=tuple(m.upsample_kernel_sizes),
        spk_embed_dim=m.spk_embed_dim, gin_channels=m.gin_channels, sr=d.sampling_rate,
        feature_dim=m.feature_dim, use_f0=m.use_f0)


class VoiceConverter:
    """End-to-end RVC conversion on one device, in float32 or bfloat16."""

    def __init__(self, synth: Synthesizer, synth_kwargs: dict, hubert: HubertEncoder,
                 pitch: PitchExtractor | None = None, index_bank: np.ndarray | None = None,
                 config: RVCConfig | None = None, index_int8: bool = False,
                 device=None, seed: int = 0, dtype: torch.dtype = torch.float32):
        """``synth``, ``hubert`` and ``pitch`` hold loaded weights; they are
        moved to ``device`` (default: the card), and ``synth`` and ``hubert``
        compute in ``dtype``. ``index_bank`` (N, D) is the retrieval bank,
        stored int8 with per-row scales when ``index_int8``. ``seed`` seeds
        the synthesizer's random draws."""
        self.device = resolve_device(device)
        set_float32_math()
        self.config = config or RVCConfig()
        self.seed = seed
        self.dtype = dtype
        self.synth = set_dtype_(synth.to(self.device).eval(), dtype)
        self.synth.dec.fuse_group = synth_kwargs.get("fuse_group", True)
        self.hubert = set_dtype_(hubert.to(self.device).eval(), dtype)
        self.pitch = pitch or PitchExtractor(dtype=dtype)
        if self.pitch.rmvpe is not None:
            self.pitch.rmvpe = self.pitch.rmvpe.to(self.device).eval()
        self.tgt_sr = synth_kwargs["sr"]
        self.index_bank = None
        if index_bank is not None:
            if index_int8:
                q, s = quantize_bank(index_bank)
                self.index_bank = (torch.from_numpy(q).to(self.device),
                                   torch.from_numpy(s).to(self.device))
            else:
                self.index_bank = torch.as_tensor(
                    np.asarray(index_bank, np.float32), device=self.device)
        c = self.config
        self.t_pad = SR * c.x_pad
        self.t_pad_tgt = self.tgt_sr * c.x_pad
        self.t_pad2 = self.t_pad * 2
        self.t_query = SR * c.x_query
        self.t_center = SR * c.x_center
        self.t_max = SR * c.x_max

    @classmethod
    def from_state_dicts(cls, synth_state: dict, synth_kwargs: dict, hubert_state: dict,
                         hubert_cfg: HubertConfig | None = None,
                         rmvpe_state: dict | None = None, **kwargs) -> "VoiceConverter":
        """Build from reference-named state_dicts ({name: array}), e.g. those
        of ``compat.weights``; ``kwargs`` go to the constructor, the pitch
        model computing in its ``dtype`` too."""
        synth = load_numpy_state_dict(Synthesizer(**synth_kwargs), synth_state)
        version = "v1" if synth_kwargs.get("feature_dim", 768) == 256 else "v2"
        hubert = load_numpy_state_dict(HubertEncoder(hubert_cfg, version), hubert_state)
        rmvpe = None
        if rmvpe_state is not None:  # reference E2E names
            rmvpe = RMVPE()
            load_numpy_state_dict(rmvpe.model, rmvpe_state)
        pitch = PitchExtractor(rmvpe, dtype=kwargs.get("dtype", torch.float32))
        return cls(synth, synth_kwargs, hubert, pitch, **kwargs)

    def spans(self, audio: np.ndarray) -> list[tuple[int, int]]:
        """Chunk spans over the reflect-padded waveform of high-passed audio."""
        opt_ts: list[int] = []
        if len(audio) + WINDOW > self.t_max:
            opt_ts = find_split_points(audio, self.t_center, self.t_query)
        spans, start = [], 0
        for t in opt_ts:
            t = t // WINDOW * WINDOW
            spans.append((start, t + self.t_pad2 + WINDOW))
            start = t
        spans.append((start, len(audio) + 2 * self.t_pad))
        return spans

    def draws(self, n_chunks: int, frames: int) -> dict:
        """The synthesizer's random draws for one batch, from a CPU generator
        seeded with ``seed`` (so every call, and every device, draws the
        same): the prior's eps, the sine source's start phase and noise."""
        gen = torch.Generator().manual_seed(self.seed)
        inter = self.synth.enc_p.out_channels
        upp = self.synth.dec.upp
        out = dict(eps=torch.randn(n_chunks, inter, frames, generator=gen),
                   rand_ini=torch.rand(n_chunks, 1, generator=gen),
                   noise=torch.randn(n_chunks, frames * upp, 1, generator=gen))
        return {k: v.to(self.device) for k, v in out.items()}

    def convert(self, audio: np.ndarray, input_sr: int = SR,
                settings: ConvertSettings | None = None, bucket_samples: int = 1600,
                draws: dict | None = None) -> tuple[np.ndarray, int]:
        """audio: float mono waveform at 16 kHz. Returns (int16 audio, sr).

        ``draws`` optionally replaces the synthesizer's random draws (``eps``,
        ``rand_ini``, ``noise``; see ``draws``)."""
        s = settings or ConvertSettings()
        if input_sr != SR:
            raise NotImplementedError("input_sr other than 16000 is not ported yet")
        if s.resample_sr >= SR and s.resample_sr != self.tgt_sr:
            raise NotImplementedError("resample_sr is not ported yet")
        if not isinstance(s.f0_method, str):
            raise NotImplementedError("multi-method f0 merging is not ported yet")
        with torch.no_grad():
            chunks, lengths = self.chunks(audio, bucket_samples)
            out = self._core(chunks, lengths, s, draws)
        return out, self.tgt_sr

    def chunks(self, audio: np.ndarray, bucket_samples: int = 1600
               ) -> tuple[torch.Tensor, np.ndarray]:
        """Host side of ``convert``: high-pass, reflect pad, bucket, int16
        peak quantization, then the chunk batch (N, L) on the device (L the
        longest span rounded up to the bucket) and the spans' lengths."""
        audio = butter_highpass_host(np.asarray(audio, np.float32), 48.0, SR)
        spans = self.spans(audio)
        audio_pad = np.pad(audio, (self.t_pad, self.t_pad), mode="reflect")
        P = len(audio_pad)
        tail = int(np.ceil((P + 1) / 16000) * 16000) - P
        audio_pad_b = np.pad(audio_pad, (0, tail), mode="reflect" if tail < P else "constant")
        q16, peak = peak_quantize_i16(audio_pad_b)
        inv_scale = np.float32(max(peak, 1e-9) / 32766.0)
        lengths = np.array([e - b for b, e in spans], np.int64)
        starts = np.array([b for b, _ in spans], np.int64)
        L = int(np.ceil(lengths.max() / bucket_samples) * bucket_samples)
        wave_dev = torch.from_numpy(q16).to(self.device).float() * inv_scale
        # a start is clamped so the slice fits, as jax.lax.dynamic_slice does
        chunks = torch.stack([wave_dev[st: st + L]
                              for st in np.clip(starts, 0, len(wave_dev) - L)])
        return chunks, lengths

    def _core(self, chunks: torch.Tensor, lengths: np.ndarray, s: ConvertSettings, draws):
        dev = self.device
        N, L = chunks.shape
        F = L // WINDOW
        lengths_t = torch.as_tensor(lengths, device=dev)
        # f0 per chunk (the chunk batch is the f0 batch)
        f0 = self.pitch.method_fn(s.f0_method, s.f0_min, s.f0_max)(chunks)[:, :F]
        if s.f0_autotune:
            f0 = autotune(f0)
        f0 = shift_semitones(f0, np.float32(s.f0_up_key))
        pitch = coarse_f0(f0, s.f0_min, s.f0_max)
        feats = self.hubert.extract_features(chunks, lengths_t)
        feats0 = feats
        if self.index_bank is not None and s.index_rate > 0:
            if isinstance(self.index_bank, tuple):
                feats = blend_into_q(feats, *self.index_bank, s.index_rate)
            else:
                feats = blend_into(feats, self.index_bank, s.index_rate)
        # 50 Hz -> 100 Hz
        feats = torch.repeat_interleave(feats, 2, dim=1)
        T100 = feats.shape[1]
        p_len = torch.clamp(lengths_t // WINDOW, max=T100)
        Tp = min(F, T100)
        feats = feats[:, :Tp]
        if s.protect < 0.5:
            feats0 = torch.repeat_interleave(feats0, 2, dim=1)[:, :Tp]
            pitchff = torch.where(f0[:, :Tp] > 0, 1.0, s.protect)[..., None]
            feats = feats * pitchff + feats0 * (1.0 - pitchff)
        draws = draws or self.draws(N, Tp)
        sid = torch.full((N,), s.sid, device=dev, dtype=torch.int64)
        o, _, _ = self.synth.infer(feats, p_len, pitch[:, :Tp], f0[:, :Tp], sid, **draws)
        o = o[:, 0].float()
        if s.rms_mix_rate < 1:
            o = change_rms(chunks, SR, o, self.tgt_sr, s.rms_mix_rate)
        # pad trim + concat, then int16 peak normalization
        ratio = self.tgt_sr // 100
        p_lens = np.minimum(lengths // WINDOW, o.shape[1] // ratio)
        flat = torch.cat([o[i, self.t_pad_tgt: p * ratio - self.t_pad_tgt]
                          for i, p in enumerate(p_lens)])
        audio_max = torch.max(torch.abs(flat)) / 0.99
        flat = flat * (MAX_INT16 / torch.clamp(audio_max, min=1e-9))
        flat = torch.clamp(flat, 1 - MAX_INT16, MAX_INT16 - 1).to(torch.int16)
        return flat.cpu().numpy()


def make_random_converter(
    preset: str = "40k_v2",
    seed: int = 0,
    chunking: tuple[int, int, int, int] | None = None,
    index_rows: int = 0,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> VoiceConverter:
    """A converter with random weights at the preset's full width, drawn from
    numpy as the JAX package's ``fast_init`` draws them (scale 0.02), and
    the default HuBERT and RMVPE, computing in ``dtype``. ``chunking``
    overrides (x_pad, x_query, x_center, x_max); ``index_rows`` > 0
    attaches a random int8 retrieval bank of that many rows."""
    dev = resolve_device(device)
    cfg = get_preset(preset)
    if chunking is not None:
        cfg = dataclasses.replace(cfg, x_pad=chunking[0], x_query=chunking[1],
                                  x_center=chunking[2], x_max=chunking[3])
    kwargs = synth_kwargs_from_config(cfg)
    synth = init_random_(Synthesizer(**kwargs), seed)
    hubert = init_random_(HubertEncoder(None, cfg.model.version), seed + 1)
    rmvpe = init_random_(RMVPE(), seed + 2)
    index_bank = None
    if index_rows > 0:
        index_bank = np.random.default_rng(seed + 7).standard_normal(
            (index_rows, kwargs["feature_dim"])).astype(np.float32)
    return VoiceConverter(synth, kwargs, hubert, PitchExtractor(rmvpe, dtype=dtype),
                          index_bank=index_bank, config=cfg, index_int8=True, device=dev,
                          seed=seed, dtype=dtype)
