"""Voice conversion: the port's main path.

Counterpart of ``rvc_tpu/pipelines/convert.py::VoiceConverter.convert`` on
one device with the chunks concatenated on the device. The same steps in
the same order:

  host:   48 Hz high-pass (scipy filtfilt) -> silence-seek split points ->
          reflect pad -> length bucket -> int16 peak quantization
  device: chunk slicing -> f0 per chunk -> shift, coarse bins ->
          HuBERT (masked) -> retrieval blend (kernel 3) -> 2x frame repeat
          -> protect blend -> synthesizer (text encoder with kernel 2, flow,
          NSF decoder with kernel 1) -> per-chunk RMS mix -> pad trim,
          concat, int16 peak normalization

Chunk spans, bucketing and pad trim equal the JAX package's. The JAX
package's TPU-only tricks (int16 bit-pair upload, s2d packing, dp mesh)
are left out; outputs are kept. Input at another rate than 16 kHz is
resampled on the host (``io.audio.remix_audio``); ``resample_sr``
resamples the int16 result on the device (``ops.resample``). ``convert_batch``
converts many songs in one chunk batch. A no-f0 model runs without the
pitch model and the protect blend.

f0: one method (``pitch.extractor.METHODS``) runs per chunk, the chunk
batch its batch. A list of methods (the hybrid merge) runs as the JAX
package runs it (rvc_tpu/pipelines/convert.py:420-445, :250-256): on the
whole padded song at batch 1, the same int16-quantized samples the chunks
are cut from, and each chunk's frames are sliced from it at
``start // 160``, clamped as ``jax.lax.dynamic_slice`` clamps.
``convert_batch`` takes one method only, as in JAX.

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
import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..config import RVCConfig, preset as get_preset
from ..device import resolve_device, set_float32_math
from ..io.audio import MAX_INT16, remix_audio
from ..models.hubert import HubertConfig, HubertEncoder
from ..models.layers import init_random_, load_numpy_state_dict, set_dtype_
from ..models.rmvpe import RMVPE
from ..models.synthesizer import Synthesizer
from ..ops.filters import butter_highpass_host, change_rms, peak_quantize_i16
from ..ops.resample import resample
from ..ops.retrieval import blend_into, blend_into_q, quantize_bank
from ..pitch.extractor import PitchExtractor, autotune, coarse_f0, shift_semitones

SR = 16000
WINDOW = 160


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
        the synthesizer's random draws. A no-f0 model (``synth_kwargs
        ["use_f0"]`` false) needs no pitch model."""
        self.device = resolve_device(device)
        set_float32_math()
        self.config = config or RVCConfig()
        self.seed = seed
        self.dtype = dtype
        self.use_f0 = synth_kwargs.get("use_f0", True)
        self.synth = set_dtype_(synth.to(self.device).eval(), dtype)
        self.synth.dec.fuse_group = synth_kwargs.get("fuse_group", True)
        self.hubert = set_dtype_(hubert.to(self.device).eval(), dtype)
        self.pitch = (pitch or PitchExtractor(dtype=dtype)).to(self.device)
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
        of ``compat.weights`` or ``compat.torch_import``; ``kwargs`` go to the
        constructor, the pitch model computing in its ``dtype`` too. HuBERT
        layers past those the version reads (a full HF file holds 12) are
        left out; every module weight must be present."""
        synth = load_numpy_state_dict(Synthesizer(**synth_kwargs), synth_state)
        version = "v1" if synth_kwargs.get("feature_dim", 768) == 256 else "v2"
        hubert = HubertEncoder(hubert_cfg, version)
        used = hubert.state_dict()
        load_numpy_state_dict(hubert, {k: v for k, v in hubert_state.items() if k in used})
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
        same): the prior's eps, and with f0 the sine source's start phase
        and noise."""
        gen = torch.Generator().manual_seed(self.seed)
        inter = self.synth.enc_p.out_channels
        out = dict(eps=torch.randn(n_chunks, inter, frames, generator=gen))
        if self.use_f0:
            upp = self.synth.dec.upp
            out.update(rand_ini=torch.rand(n_chunks, 1, generator=gen),
                       noise=torch.randn(n_chunks, frames * upp, 1, generator=gen))
        return {k: v.to(self.device) for k, v in out.items()}

    def convert(self, audio: np.ndarray, input_sr: int = SR,
                settings: ConvertSettings | None = None, bucket_samples: int = 1600,
                draws: dict | None = None) -> tuple[np.ndarray, int]:
        """audio: float mono waveform at ``input_sr`` (resampled to 16 kHz and
        limited to a peak of 0.95 by ``io.audio.remix_audio`` when not 16
        kHz). Returns (int16 audio, sr): at the model's rate, or at
        ``settings.resample_sr`` when that is 16 kHz or more and not the
        model's.

        ``draws`` optionally replaces the synthesizer's random draws (``eps``,
        ``rand_ini``, ``noise``; see ``draws``)."""
        s = settings or ConvertSettings()
        if input_sr != SR:
            audio, _ = remix_audio((audio, input_sr), target_sr=SR)
        with torch.no_grad():
            wave_dev, starts, lengths, _, L = self._upload([self.padded(audio)], bucket_samples)
            f0 = None
            if self.use_f0 and not isinstance(s.f0_method, str):
                f0 = self._hybrid_f0(wave_dev, starts, L, s)
            o = self._grid(self._slices(wave_dev, starts, L), lengths, s, draws, f0)
            # pad trim + concat, then int16 peak normalization
            ratio = self.tgt_sr // 100
            p_lens = np.minimum(lengths // WINDOW, o.shape[1] // ratio)
            flat = torch.cat([o[i, self.t_pad_tgt: p * ratio - self.t_pad_tgt]
                              for i, p in enumerate(p_lens)])
            audio_max = torch.max(torch.abs(flat)) / 0.99
            return self._resampled(to_int16(flat, audio_max), s)

    def _resampled(self, out16: torch.Tensor, s: ConvertSettings) -> tuple[np.ndarray, int]:
        """The int16 result (on the device), resampled to ``s.resample_sr``
        where asked, clipped and truncated back to int16, as numpy."""
        if s.resample_sr >= SR and s.resample_sr != self.tgt_sr:
            res = resample(out16.to(self.device, torch.float32), self.tgt_sr, s.resample_sr)
            res = torch.clamp(res, 1 - MAX_INT16, MAX_INT16 - 1).to(torch.int16)
            return res.cpu().numpy(), s.resample_sr
        return out16.cpu().numpy(), self.tgt_sr

    def padded(self, audio: np.ndarray) -> tuple[np.ndarray, list[tuple[int, int]]]:
        """Host side for one 16 kHz song: the high-passed, reflect-padded
        waveform with a tail up to the next whole second past it (reflected,
        or zeros where the tail is longer than the song), and its chunk
        spans."""
        audio = butter_highpass_host(np.asarray(audio, np.float32), 48.0, SR)
        spans = self.spans(audio)
        audio_pad = np.pad(audio, (self.t_pad, self.t_pad), mode="reflect")
        P = len(audio_pad)
        tail = int(np.ceil((P + 1) / 16000) * 16000) - P
        return np.pad(audio_pad, (0, tail), mode="reflect" if tail < P else "constant"), spans

    def _upload(self, songs: list, bucket_samples: int):
        """Every song's padded buffer in one flat buffer under one int16
        peak quantization (one ``inv_scale``), on the device. Returns the
        dequantized buffer, and per chunk its start in it, its length and
        its song; and L, the longest chunk rounded up to the bucket."""
        buffers, starts, lengths, owner, offset = [], [], [], [], 0
        for si, (buf, spans) in enumerate(songs):
            buffers.append(buf)
            starts += [offset + b for b, _ in spans]
            lengths += [e - b for b, e in spans]
            owner += [si] * len(spans)
            offset += len(buf)
        q16, peak = peak_quantize_i16(np.concatenate(buffers))
        inv_scale = np.float32(max(peak, 1e-9) / 32766.0)
        lengths = np.array(lengths, np.int64)
        L = int(np.ceil(lengths.max() / bucket_samples) * bucket_samples)
        wave_dev = torch.from_numpy(q16).to(self.device).float() * inv_scale
        return wave_dev, np.array(starts, np.int64), lengths, np.array(owner), L

    @staticmethod
    def _slices(wave_dev: torch.Tensor, starts: np.ndarray, L: int) -> torch.Tensor:
        """The (N, L) chunk batch; a start is clamped so the slice fits, as
        ``jax.lax.dynamic_slice`` clamps, so a chunk may run into the next
        song's buffer."""
        return torch.stack([wave_dev[st: st + L]
                            for st in np.clip(starts, 0, len(wave_dev) - L)])

    def _hybrid_f0(self, wave_dev: torch.Tensor, starts: np.ndarray, L: int,
                  s: ConvertSettings) -> torch.Tensor:
        """f0 of a list of methods, merged, autotuned and shifted, on the
        whole padded song ``wave_dev`` at batch 1, then each chunk's
        ``L // 160`` frames from ``start // 160`` (clamped to fit): (N, L //
        160)."""
        _, f0 = self.pitch.get_f0(
            wave_dev[None], s.f0_up_key, s.f0_method, s.merge_type, s.filter_radius,
            s.crepe_hop_length, s.f0_autotune, s.f0_min, s.f0_max)
        n = L // WINDOW
        return torch.stack([f0[0, st: st + n]
                            for st in np.clip(starts // WINDOW, 0, f0.shape[-1] - n)])

    def chunks(self, audio: np.ndarray, bucket_samples: int = 1600
               ) -> tuple[torch.Tensor, np.ndarray]:
        """Host side of ``convert``: high-pass, reflect pad, bucket, int16
        peak quantization, then the chunk batch (N, L) on the device (L the
        longest span rounded up to the bucket) and the spans' lengths."""
        wave_dev, starts, lengths, _, L = self._upload([self.padded(audio)], bucket_samples)
        return self._slices(wave_dev, starts, L), lengths

    def convert_batch(self, audios: Sequence[np.ndarray], input_sr: int = SR,
                      settings: ConvertSettings | None = None, bucket_samples: int = 1600,
                      stats: dict | None = None, return_async: bool = False,
                      draws: dict | None = None):
        """N songs in one chunk batch: the throughput mode
        (rvc_tpu/pipelines/convert.py:544-724).

        Every song's padded waveform goes into one flat buffer under one int16
        peak quantization, and every song's chunks into one chunk batch; a
        chunk's slice may run past its song into the next one's buffer, as
        in the JAX package. Settings are shared. The int16 normalization is
        global over the batch's valid samples (each chunk's
        ``t_pad_tgt <= t < (length // 160) * ratio - t_pad_tgt``), so a song
        comes out at the batch's scale, not at its own. ``draws`` replaces
        the synthesizer's draws for the whole chunk batch.

        Returns ``[(int16 audio, sr), ...]`` in input order. With
        ``return_async``, returns ``(dispatch, finalize)`` instead:
        ``dispatch()`` queues the device work and returns the int16 chunk
        grid on the device, ``finalize(grid)`` downloads it and returns the
        songs, so a caller can queue the next batch before downloading this
        one. ``stats``, when given, receives ``device_s`` (the device work,
        synchronized, no download), ``download_s``, ``dispatch_s`` (both),
        ``download_bytes``, ``n_chunks`` and ``chunk_samples``; the JAX
        package's ``flops``, XLA's cost analysis, has no counterpart here."""
        s = settings or ConvertSettings()
        if self.use_f0 and not isinstance(s.f0_method, str):
            raise ValueError("convert_batch requires a single f0 method (hybrid multi-method "
                             "merging is per-song: use convert())")
        songs = []
        for audio in audios:
            if input_sr != SR:
                audio, _ = remix_audio((audio, input_sr), target_sr=SR)
            songs.append(self.padded(audio))
        wave_dev, starts, lengths, owner, L = self._upload(songs, bucket_samples)
        n_songs = len(audios)

        @torch.no_grad()
        def dispatch() -> torch.Tensor:
            o = self._grid(self._slices(wave_dev, starts, L), lengths, s, draws)
            ratio = self.tgt_sr // 100
            t = torch.arange(o.shape[1], device=o.device)[None, :]
            hi = torch.as_tensor((lengths // WINDOW) * ratio - self.t_pad_tgt, device=o.device)
            mask = (t >= self.t_pad_tgt) & (t < hi[:, None])
            audio_max = torch.max(torch.abs(torch.where(mask, o, 0.0))) / 0.99
            return to_int16(o, audio_max)

        def finalize(grid: torch.Tensor) -> list[tuple[np.ndarray, int]]:
            return self._finalize_batch(grid.cpu().numpy(), n_songs, owner, lengths, s)

        if return_async:
            return dispatch, finalize
        if stats is None:
            return finalize(dispatch())
        t0 = time.perf_counter()
        grid = dispatch()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats["device_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        out16 = grid.cpu().numpy()
        stats["download_s"] = time.perf_counter() - t1
        stats["dispatch_s"] = time.perf_counter() - t0
        stats.update(download_bytes=int(out16.nbytes), n_chunks=len(starts), chunk_samples=L)
        return self._finalize_batch(out16, n_songs, owner, lengths, s)

    def _finalize_batch(self, out16: np.ndarray, n_songs: int, owner: np.ndarray,
                        lengths: np.ndarray, s: ConvertSettings) -> list[tuple[np.ndarray, int]]:
        """Host side of ``convert_batch``: the int16 chunk grid back into
        songs (pad trim + concat), each resampled where asked."""
        ratio = self.tgt_sr // 100
        results = []
        for si in range(n_songs):
            pieces = []
            for i in np.nonzero(owner == si)[0]:
                p_len = min(int(lengths[i]) // WINDOW, out16.shape[1] // ratio)
                valid = out16[i, :p_len * ratio]
                pieces.append(valid[self.t_pad_tgt: len(valid) - self.t_pad_tgt])
            results.append(self._resampled(torch.from_numpy(np.concatenate(pieces)), s))
        return results

    def _grid(self, chunks: torch.Tensor, lengths: np.ndarray, s: ConvertSettings,
              draws, f0: torch.Tensor | None = None) -> torch.Tensor:
        """The device core: the chunk batch (N, L) -> the synthesizer's
        float32 output (N, T_out) after the per-chunk RMS mix. ``f0`` (N, L //
        160), shifted, replaces the per-chunk f0 (the hybrid merge's)."""
        dev = self.device
        N, L = chunks.shape
        F = L // WINDOW
        lengths_t = torch.as_tensor(lengths, device=dev)
        if self.use_f0 and f0 is None:  # f0 per chunk (the chunk batch is the f0 batch)
            f0 = self.pitch.method_fn(s.f0_method, s.f0_min, s.f0_max, s.filter_radius,
                                      s.crepe_hop_length)(chunks)[:, :F]
            if s.f0_autotune:
                f0 = autotune(f0)
            f0 = shift_semitones(f0, np.float32(s.f0_up_key))
        if self.use_f0:
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
        Tp = min(F, T100) if self.use_f0 else T100
        feats = feats[:, :Tp]
        if self.use_f0 and s.protect < 0.5:
            feats0 = torch.repeat_interleave(feats0, 2, dim=1)[:, :Tp]
            pitchff = torch.where(f0[:, :Tp] > 0, 1.0, s.protect)[..., None]
            feats = feats * pitchff + feats0 * (1.0 - pitchff)
        draws = draws or self.draws(N, Tp)
        sid = torch.full((N,), s.sid, device=dev, dtype=torch.int64)
        if self.use_f0:
            o, _, _ = self.synth.infer(feats, p_len, pitch[:, :Tp], f0[:, :Tp], sid, **draws)
        else:
            o, _, _ = self.synth.infer(feats, p_len, None, None, sid, **draws)
        o = o[:, 0].float()
        if s.rms_mix_rate < 1:
            o = change_rms(chunks, SR, o, self.tgt_sr, s.rms_mix_rate)
        return o


def to_int16(x: torch.Tensor, audio_max: torch.Tensor) -> torch.Tensor:
    """x scaled so that ``audio_max`` maps to full scale, clipped to int16's
    symmetric range and truncated toward zero."""
    x = x * (MAX_INT16 / torch.clamp(audio_max, min=1e-9))
    return torch.clamp(x, 1 - MAX_INT16, MAX_INT16 - 1).to(torch.int16)


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
