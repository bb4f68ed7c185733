"""The Karafan ensemble separation recipe (the reference's
``lib/karafan/inference.py:275-699``).

Counterpart of ``rvc_tpu/pipelines/karafan.py``: a declarative pipeline
over any extractors, callables ``(2, T) float32 mix -> (2, T) stem`` (the
port's separators wrapped by the caller, e.g. ``lambda m:
sep.demix(m)[0].cpu().numpy()``; the package holds no such adapter, as the
JAX package holds none):

  1. music pre-extraction (ensemble-max over the music models),
  2. vocals extraction on (mix - music) (ensemble-max),
  3. music-bleed filtering of vocals,
  4. high/low-pass cleanup of vocals,
  5. music = mix - vocals,
  6. vocal-bleed (and music re-removal) filtering of music,
  7. optional infra-bass and silence gating.

Each model's extraction (``extract_with_model``, the reference's
Extract_with_Model :526-699) adds to the raw extractor the 2-pass
phase-inversion denoise, the high SRS pass for band-limited models (the
mix shifted so the model's band covers the original's top octave,
re-inferred, shifted back and blended: ensemble-max for vocals, a 16 kHz
Linkwitz-Riley crossover for music), the low SRS pass of vocal models and
the model's volume compensation. BigShifts averaging (``bigshifts_demix``)
runs the extractor over time-rolled copies of the mix. The recipe's filters
and resampling run on the host (``ops.karafan_utils``); the extractors
take the card's time.

A hash-keyed disk stem cache (the reference's GOD-MODE) keeps each model's
stage output under ``config.cache_dir``, so a re-run with other downstream
settings skips the extractions.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from ..io.audio import remix_audio
from ..ops import karafan_utils as KU
from .separate import _to_stereo_44k


Extractor = Callable[[np.ndarray], np.ndarray]  # (2, T) mix -> (2, T) stem


@dataclass
class KarafanModel:
    """An extractor plus the metadata the recipe's per-model treatment needs
    (reference model dicts: Name/Cut_OFF/Compensation, App/Models.csv)."""

    extractor: Extractor
    name: str = "model"
    cut_off: float = 0.0       # trained band limit in Hz; 0 = full-band (no SRS)
    compensation: float = 1.0  # output volume compensation
    srs_high: bool = True      # reference skips high-SRS for "Vocal Main" (:602)

    def __call__(self, mix: np.ndarray) -> np.ndarray:
        return self.extractor(mix)


def _as_model(m: Extractor | KarafanModel) -> KarafanModel:
    return m if isinstance(m, KarafanModel) else KarafanModel(extractor=m)


def extract_with_model(kind: str, audio: np.ndarray, model: KarafanModel,
                       *, bigshifts: int = 1, bigshifts_srs: int = 0,
                       denoise: bool = True, sample_rate: int = 44100,
                       original_cutoff: float | None = None) -> np.ndarray:
    """One model's full extraction treatment (reference Extract_with_Model,
    inference.py:526-699). kind: 'vocal' | 'music' | 'bleed'."""
    orig_cut = original_cutoff if original_cutoff else sample_rate / 2

    def demix(a: np.ndarray, shifts: int) -> np.ndarray:
        if denoise:
            # phase-inversion 2-pass: model noise cancels, signal sums to 1
            out = 0.5 * -bigshifts_demix(-a, model.extractor, shifts, sample_rate)
            out += 0.5 * bigshifts_demix(a, model.extractor, shifts, sample_rate)
            return out
        return bigshifts_demix(a, model.extractor, shifts, sample_rate)

    source = demix(audio, bigshifts)

    if bigshifts_srs > 0:
        # 1 - high SRS: shift content down so the model's band reaches the
        # original signal's top octave, re-infer, shift back (:597-651)
        if model.cut_off > 0 and model.srs_high:
            delta = 810.0 if kind == "vocal" else 1220.0  # :607 (empirical)
            a_srs = KU.srs_shift(audio, "DOWN", orig_cut, model.cut_off + delta)
            a_srs = KU.pass_filter("lowpass", model.cut_off, a_srs,
                                   sample_rate, order=100)
            s_srs = demix(a_srs, bigshifts_srs)
            s_srs = KU.srs_shift(s_srs, "UP", orig_cut, model.cut_off + delta)
            s_srs = _fix_length(s_srs, source.shape[-1])
            if kind == "vocal":
                source = KU.make_ensemble("Max", [source, s_srs])
            else:
                # Linkwitz-Riley crossover blend: model's real band below,
                # SRS-recovered content above 16 kHz (:644-645)
                source = (
                    KU.linkwitz_riley("lowpass", 16000, source, sample_rate, 12)
                    + KU.linkwitz_riley("highpass", 16000, s_srs, sample_rate, 12)
                )
        # 2 - low SRS, vocal models only, single bigshift (:655-691)
        if kind == "vocal":
            cut_freq = 18550.0
            a_srs = KU.srs_shift(audio, "UP", orig_cut, cut_freq)
            if model.cut_off > 0:
                a_srs = KU.pass_filter("lowpass", model.cut_off, a_srs,
                                       sample_rate, order=100)
            s_srs = demix(a_srs, 1)
            s_srs = KU.srs_shift(s_srs, "DOWN", orig_cut, cut_freq)
            s_srs = _fix_length(s_srs, source.shape[-1])
            source = KU.make_ensemble("Max", [source, s_srs])

    return source * model.compensation


def _fix_length(audio: np.ndarray, size: int) -> np.ndarray:
    """librosa.util.fix_length semantics: trim or zero-pad the last axis."""
    if audio.shape[-1] >= size:
        return audio[..., :size]
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, size - audio.shape[-1])]
    return np.pad(audio, pad)


def bigshifts_demix(mix: np.ndarray, extractor: Extractor, bigshifts: int,
                    sr: int = 44100) -> np.ndarray:
    """Time-shift ensembling (reference demix_full)."""
    mix_length = mix.shape[-1] // sr
    bigshifts = max(1, min(bigshifts, max(mix_length - 1, 1)))
    demix_seconds = bigshifts
    while bigshifts * demix_seconds > mix_length and demix_seconds > 1:
        demix_seconds -= 1
    results = []
    for k in range(bigshifts):
        shift = int(k * demix_seconds * sr)
        shifted = np.roll(mix, shift, axis=-1)
        out = extractor(shifted)
        results.append(np.roll(out, -shift, axis=-1))
    n = min(r.shape[-1] for r in results)
    return np.mean([r[..., :n] for r in results], axis=0)


#: reference speed presets (inference.py:160-189): per-stage
#: (BigShifts, BigShifts_SRS) for the vocal / music / bleed extractions.
SPEED_PRESETS = {
    "Fastest": {"vocal": (1, 0), "music": (1, 0), "bleed": (1, 0)},
    "Fast": {"vocal": (1, 1), "music": (1, 0), "bleed": (1, 1)},
    "Medium": {"vocal": (1, 3), "music": (2, 0), "bleed": (2, 0)},
    "Slow": {"vocal": (2, 3), "music": (3, 0), "bleed": (2, 1)},
    "Slowest": {"vocal": (2, 4), "music": (4, 0), "bleed": (2, 2)},
}


@dataclass
class KarafanConfig:
    normalize_db: float = -1.0
    high_pass: float = 80.0
    low_pass: float = 16000.0
    infra_bass: bool = False
    silent_db: float = 0.0  # <0 enables the silence gate
    bigshifts: int = 1
    bigshifts_srs: int = 0  # >0 enables the SRS re-inference passes
    denoise: bool = True
    cache_dir: str | None = None  # GOD-MODE stem cache (reference :304-310)
    # per-stage (bigshifts, bigshifts_srs) overrides; None falls back to the
    # global pair above. The reference keys these off its speed option
    # (Quality_Vocal/Music/Bleed, inference.py:160-189) — use speed_preset().
    quality_vocal: tuple[int, int] | None = None
    quality_music: tuple[int, int] | None = None
    quality_bleed: tuple[int, int] | None = None

    def quality_for(self, kind: str) -> tuple[int, int]:
        """(bigshifts, bigshifts_srs) for a stage kind
        ('vocal'|'music'|'bleed')."""
        q = getattr(self, f"quality_{kind}", None)
        return tuple(q) if q is not None else (self.bigshifts, self.bigshifts_srs)


def speed_preset(name: str, **overrides) -> KarafanConfig:
    """Config from a reference speed option (Fastest..Slowest)."""
    if name not in SPEED_PRESETS:
        raise ValueError(f"unknown speed {name!r}, choose {list(SPEED_PRESETS)}")
    q = SPEED_PRESETS[name]
    return KarafanConfig(quality_vocal=q["vocal"], quality_music=q["music"],
                         quality_bleed=q["bleed"], **overrides)


@dataclass
class KarafanPipeline:
    """models: dict of stage name → list of extractors (or KarafanModel for
    per-model SRS/compensation metadata)."""

    music: Sequence[Extractor | KarafanModel] = ()
    vocal: Sequence[Extractor | KarafanModel] = ()
    bleed_music: Sequence[Extractor | KarafanModel] = ()
    bleed_vocal: Sequence[Extractor | KarafanModel] = ()
    remove_music: Sequence[Extractor | KarafanModel] = ()
    config: KarafanConfig = field(default_factory=KarafanConfig)

    # -- GOD-MODE stem cache --------------------------------------------------
    def _cache_path(self, song_key: str, stage: int, model: KarafanModel,
                    mix: np.ndarray, quality: tuple[int, int]) -> str | None:
        """One file per (song, stage input, model, extraction settings) —
        hash-keyed rather than name-keyed (the reference keys on the song
        name alone, which silently serves stale stems when settings change)."""
        cfg = self.config
        if cfg.cache_dir is None:
            return None
        h = hashlib.sha1()
        h.update(song_key.encode())
        h.update(np.ascontiguousarray(mix[..., :: max(1, mix.shape[-1] // 4096)]))
        h.update(f"{stage}|{model.name}|{model.cut_off}|{model.compensation}|"
                 f"{quality[0]}|{quality[1]}|{cfg.denoise}".encode())
        return os.path.join(cfg.cache_dir, f"{h.hexdigest()}.npy")

    def _extract(self, kind: str, stage: int,
                 models: Sequence[Extractor | KarafanModel], mix: np.ndarray,
                 song_key: str) -> np.ndarray | None:
        """Per-model treated extraction + ensemble-max (reference :346-523
        per-stage loops; ensembles are Max — 'because it's Vocals !!')."""
        if not models:
            return None
        cfg = self.config
        bigshifts, bigshifts_srs = cfg.quality_for(kind)
        outs = []
        for m in models:
            m = _as_model(m)
            path = self._cache_path(song_key, stage, m, mix,
                                    (bigshifts, bigshifts_srs))
            if path is not None and os.path.isfile(path):
                outs.append(np.load(path))
                continue
            out = extract_with_model(
                kind, mix, m, bigshifts=bigshifts,
                bigshifts_srs=bigshifts_srs, denoise=cfg.denoise)
            if path is not None:
                os.makedirs(cfg.cache_dir, exist_ok=True)
                np.save(path, out)
            outs.append(out)
        return outs[0] if len(outs) == 1 else KU.make_ensemble("Max", outs)

    def separate(self, audio: np.ndarray, sr: int,
                 stages: dict | None = None) -> dict:
        """``stages``: optional dict filled with the float intermediates
        (normalized / ensembles / finals) — the counterpart of the
        reference's per-stage Save_Audio files, used by the recipe
        equivalence tests."""
        cfg = self.config
        mix = _to_stereo_44k(audio, sr)
        normalized = KU.normalize(mix, cfg.normalize_db) if cfg.normalize_db < 0 else mix
        song_key = hashlib.sha1(
            np.ascontiguousarray(mix[..., : 44100 * 4])).hexdigest()

        # 1-2: music pre-pass then vocals on the residual
        music_ens = self._extract("music", 1, self.music, normalized, song_key)
        vocal_src = normalized if music_ens is None else normalized - music_ens
        vocal_ens = self._extract("vocal", 2, self.vocal, vocal_src, song_key)
        if vocal_ens is None:
            raise ValueError("karafan pipeline needs at least one vocal extractor")

        # 3: remove music bleed from vocals
        bleed = self._extract("bleed", 3, self.bleed_music, vocal_ens, song_key)
        vocal_final = vocal_ens if bleed is None else vocal_ens - bleed

        # 4: band-pass cleanup
        if cfg.high_pass > 0:
            vocal_final = KU.pass_filter("highpass", cfg.high_pass, vocal_final, 44100, 16)
        if cfg.low_pass < 22000:
            order = 16 if cfg.low_pass > 17000 else 8
            vocal_final = KU.pass_filter("lowpass", cfg.low_pass, vocal_final, 44100, order)

        # 5-6: music residual, vocal-bleed removal
        n = min(normalized.shape[-1], vocal_final.shape[-1])
        music_sub = normalized[..., :n] - vocal_final[..., :n]
        vbleed = self._extract("bleed", 5, self.bleed_vocal, music_sub, song_key)
        if vbleed is not None:
            mrem = self._extract("bleed", 6, self.remove_music, vbleed, song_key)
            if mrem is not None:
                vbleed = vbleed - mrem[..., : vbleed.shape[-1]]
            music_final = music_sub - vbleed[..., : music_sub.shape[-1]]
        else:
            music_final = music_sub

        # 7: final polish
        if cfg.infra_bass:
            vocal_final = KU.pass_filter("highpass", 18, vocal_final, 44100, 100)
            music_final = KU.pass_filter("highpass", 18, music_final, 44100, 100)
        if cfg.silent_db < 0:
            # the reference gates BOTH finals (inference.py:492,504)
            vocal_final = KU.silent(vocal_final, 44100, cfg.silent_db)
            music_final = KU.silent(music_final, 44100, cfg.silent_db)

        if stages is not None:
            stages.update(normalized=normalized, music_extract=music_ens,
                          vocal_extract=vocal_ens, music_bleed=bleed,
                          vocal_bleed=vbleed, vocal_final=vocal_final,
                          music_final=music_final)
        return {
            "sr": 44100,
            "vocals": remix_audio((vocal_final, 44100), to_int16=True),
            "instrumentals": remix_audio((music_final, 44100), to_int16=True),
            "input_audio": (mix, 44100),
        }
