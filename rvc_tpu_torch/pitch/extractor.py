"""Pitch extraction: every f0 method, the hybrid merge, coarse quantization.

Counterpart of ``rvc_tpu/pitch/extractor.py``:

  * rmvpe / rmvpe+: the RMVPE network (``models/rmvpe.py``);
  * crepe / crepe-tiny: the CREPE network (``models/crepe.py``), Viterbi
    decoded at the 160-sample hop, then a 3-frame median on the
    periodicity, a 3-frame mean on f0 and a 0.1 periodicity gate;
    mangio-crepe / mangio-crepe-tiny: weighted-argmax decoded at a caller's
    hop, resized to the 100 Hz grid;
  * pm: a windowed-autocorrelation estimator (``acf_pitch``: the ACF from
    the DFT power as products, parabolic peak refinement, an octave cost);
  * dio / harvest: WORLD's candidate-grid algorithms (``pitch/world.py``),
    each refined by ``stonemask_refine``; harvest then takes the
    ``filter_radius`` median pass;
  * a list of methods: each one's f0, cut to the shortest and merged frame
    by frame by a nan-aware reducer over the voiced values (``nan_merge``).

``coarse_f0`` quantizes to the synthesizer's 256 mel bins. The products of
``acf_pitch`` and ``stonemask_refine`` are full float32, as the JAX
package's ``Precision.HIGHEST``: ``PitchExtractor`` turns TF32 off
(``device.set_float32_math``).
"""
from __future__ import annotations

import functools
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import set_float32_math
from ..models import crepe as crepe_mod
from ..models.crepe import CrepeNet
from ..models.layers import set_dtype_
from ..models.rmvpe import RMVPE
from ..ops.filters import median_filter_1d
from ..ops.stft import frame_signal
from . import world

F0_BINS = 256
HUBERT_SR = 16000
HUBERT_WINDOW = 160
METHODS = ("pm", "dio", "harvest", "rmvpe", "rmvpe+", "crepe", "crepe-tiny",
           "mangio-crepe", "mangio-crepe-tiny")


def coarse_f0(f0: torch.Tensor, f0_min: float = 50.0, f0_max: float = 1100.0) -> torch.Tensor:
    """f0 Hz -> 1..255 mel bins (int64)."""
    mel_min = 2595.0 * np.log10(1.0 + f0_min / 700.0)
    mel_max = 2595.0 * np.log10(1.0 + f0_max / 700.0)
    mel = 2595.0 * torch.log10(1.0 + f0 / 700.0)
    mel = (mel - mel_min) * (F0_BINS - 2) / (mel_max - mel_min) + 1.0
    return torch.round(torch.clamp(mel, 1.0, F0_BINS - 1)).to(torch.int64)


def shift_semitones(f0: torch.Tensor, semitones: float) -> torch.Tensor:
    return f0 * (2.0 ** (semitones / 12.0))


def autotune(f0: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Snap to the 72-note equal-tempered table."""
    notes = torch.as_tensor(440.0 * 2.0 ** ((np.arange(72) - 33) / 12.0),
                            dtype=f0.dtype, device=f0.device)
    diff = torch.abs(notes - f0[..., None])
    best, idx = torch.min(diff, dim=-1)
    return torch.where(best < threshold, f0, notes[idx])


def median_pass(f0: torch.Tensor, radius: int) -> torch.Tensor:
    """The optional f0 median filter (applied where radius > 2)."""
    return median_filter_1d(f0, radius) if radius > 2 else f0


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] per row of the last axis: (..., n) and (...) -> (...)."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _parabolic_delta(ym1: torch.Tensor, y0: torch.Tensor, yp1: torch.Tensor) -> torch.Tensor:
    """The parabola's peak offset through three points, within +-0.5."""
    denom = ym1 - 2 * y0 + yp1
    delta = torch.where(torch.abs(denom) > 1e-9, 0.5 * (ym1 - yp1) / denom, 0.0)
    return torch.clamp(delta, -0.5, 0.5)


# ---------------------------------------------------------------------------
# pm: the autocorrelation estimator
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _acf_bases(frame_length: int, n_fft: int, max_lag: int) -> tuple[np.ndarray, ...]:
    """The rectangular-window DFT of a frame zero-padded to ``n_fft`` (its
    first ``frame_length`` rows: the rest meet zeros), and the bases
    acf[tau] = sum_k w_k |X_k|^2 cos(2 pi k tau / N) / N over the half
    spectrum."""
    n_bins = n_fft // 2 + 1
    kk = np.arange(frame_length)[:, None] * np.arange(n_bins)[None, :]
    cosb = np.cos(2 * np.pi * kk / n_fft).astype(np.float32)
    sinb = (-np.sin(2 * np.pi * kk / n_fft)).astype(np.float32)
    k = np.arange(n_bins)[:, None]
    tau = np.arange(max_lag + 1)[None, :]
    wk = np.full((n_bins, 1), 2.0)
    wk[0] = 1.0
    if n_fft % 2 == 0:
        wk[-1] = 1.0
    acf = (np.cos(2 * np.pi * k * tau / n_fft) / n_fft * wk).astype(np.float32)
    return cosb, sinb, acf


def _on(x: torch.Tensor, *arrays: np.ndarray) -> list[torch.Tensor]:
    return [torch.from_numpy(a).to(x.device) for a in arrays]


def acf_pitch(audio: torch.Tensor, sr: int = HUBERT_SR, hop: int = HUBERT_WINDOW,
              f0_min: float = 50.0, f0_max: float = 1100.0, frame_length: int = 1024,
              voicing_threshold: float = 0.45, octave_cost: float = 0.01) -> torch.Tensor:
    """Windowed-autocorrelation f0 with parabolic peak refinement: audio
    (B, T) -> (B, 1 + T // hop) Hz, 0 where unvoiced. The ACF is the
    inverse transform of the frame's DFT power, zero-padded to twice the
    frame so that it is the linear ACF; the peak is the highest normalized
    ACF between the lags of f0_max and f0_min, less an octave cost that
    favours the shorter lag."""
    n_fft = 2 * frame_length
    pad = frame_length // 2
    frames = frame_signal(F.pad(audio, (pad, pad)), frame_length, hop)
    frames = frames - frames.mean(-1, keepdim=True)
    min_lag = max(int(sr / f0_max), 2)
    max_lag = min(int(sr / f0_min) + 1, frame_length - 2)
    cosb, sinb, acf_basis = _on(audio, *_acf_bases(frame_length, n_fft, max_lag))
    re = torch.matmul(frames, cosb)
    im = torch.matmul(frames, sinb)
    acf = torch.matmul(re * re + im * im, acf_basis)
    nacf = acf / torch.clamp(acf[..., :1], min=1e-9)

    lags = torch.arange(max_lag + 1, device=audio.device)
    valid = (lags >= min_lag) & (lags <= max_lag)
    score = nacf - octave_cost * torch.log2(torch.clamp(lags, min=1) / min_lag)
    best = torch.argmax(torch.where(valid, score, -torch.inf), -1)
    y0 = _gather(nacf, best)
    delta = _parabolic_delta(_gather(nacf, torch.clamp(best - 1, 0, max_lag)), y0,
                             _gather(nacf, torch.clamp(best + 1, 0, max_lag)))
    f0 = sr / torch.clamp(best.float() + delta, min=1.0)
    return torch.where((y0 > voicing_threshold) & (best >= min_lag), f0, 0.0)


# ---------------------------------------------------------------------------
# StoneMask refinement (pyworld's second stage after dio and harvest)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _spec_bases(frame_length: int, n_fft: int, n_bins: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``n_bins`` of a Hann-windowed frame's DFT zero-padded to
    ``n_fft``, as products over the frame's own samples."""
    n = np.arange(frame_length)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * n / frame_length)
    ang = 2 * np.pi * n[:, None] * np.arange(n_bins)[None, :] / n_fft
    return ((np.cos(ang) * win[:, None]).astype(np.float32),
            (np.sin(ang) * win[:, None]).astype(np.float32))


def stonemask_refine(audio: torch.Tensor, f0: torch.Tensor, sr: int = HUBERT_SR,
                     hop: int = HUBERT_WINDOW, frame_length: int = 1024, n_fft: int = 4096,
                     search: float = 0.2, K: int = 64) -> torch.Tensor:
    """Each voiced frame's f0 moved to the highest power-spectrum bin within
    +-``search`` of it (of the K + 1 bins around it, on the 4096-point grid
    of the zero-padded frame), refined by a parabola through the log power.
    A frame whose window holds under two periods, or with no bin in the
    band, keeps its candidate; unvoiced frames stay 0. audio (B, T); f0
    (B, F) Hz on the same hop grid."""
    pad = frame_length // 2
    frames = frame_signal(F.pad(audio, (pad, pad)), frame_length, hop)[:, : f0.shape[1]]
    f0 = f0[:, : frames.shape[1]]
    n_bins = min(n_fft // 2 + 1, int(np.ceil(1100.0 * 1.3 * n_fft / sr)) + K + 2)
    cosb, sinb = _on(audio, *_spec_bases(frame_length, n_fft, n_bins))
    re = torch.matmul(frames, cosb)
    im = torch.matmul(frames, sinb)
    power = re * re + im * im  # (B, F, n_bins)

    bin_hz = sr / n_fft
    center = torch.clamp(torch.round(f0 / bin_hz).to(torch.int64), 0, n_bins - 1)
    offs = torch.arange(-(K // 2), K // 2 + 1, device=audio.device)
    idx = torch.clamp(center[..., None] + offs, 0, n_bins - 1)  # (B, F, K + 1)
    freq = idx.float() * bin_hz
    ok = ((freq >= f0[..., None] * (1.0 - search)) & (freq <= f0[..., None] * (1.0 + search))
          & (f0[..., None] > 0))
    j = torch.argmax(torch.where(ok, torch.gather(power, -1, idx), -1.0), -1)
    peak_bin = _gather(idx, j)
    logp = torch.log(torch.clamp(power, min=1e-12))
    delta = _parabolic_delta(_gather(logp, torch.clamp(peak_bin - 1, 0, n_bins - 1)),
                             _gather(logp, peak_bin),
                             _gather(logp, torch.clamp(peak_bin + 1, 0, n_bins - 1)))
    refined = (peak_bin.float() + delta) * bin_hz
    resolvable = f0 * frame_length / sr >= 2.0
    out = torch.where(resolvable & torch.any(ok, -1), refined, f0)
    return torch.where(f0 > 0, out, 0.0)


# ---------------------------------------------------------------------------
# hybrid merge
# ---------------------------------------------------------------------------


def nan_merge(stack: torch.Tensor, merge_type: str = "median") -> torch.Tensor:
    """Merge over the method axis (0) of the voiced (> 0) values: median (of
    an even count, the mean of the two middle values, as ``jnp.nanmedian``),
    mean, min or max (another name: median); 0 where no method voices."""
    voiced = stack > 0
    count = voiced.sum(0)
    if merge_type == "mean":
        merged = torch.where(voiced, stack, 0.0).sum(0) / count
    elif merge_type == "min":
        merged = torch.where(voiced, stack, torch.inf).amin(0)
    elif merge_type == "max":
        merged = torch.where(voiced, stack, -torch.inf).amax(0)
    else:  # nan sorts last
        s = torch.sort(torch.where(voiced, stack, torch.nan), 0).values
        lo = torch.clamp((count - 1) // 2, min=0)[None]
        hi = torch.clamp(count // 2, max=stack.shape[0] - 1)[None]
        merged = (torch.gather(s, 0, lo) + torch.gather(s, 0, hi))[0] * 0.5
    return torch.where(count > 0, merged, 0.0)


def _linspace(stop: int, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0, stop, num)`` in float32 as it comes out of XLA:
    i times float32(stop) / float32(num - 1), the last point ``stop``
    itself."""
    if num <= 1:
        return torch.zeros(num, device=device)
    delta = torch.tensor(float(stop), device=device) / (num - 1)
    step = delta * torch.arange(num - 1, device=device, dtype=torch.float32)
    return torch.cat([step, torch.full((1,), float(stop), device=device)])


class PitchExtractor:
    """Holds the pitch models; ``method_fn`` builds one method's f0 function,
    ``compute`` and ``get_f0`` run a method or a list of them. ``dtype`` is
    the networks' compute dtype, as JAX's ``PitchExtractor(dtype=)``; f0
    comes out in float32. A method whose weights are absent raises
    ``KeyError``, as an unknown method does."""

    def __init__(self, rmvpe: RMVPE | None = None, crepe: CrepeNet | None = None,
                 crepe_tiny: CrepeNet | None = None, dtype: torch.dtype = torch.float32):
        self.rmvpe = rmvpe
        self.crepe = crepe
        self.crepe_tiny = crepe_tiny
        self.dtype = dtype
        for model in (rmvpe, crepe, crepe_tiny):
            if model is not None:
                set_dtype_(model, dtype)
        set_float32_math()

    def to(self, device) -> "PitchExtractor":
        """The networks moved to ``device``, in eval mode."""
        for name in ("rmvpe", "crepe", "crepe_tiny"):
            model = getattr(self, name)
            if model is not None:
                setattr(self, name, model.to(device).eval())
        return self

    def _model(self, name: str):
        model = getattr(self, name)
        if model is None:
            raise KeyError(f"{name.replace('_', '-')} weights are not loaded")
        return model

    def method_fn(self, method: str, f0_min: float = 50.0, f0_max: float = 1100.0,
                  filter_radius: int = 3, crepe_hop_length: int = 160
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
        """(B, T) 16 kHz -> f0 Hz (B, F): F = T // 160 + 1, and T // 160 for
        a mangio method at another hop than 160."""
        if method not in METHODS:
            raise KeyError(f"pitch method {method!r} not found")
        if method in ("rmvpe", "rmvpe+"):
            model = self._model("rmvpe")

            def fn(audio):
                f0 = model(audio, 0.03)
                return torch.clamp(f0, f0_min, f0_max) if method == "rmvpe+" else f0
        elif "crepe" in method:
            net = self._model("crepe_tiny" if method.endswith("tiny") else "crepe")
            mangio = method.startswith("mangio")
            hop = crepe_hop_length if mangio else HUBERT_WINDOW

            def fn(audio):
                return self._crepe(net, audio, f0_min, f0_max, mangio, hop)
        elif method == "pm":
            def fn(audio):
                return acf_pitch(audio, f0_min=f0_min, f0_max=f0_max, voicing_threshold=0.45)
        elif method == "dio":
            def fn(audio):
                return stonemask_refine(audio, world.dio(audio, f0_floor=f0_min, f0_ceil=f0_max))
        else:
            def fn(audio):
                f0 = world.harvest(audio, f0_floor=f0_min, f0_ceil=f0_max)
                return median_pass(stonemask_refine(audio, f0), filter_radius)
        return torch.no_grad()(fn)

    @staticmethod
    def _crepe(net: CrepeNet, audio: torch.Tensor, f0_min: float, f0_max: float,
               mangio: bool, hop: int) -> torch.Tensor:
        f0, pd = crepe_mod.predict(net, audio, hop, f0_min, f0_max,
                                   "weighted_argmax" if mangio else "viterbi")
        if not mangio:
            # the reference's median(pd, 3), mean(f0, 3), zero where pd < 0.1
            pd = median_filter_1d(pd, 3)
            f0 = F.conv1d(F.pad(f0, (1, 1))[:, None], torch.full(
                (1, 1, 3), 1.0 / 3.0, device=f0.device))[:, 0]
            f0 = torch.where(pd < 0.1, 0.0, f0)
        if hop != HUBERT_WINDOW:  # linear resize to the 100 Hz grid
            n = f0.shape[-1]
            pos = _linspace(n - 1, audio.shape[-1] // HUBERT_WINDOW, f0.device)
            lo = torch.floor(pos).to(torch.int64)
            hi = torch.clamp(lo + 1, max=n - 1)
            w = pos - lo
            f0 = f0[..., lo] * (1 - w) + f0[..., hi] * w
        return f0

    def compute(self, audio: torch.Tensor, method: str | Sequence[str] = "rmvpe",
                merge_type: str = "median", f0_min: float = 50.0, f0_max: float = 1100.0,
                filter_radius: int = 3, crepe_hop_length: int = 160) -> torch.Tensor:
        """(B, T) 16 kHz -> f0 Hz at the 100 Hz frame grid; a list of methods
        is merged by ``merge_type`` over its shortest length."""
        if isinstance(method, (list, tuple)) and len(method) == 1:
            method = method[0]
        if isinstance(method, str):
            return self.method_fn(method, f0_min, f0_max, filter_radius, crepe_hop_length)(audio)
        outs = [self.compute(audio, m, merge_type, f0_min, f0_max, filter_radius,
                             crepe_hop_length) for m in method]
        n = min(o.shape[-1] for o in outs)
        return nan_merge(torch.stack([o[..., :n] for o in outs]), merge_type)

    def get_f0(self, audio: torch.Tensor, f0_up_key: float = 0.0,
               method: str | Sequence[str] = "rmvpe", merge_type: str = "median",
               filter_radius: int = 3, crepe_hop_length: int = 160, f0_autotune: bool = False,
               f0_min: float = 50.0, f0_max: float = 1100.0
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(coarse bins (int64), f0 Hz) after autotune (if asked) and the
        shift of ``f0_up_key`` semitones."""
        f0 = self.compute(audio, method, merge_type, f0_min, f0_max, filter_radius,
                          crepe_hop_length)
        if f0_autotune:
            f0 = autotune(f0)
        # one method: the factor in float32, as JAX's jitted chain forms it;
        # a list: in double, rounded to float32 at the product, as its eager
        # path does
        f0 = shift_semitones(f0, np.float32(f0_up_key) if isinstance(method, str)
                             else float(f0_up_key))
        return coarse_f0(f0, f0_min, f0_max), f0
