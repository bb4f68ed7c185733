"""WORLD-style DIO and Harvest pitch estimators.

Counterpart of ``rvc_tpu/pitch/world.py``, the same candidate-grid
algorithm in the same steps:

  1. a bank of Nuttall-window low-pass kernels (boundaries log-spaced at
     ``channels_in_octave`` per octave over [f0_floor, f0_ceil]) filters the
     signal, one product of the signal's windows with the whole bank;
  2. per band, four event-interval period estimates (negative- and
     positive-going zero crossings, peaks, dips) at each frame centre, by
     WORLD's midpoint linear interpolation of the interval values; the
     previous and next event times are running maxima (``cummax``, and
     ``flip`` -> ``cummax`` -> ``flip`` for JAX's reverse scans);
  3. per frame and band: the candidate (the mean of the four) and its score
     (their deviation over the candidate), a band proposing only f0 in
     [boundary / 2, boundary];
  4. DIO takes each frame's best-scored candidate; Harvest picks a path
     through the candidates by Viterbi over a 24-a-octave grid; both then
     run WORLD's FixF0Contour surgery.

Stonemask refinement (``pitch/extractor.stonemask_refine``) is the caller's.
Harvest's Viterbi is a Python loop of three launches a frame on the card,
its backtrace a loop on the host.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

HUBERT_SR = 16000
HUBERT_WINDOW = 160
_VITERBI_BLOCK = 512  # frames whose transition costs are formed at once
_FILTER_SEGMENT = 1 << 17  # samples the filter bank takes at once (335 MB of windows)


@functools.lru_cache(maxsize=None)
def _nuttall_bank(sr: int, f0_floor: float, f0_ceil: float,
                  channels_in_octave: float) -> tuple[np.ndarray, np.ndarray]:
    """Low-pass FIR bank: one unit-DC-gain Nuttall window per boundary f0
    (support about two periods of the boundary), centred in a common
    K = 2 sr / f0_floor + 1 buffer. Returns (kernels (n_bands, K),
    boundaries (n_bands,))."""
    n_bands = int(np.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave))
    boundaries = f0_floor * 2.0 ** ((np.arange(n_bands) + 1.0)
                                    / channels_in_octave)
    K = 2 * int(round(sr / f0_floor)) + 1
    kernels = np.zeros((n_bands, K), np.float32)
    for j, b in enumerate(boundaries):
        half = int(round(sr / b / 2.0)) * 2  # 2 periods total support
        n = np.arange(2 * half + 1)
        x = n / (2 * half)
        w = (0.355768 - 0.487396 * np.cos(2 * np.pi * x)
             + 0.144232 * np.cos(4 * np.pi * x)
             - 0.012604 * np.cos(6 * np.pi * x))
        w /= w.sum()
        c = K // 2
        kernels[j, c - half: c + half + 1] = w
    return kernels, boundaries.astype(np.float32)


def _cummax(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Running maximum over the last axis; ``reverse`` runs it from the end."""
    if reverse:
        return torch.flip(torch.cummax(torch.flip(x, (-1,)), -1).values, (-1,))
    return torch.cummax(x, -1).values


def _event_f0_tracks(x: torch.Tensor, centers: torch.Tensor, sr: int) -> torch.Tensor:
    """Per-event-type f0 at each frame centre. x (..., T) band-filtered;
    centers (F,) sample indices. Returns (4, ..., F) Hz, nan where a frame
    has no enclosing event pair.

    For crossing times t_0 < t_1 < ..., interval i has the value
    sr / (t_{i+1} - t_i) at its midpoint; the track is interpolated at the
    centres and clamped at its ends. The enclosing pair (t1, t2) comes from
    the previous/next event-time tracks, and the neighbours t0 and t3 from
    the same tracks read one slot beyond, which gives the intervals
    A = (t0, t1), B = (t1, t2), C = (t2, t3)."""
    T = x.shape[-1]
    inf = torch.tensor(float("inf"), device=x.device)
    dx = x[..., 1:] - x[..., :-1]
    t_idx = torch.arange(T - 1, device=x.device, dtype=torch.float32)
    c = torch.clamp(centers, max=T - 2)
    cf = c.to(torch.float32)
    tracks = []
    for sig in (x[..., :-1], -x[..., :-1], dx, -dx):
        nxt = torch.cat([sig[..., 1:], sig[..., -1:]], -1)
        mask = (sig > 0) & (nxt <= 0)  # a negative-going crossing in [t, t + 1)
        frac = torch.where(mask, sig / torch.clamp(sig - nxt, min=1e-12), 0.0)
        times = t_idx + frac
        prev_t = _cummax(torch.where(mask, times, -inf))
        next_t = -_cummax(torch.where(mask, -times, -inf), reverse=True)
        # the previous event strictly before slot s, the next strictly after
        prev_excl = torch.cat([torch.full_like(prev_t[..., :1], -inf), prev_t[..., :-1]], -1)
        next_excl = torch.cat([next_t[..., 1:], torch.full_like(next_t[..., :1], inf)], -1)
        t1 = prev_t[..., c]  # the last event at or before the centre
        t2 = next_t[..., c]  # the next event at or after it
        s1 = torch.clamp(torch.nan_to_num(t1, neginf=0.0), 0, T - 2).to(torch.int64)
        s2 = torch.clamp(torch.nan_to_num(t2, posinf=T - 2), 0, T - 2).to(torch.int64)
        t0 = torch.gather(prev_excl, -1, s1)
        t3 = torch.gather(next_excl, -1, s2)

        def iv(lo, hi):
            d = hi - lo
            v = torch.where((d > 0) & torch.isfinite(d), sr / torch.clamp(d, min=1e-6), torch.nan)
            return 0.5 * (lo + hi), v  # the midpoint is +-inf where an end is missing

        mA, vA = iv(t0, t1)
        mB, vB = iv(t1, t2)
        mC, vC = iv(t2, t3)
        left = cf < mB  # the centre sits before interval B's midpoint
        m_lo = torch.where(left, mA, mB)
        v_lo = torch.where(left, vA, vB)
        m_hi = torch.where(left, mB, mC)
        v_hi = torch.where(left, vB, vC)
        denom = m_hi - m_lo
        w = torch.clamp(torch.where(torch.isfinite(denom) & (denom > 0),
                               (cf - m_lo) / torch.where(denom > 0, denom, 1.0), 1.0), 0.0, 1.0)
        est = v_lo + w * (v_hi - v_lo)
        # end clamping: the single valid side, nan without an enclosing pair
        est = torch.where(torch.isfinite(m_lo) & torch.isfinite(v_lo), est,
                     torch.where(torch.isfinite(v_hi), v_hi, torch.nan))
        est = torch.where(torch.isfinite(m_hi) & torch.isfinite(v_hi), est,
                     torch.where(torch.isfinite(v_lo), v_lo, torch.nan))
        est = torch.where(torch.isfinite(t1) | torch.isfinite(t2), est, torch.nan)
        tracks.append(est)
    return torch.stack(tracks, 0)


def _nanmean0(x: torch.Tensor) -> torch.Tensor:
    """Mean over axis 0 of the values that are not nan (nan where none is)."""
    ok = ~torch.isnan(x)
    return torch.sum(torch.where(ok, x, 0.0), 0) / torch.sum(ok, 0)


def _bank_filter(audio: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """audio (B, T) correlated with each kernel of ``bank`` (n_bands, K), K
    odd, centred with zero padding: (B, n_bands, T). Each segment of
    ``_FILTER_SEGMENT`` outputs is one product of its (B, S, K) windows with
    the bank (a 1-in-channel conv with a 641-tap kernel is a slow path of
    the CPU's conv library)."""
    K = bank.shape[1]
    x = F.pad(audio, (K // 2, K // 2))
    T = audio.shape[-1]
    out = [torch.matmul(x[:, s: s + _FILTER_SEGMENT + K - 1].unfold(-1, K, 1), bank.T)
           for s in range(0, T, _FILTER_SEGMENT)]
    return torch.cat(out, 1).transpose(1, 2)


def _band_candidates(audio: torch.Tensor, sr: int, hop: int, f0_floor: float,
                     f0_ceil: float, channels_in_octave: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """All-band candidate grid. audio (B, T) -> (cand (B, n_bands, F) Hz,
    0 where invalid; score (B, n_bands, F), lower is better, inf where
    invalid)."""
    kernels_np, boundaries = _nuttall_bank(
        sr, float(f0_floor), float(f0_ceil), float(channels_in_octave))
    B, T = audio.shape
    K = kernels_np.shape[1]
    n_frames = T // hop + 1
    filt = _bank_filter(audio.float(), torch.from_numpy(kernels_np).to(audio.device))
    filt = filt - filt.mean(-1, keepdim=True)
    centers = torch.arange(n_frames, device=audio.device) * hop
    est = _event_f0_tracks(filt, centers, sr)  # (4, B, n_bands, F)
    est = torch.where(torch.isfinite(est) & (est > 0), est, torch.nan)
    cand = _nanmean0(est)
    dev = torch.sqrt(_nanmean0(torch.square(est - cand[None])))
    bnd = torch.from_numpy(boundaries).to(audio.device)[None, :, None]
    # WORLD's band gate: a channel proposes only f0 in [boundary / 2, boundary]
    ok = (torch.isfinite(cand) & (cand >= bnd * 0.5) & (cand <= bnd)
          & (cand >= f0_floor) & (cand <= f0_ceil) & torch.all(torch.isfinite(est), 0))
    score = torch.where(ok, dev / torch.clamp(cand, min=1e-6), torch.inf)
    return torch.where(ok, cand, 0.0), score


def _fix_step1(f0: torch.Tensor, allowed_range: float = 0.1) -> torch.Tensor:
    """WORLD FixStep1: a voiced frame whose relative jump from its
    predecessor exceeds ``allowed_range`` becomes unvoiced."""
    prev = torch.cat([f0[..., :1], f0[..., :-1]], -1)
    nxt = torch.cat([f0[..., 1:], f0[..., -1:]], -1)
    ref = torch.where(prev > 0, prev, nxt)
    jump = torch.abs(f0 - ref) / torch.clamp(ref, min=1e-6)
    bad = (f0 > 0) & (ref > 0) & (jump > allowed_range)
    return torch.where(bad, 0.0, f0)


def _run_lengths(voiced: torch.Tensor) -> torch.Tensor:
    """Length of the run of equal values each frame belongs to, (..., F)
    bool -> (..., F) int64: the run's start is a running maximum over the
    change points, its end a reversed one."""
    n = voiced.shape[-1]
    t = torch.arange(n, device=voiced.device)
    changed = torch.cat([torch.ones_like(voiced[..., :1]), voiced[..., 1:] != voiced[..., :-1]], -1)
    start = _cummax(torch.where(changed, t, -1))
    change_next = torch.cat([changed[..., 1:], torch.ones_like(changed[..., :1])], -1)
    end = -_cummax(torch.where(change_next, -t, -n), reverse=True)
    return end - start + 1


def _fix_f0_contour(f0: torch.Tensor, cand: torch.Tensor, allowed_range: float,
                    min_voiced_frames: int, max_extend: int) -> torch.Tensor:
    """WORLD FixF0Contour: Step1 rapid-jump removal; Step2 voiced segments
    shorter than ``min_voiced_frames`` unvoiced; Steps 3/4 an unvoiced frame
    within ``max_extend`` frames of a voiced segment's edge re-voiced with
    the band candidate closest to the edge's value, where that candidate is
    within ``allowed_range`` of it. f0 (B, F); cand (B, n_bands, F)."""
    f0 = _fix_step1(f0, allowed_range)
    voiced = f0 > 0
    if min_voiced_frames > 1:
        f0 = torch.where(voiced & (_run_lengths(voiced) < min_voiced_frames), 0.0, f0)
        voiced = f0 > 0
    if max_extend <= 0:
        return f0
    n = f0.shape[-1]
    t = torch.arange(n, device=f0.device)
    big = n + max_extend + 1
    # the nearest voiced frame at or before t, and at or after it
    last_idx = _cummax(torch.where(voiced, t, -1))
    fwd_val = torch.gather(f0, -1, torch.clamp(last_idx, min=0))
    fwd_dist = torch.where(last_idx >= 0, t - last_idx, big)
    next_idx = -_cummax(torch.where(voiced, -t, -big), reverse=True)
    bwd_val = torch.gather(f0, -1, torch.clamp(next_idx, max=n - 1))
    bwd_dist = torch.where(next_idx < n, next_idx - t, big)
    use_fwd = fwd_dist <= bwd_dist
    edge_val = torch.where(use_fwd, fwd_val, bwd_val)
    edge_dist = torch.minimum(fwd_dist, bwd_dist)
    # the candidate closest to the edge's value (WORLD SelectBestF0)
    dev = torch.abs(cand - edge_val[:, None, :]) / torch.clamp(edge_val[:, None, :], min=1e-6)
    dev = torch.where(cand > 0, dev, torch.inf)
    best = torch.argmin(dev, 1, keepdim=True)
    best_val = torch.gather(cand, 1, best)[:, 0]
    best_dev = torch.gather(dev, 1, best)[:, 0]
    extend = (~voiced) & (edge_dist <= max_extend) & (best_dev < allowed_range)
    return torch.where(extend, best_val, f0)


def dio(audio: torch.Tensor, sr: int = HUBERT_SR, hop: int = HUBERT_WINDOW,
        f0_floor: float = 50.0, f0_ceil: float = 1100.0, channels_in_octave: float = 2.0,
        score_threshold: float | None = None) -> torch.Tensor:
    """DIO: audio (B, T) -> (B, T // hop + 1) Hz, 0 where unvoiced. Each
    frame takes its lowest-scored band candidate, voiced where the score is
    at most ``score_threshold`` (None: 0.24 / channels_in_octave), then
    FixF0Contour with WORLD's 50 ms minimum voiced length."""
    if score_threshold is None:
        score_threshold = 0.24 / channels_in_octave
    cand, score = _band_candidates(audio, sr, hop, f0_floor, f0_ceil, channels_in_octave)
    best = torch.argmin(score, 1, keepdim=True)
    f0 = torch.gather(cand, 1, best)[:, 0]
    s = torch.gather(score, 1, best)[:, 0]
    f0 = torch.where(s <= score_threshold, f0, 0.0)
    frame_ms = 1000.0 * hop / sr
    min_voiced = max(2, int(round(50.0 / frame_ms)))
    return _fix_f0_contour(f0, cand, allowed_range=0.1, min_voiced_frames=min_voiced,
                           max_extend=10)


def _viterbi_path(emit: torch.Tensor, log_f: torch.Tensor, voiced: torch.Tensor,
                  transition_cost: float) -> torch.Tensor:
    """The least-cost band path (B, F) through emission costs (B, n_bands,
    F), a step from a voiced candidate costing ``transition_cost`` times its
    |log2| jump to the next frame's candidate (a step from an unvoiced one is
    free). Ties go to the lowest band, as ``argmin`` breaks them."""
    n = emit.shape[-1]
    cost = emit[:, :, 0]
    emit_t = emit.permute(2, 0, 1).contiguous()  # (F, B, n_bands)
    backs = []
    for t0 in range(1, n, _VITERBI_BLOCK):
        t1 = min(t0 + _VITERBI_BLOCK, n)
        # the block's transition costs, formed at once: (frames, B, prev, cur)
        prev_lf = torch.where(voiced[:, :, t0 - 1: t1 - 1], log_f[:, :, t0 - 1: t1 - 1], 0.0)
        trans = torch.where(voiced[:, :, None, t0 - 1: t1 - 1],
                            torch.abs(log_f[:, None, :, t0:t1] - prev_lf[:, :, None, :]), 0.0)
        trans = (transition_cost * trans).permute(3, 0, 1, 2).contiguous()
        for k in range(t1 - t0):
            best, back = torch.min(cost[:, :, None] + trans[k], 1)
            cost = best + emit_t[t0 + k]
            backs.append(back)
    idx = torch.argmin(cost, 1).cpu()
    path = [idx]
    for back in reversed(torch.stack(backs).cpu() if backs else []):
        idx = torch.gather(back, 1, idx[:, None])[:, 0]
        path.append(idx)
    return torch.stack(path[::-1], 1).to(emit.device)


def harvest(audio: torch.Tensor, sr: int = HUBERT_SR, hop: int = HUBERT_WINDOW,
            f0_floor: float = 50.0, f0_ceil: float = 1100.0,
            channels_in_octave: float = 24.0, score_threshold: float | None = None,
            transition_cost: float = 0.35) -> torch.Tensor:
    """Harvest: the candidate grid at 24 bands an octave, the path chosen by
    a Viterbi over the bands (emission: the score; transition:
    ``transition_cost`` times the octave jump), voiced where the path's score
    is at most ``score_threshold`` (None: 0.24 / channels_in_octave), then
    FixF0Contour with a two-frame minimum. audio (B, T) -> (B, T // hop + 1)
    Hz."""
    if score_threshold is None:
        score_threshold = 0.24 / channels_in_octave
    cand, score = _band_candidates(audio, sr, hop, f0_floor, f0_ceil, channels_in_octave)
    log_f = torch.log2(torch.clamp(cand, min=1e-6))
    emit = torch.where(torch.isfinite(score), score, 1e3)
    path = _viterbi_path(emit, log_f, cand > 0, transition_cost)[:, None, :]
    f0 = torch.gather(cand, 1, path)[:, 0]
    s = torch.gather(emit, 1, path)[:, 0]
    f0 = torch.where(s <= score_threshold, f0, 0.0)
    return _fix_f0_contour(f0, cand, allowed_range=0.18, min_voiced_frames=2, max_extend=10)
