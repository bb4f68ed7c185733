"""Timing and tracing helpers (``rvc_tpu/utils/profiling.py``): a stage
timer that reports the real-time factor, a ``torch.profiler`` trace for
TensorBoard, and a per-epoch wall clock.

``StageTimer`` reads the host clock: around work on the card it measures
the queueing unless the stage ends in ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    """Wall time per named stage; reports the RTF for ``audio_seconds``."""

    times: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, audio_seconds: float | None = None) -> str:
        total = sum(self.times.values())
        lines = []
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            pct = 100 * t / total if total else 0
            lines.append(f"{name:24s} {t:8.3f}s {pct:5.1f}% (n={self.counts[name]})")
        if audio_seconds:
            lines.append(f"{'RTF':24s} {audio_seconds / max(total, 1e-9):8.2f}x")
        return "\n".join(lines)

    def to_json(self, audio_seconds: float | None = None) -> str:
        d = {"stages": dict(self.times), "counts": dict(self.counts)}
        if audio_seconds:
            d["rtf"] = audio_seconds / max(sum(self.times.values()), 1e-9)
        return json.dumps(d)


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace of the block (host activity, and the
    card's where there is one), written into ``logdir`` as a
    ``*.pt.trace.json`` file that TensorBoard's profiler plugin and
    chrome://tracing read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class EpochRecorder:
    """Wall-clock seconds since the previous ``record`` (or construction)."""

    def __init__(self):
        self.last = time.time()

    def record(self) -> str:
        now = time.time()
        elapsed = now - self.last
        self.last = now
        return time.strftime("[%Y-%m-%d %H:%M:%S]") + f" | ({elapsed:.1f}s/epoch)"
