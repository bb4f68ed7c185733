"""Where the time of one conversion goes on the card (rvc_tpu_torch).

    python3 scripts/profile_torch_convert.py [--seconds 30] [--dtype bfloat16]

Builds the 48k_v2 converter of chip_smoke.py (full width, random weights,
131072-row int8 bank), computing in ``--dtype`` (float32 by default, or
bfloat16), warms it up, then converts a slice of
assets/speech_65s.wav three times:
  1. plain: the wall time;
  2. with CUDA events around each stage (RMVPE, HuBERT, retrieval, text
     encoder, flow, decoder, RMS mix): device time per stage, the rest of
     the wall being host work and gaps;
  3. under torch.profiler: the device's busy share (kernel time over wall)
     and the kernels that take the most time.
Prints the card's name and power limit. Needs a CUDA card.
"""
import argparse
import functools
import os
import subprocess
import sys
import time
import wave

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rvc_tpu_torch.pipelines import convert  # noqa: E402


def speech(seconds, offset_s=10.0):
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "assets", "speech_65s.wav")
    with wave.open(path) as f:
        f.setpos(int(offset_s * 16000))
        raw = f.readframes(int(seconds * 16000))
    return np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0


class StageTimer:
    """CUDA events around calls, summed per stage name."""

    def __init__(self):
        self.events = []

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((name, start, end))
            return out
        return timed

    def totals(self):
        torch.cuda.synchronize()
        out = {}
        for name, s, e in self.events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    vc = convert.make_random_converter("48k_v2", chunking=(1, 5, 16, 20), index_rows=131072,
                                       device="cuda", dtype=getattr(torch, args.dtype))
    audio = speech(args.seconds)
    s = convert.ConvertSettings(f0_method="rmvpe", index_rate=0.75, protect=0.33)
    vc.convert(audio, settings=s)

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vc.convert(audio, settings=s)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"card: {card}; compute dtype {args.dtype}")
    print(f"{args.seconds:g} s of audio: wall ms {[round(w, 2) for w in walls]}, "
          f"RTF {args.seconds * 1e3 / min(walls):.2f}x (best of 3)")

    timer = StageTimer()
    rmvpe = vc.pitch.rmvpe
    rmvpe.forward = timer.wrap("rmvpe f0", rmvpe.forward)
    vc.hubert.extract_features = timer.wrap("hubert", vc.hubert.extract_features)
    convert.blend_into_q = timer.wrap("retrieval (kernel 3 + blend)", convert.blend_into_q)
    vc.synth.enc_p.forward = timer.wrap("text encoder (kernel 2)", vc.synth.enc_p.forward)
    vc.synth.flow.reverse = timer.wrap("flow", vc.synth.flow.reverse)
    vc.synth.dec.forward = timer.wrap("decoder (kernel 1)", vc.synth.dec.forward)
    convert.change_rms = timer.wrap("rms mix", convert.change_rms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vc.convert(audio, settings=s)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    stages = timer.totals()
    print(f"stages (CUDA events, one conversion, wall {wall:.2f} ms):")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {name:32s} {ms:9.2f} ms  {ms / wall:6.1%}")
    rest = wall - sum(stages.values())
    print(f"  {'host work and gaps (rest)':32s} {rest:9.2f} ms  {rest / wall:6.1%}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vc.convert(audio, settings=s)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        print("device busy share: not measured (the profiler saw no device time)")
        return
    print(f"profiled wall {wall:.2f} ms; kernel time {busy:.2f} ms; device busy "
          f"{busy / wall:.1%}, idle {1 - busy / wall:.1%}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:90]}")


if __name__ == "__main__":
    main()
