"""What holding cuDNN to its deterministic engines would cost a conversion
on the card, and whether repeated conversions give the same bits either
way.

    python3 scripts/bench_torch_cudnn_pin.py [--calls 6]

A conversion lets cuDNN pick any engine, some of which sum with atomics.
This script converts with ``torch.backends.cudnn.deterministic`` off
("free", the port's setting) and on ("pinned"), in turns (free, pinned,
pinned, free, ...) in one process: make_random_converter("48k_v2") at full
width in float32 and in bfloat16, ``convert`` on 30 s of
assets/speech_65s.wav and ``convert_batch`` of 8 songs of 10 s (RMVPE f0,
index_rate 0.75 over a 131072-row int8 bank). It prints each mode's median
wall (synchronized) and the largest difference between its calls' int16
outputs, the card's name and power limit beside them.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
from bench_torch_convert import BANK_ROWS, CHUNKING, load_speech  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=6, help="timed calls a mode and case")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this measurement needs the card", file=sys.stderr)
        return 1
    from rvc_tpu_torch.pipelines.convert import ConvertSettings, make_random_converter

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    modes = {"free": False, "pinned": True}
    s = ConvertSettings(f0_method="rmvpe", index_rate=0.75, protect=0.33)
    song = load_speech(30.0)
    songs = [load_speech(10.0, 5.0 * i) for i in range(8)]
    print(card, flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        vc = make_random_converter("48k_v2", chunking=CHUNKING, index_rows=BANK_ROWS,
                                   device="cuda", dtype=dtype)
        cases = {"convert 30 s": lambda: [vc.convert(song, settings=s)[0]],
                 "convert_batch 8 x 10 s": lambda: [w for w, _ in
                                                    vc.convert_batch(songs, settings=s)]}
        for case, fn in cases.items():
            walls = {m: [] for m in modes}
            outs = {m: [] for m in modes}
            order = [m for i in range(args.calls) for m in
                     (("free", "pinned") if i % 2 == 0 else ("pinned", "free"))]
            for m in ("free", "pinned"):  # set-up: each mode's engines picked once
                torch.backends.cudnn.deterministic = modes[m]
                fn()
            for m in order:
                torch.backends.cudnn.deterministic = modes[m]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                walls[m].append(time.perf_counter() - t0)
                outs[m].append(out)
            torch.backends.cudnn.deterministic = False
            for m in modes:
                spread = max(int(np.abs(a.astype(np.int32) - b).max())
                             for first in outs[m][:1] for other in outs[m][1:]
                             for a, b in zip(first, other))
                print(f"{str(dtype).split('.')[-1]} {case}, cuDNN {m}: median "
                      f"{np.median(walls[m]) * 1e3:.2f} ms over {len(walls[m])} calls "
                      f"(walls ms {[round(w * 1e3, 2) for w in walls[m]]}), the calls' int16 "
                      f"outputs against the first: max |diff| {spread} LSB; {card}", flush=True)
            free, pin = np.median(walls["free"]), np.median(walls["pinned"])
            print(f"  pinned / free: {pin / free:.4f}", flush=True)
        del vc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
