"""Kernel 8 (one ResBlock1 chain with the bf16 carry) against the float32
chain kernel, at the seven decoder stages of scripts/bench_resblock_v2.py.

    python3 scripts/bench_torch_resblock_v2.py [--reps 3]

The port's counterpart of ``scripts/bench_resblock_v2.py``'s entry point:
the same stages of 48k_v2 at 4 x 18 s (B = 4; (T, C, k) per stage, three
units of dilations 1, 3, 5, weights and biases N(0, 0.05^2), x N(0, 0.3^2)),
with S = 1 (the JAX script's space-to-depth packing at C = 64 and 32 is a
layout of the TPU's lanes: here those stages run at T = 432000 and 864000
with C = 64 and 32). For each stage it prints kernel 8's time
(``fused_resblock1_v2`` on bf16 activations) beside the float32 chain
kernel's (kernel 4, ``fused_resblock1``, on the same values in float32),
the largest difference from kernel 8's plain version (relative to its
largest magnitude) and whether the two are bit-identical, and the card's
name and power limit. Times are CUDA events over ``--reps`` calls after a
warm-up. Needs a CUDA card.
"""
import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rvc_tpu_torch.device import set_float32_math  # noqa: E402
from rvc_tpu_torch.ops import resblock as rb  # noqa: E402

B = 4
# (label, T, C, k): scripts/bench_resblock_v2.py:185-193 with S = 1
STAGES = [
    ("s0 C=256 k=3", 21600, 256, 3),
    ("s0 C=256 k=11", 21600, 256, 11),
    ("s1 C=128 k=3", 216000, 128, 3),
    ("s1 C=128 k=7", 216000, 128, 7),
    ("s1 C=128 k=11", 216000, 128, 11),
    ("s2 C=64 k=11", 432000, 64, 11),
    ("s3 C=32 k=11", 864000, 32, 11),
]


def timed(fn, reps: int) -> float:
    """Milliseconds per call: CUDA events around ``reps`` calls after one."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_convs(gen: torch.Generator, C: int, k: int, dils=(1, 3, 5)) -> list:
    convs = []
    for d in dils:
        for dd in (d, 1):
            w = torch.randn(C, C, k, generator=gen, device="cuda") * 0.05
            b = torch.randn(C, generator=gen, device="cuda") * 0.05
            convs.append((w, b, k, dd))
    return convs


def run(stages=STAGES, reps: int = 3, seed: int = 0, beside=None) -> list[dict]:
    """One row per stage: label, shape, k, kernel 8 ms, the float32 chain
    kernel's ms, max |kernel 8 - plain| / max |plain|, bit-identical; with
    ``beside`` (a function of the bf16 input and the convs) also its ms on
    the same input, timed in turns with kernel 8 (``beside_ms``)."""
    set_float32_math()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    with torch.no_grad():
        for label, T, C, k in stages:
            convs = make_convs(gen, C, k)
            x32 = torch.randn(B, T, C, generator=gen, device="cuda") * 0.3
            x = x32.bfloat16()
            x32 = x.float()  # the same values in float32
            got = rb.fused_resblock1_v2(x, convs)
            torch.cuda.synchronize()
            ref = rb.fused_resblock1_plain(x, convs)
            err = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
            exact = bool(torch.equal(got, ref))
            del ref
            f32_ms = timed(lambda: rb.fused_resblock1(x32, convs), reps)
            row = dict(label=label, shape=(B, T, C), k=k, f32_ms=f32_ms, max_rel_err=err,
                       exact=exact)
            v2 = lambda: rb.fused_resblock1_v2(x, convs)  # noqa: E731
            if beside is None:
                row["v2_ms"] = timed(v2, reps)
            else:
                other = lambda: beside(x, convs)  # noqa: E731
                b_ms = timed(other, reps)
                row["v2_ms"] = min(timed(v2, reps), timed(v2, reps))
                row["beside_ms"] = min(b_ms, timed(other, reps))
            rows.append(row)
            del x, x32, got
            torch.cuda.empty_cache()
    return rows


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark needs the card", file=sys.stderr)
        return 1
    print(card(), flush=True)
    for r in run(reps=args.reps):
        print(f"{r['label']:16s} x {r['shape']} bf16: kernel 8 {r['v2_ms']:8.3f} ms, float32 "
              f"chain kernel {r['f32_ms']:8.3f} ms, ratio {r['f32_ms'] / r['v2_ms']:5.2f}x, "
              f"max err vs plain {r['max_rel_err']:.3g} of the largest, "
              f"exact={r['exact']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
