"""Kernels 5 and 7 split into their launches at the training run's shapes.

    python3 scripts/profile_torch_train_kernels.py [--reps 5] [--yardstick]

Kernel 5 (the ResBlock1 chain backward) runs on every chain of the 48k_v2
decoder at batch 4 and the training segment's frames per stage; kernel 7
(the WN stack backward) at (4, 400, 192), k 5, for the posterior encoder's
16 layers and a flow's 3 (the training run's shapes, chip_smoke.py phase
6; lengths 300, 280, 260, 240, which change no launch's work). Each call is
traced with torch.profiler over ``--reps`` calls after a warm-up; for every
kernel the script prints its device time per call, its launches per call
and its grid and block (from the trace's kernel events). With
``--yardstick`` it also splits the float32 SIMT backward that the
tensor-core kernels replaced (``rvc_resblock1_bwd_simt``, ``rvc_wn_bwd_simt``,
reached through chip_smoke.py's helpers), in turns with the kernels.
Prints the card's name and power limit. Needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rvc_tpu_torch.config import preset  # noqa: E402
from rvc_tpu_torch.ops import resblock as rb  # noqa: E402
from rvc_tpu_torch.ops import wavenet as wn  # noqa: E402
from rvc_tpu_torch.train.step import Trainer  # noqa: E402

BATCH = 4
WN_T = 400
WN_LENGTHS = (300, 280, 260, 240)


def split(fn, reps: int) -> dict:
    """{kernel name: [ms per call, launches per call, grid, block]} of fn's
    launches, from a torch.profiler trace of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = defaultdict(lambda: [0.0, 0, set(), set()])
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e["name"].replace("(anonymous namespace)::", "").removeprefix("void ")
        name = name.split("(")[0]
        row = out[name]
        row[0] += e["dur"] / 1e3 / reps
        row[1] += 1
        args = e.get("args", {})
        row[2].add(tuple(args.get("grid", ())))
        row[3].add(tuple(args.get("block", ())))
    for row in out.values():
        row[1] /= reps
    return dict(out)


def show(title: str, parts: dict) -> dict:
    total = sum(r[0] for r in parts.values())
    print(f"{title}: {total:.4f} ms per call")
    for name, (ms, n, grids, blocks) in sorted(parts.items(), key=lambda kv: -kv[1][0]):
        print(f"    {ms:9.4f} ms  x{n:<5g} grid {sorted(grids)} block {sorted(blocks)}  {name}")
    return parts


def add(into: dict, parts: dict) -> None:
    """Sum a call's split into a stage's (or depth's): ms and launches, and
    the grids seen."""
    for name, (ms, n, grids, _) in parts.items():
        row = into.setdefault(name, [0.0, 0.0, set()])
        row[0] += ms
        row[1] += n
        row[2] |= grids


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--yardstick", action="store_true",
                    help="also split the SIMT backward the kernels replaced")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    previous = {}
    if args.yardstick:
        import chip_smoke
        previous = {"k5": chip_smoke.resblock1_backward_simt, "k7": chip_smoke.wn_backward_simt}
    trainer = Trainer(preset("48k_v2"), device="cuda")
    trainer.init_state(seed=0)
    gen = torch.Generator().manual_seed(0)
    dec = trainer.synth.dec
    nk = dec.num_kernels
    totals = defaultdict(dict)
    T = trainer.seg_frames
    for i, rate in enumerate(dec.upsample_rates):
        T *= rate
        for blk in dec.resblocks[i * nk:(i + 1) * nk]:
            with torch.no_grad():
                convs = [(w.detach().clone(), b.detach().clone(), k, d)
                         for w, b, k, d in blk.chain()]
            C, k = convs[0][0].shape[0], convs[0][2]
            x = torch.randn(BATCH, T, C, generator=gen).cuda()
            gy = torch.randn(BATCH, T, C, generator=gen).cuda()
            with torch.no_grad():
                _, hs = rb._resblock1_forward(x, convs)
            runs = {"kernel 5": lambda: rb.fused_resblock1_backward(x, hs, gy, convs)}
            if "k5" in previous:
                runs["previous"] = lambda: previous["k5"](x, hs, gy, convs)
            for label, fn in runs.items():
                add(totals[(label, f"stage {i + 1}")],
                    show(f"{label}, stage {i + 1}, chain x ({BATCH}, {T}, {C}), k {k}",
                         split(fn, args.reps)))
    synth = trainer.synth
    stacks = {16: synth.enc_q.enc, 3: [f.enc for f in synth.flow.flows if hasattr(f, "enc")][0]}
    lens = torch.tensor(WN_LENGTHS, dtype=torch.int32, device="cuda")
    mask = (torch.arange(WN_T, device="cuda")[None, :] < lens[:, None]).float()[:, None]
    for L, stack in stacks.items():
        C, k = stack.hidden_channels, stack.kernel_size
        g = torch.randn(BATCH, stack.cond_layer.in_channels, 1, generator=gen).cuda()
        with torch.no_grad():
            *ws, lengths_t = [a.detach().clone() for a in stack.fused_args(mask, g)]
            x = torch.randn(BATCH, WN_T, C, generator=gen).cuda() * mask.transpose(1, 2)
            gy = torch.randn(BATCH, WN_T, C, generator=gen).cuda()
            _, xs, pre = wn._forward(x, *ws, lengths_t, k)
        runs = {"kernel 7": lambda: wn.fused_wn_backward(x, xs, pre, gy, *ws, lengths_t,
                                                         kernel_size=k)}
        if "k7" in previous:
            runs["previous"] = lambda: previous["k7"](x, xs, pre, gy, *ws, lengths_t,
                                                      kernel_size=k)
        for label, fn in runs.items():
            add(totals[(label, f"L {L}")],
                show(f"{label}, WN stack x ({BATCH}, {WN_T}, {C}), L {L}, k {k}",
                     split(fn, args.reps)))
    print("totals (ms per call, launches per call; kernel 5 summed over a stage's 3 chains, "
          "grids of the chains' k 3 / 7 / 11 where they differ):")
    for (label, where), parts in totals.items():
        ms = sum(r[0] for r in parts.values())
        print(f"  {label:10s} {where:8s} {ms:9.4f}: " + "; ".join(
            f"{name} {r[0]:.4f} x{r[1]:g} {sorted(r[2])}"
            for name, r in sorted(parts.items(), key=lambda kv: -kv[1][0]) if r[0] >= 0.001))
    print(f"card: {card}")


if __name__ == "__main__":
    main()
