"""Where the time of one GAN training step goes on the card (rvc_tpu_torch).

    python3 scripts/profile_torch_train.py [--steps 5] [--dtype float32|bfloat16]

Builds the training run of chip_smoke.py (an RVCDataset of 8 clips of the
speech fixture at 48 kHz, BucketBatcher(batch_size=4), Trainer(preset
("48k_v2"), dtype) at full width with random weights, float32 unless
--dtype bfloat16), takes 2 warm-up steps, then:
  1. ``--steps`` plain steps: the wall time per step, steps/s, seconds of
     audio (the sliced segments) trained per second, peak device memory;
  2. 3 steps with CUDA events between the step's stages (generator
     forward, discriminator forward and backward, discriminator update,
     generator losses, generator backward, generator update): device time
     per stage, the rest of the wall being host work and gaps;
  3. 2 steps under torch.profiler: the device's busy share (kernel time
     over wall), the time in the port's own kernels (4-7) against the rest,
     and the kernels that take the most time.
Prints the card's name and power limit. Needs a CUDA card.
"""
import argparse
import itertools
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from rvc_tpu_torch.config import preset  # noqa: E402
from rvc_tpu_torch.train.data import BucketBatcher, RVCDataset  # noqa: E402
from rvc_tpu_torch.train.step import Trainer  # noqa: E402

# name fragments of the kernels of csrc/ that the training step launches
OWN_KERNELS = ("resblock_unit_kernel", "resblock_unit_wgmma", "chain_conv_kernel", "rb_bwd_",
               "rb_tc_", "wgrad", "wn_")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cfg = preset("48k_v2")
    tmp = tempfile.TemporaryDirectory(prefix="rvc_profile_")
    batcher = BucketBatcher(RVCDataset(chip_smoke.make_dataset(tmp.name, cfg.data), cfg.data),
                            chip_smoke.TRAIN_BATCH, seed=1234)
    batches = [b for e in range(8) for b in batcher.epoch(e)]
    trainer = Trainer(cfg, dtype=getattr(torch, args.dtype), device="cuda")
    state = trainer.init_state(seed=0)
    it = itertools.cycle(batches)  # --steps may ask for more steps than there are batches
    for _ in range(2):
        state, _ = trainer.step(state, next(it))
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, m = trainer.step(state, next(it))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    audio_s = chip_smoke.TRAIN_BATCH * cfg.train.segment_size / cfg.data.sampling_rate
    print(f"card: {card}")
    print(f"48k_v2 in {args.dtype}, batch {chip_smoke.TRAIN_BATCH}, "
          f"{np.shape(batches[0]['spec'])[1]} frames: "
          f"wall s per step {[round(w, 4) for w in walls]}, {len(walls) / sum(walls):.3f} "
          f"steps/s, {audio_s * len(walls) / sum(walls):.3f} s of audio trained per s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    totals, wall_ms = {}, 0.0
    for _ in range(3):
        events = []
        t0 = time.perf_counter()
        state, _ = trainer.step(state, next(it), events=events)
        torch.cuda.synchronize()
        wall_ms += (time.perf_counter() - t0) * 1e3
        for (_, a), (name, b) in zip(events[:-1], events[1:]):
            totals[name] = totals.get(name, 0.0) + a.elapsed_time(b)
    print(f"stages (CUDA events, mean of 3 steps, wall {wall_ms / 3:.2f} ms):")
    for name, ms in totals.items():
        print(f"  {name:36s} {ms / 3:9.2f} ms  {ms / wall_ms:6.1%}")
    rest = wall_ms - sum(totals.values())
    print(f"  {'host work and gaps (rest)':36s} {rest / 3:9.2f} ms  {rest / wall_ms:6.1%}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            state, _ = trainer.step(state, next(it))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 2
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / 2
    if busy <= 0:
        print("device busy share: not measured (the profiler saw no device time)")
        return
    own = sum(e.self_device_time_total for e in kernels
              if any(f in e.key for f in OWN_KERNELS)) / 1e3 / 2
    print(f"profiled wall {wall:.2f} ms per step; kernel time {busy:.2f} ms; device busy "
          f"{busy / wall:.1%}, idle {1 - busy / wall:.1%}; the port's kernels 4-7 "
          f"{own:.2f} ms ({own / busy:.1%} of kernel time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 2e3:9.2f} ms  x{e.count // 2:<5d} {e.key[:90]}")


if __name__ == "__main__":
    main()
