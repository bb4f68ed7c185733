"""Training-step throughput of the PyTorch port on one NVIDIA card (full-size
48k_v2 GAN), the counterpart of scripts/bench_train.py.

    python3 scripts/bench_torch_train.py [--batch-size 4] [--dtype bfloat16|float32]

The same batch as scripts/bench_train.py: preset("48k_v2"), batch 4 by
default, T = 400 frames of 768-wide features, random spectrogram, f0 and
waveform from numpy seeded with 0. Trainer(config, dtype) in bfloat16 by
default (the JAX bench's dtype on an accelerator), float32 with --dtype
float32; random weights from seed 0. One warm-up step, then 10 steps ending
in one synchronize. Prints the card's name and power limit (nvidia-smi)
and the dtype on lines of their own, then one JSON line under
bench_train.py's metric name, ``train_step_48k_v2_per_chip``: steps/s,
seconds of audio trained per second and the last loss_mel. The card is
always the device: without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
T = 400     # ~4 s of 48 kHz audio per utterance (hop 480), as bench_train.py
FEAT = 768  # v2 content-vec width
STEPS = 10


def make_batch(cfg, batch_size: int) -> dict:
    """bench_train.py's batch, drawn in its order from numpy seeded with 0."""
    d = cfg.data
    rng = np.random.default_rng(0)
    wave_len = T * d.hop_length
    return {
        "phone": rng.standard_normal((batch_size, T, FEAT)).astype(np.float32),
        "phone_lengths": np.full((batch_size,), T, np.int32),
        "pitch": rng.integers(1, 255, (batch_size, T)).astype(np.int32),
        "pitchf": rng.uniform(100, 300, (batch_size, T)).astype(np.float32),
        "spec": rng.standard_normal((batch_size, T, d.filter_length // 2 + 1)
                                    ).astype(np.float32),
        "spec_lengths": np.full((batch_size,), T, np.int32),
        "wave": (0.1 * rng.standard_normal((batch_size, wave_len))).astype(np.float32),
        "sid": np.zeros((batch_size,), np.int32),
    }


def run(batch_size: int = 4, dtype: str = "bfloat16") -> dict:
    """The benchmark on the card: its JSON result as a dict."""
    import dataclasses

    import torch

    from rvc_tpu_torch.config import preset
    from rvc_tpu_torch.train.step import Trainer

    cfg = preset("48k_v2")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=batch_size))
    batch = make_batch(cfg, batch_size)
    trainer = Trainer(cfg, dtype=getattr(torch, dtype), device="cuda")
    state = trainer.init_state(seed=0)
    state, metrics = trainer.step(state, batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, metrics = trainer.step(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / STEPS
    wave_len = T * cfg.data.hop_length
    loss_mel = float(metrics["loss_mel"])
    if not np.isfinite(loss_mel):
        raise RuntimeError(f"loss_mel is not finite: {loss_mel}")
    return {
        "metric": "train_step_48k_v2_per_chip",
        "value": round(1.0 / dt, 3),
        "unit": "steps_per_s",
        "detail": {
            "batch_size": batch_size,
            "utt_seconds": round(wave_len / cfg.data.sampling_rate, 2),
            "audio_seconds_per_s": round(batch_size * wave_len / cfg.data.sampling_rate / dt,
                                         2),
            "loss_mel": round(loss_mel, 3),
            "dtype": dtype,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark needs the card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"dtype {args.dtype}, {torch.cuda.get_device_name(0)}")
    print(json.dumps(run(args.batch_size, args.dtype)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
