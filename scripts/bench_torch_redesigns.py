"""Kernel 4 and kernel 2 in bf16 on the card, each beside its yardsticks.

    python3 scripts/bench_torch_redesigns.py

Kernel 4 (``fused_resblock1``, the ResBlock1 chain forward on ``wgmma`` in
3xTF32) at the training run's shapes (batch 4; (T, C) = (432, 256), (4320,
128), (8640, 64), (17280, 32); k = 3, 7, 11; dilations 1, 3, 5), random
weights from a seed: each chain against its plain version, then its time,
the SIMT chain it replaced (``chip_smoke.previous_chain``) and the chain
through kernel 1's float32 unit on mma.sync (``chip_smoke.mma_sync_chain``),
and the totals over a step (three chains a stage). Kernel 2 in bf16 at the
30 s and 10 s conversion's shapes ((2, 2, 2178, 96) and (1, 2, 1198, 96)):
against its plain version, then its time and its first version's
(``chip_smoke.attention_bf16_sync``). CUDA events, ms a call; the card's
name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from rvc_tpu_torch.ops import attention as at  # noqa: E402
from rvc_tpu_torch.ops import resblock as rb  # noqa: E402

STAGES = ((432, 256), (4320, 128), (8640, 64), (17280, 32))
ATTENTION = (((2, 2, 2178, 96), [2178, 1221]), ((1, 2, 1198, 96), [1198]))


def chain(C: int, k: int, gen) -> list:
    convs = []
    for d in (1, 3, 5):
        for dd in (d, 1):
            w = (torch.randn(C, C, k, generator=gen) / (C * k) ** 0.5).cuda()
            convs.append((w, (0.1 * torch.randn(C, generator=gen)).cuda(), k, dd))
    return convs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    timed = chip_smoke.timed
    gen = torch.Generator().manual_seed(0)
    tot = dict(kernel=0.0, previous=0.0, mma_sync=0.0)
    with torch.no_grad():
        for T, C in STAGES:
            for k in (3, 7, 11):
                x = torch.randn(4, T, C, generator=gen).cuda()
                convs = chain(C, k, gen)
                ref = rb.fused_resblock1_plain(x, convs)
                err = ((rb.fused_resblock1(x, convs) - ref).abs().max() / ref.abs().max()).item()
                simt = chip_smoke.simt_chain_weights(convs)
                times = dict(kernel=timed(lambda: rb.fused_resblock1(x, convs), reps=5),
                             previous=timed(lambda: chip_smoke.previous_chain(x, simt), reps=5),
                             mma_sync=timed(lambda: chip_smoke.mma_sync_chain(x, convs), reps=5))
                for key, ms in times.items():
                    tot[key] += ms
                print(f"kernel 4, x (4, {T}, {C}), k {k}: err {err:.3g} of the largest; "
                      + ", ".join(f"{key} {ms:.3f}" for key, ms in times.items()), flush=True)
        print("kernel 4 over a step (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()),
              flush=True)
        for (B, H, T, D), lens in ATTENTION:
            q, k, v = (torch.randn(B, H, T, D, generator=gen).cuda().bfloat16() for _ in range(3))
            ek, ev = ((D ** -0.5 * torch.randn(21, D, generator=gen)).cuda().bfloat16()
                      for _ in range(2))
            lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
            kw = dict(window=10, scale=D ** -0.5)
            got = at.banded_rel_attention(q, k, v, ek, ev, lt, **kw)
            ref = at.banded_rel_attention_plain(q, k, v, ek, ev, lt, **kw)
            rel, l2, _ = chip_smoke.bf16_agreement(got, ref)
            ms = timed(lambda: at.banded_rel_attention(q, k, v, ek, ev, lt, **kw))
            prev = timed(lambda: chip_smoke.attention_bf16_sync(q, k, v, ek, ev, lt, **kw))
            print(f"kernel 2 bf16 {B, H, T, D}: max {rel:.3g}, relative L2 {l2:.3g}; "
                  f"kernel {ms:.4f}, previous {prev:.4f} ms a layer", flush=True)


if __name__ == "__main__":
    main()
