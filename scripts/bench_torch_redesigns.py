"""Kernels 4 and 6 and kernel 2 in bf16 on the card, each beside its yardsticks.

    python3 scripts/bench_torch_redesigns.py [--kernels 4,6,2bf16]

Kernel 4 (``fused_resblock1``, the ResBlock1 chain forward on ``wgmma`` in
3xTF32) at the training run's shapes (batch 4; (T, C) = (432, 256), (4320,
128), (8640, 64), (17280, 32); k = 3, 7, 11; dilations 1, 3, 5), random
weights from a seed: each chain against its plain version, then its time,
the SIMT chain it replaced (``chip_smoke.previous_chain``) and the chain
through kernel 1's float32 unit on mma.sync (``chip_smoke.mma_sync_chain``),
and the totals over a step (three chains a stage). Kernel 2 in bf16 at the
30 s and 10 s conversion's shapes ((2, 2, 2178, 96) and (1, 2, 1198, 96)):
against its plain version, then its time and its first version's
(``chip_smoke.attention_bf16_sync``). Kernel 6 (the WaveNet stack forward
on ``wgmma`` in 3xTF32) at the training run's shapes ((4, 400, 192), k = 5,
16 and 3 layers, lengths 400, 377, 350, 320), random weights from a seed:
against its plain version, then its device time on weights packed before
the timed calls, the SIMT forward it replaced (``chip_smoke.
wn_forward_simt``), the plain version and the packing, and the totals over
a step (one 16-layer stack and four 3-layer ones), each of its two kernels'
marginal time a launch (``launch_times``), and the host's time to enqueue
a call of ``fused_wn`` on weights that want gradients (as in training,
packing included) and of the packing alone (``host_ms``); with the ptxas
summary of the conv kernels. CUDA events, ms a call; the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from rvc_tpu_torch.ops import attention as at  # noqa: E402
from rvc_tpu_torch.ops import _cuda  # noqa: E402
from rvc_tpu_torch.ops import resblock as rb  # noqa: E402
from rvc_tpu_torch.ops import wavenet as wn  # noqa: E402

STAGES = ((432, 256), (4320, 128), (8640, 64), (17280, 32))
ATTENTION = (((2, 2, 2178, 96), [2178, 1221]), ((1, 2, 1198, 96), [1198]))
WN_LENGTHS = (400, 377, 350, 320)


def chain(C: int, k: int, gen) -> list:
    convs = []
    for d in (1, 3, 5):
        for dd in (d, 1):
            w = (torch.randn(C, C, k, generator=gen) / (C * k) ** 0.5).cuda()
            convs.append((w, (0.1 * torch.randn(C, generator=gen)).cuda(), k, dd))
    return convs


def wn_stack(B: int, T: int, C: int, L: int, k: int, gen) -> list:
    """fused_wn's arguments after x, random from ``gen``, on the card."""
    f = lambda *s, sc: (sc * torch.randn(*s, generator=gen)).cuda()  # noqa: E731
    w_res = f(L, C, C, sc=C ** -0.5)
    w_res[-1] = 0.0
    b_rs2 = f(2 * L, C, sc=0.1)
    b_rs2[L - 1] = 0.0
    return [f(L * k, C, C, sc=(C * k) ** -0.5), f(L * k, C, C, sc=(C * k) ** -0.5),
            f(2 * L, C, sc=0.1), f(B, 2 * L, C, sc=0.3), w_res, f(L, C, C, sc=C ** -0.5),
            b_rs2]


def host_ms(fn, reps: int = 30) -> float:
    """The host's milliseconds to enqueue one call: ``reps`` calls after a
    synchronize, timed on the host's clock before the next synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def launch_times(run, reps: int = 5) -> str:
    """Each of kernel 6's kernels' marginal device time a launch, from
    torch.profiler's timeline over ``reps`` calls: a kernel's end less the
    end of the kernel before it (or its own start, after a gap). Its span
    from start to end would overlap the kernel before: each conv launch is
    a programmatic dependent of the one before (csrc/tf32_conv.cuh)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    total, count, prev_end = {}, {}, None
    for start, end, name in kernels:
        for kname in ("wn_gate_kernel", "wn_res_skip_kernel"):
            if kname in name:
                since = start if prev_end is None else max(start, prev_end)
                total[kname] = total.get(kname, 0.0) + (end - since) / 1e3
                count[kname] = count.get(kname, 0) + 1
        prev_end = end
    return ", ".join(f"{k} {total[k] / count[k]:.4f} ms x {count[k] // reps}"
                     for k in sorted(total))


def bench_wn(gen) -> None:
    timed = chip_smoke.timed
    B, T, C, k = len(WN_LENGTHS), 400, 192, 5
    lens = torch.tensor(WN_LENGTHS, dtype=torch.int32, device="cuda")
    mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None]).float()[..., None]
    tot = dict(kernel=0.0, previous=0.0, plain=0.0, pack=0.0, host=0.0, pack_host=0.0)
    for L, count in ((16, 1), (3, 4)):
        x = torch.randn(B, T, C, generator=gen).cuda() * mask
        ws = wn_stack(B, T, C, L, k, gen)
        ws_grad = [w.clone().requires_grad_() for w in ws]  # as in training
        ref = wn.fused_wn_plain(x, *ws, lens, kernel_size=k)
        err = ((wn._forward(x, *ws, lens, k)[0] - ref).abs().max() / ref.abs().max()).item()
        packs = wn.pack_forward_weights(ws[0], ws[1], ws[4], ws[5], k)
        run = lambda: wn._forward(x, *ws, lens, k, packs)  # noqa: E731
        prev = lambda: chip_smoke.wn_forward_simt(x, *ws, lens, kernel_size=k)  # noqa: E731
        times = dict(kernel=timed(run, reps=20, device_only=True),
                     previous=timed(prev, reps=5, device_only=True),
                     plain=timed(lambda: wn.fused_wn_plain(x, *ws, lens, kernel_size=k), reps=5,
                                 device_only=True),
                     pack=timed(lambda: wn.pack_forward_weights(ws[0], ws[1], ws[4], ws[5], k),
                                reps=5, device_only=True))
        times["kernel"] = min(times["kernel"], timed(run, reps=20, device_only=True))
        with torch.enable_grad():
            times["host"] = host_ms(lambda: wn.fused_wn(x, *ws_grad, lens, kernel_size=k))
        times["pack_host"] = host_ms(
            lambda: wn.pack_forward_weights(ws[0], ws[1], ws[4], ws[5], k))
        for key, ms in times.items():
            tot[key] += count * ms
        print(f"kernel 6, x ({B}, {T}, {C}), L {L}: err {err:.3g} of the largest; "
              + ", ".join(f"{key} {ms:.4f}" for key, ms in times.items())
              + f"; grids: {chip_smoke.wn_grids(B, T, C)}; per launch: {launch_times(run)}",
              flush=True)
    print("kernel 6 over a step (ms): " + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()),
          flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", default="4,6,2bf16",
                        help="comma-separated: 4, 6 and 2bf16 (default all)")
    which = set(parser.parse_args().kernels.split(","))
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    _cuda.library()
    print("ptxas: " + "; ".join(line for line in _cuda.build_info["ptxas"]
                                if "conv_kernel" in line or line.startswith("wn_")), flush=True)
    print("ptxas C7515 (wgmma serialized): "
          + (", ".join(_cuda.build_info["serialized"]) or "none"), flush=True)
    timed = chip_smoke.timed
    gen = torch.Generator().manual_seed(0)
    tot = dict(kernel=0.0, previous=0.0, mma_sync=0.0)
    with torch.no_grad():
        if "6" in which:
            bench_wn(gen)
        for T, C in STAGES if "4" in which else ():
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
        if "4" in which:
            print("kernel 4 over a step (ms): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()), flush=True)
        for (B, H, T, D), lens in ATTENTION if "2bf16" in which else ():
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
