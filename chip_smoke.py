"""Smoke run of rvc_tpu_torch on one NVIDIA card: build, check, convert.

    python3 chip_smoke.py

Phases, each announced on its own line:
  1. the card: name, count, and nvidia-smi's name and power limit;
  2. the build: nvcc compiles the CUDA kernels of rvc_tpu_torch/csrc into
     one shared library (seconds and the -Xptxas -v summary are printed);
  3. each kernel against its plain PyTorch version at the shapes of the
     30 s conversion of phase 4, with its time, its plain version's time
     and its bound (the least time the card could take);
  4. the main path: make_random_converter("48k_v2") at full width with
     random weights from a seed and a 131072-row int8 retrieval bank
     converts 10 s and 30 s of assets/speech_65s.wav with RMVPE f0,
     index_rate 0.75 and protect 0.33, each once to set up, once counted and
     timed, twice more timed (RTF from the median of the three); in each
     counted run every kernel must launch as often as the model's structure
     says (a launch per residual unit, per encoder layer, per search),
     and the output must be 48 kHz int16 of the length the chunk spans
     give, with a peak above 0;
  5. a reference check: 3 s converted on the card and on the CPU (plain
     versions, same weights and draws) agree within a stated tolerance.
Then one JSON line with the kernels, and the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero before that.
Without a CUDA card it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import wave

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_F32 = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s
HBM = 3.35e12         # H100 SXM device memory, bytes/s
SETTINGS = dict(f0_method="rmvpe", index_rate=0.75, protect=0.33)
CHUNKING = (1, 5, 16, 20)
BANK_ROWS = 131072


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    say(f"FAILED: {msg}")
    sys.exit(1)


def speech(seconds: float, offset_s: float) -> np.ndarray:
    with wave.open(os.path.join(REPO, "assets", "speech_65s.wav")) as f:
        if f.getframerate() != 16000 or f.getnchannels() != 1 or f.getsampwidth() != 2:
            fail("assets/speech_65s.wav is not 16 kHz mono int16")
        f.setpos(int(offset_s * 16000))
        raw = f.readframes(int(seconds * 16000))
    out = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    if len(out) != int(seconds * 16000):
        fail("speech fixture too short")
    return out


def timed(fn, reps: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call: CUDA events around ``reps`` calls after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def path_shapes(vc, audio: np.ndarray) -> dict:
    """The kernels' input shapes in vc.convert(audio), from the converter's
    own chunking (spans, length bucket, frame counts)."""
    from rvc_tpu_torch.models.hubert import conv_output_lengths
    from rvc_tpu_torch.ops.filters import butter_highpass_host
    from rvc_tpu_torch.pipelines.convert import WINDOW

    import torch

    spans = vc.spans(butter_highpass_host(audio))
    lengths = np.array([e - b for b, e in spans])
    L = int(np.ceil(lengths.max() / 1600) * 1600)
    t50 = int(conv_output_lengths(vc.hubert.cfg, torch.tensor([L]))[0])
    Tp = min(L // WINDOW, 2 * t50)
    return dict(N=len(spans), T50=t50, Tp=Tp, p_len=np.minimum(lengths // WINDOW, 2 * t50),
                spans=spans)


def check_resblock(vc, shapes, gen) -> dict:
    import torch

    from rvc_tpu_torch.ops.resblock import fused_resblock_group, resblock_group_plain

    dec = vc.synth.dec
    nk = dec.num_kernels
    N, T = shapes["N"], shapes["Tp"]
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, flops=0.0, bytes=0.0)
    for i, rate in enumerate(dec.upsample_rates):
        T = T * rate
        chains = [rb.chain() for rb in dec.resblocks[i * nk:(i + 1) * nk]]
        C = chains[0][0][0].shape[0]
        x = torch.randn(N, T, C, generator=gen).to(vc.device)
        got = fused_resblock_group(x, chains)
        torch.cuda.synchronize()
        ref = resblock_group_plain(x, chains)
        err = (got - ref).abs().max().item()
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        macs = sum(w.shape[2] for c in chains for (w, _, _, _) in c) * C * C * N * T
        nbytes = 2 * x.numel() * 4 + sum(w.numel() * 4 + b.numel() * 4
                                         for c in chains for (w, b, _, _) in c)
        ms = timed(lambda: fused_resblock_group(x, chains), reps=5)
        plain_ms = timed(lambda: resblock_group_plain(x, chains), reps=5)
        b_ms, b_by = bound(2 * macs, nbytes)
        say(f"  resblock stage {i + 1}: x ({N}, {T}, {C}), {len(chains)} chains -> "
            f"max_abs_err {err:.3g} (tolerance {tol:.3g}), kernel_ms {ms:.3f}, "
            f"plain_ms {plain_ms:.3f}, bound_ms {b_ms:.3f} ({b_by}), "
            f"library_ms none, achieved {2 * macs / ms / 1e9:.1f} TFLOP/s")
        if not err <= tol:
            fail(f"resblock stage {i + 1} disagrees with its plain version")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("flops", 2 * macs), ("bytes", nbytes)):
            tot[k] += v
        tot["err"] = max(tot["err"], err)
    b_ms, b_by = bound(tot["flops"], tot["bytes"])
    return dict(max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=tot["bound_ms"], bound_by=b_by)


def check_attention(vc, shapes, gen) -> dict:
    import torch

    from rvc_tpu_torch.ops.attention import banded_rel_attention, banded_rel_attention_plain

    attn = vc.synth.enc_p.encoder.attn_layers
    layer = attn[0]
    N, T = shapes["N"], shapes["Tp"]
    H, D, w = layer.n_heads, layer.k_channels, layer.window_size
    q, k, v = (torch.randn(N, H, T, D, generator=gen).to(vc.device) for _ in range(3))
    ek, ev = layer.emb_rel_k[0].detach().contiguous(), layer.emb_rel_v[0].detach().contiguous()
    lengths = torch.as_tensor(shapes["p_len"], device=vc.device)
    args = (q, k, v, ek, ev, lengths)
    kw = dict(window=w, scale=D ** -0.5)
    got = banded_rel_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = banded_rel_attention_plain(*args, **kw)
    err = (got - ref).abs().max().item()
    tol = 1e-4
    W = 2 * w + 1
    flops = N * H * (4 * T * T * D + 4 * T * W * D + 5 * T * T)
    nbytes = 4 * N * H * T * D * 4 + 2 * W * D * 4 + N * 4
    ms = timed(lambda: banded_rel_attention(*args, **kw))
    plain_ms = timed(lambda: banded_rel_attention_plain(*args, **kw))
    b_ms, b_by = bound(flops, nbytes)
    n_layers = len(attn)
    say(f"  banded attention: q ({N}, {H}, {T}, {D}), lengths {shapes['p_len'].tolist()} -> "
        f"max_abs_err {err:.3g} (tolerance {tol:.3g}), kernel_ms {ms:.3f}, "
        f"plain_ms {plain_ms:.3f}, bound_ms {b_ms:.4f} ({b_by}), library_ms none; "
        f"x {n_layers} layers")
    if not err <= tol:
        fail("banded attention disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms * n_layers, plain_ms=plain_ms * n_layers,
                bound_ms=b_ms * n_layers, bound_by=b_by)


def check_nearest(vc, shapes, gen) -> dict:
    """Holds the kernel's rows against the plain version's. A query whose two
    best plain distances lie within float32 rounding of each other (1e-5
    relative) may pick either row; every other row must be identical."""
    import torch

    from rvc_tpu_torch.ops import retrieval

    bank_q, scales = vc.index_bank
    NQ, D = shapes["N"] * shapes["T50"], bank_q.shape[1]
    N = bank_q.shape[0]
    feats = torch.randn(NQ, D, generator=gen).to(vc.device)
    results = {}
    bank_f = bank_q.float() * scales
    for mode in ("int8", "float32"):
        if mode == "int8":
            run = lambda: retrieval.nearest_rows_q(feats, bank_q, scales)  # noqa: E731
        else:
            run = lambda: retrieval.nearest_rows(feats, bank_f)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        ref = retrieval.topk_blend(feats, bank_f, 1)
        d2 = (torch.sum(bank_f * bank_f, 1)[None] - 2.0 * feats @ bank_f.T)
        best2 = torch.topk(-d2, 2, dim=1).values
        gap = (best2[:, 0] - best2[:, 1]) / best2[:, 0].abs().clamp(min=1.0)
        same = (got - ref).abs().max(dim=1).values <= 1e-6
        ok = bool(torch.all(same | (gap < 1e-5)))
        err = (got - ref).abs().max().item()
        ms = timed(run)
        plain_ms = timed(lambda: retrieval.topk_blend(feats, bank_f, 1))
        bank_bytes = N * D * (1 if mode == "int8" else 4) + (N * 4 if mode == "int8" else 0)
        flops = 2 * NQ * N * D + 3 * NQ * N + 2 * N * D
        b_ms, b_by = bound(flops, bank_bytes + 2 * NQ * D * 4)
        say(f"  nearest rows ({mode} bank): queries ({NQ}, {D}), bank ({N}, {D}) -> "
            f"rows identical {same.float().mean().item():.4%} (others within rounding: {ok}), "
            f"max_abs_err {err:.3g}, kernel_ms {ms:.3f}, plain_ms {plain_ms:.3f}, "
            f"bound_ms {b_ms:.3f} ({b_by}), library_ms none")
        if not ok:
            fail(f"nearest rows ({mode}) disagree with the plain version")
        results[mode] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by)
    return results


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")

    # 1. the card
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    say(f"[1/5] card: {name}, {count} device(s); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(card)

    # 2. the build
    from rvc_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    info = _cuda.build_info
    say(f"[2/5] build: {'cached' if info['cached'] else 'nvcc'} {info['seconds']:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")
    say("ptxas: " + "; ".join(info["ptxas"]))

    from rvc_tpu_torch.ops import attention, resblock, retrieval
    from rvc_tpu_torch.ops.filters import butter_highpass_host
    from rvc_tpu_torch.pipelines.convert import WINDOW, ConvertSettings, make_random_converter

    t0 = time.perf_counter()
    vc = make_random_converter("48k_v2", seed=0, chunking=CHUNKING, index_rows=BANK_ROWS,
                               device="cuda")
    say(f"converter built in {time.perf_counter() - t0:.1f} s")
    clips = {10: speech(10.0, 0.0), 30: speech(30.0, 10.0)}

    # 3. kernels against their plain versions at the 30 s conversion's shapes
    shapes = path_shapes(vc, clips[30])
    say(f"[3/5] kernels at the 30 s conversion's shapes: {shapes['N']} chunks, "
        f"{shapes['Tp']} frames at 100 Hz, {shapes['T50']} HuBERT frames per chunk")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        checks = {"resblock": check_resblock(vc, shapes, gen),
                  "attention": check_attention(vc, shapes, gen)}
        nearest = check_nearest(vc, shapes, gen)
    checks["nearest"] = nearest["int8"]
    checks["nearest"]["max_abs_err"] = max(v["max_abs_err"] for v in nearest.values())
    # launches one conversion must make: a unit per launch in each decoder
    # stage's chains, a launch per encoder layer, one search
    dec = vc.synth.dec
    expected = {"resblock": sum(len(rb.convs1) for rb in dec.resblocks),
                "attention": len(vc.synth.enc_p.encoder.attn_layers), "nearest": 1}
    say(f"launches expected per conversion: {expected}")

    # 4. the main path
    counters = {"resblock": resblock.fused_resblock_group,
                "attention": attention.banded_rel_attention,
                "nearest": retrieval.nearest_rows_q}
    settings = ConvertSettings(**SETTINGS)
    launches = {}
    for sec, audio in clips.items():
        t0 = time.perf_counter()
        vc.convert(audio, settings=settings)  # first call at this length: set-up
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, sr = vc.convert(audio, settings=settings)
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t0]
        launches = {k: fn.launches for k, fn in counters.items()}
        for _ in range(2):  # the spread of the wall time, uncounted
            t0 = time.perf_counter()
            vc.convert(audio, settings=settings)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        spans = vc.spans(butter_highpass_host(audio))
        Tp = path_shapes(vc, audio)["Tp"]
        expect = sum(min((e - b) // WINDOW, Tp) * (sr // 100) - 2 * vc.t_pad_tgt
                     for b, e in spans)
        peak = int(np.abs(out.astype(np.int32)).max())
        say(f"[4/5] convert {sec} s: {len(spans)} chunks, {len(out)} samples at {sr} Hz, "
            f"peak {peak}, wall ms {[round(w * 1e3, 2) for w in walls]} (median "
            f"{wall * 1e3:.2f}; first call {first * 1e3:.1f}), RTF {sec / wall:.2f}x, "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches {launches}; {card}")
        if sr != 48000 or out.dtype != np.int16:
            fail(f"output is {out.dtype} at {sr} Hz, not int16 at 48000 Hz")
        if len(out) != expect:
            fail(f"output has {len(out)} samples, the spans give {expect}")
        if peak <= 0:  # a NaN anywhere makes the peak normalization zero the output
            fail("silent output")
        if launches != expected:
            fail(f"kernel launches {launches}, expected {expected}")

    # 5. the card's conversion against the CPU's (plain versions) on 3 s
    ref_clip = speech(3.0, 40.0)
    out_gpu, _ = vc.convert(ref_clip, settings=settings)
    t0 = time.perf_counter()
    cpu = make_random_converter("48k_v2", seed=0, chunking=CHUNKING, index_rows=BANK_ROWS,
                                device="cpu")
    out_cpu, _ = cpu.convert(ref_clip, settings=settings)
    diff = np.abs(out_gpu.astype(np.int32) - out_cpu.astype(np.int32))
    tol = 4
    say(f"[5/5] 3 s on the card vs the CPU: {len(out_gpu)} vs {len(out_cpu)} samples, "
        f"max |diff| {diff.max()} LSB, share above {tol} LSB {np.mean(diff > tol):.4%} "
        f"(tolerance {tol} LSB: the same float32 math summed in another order, "
        f"~1e-5 relative before the int16 scaling); CPU run "
        f"{time.perf_counter() - t0:.1f} s")
    if out_gpu.shape != out_cpu.shape or diff.max() > tol:
        fail("the card's conversion disagrees with the CPU's")

    kernels = []
    meta = {
        "resblock": ("fused_resblock_group", "rvc_tpu_torch/csrc/resblock_group.cu",
                     "rvc_tpu/ops/pallas_resblock.py:591"),
        "attention": ("banded_rel_attention", "rvc_tpu_torch/csrc/banded_attention.cu",
                      "rvc_tpu/ops/pallas_attention.py:156"),
        "nearest": ("nearest_rows_q", "rvc_tpu_torch/csrc/nearest_rows.cu",
                    "rvc_tpu/ops/pallas_retrieval.py:99"),
    }
    for key, (kname, src, replaces) in meta.items():
        c = checks[key]
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[key], "max_abs_err": c["max_abs_err"],
                        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"], "library_ms": None})
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
