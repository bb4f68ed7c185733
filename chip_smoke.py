"""Smoke run of rvc_tpu_torch on one NVIDIA card: build, check, convert, train.

    python3 chip_smoke.py

Phases, each announced on its own line:
  1. the card: name, count, and nvidia-smi's name and power limit;
  2. the build: nvcc compiles the CUDA kernels of rvc_tpu_torch/csrc into
     one shared library (seconds and the -Xptxas -v summary are printed);
  3. each kernel against its plain PyTorch version at the shapes of the
     30 s conversion of phase 4, with its time, its plain version's time
     and two bounds (the least time the card could take): bound_ms for
     float32-accurate work on the tensor cores (three bf16 passes for
     kernel 3, three TF32 passes for the conv and attention kernels) and
     bound_f32_ms on the float32 pipes (67 TFLOP/s); for kernel 1 also
     previous_ms, each stage through the float32 SIMT unit kernel that
     kernel 1 replaced (still kernel 4's), timed in the same run;
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
     versions, same weights and draws) agree within a stated tolerance;
  6. the training kernels (4-7) against their plain versions at the shapes
     of the training run of phase 7, values and every gradient, with their
     times and bounds; for kernels 5 and 7 also previous_ms, per decoder
     stage or WN depth and in all, the float32 SIMT backward that their
     tensor-core versions replaced (resblock1_backward_simt,
     wn_backward_simt), timed in turns with them in the same run;
  7. the training path: an RVCDataset of 8 clips cut from the speech fixture
     (48 kHz, seeded random features and f0), Trainer(preset("48k_v2")) at
     full width with random weights, one warm-up step and 5 timed steps from
     BucketBatcher(batch_size=4); losses finite, every parameter of G and D
     with a nonzero gradient after the first step, and in the timed steps
     every training kernel launched as often as the model's structure says
     (a launch per ResBlock1 chain and per WN stack, each direction);
  8. a reference check: one training step on the card and on the CPU
     (plain versions, same weights, batch and draws) at batch 1, 48 frames:
     losses, gradient norms and updated parameters within stated tolerances.
Then one JSON line with the kernels, and the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero before that.
Without a CUDA card it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
import wave

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_F32 = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s
PEAK_TF32 = 495e12    # H100 SXM dense TF32 on the tensor cores, FLOP/s
PEAK_BF16 = 989e12    # H100 SXM dense bf16 on the tensor cores, FLOP/s
HBM = 3.35e12         # H100 SXM device memory, bytes/s
SETTINGS = dict(f0_method="rmvpe", index_rate=0.75, protect=0.33)
CHUNKING = (1, 5, 16, 20)
BANK_ROWS = 131072
TRAIN_BATCH = 4
TRAIN_STEPS = 5
CLIP_SECONDS = np.linspace(2.4, 3.0, 8)  # float32 wavs of these lengths fall in the
# dataset's 400-frame bucket (its length estimate is file bytes / (3 hop))


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


def bound(flops: float, nbytes: float, peak: float = PEAK_F32) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_tc(flops: float, nbytes: float) -> tuple[float, str]:
    """float32-accurate products on the tensor cores: three TF32 passes"""
    return bound(3 * flops, nbytes, PEAK_TF32)


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

    from rvc_tpu_torch.ops import resblock as rb
    from rvc_tpu_torch.ops.resblock import fused_resblock_group, resblock_group_plain

    simt = types.SimpleNamespace(launches=0)

    def previous(x, chains):  # the stage through the SIMT unit kernel (kernel 4's)
        return rb._run_units(x, chains, "rvc_resblock_unit_simt",
                             lambda w: w.permute(2, 1, 0).contiguous(), simt)

    dec = vc.synth.dec
    nk = dec.num_kernels
    N, T = shapes["N"], shapes["Tp"]
    tot = dict(ms=0.0, plain_ms=0.0, previous_ms=0.0, bound_ms=0.0, bound_f32_ms=0.0, err=0.0,
               flops=0.0, bytes=0.0)
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
        # kernel 1 and the SIMT unit kernel it replaced, in turns
        prev_ms = timed(lambda: previous(x, chains), reps=5)
        ms = timed(lambda: fused_resblock_group(x, chains), reps=5)
        ms = min(ms, timed(lambda: fused_resblock_group(x, chains), reps=5))
        prev_ms = min(prev_ms, timed(lambda: previous(x, chains), reps=5))
        # the split and packing of the stage's weights, which every call of
        # kernel 1 does (inside kernel_ms)
        pack_ms = timed(lambda: [rb.pack_tf32_weights(w) for c in chains for w, _, _, _ in c])
        plain_ms = timed(lambda: resblock_group_plain(x, chains), reps=5)
        b_ms, b_by = bound_tc(2 * macs, nbytes)
        f32_ms = bound(2 * macs, nbytes)[0]
        say(f"  resblock stage {i + 1}: x ({N}, {T}, {C}), {len(chains)} chains -> "
            f"max_abs_err {err:.3g} (tolerance {tol:.3g}), kernel_ms {ms:.3f}, "
            f"previous_ms {prev_ms:.3f} (kernel below it: {ms < prev_ms}), weight packing "
            f"{pack_ms:.3f} ms of kernel_ms, "
            f"plain_ms {plain_ms:.3f}, bound_ms {b_ms:.3f} ({b_by}), bound_f32_ms {f32_ms:.3f}, "
            f"library_ms none, achieved {2 * macs / ms / 1e9:.1f} TFLOP/s")
        if not err <= tol:
            fail(f"resblock stage {i + 1} disagrees with its plain version")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("previous_ms", prev_ms),
                     ("bound_ms", b_ms), ("bound_f32_ms", f32_ms), ("flops", 2 * macs),
                     ("bytes", nbytes)):
            tot[k] += v
        tot["err"] = max(tot["err"], err)
    b_by = bound_tc(tot["flops"], tot["bytes"])[1]
    return dict(max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
                previous_ms=tot["previous_ms"], bound_ms=tot["bound_ms"], bound_by=b_by,
                bound_f32_ms=tot["bound_f32_ms"])


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
    b_ms, b_by = bound_tc(flops, nbytes)
    f32_ms = bound(flops, nbytes)[0]
    n_layers = len(attn)
    say(f"  banded attention: q ({N}, {H}, {T}, {D}), lengths {shapes['p_len'].tolist()} -> "
        f"max_abs_err {err:.3g} (tolerance {tol:.3g}), kernel_ms {ms:.3f}, "
        f"plain_ms {plain_ms:.3f}, bound_ms {b_ms:.4f} ({b_by}), bound_f32_ms {f32_ms:.4f}, "
        f"library_ms none; x {n_layers} layers")
    if not err <= tol:
        fail("banded attention disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms * n_layers, plain_ms=plain_ms * n_layers,
                bound_ms=b_ms * n_layers, bound_by=b_by, bound_f32_ms=f32_ms * n_layers)


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
        # the one-library route: the dequantized bank's distances by one
        # float32 GEMM (cuBLAS), argmin, gather; timed here only
        sq = torch.sum(bank_f * bank_f, 1)[None]
        lib_ms = timed(lambda: bank_f[torch.argmin(
            torch.addmm(sq, feats, bank_f.T, beta=1.0, alpha=-2.0), dim=1)])
        bank_bytes = N * D * (1 if mode == "int8" else 4) + (N * 4 if mode == "int8" else 0)
        flops = 2 * NQ * N * D + 3 * NQ * N + 2 * N * D
        # float32-accurate dots on the tensor cores: three bf16 passes against
        # an int8 bank, six against a float32 one (the kernel's pieces)
        passes = 3 if mode == "int8" else 6
        b_ms, b_by = bound(passes * flops, bank_bytes + 2 * NQ * D * 4, PEAK_BF16)
        f32_ms = bound(flops, bank_bytes + 2 * NQ * D * 4)[0]
        say(f"  nearest rows ({mode} bank): queries ({NQ}, {D}), bank ({N}, {D}) -> "
            f"rows identical {same.float().mean().item():.4%} (others within rounding: {ok}), "
            f"max_abs_err {err:.3g}, kernel_ms {ms:.3f}, plain_ms {plain_ms:.3f}, "
            f"bound_ms {b_ms:.3f} ({b_by}, {passes} bf16 passes), bound_f32_ms {f32_ms:.3f}, "
            f"library_ms {lib_ms:.3f} (addmm + argmin; kernel below it: {ms < lib_ms})")
        if not ok:
            fail(f"nearest rows ({mode}) disagree with the plain version")
        results[mode] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, bound_f32_ms=f32_ms, library_ms=lib_ms)
    return results


def scaled(got, ref) -> tuple[float, float]:
    """(max |got - ref|, max |ref|)."""
    return (got - ref).abs().max().item(), max(ref.abs().max().item(), 1e-6)


def resblock1_backward_simt(x, hs, gy, convs):
    """Kernel 5 as PR 5 wrote it, on the float32 SIMT pipes
    (``rvc_resblock1_bwd_simt``): on no path of the port, timed here beside
    kernel 5 as its same-run yardstick. Returns what
    ``fused_resblock1_backward`` returns."""
    import torch

    from rvc_tpu_torch.ops import _cuda
    from rvc_tpu_torch.ops import resblock as rb

    B, T, C = x.shape
    k = convs[0][2]
    taps, taps_t, bias, dil = rb._packed(convs)
    lib = _cuda.library()
    work = x.new_empty(lib.rvc_resblock1_bwd_simt_workspace(B, T, C, k))
    dx, dw, db = torch.empty_like(x), x.new_empty(taps.shape), x.new_empty(bias.shape)
    err = lib.rvc_resblock1_bwd_simt(
        x.data_ptr(), hs.data_ptr(), gy.contiguous().data_ptr(), taps.data_ptr(),
        taps_t.data_ptr(), bias.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        work.data_ptr(), work.numel(), B, T, C, k, len(dil), dil, _cuda.stream_ptr(x))
    _cuda.check(err, "resblock1_bwd_simt launch")
    return dx, dw.permute(0, 3, 2, 1), db


def wn_backward_simt(x, xs, pre, gy, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths, *,
                     kernel_size: int):
    """Kernel 7 as PR 5 wrote it, on the float32 SIMT pipes
    (``rvc_wn_bwd_simt``): on no path of the port, timed here beside kernel 7
    as its same-run yardstick. Returns what ``fused_wn_backward`` returns."""
    import torch

    from rvc_tpu_torch.ops import _cuda

    B, T, C = x.shape
    L, k = w_res.shape[0], kernel_size
    # wabT[i][j][c][o] = W{a,b}[i][k-1-j][o][c]; wrsT[i] = [Wres_i^T; Wskip_i^T]
    wab_t = torch.cat([w.reshape(L, k, C, C).flip(1).transpose(2, 3) for w in (w_a, w_b)],
                      dim=2).contiguous()
    wrs_t = torch.cat([w_res.transpose(1, 2), w_skip.transpose(1, 2)], dim=1).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    lib = _cuda.library()
    work = x.new_empty(lib.rvc_wn_bwd_simt_workspace(B, T, C, k))
    dx = torch.empty_like(x)
    grads = [x.new_empty(sh) for sh in ((L * k, C, C), (L * k, C, C), (2 * L, C),
                                       (B, 2 * L, C), (L, C, C), (L, C, C), (2 * L, C))]
    err = lib.rvc_wn_bwd_simt(
        x.data_ptr(), xs.data_ptr(), pre[0].data_ptr(), pre[1].data_ptr(),
        gy.contiguous().data_ptr(), wab_t.data_ptr(), wrs_t.data_ptr(), lens.data_ptr(),
        dx.data_ptr(), *[g.data_ptr() for g in grads], work.data_ptr(), work.numel(), B, T, C,
        k, L, _cuda.stream_ptr(x))
    _cuda.check(err, "wn_bwd_simt launch")
    return (dx, *grads)


VALUE_TOL = 2e-5  # of the largest magnitude: float32 sums in another order
GRAD_TOL = 1e-4   # of the largest magnitude: also reductions over every row
# Through a leaky ReLU a gradient jumps (slope 1 or 0.1) where the
# pre-activation crosses 0; at these sizes a few hundred of a chain's ~10^7
# pre-activations lie within float32 rounding of 0 and may take the other
# slope in the kernel than in the plain version, which changes the gradients
# through them. The gradients are linear in the cotangent at each such
# pre-activation (found in a float64 run of the plain chain), so
# resblock.check_chain_grads fits those cotangents to the difference by
# least squares and holds what is left at GRAD_TOL in every element of dx,
# dW and db. (The WN is smooth: its gradients are held elementwise.)


def check_resblock_train(trainer, gen) -> tuple[dict, dict]:
    """Kernels 4 (chain forward) and 5 (its VJP) on every ResBlock1 chain of
    the decoder at the training run's shapes: x (TRAIN_BATCH, T, C) per
    stage of the sliced segment. Values, then dx, dW, db against autograd of
    the plain chain; times summed over the step's chains."""
    import torch

    from rvc_tpu_torch.ops import resblock as rb

    dev = trainer.device
    dec = trainer.synth.dec
    nk = dec.num_kernels
    B, T = TRAIN_BATCH, trainer.seg_frames
    tot = {key: dict(ms=0.0, plain_ms=0.0, flops=0.0, bytes=0.0, err=0.0, bound_ms=0.0,
                     bound_f32_ms=0.0, previous_ms=0.0) for key in ("fwd", "bwd")}
    kinks = dict(near_zero=0, explained=0, worst=0.0)
    for i, rate in enumerate(dec.upsample_rates):
        T *= rate
        stage = dict(ms=0.0, previous_ms=0.0)
        for blk in dec.resblocks[i * nk:(i + 1) * nk]:
            with torch.no_grad():
                convs = [(w.detach().clone(), b.detach().clone(), k, d)
                         for w, b, k, d in blk.chain()]
            C, k, n = convs[0][0].shape[0], convs[0][2], len(convs) // 2
            params = [t for w, b, _, _ in convs for t in (w, b)]
            x = torch.randn(B, T, C, generator=gen).to(dev)
            gy = torch.randn(B, T, C, generator=gen).to(dev)
            y, hs = rb._resblock1_forward(x, convs)
            dx, dw, db = rb.fused_resblock1_backward(x, hs, gy, convs)
            torch.cuda.synchronize()
            y_ref = rb.fused_resblock1_plain(x, convs)
            dx_ref, dw_ref, db_ref = rb.fused_resblock1_backward_plain(x, hs, gy, convs)
            g_ref = [dx_ref] + [t for c in range(2 * n) for t in (dw_ref[c], db_ref[c])]
            err, sc = scaled(y, y_ref)
            if not err <= VALUE_TOL * sc:
                fail(f"kernel 4 disagrees with its plain version at C={C}, k={k}: "
                     f"{err:.3g} > {VALUE_TOL} x {sc:.3g}")
            got = [dx] + [t for c in range(2 * n) for t in (dw[c], db[c])]
            msg, counts = rb.check_chain_grads(x, convs, (dx, dw, db), (dx_ref, dw_ref, db_ref),
                                               GRAD_TOL)
            if msg:
                fail(f"kernel 5 disagrees with autograd of the plain chain at C={C}, k={k}: "
                     f"{msg} ({counts})")
            kinks["near_zero"] += counts["near_zero"]
            kinks["explained"] += counts["explained"]
            kinks["worst"] = max(kinks["worst"], counts["worst"])
            tot["fwd"]["err"] = max(tot["fwd"]["err"], err)
            tot["bwd"]["err"] = max([tot["bwd"]["err"]] + [scaled(a, r)[0]
                                                           for a, r in zip(got, g_ref)])
            ms4 = timed(lambda: rb.fused_resblock1(x, convs), reps=5)
            plain4 = timed(lambda: rb.fused_resblock1_plain(x, convs), reps=5)
            # kernel 5 and the SIMT backward it replaced, in turns
            run5 = lambda: rb.fused_resblock1_backward(x, hs, gy, convs)  # noqa: E731
            run_prev = lambda: resblock1_backward_simt(x, hs, gy, convs)  # noqa: E731
            prev5 = timed(run_prev, reps=5)
            ms5 = min(timed(run5, reps=5), timed(run5, reps=5))
            prev5 = min(prev5, timed(run_prev, reps=5))
            stage["ms"] += ms5
            stage["previous_ms"] += prev5
            tot["bwd"]["previous_ms"] += prev5
            plain5 = timed(lambda: rb.fused_resblock1_backward_plain(x, hs, gy, convs), reps=5)
            act, wts = B * T * C * 4, sum(p.numel() for p in params) * 4
            conv = 2 * k * C * C * B * T  # flops of one conv
            cost = {"fwd": (2 * n * conv, (n + 1) * act + wts),
                    "bwd": (5 * n * conv, (n + 3) * act + 2 * wts)}
            for key, ms, plain in (("fwd", ms4, plain4), ("bwd", ms5, plain5)):
                flops, nbytes = cost[key]
                t = tot[key]
                t["ms"] += ms
                t["plain_ms"] += plain
                t["flops"] += flops
                t["bytes"] += nbytes
                t["bound_ms"] += bound_tc(flops, nbytes)[0]
                t["bound_f32_ms"] += bound(flops, nbytes)[0]
            say(f"  chain x ({B}, {T}, {C}), k {k}: kernel 4 ms {ms4:.3f} (plain {plain4:.3f}, "
                f"err {err:.3g}), kernel 5 ms {ms5:.3f} (previous_ms {prev5:.3f}, plain "
                f"{plain5:.3f}; pre-activations "
                f"near 0 {counts['near_zero']}, elements beyond {GRAD_TOL} {counts['explained']}, "
                f"left after the fit {counts['worst']:.3g}), "
                f"bounds {bound_tc(*cost['fwd'])[0]:.3f} / {bound_tc(*cost['bwd'])[0]:.3f} ms "
                f"(float32 {bound(*cost['fwd'])[0]:.3f} / {bound(*cost['bwd'])[0]:.3f})")
        say(f"  kernel 5, stage {i + 1} ({len(dec.resblocks[i * nk:(i + 1) * nk])} chains): "
            f"kernel_ms {stage['ms']:.3f}, previous_ms {stage['previous_ms']:.3f} (kernel below "
            f"it: {stage['ms'] < stage['previous_ms']})")
    say(f"  kernel 5 over all chains: {kinks['explained']} elements of dx, dW and db beyond "
        f"{GRAD_TOL} of their largest magnitude, explained by fitting the cotangents at "
        f"{kinks['near_zero']} pre-activations near 0; the worst element left after the fit "
        f"{kinks['worst']:.3g} of its largest magnitude")
    return _train_results(tot)


def _train_results(tot) -> tuple[dict, dict]:
    """The forward's and the backward's entries of the kernels line; the
    backward's with previous_ms, its SIMT yardstick's time."""
    return tuple(dict(max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                      bound_ms=t["bound_ms"], bound_by=bound_tc(t["flops"], t["bytes"])[1],
                      bound_f32_ms=t["bound_f32_ms"], library_ms=None,
                      **({"previous_ms": t["previous_ms"]} if key == "bwd" else {}))
                 for key, t in tot.items())


def check_wn_train(trainer, lengths, T: int, gen) -> tuple[dict, dict]:
    """Kernels 6 (WN stack) and 7 (its VJP) on every WN stack of the
    generator (the posterior encoder's 16 layers, each flow's 3) at the
    training batch's shape and lengths: values, then dx and every weight
    and conditioning gradient against autograd of the plain stack."""
    import torch

    from rvc_tpu_torch.ops import wavenet as wn

    dev = trainer.device
    synth = trainer.synth
    stacks = [synth.enc_q.enc] + [f.enc for f in synth.flow.flows if hasattr(f, "enc")]
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    B = len(lengths)
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None]).float()[:, None]
    tot = {key: dict(ms=0.0, plain_ms=0.0, flops=0.0, bytes=0.0, err=0.0, bound_ms=0.0,
                     bound_f32_ms=0.0, previous_ms=0.0) for key in ("fwd", "bwd")}
    timed_for = {}
    for stack in stacks:
        C, L, k = stack.hidden_channels, stack.n_layers, stack.kernel_size
        g = torch.randn(B, stack.cond_layer.in_channels, 1, generator=gen).to(dev)
        with torch.no_grad():
            *ws, lengths_t = [a.detach().clone() for a in stack.fused_args(mask, g)]
        x = torch.randn(B, T, C, generator=gen).to(dev) * mask.transpose(1, 2)
        gy = torch.randn(B, T, C, generator=gen).to(dev)
        y, xs, pre = wn._forward(x, *ws, lengths_t, k)
        got = wn.fused_wn_backward(x, xs, pre, gy, *ws, lengths_t, kernel_size=k)
        torch.cuda.synchronize()
        y_ref = wn.fused_wn_plain(x, *ws, lengths_t, kernel_size=k)
        g_ref = wn.fused_wn_backward_plain(x, xs, pre, gy, *ws, lengths_t, kernel_size=k)
        err, sc = scaled(y, y_ref)
        if not err <= VALUE_TOL * sc:
            fail(f"kernel 6 disagrees with its plain version (L={L}): {err:.3g} > "
                 f"{VALUE_TOL} x {sc:.3g}")
        gerrs = [scaled(a, r) for a, r in zip(got, g_ref)]
        names = ("dx", "dWa", "dWb", "dBab", "dG", "dWres", "dWskip", "dBrs")
        for name, (e, s_) in zip(names, gerrs):
            if not e <= GRAD_TOL * s_:
                fail(f"kernel 7 disagrees with autograd of the plain stack (L={L}) in {name}: "
                     f"{e:.3g} > {GRAD_TOL} x {s_:.3g}")
        tot["fwd"]["err"] = max(tot["fwd"]["err"], err)
        tot["bwd"]["err"] = max([tot["bwd"]["err"]] + [e for e, _ in gerrs])
        if L not in timed_for:  # stacks of one depth share shapes: time one of each
            ms6 = timed(lambda: wn._forward(x, *ws, lengths_t, k), reps=5)
            plain6 = timed(lambda: wn.fused_wn_plain(x, *ws, lengths_t, kernel_size=k), reps=5)
            # kernel 7 and the SIMT backward it replaced, in turns
            run7 = lambda: wn.fused_wn_backward(x, xs, pre, gy, *ws, lengths_t,  # noqa: E731
                                                kernel_size=k)
            run_prev = lambda: wn_backward_simt(x, xs, pre, gy, *ws, lengths_t,  # noqa: E731
                                                kernel_size=k)
            prev7 = timed(run_prev, reps=5)
            ms7 = min(timed(run7, reps=5), timed(run7, reps=5))
            prev7 = min(prev7, timed(run_prev, reps=5))
            plain7 = timed(lambda: wn.fused_wn_backward_plain(x, xs, pre, gy, *ws, lengths_t,
                                                              kernel_size=k), reps=5)
            timed_for[L] = (ms6, plain6, ms7, plain7, prev7)
            say(f"  WN stack x ({B}, {T}, {C}), L {L}, lengths {lens.tolist()}: kernel 6 ms "
                f"{ms6:.3f} (plain {plain6:.3f}, err {err:.3g}), kernel 7 ms {ms7:.3f} "
                f"(previous_ms {prev7:.3f}, kernel below it: {ms7 < prev7}; plain "
                f"{plain7:.3f}, worst grad err {max(e / s_ for e, s_ in gerrs):.3g} "
                f"of its largest magnitude)")
        ms6, plain6, ms7, plain7, prev7 = timed_for[L]
        tot["bwd"]["previous_ms"] += prev7
        act, wts = B * T * C * 4, sum(w.numel() for w in ws) * 4
        rows = B * T
        cost = {"fwd": (L * rows * (4 * k * C * C + 4 * C * C), (3 * L + 1) * act + wts),
                "bwd": (L * rows * (8 * k * C * C + 8 * C * C), (3 * L + 2) * act + 2 * wts)}
        for key, ms, plain in (("fwd", ms6, plain6), ("bwd", ms7, plain7)):
            flops, nbytes = cost[key]
            t = tot[key]
            t["ms"] += ms
            t["plain_ms"] += plain
            t["flops"] += flops
            t["bytes"] += nbytes
            t["bound_ms"] += bound_tc(flops, nbytes)[0]
            t["bound_f32_ms"] += bound(flops, nbytes)[0]
    return _train_results(tot)


def make_dataset(root: str, data) -> str:
    """An RVCDataset on disk: len(CLIP_SECONDS) clips of the speech fixture
    resampled to 48 kHz and written as float32 wavs (as preprocessing writes
    them), seeded random 768-dim features at 50 Hz and f0 of 100-300 Hz with
    its coarse bins. Returns the filelist's path."""
    import torch
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    from rvc_tpu_torch.pitch.extractor import coarse_f0
    from rvc_tpu_torch.train.data import write_filelist

    rng = np.random.default_rng(0)
    rows = []
    for i, sec in enumerate(CLIP_SECONDS):
        clip = resample_poly(speech(float(sec), 5.0 + 7.0 * i), 3, 1).astype(np.float32)
        frames = len(clip) // data.hop_length
        f0 = rng.uniform(100.0, 300.0, frames).astype(np.float32)
        paths = [os.path.join(root, f"{i}{ext}") for ext in
                 (".wav", ".feat.npy", ".pitch.npy", ".pitchf.npy")]
        wavfile.write(paths[0], data.sampling_rate, clip)
        np.save(paths[1], rng.standard_normal((frames // 2 + 1, 768)).astype(np.float32))
        np.save(paths[2], coarse_f0(torch.from_numpy(f0)).numpy().astype(np.int32))
        np.save(paths[3], f0)
        rows.append("|".join(paths) + "|0")
    filelist = os.path.join(root, "filelist.txt")
    write_filelist(filelist, rows)
    return filelist


def check_train_vs_cpu(cfg, batch: dict) -> None:
    """One training step on the card and on the CPU (plain versions) from the
    same weights, batch and draws, at batch 1 and 48 frames."""
    import torch

    from rvc_tpu_torch.train.step import Trainer

    F = 48
    hop = cfg.data.hop_length
    small = {}
    for key, v in batch.items():
        v = np.asarray(v)[:1]
        if key in ("phone", "pitch", "pitchf", "spec"):
            v = v[:, :F]
        elif key == "wave":
            v = v[:, :F * hop]
        elif key.endswith("lengths"):
            v = np.minimum(v, F * (hop if key == "wave_lengths" else 1))
        small[key] = v
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        tr = Trainer(cfg, device=dev)
        st = tr.init_state(seed=7)
        st, m = tr.step(st, small, draws=tr.draws(small, seed=3))
        params = [p.detach().cpu() for p in list(tr.synth.parameters()) +
                  list(tr.disc.parameters())]
        runs[dev] = ({k: float(v) for k, v in m.items()}, params, time.perf_counter() - t0)
        del tr, st
    (mg, pg, tg), (mc, pc, tc) = runs["cuda"], runs["cpu"]
    lr = cfg.train.learning_rate
    loss_err = max(abs(mg[k] - mc[k]) / max(1.0, abs(mc[k])) for k in mg
                   if not k.startswith("grad_norm"))
    norm_err = max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in ("grad_norm_g", "grad_norm_d"))
    delta = torch.cat([(a - b).abs().flatten() for a, b in zip(pg, pc)])
    worst, share = delta.max().item(), (delta > 0.01 * lr).float().mean().item()
    say(f"[8/8] one training step, batch 1, {F} frames, card vs CPU: losses within "
        f"{loss_err:.3g} (relative, of max(1, |loss|); tolerance 1e-3), gradient norms within "
        f"{norm_err:.3g} (tolerance 1e-2), updated parameters max |diff| {worst:.3g} "
        f"(tolerance 2.01 lr = {2.01 * lr:.3g}), share above 0.01 lr {share:.4%} (tolerance "
        f"1%); card run {tg:.1f} s, CPU run {tc:.1f} s")
    # Tolerances: the forward is the same float32 math summed in another
    # order (1e-3 of each loss); a gradient norm also sees leaky-ReLU slope
    # flips at pre-activations within rounding of 0 (1e-2); Adam's first
    # update moves each parameter by lr times about sign(gradient) (plus
    # decay), so two runs differ by at most 2 lr where a gradient's sign
    # differs, which only gradients within rounding of 0 do (1% of elements).
    if not (loss_err <= 1e-3 and norm_err <= 1e-2 and worst <= 2.01 * lr and share <= 0.01):
        fail("the card's training step disagrees with the CPU's")


def run_training(trainer, batches: list, card: str) -> dict:
    """One warm-up step and TRAIN_STEPS timed steps; returns the launches of
    the timed steps."""
    import torch

    from rvc_tpu_torch.ops import attention, resblock, retrieval, wavenet

    state = trainer.init_state(seed=0, steps_per_epoch=len(batches))
    t0 = time.perf_counter()
    state, m = trainer.step(state, batches[0], keep_grads=True)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    dead = [name for module, key in ((trainer.synth, "g"), (trainer.disc, "d"))
            for (name, _), g in zip(module.named_parameters(), trainer.grads[key])
            if not torch.any(g != 0).item()]
    trainer.grads = None
    if dead:
        fail(f"{len(dead)} parameters got no gradient in the first step: {dead[:8]}")
    say(f"  warm-up step {first:.2f} s; every parameter of G "
        f"({sum(1 for _ in trainer.synth.parameters())}) and D "
        f"({sum(1 for _ in trainer.disc.parameters())}) has a nonzero gradient")
    counters = {"fused_resblock1": resblock.fused_resblock1,
                "fused_resblock1_backward": resblock.fused_resblock1_backward,
                "fused_wn": wavenet.fused_wn, "fused_wn_backward": wavenet.fused_wn_backward,
                "fused_resblock_group": resblock.fused_resblock_group,
                "banded_rel_attention": attention.banded_rel_attention,
                "nearest_rows_q": retrieval.nearest_rows_q}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        vals = {k: float(v) for k, v in m.items()}
        losses.append(vals)
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"a loss is not finite: {vals}")
    launches = {k: fn.launches for k, fn in counters.items()}
    n_chains = len(trainer.synth.dec.resblocks)
    n_wn = sum(1 for mod in trainer.synth.modules() if type(mod).__name__ == "WN")
    steps = len(walls)
    expected = {"fused_resblock1": n_chains * steps, "fused_resblock1_backward": n_chains * steps,
                "fused_wn": n_wn * steps, "fused_wn_backward": n_wn * steps,
                "fused_resblock_group": 0, "banded_rel_attention": 0, "nearest_rows_q": 0}
    cfg = trainer.config
    audio_s = TRAIN_BATCH * cfg.train.segment_size / cfg.data.sampling_rate
    total = sum(walls)
    say(f"[7/8] training 48k_v2, batch {TRAIN_BATCH}, padded to "
        f"{np.shape(batches[1]['spec'])[1]} frames: {steps} steps, wall s "
        f"{[round(w, 4) for w in walls]}, {steps / total:.3f} steps/s, "
        f"{audio_s * steps / total:.3f} s of audio (the sliced segments) trained per s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches}; {card}")
    for i, vals in enumerate(losses):
        say(f"  step {i + 1}: " + ", ".join(f"{k} {v:.5g}" for k, v in vals.items()))
    if launches != expected:
        fail(f"training kernel launches {launches}, expected {expected}")
    return launches


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
    say(f"[1/8] card: {name}, {count} device(s); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(card)

    # 2. the build
    from rvc_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    info = _cuda.build_info
    say(f"[2/8] build: {'cached' if info['cached'] else 'nvcc'} {info['seconds']:.2f} s "
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
    say(f"[3/8] kernels at the 30 s conversion's shapes: {shapes['N']} chunks, "
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
        say(f"[4/8] convert {sec} s: {len(spans)} chunks, {len(out)} samples at {sr} Hz, "
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
    say(f"[5/8] 3 s on the card vs the CPU: {len(out_gpu)} vs {len(out_cpu)} samples, "
        f"max |diff| {diff.max()} LSB, share above {tol} LSB {np.mean(diff > tol):.4%} "
        f"(tolerance {tol} LSB: the same float32 math summed in another order, "
        f"~1e-5 relative before the int16 scaling); CPU run "
        f"{time.perf_counter() - t0:.1f} s")
    if out_gpu.shape != out_cpu.shape or diff.max() > tol:
        fail("the card's conversion disagrees with the CPU's")

    del vc, cpu
    torch.cuda.empty_cache()

    # 6. the training kernels at the training run's shapes
    from rvc_tpu_torch.config import preset
    from rvc_tpu_torch.train.data import BucketBatcher, RVCDataset
    from rvc_tpu_torch.train.step import Trainer

    cfg = preset("48k_v2")
    tmp = tempfile.TemporaryDirectory(prefix="rvc_smoke_")  # removed when main returns
    t0 = time.perf_counter()
    batcher = BucketBatcher(RVCDataset(make_dataset(tmp.name, cfg.data), cfg.data),
                            TRAIN_BATCH, seed=1234)
    per_epoch = len(list(batcher.epoch(0)))
    batches = [b for e in range(-(-(1 + TRAIN_STEPS) // per_epoch))
               for b in batcher.epoch(e)][:1 + TRAIN_STEPS]
    trainer = Trainer(cfg, device="cuda")
    trainer.init_state(seed=0)
    say(f"dataset of {len(CLIP_SECONDS)} clips, {len(batches)} batches, trainer built in "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"[6/8] training kernels at the training run's shapes: batch {TRAIN_BATCH}, "
        f"segment {cfg.train.segment_size} samples, WN over {np.shape(batches[0]['spec'])[1]} "
        f"frames")
    gen = torch.Generator().manual_seed(2)
    checks["chain"], checks["chain_bwd"] = check_resblock_train(trainer, gen)
    checks["wn"], checks["wn_bwd"] = check_wn_train(
        trainer, batches[0]["spec_lengths"], np.shape(batches[0]["spec"])[1], gen)
    per_step = {"chain": len(trainer.synth.dec.resblocks),
                "wn": sum(1 for m in trainer.synth.modules() if type(m).__name__ == "WN")}
    for key, kname, held in (
            ("chain", "kernel 4", f"values within {VALUE_TOL} of the largest"),
            ("chain_bwd", "kernel 5", f"gradients within {GRAD_TOL} of the largest once the "
             "cotangents at pre-activations near 0 are fitted"),
            ("wn", "kernel 6", f"values within {VALUE_TOL} of the largest"),
            ("wn_bwd", "kernel 7", f"gradients within {GRAD_TOL} of the largest")):
        c = checks[key]
        say(f"  {kname} per training step: max_abs_err {c['max_abs_err']:.3g} ({held}), "
            f"kernel_ms {c['ms']:.3f}, plain_ms {c['plain_ms']:.3f}, bound_ms "
            f"{c['bound_ms']:.3f} ({c['bound_by']}), bound_f32_ms {c['bound_f32_ms']:.3f}, "
            f"library_ms none, "
            + (f"previous_ms {c['previous_ms']:.3f} (kernel below it: "
               f"{c['ms'] < c['previous_ms']}), " if "previous_ms" in c else "")
            + f"launches per step {per_step[key.split('_')[0]]}")

    # 7. the training path
    trained = run_training(trainer, batches, card)
    launches = {"fused_resblock_group": launches["resblock"],
                "banded_rel_attention": launches["attention"],
                "nearest_rows_q": launches["nearest"],
                **{k: trained[k] for k in ("fused_resblock1", "fused_resblock1_backward",
                                           "fused_wn", "fused_wn_backward")}}
    del trainer
    torch.cuda.empty_cache()

    # 8. the card's training step against the CPU's
    check_train_vs_cpu(cfg, batches[0])

    kernels = []
    meta = {
        "resblock": ("fused_resblock_group", "rvc_tpu_torch/csrc/resblock_group.cu",
                     "rvc_tpu/ops/pallas_resblock.py:591"),
        "attention": ("banded_rel_attention", "rvc_tpu_torch/csrc/banded_attention.cu",
                      "rvc_tpu/ops/pallas_attention.py:156"),
        "nearest": ("nearest_rows_q", "rvc_tpu_torch/csrc/nearest_rows.cu",
                    "rvc_tpu/ops/pallas_retrieval.py:99"),
        "chain": ("fused_resblock1", "rvc_tpu_torch/csrc/resblock_group.cu",
                  "rvc_tpu/ops/pallas_resblock.py:86"),
        "chain_bwd": ("fused_resblock1_backward", "rvc_tpu_torch/csrc/resblock_bwd.cu",
                      "rvc_tpu/ops/pallas_resblock.py:223"),
        "wn": ("fused_wn", "rvc_tpu_torch/csrc/wavenet.cu", "rvc_tpu/ops/pallas_wavenet.py:56"),
        "wn_bwd": ("fused_wn_backward", "rvc_tpu_torch/csrc/wavenet.cu",
                   "rvc_tpu/ops/pallas_wavenet.py:152"),
    }
    for key, (kname, src, replaces) in meta.items():
        c = checks[key]
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[kname], "max_abs_err": c["max_abs_err"],
                        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"], "bound_f32_ms": c["bound_f32_ms"],
                        "library_ms": c.get("library_ms"),
                        **({"previous_ms": c["previous_ms"]} if "previous_ms" in c else {})})
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
