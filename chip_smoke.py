"""Smoke run of rvc_tpu_torch on one NVIDIA card: build, check, convert, train,
separate (VR, MDX-Net, Demucs, BS-RoFormer, Mel-Band RoFormer, Karafan),
train and convert over several devices, transcribe (Whisper), lip-sync
(MuseTalk).

    python3 chip_smoke.py

Phases, each announced on its own line:
  1. the card: name, count, and nvidia-smi's name and power limit;
  2. the build: nvcc compiles the CUDA kernels of rvc_tpu_torch/csrc into
     one shared library (seconds and the -Xptxas -v summary are printed);
     the library's SASS must hold wgmma (HGMMA) and bulk copies (UBLKCP)
     in the bf16 unit kernel, in kernel 4's conv kernel and in kernel 6's
     two (its in-conv with the gate, its res/skip 1x1), and mma.sync
     (HMMA) in kernel 2 (float32) and in kernel 2's bf16 launches; kernels
     whose wgmma ptxas serialized (C7515) are named;
  3. each kernel against its plain PyTorch version at the shapes of the
     30 s conversion of phase 4, with its time, its plain version's time
     and two bounds (the least time the card could take): bound_ms for
     float32-accurate work on the tensor cores (three bf16 passes for
     kernel 3, three TF32 passes for the conv and attention kernels) and
     bound_f32_ms on the float32 pipes (67 TFLOP/s); also previous_ms,
     timed in turns in the same run, for kernel 1 each stage through the
     float32 SIMT unit kernel it replaced (still kernel 4's) and for kernel
     2 the SIMT kernel it replaced (rvc_banded_attention_simt); weights are packed
     once per set of weights, and the packing is timed apart;
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
     of the training run of phase 7, values and every gradient (kernel 7's
     on kernel 6's saved values; kernels 6 and 7 by groups of 8 layers as
     training runs them, the posterior's first group also giving its last x
     and taking that x's cotangent), with their times and bounds; previous_ms,
     per decoder stage or WN depth and in all, the float32 SIMT kernels
     that their tensor-core versions replaced (kernel 4: previous_chain;
     kernel 6: wn_forward_simt; kernels 5 and 7: resblock1_backward_simt,
     wn_backward_simt), timed in turns with them in the same run; for
     kernel 4 also mma_sync_ms, the chain through kernel 1's float32 unit
     on mma.sync (mma_sync_chain); the weights' packing of kernels 4-7 (per
     training step, as the weights change every step) timed apart as
     pack_ms and left out of every kernel time; kernel 6's times (and its
     yardstick's and plain version's) are the device's alone, the calls
     queued behind a sleep on the card (short stacks are quicker on the
     card than the host enqueues them), and its grids are printed;
  7. the training path: an RVCDataset of 8 clips cut from the speech fixture
     (48 kHz, seeded random features and f0), Trainer(preset("48k_v2")) at
     full width with random weights, one warm-up step and 5 timed steps from
     BucketBatcher(batch_size=4); losses finite, every parameter of G and D
     with a nonzero gradient after the first step, and in the timed steps
     every training kernel launched as often as the model's structure says
     (a launch per ResBlock1 chain and per group of 8 WN layers, each
     direction), each stage's median CUDA-event ms;
  8. a reference check: one training step on the card and on the CPU
     (plain versions, same weights, batch and draws) at batch 1, 48 frames:
     losses, gradient norms and updated parameters within stated tolerances;
  9. the bf16 kernels at the shapes of the 30 s bfloat16 conversion of
     phase 10 against their plain versions, with their times, one-pass
     bf16 bounds and the float32 kernels' times on the same values: kernel
     1 in bf16 per decoder stage, kernel 8 (fused_resblock1_v2) per chain,
     kernel 2 in bf16; and kernel 8 against the float32 chain kernel at the
     seven stages of scripts/bench_resblock_v2.py; for kernels 1 and 8
     also previous_ms, the unit kernel on mma.sync they replaced
     (rvc_resblock_unit_bf16_sync) timed in turns, the packing of each
     unit kernel's weights apart, and the achieved TFLOP/s; for kernel 2
     in bf16 previous_ms, its first version (attention_bf16_sync) in turns,
     at the 30 s and the 10 s conversion's shapes;
 10. the main path in bfloat16: make_random_converter(..., dtype=bfloat16)
     converts 10 s and 30 s as in phase 4 (RTF beside phase 4's float32
     RTF, peak memory, exact launches of bf16 kernels 1 and 2 and kernel 3);
 11. the same 30 s with fuse_group=False: kernel 8 per ResBlock, its output
     bit-identical to the default route's;
 12. a reference check: 3 s in bf16 on the card and on the CPU, both on the
     card's f0, within a stated relative L2.
 13. a user's files: a full-width 48k_v2 reference .pth (fp16, weight_g /
     weight_v, conv_1 names), a HuBERT .safetensors in HF names (12 layers,
     final_proj; written by write_safetensors here), an rmvpe.pt and a
     float32 .npy bank of 131072 rows, written to a temporary directory;
     the command line (rvc_tpu_torch.cli.main convert, in process) converts
     30 s of stereo 44.1 kHz speech with --resample-sr 44100, its launches
     counted (kernel 3 over the float32 bank: nearest_rows), and its wav
     must equal a converter built by from_state_dicts from the same arrays
     on the same 16 kHz audio within 1 LSB; kernel 3 held on that bank;
 14. a full-width 32k v1 model loaded from files (five decoder stages, the
     last at C = 16; HuBERT layer 9 with final_proj, D = 256): kernel 1 per
     stage in float32 and bf16, kernel 3 at D = 256 (int8 and float32
     banks), against their plain versions; 10 s converted with exact
     launches and RTF; 3 s card vs CPU within phase 5's 4 LSB;
 15. a full-width 40k v1 no-f0 model from files (Generator on kernel 1, no
     pitch model): 10 s with exact launches and RTF; 3 s card vs CPU;
 16. convert_batch of 8 songs of 10 s in bf16 (the bench's throughput
     configuration): aggregate RTF, the stats' shares, exact launches, and
     each song against its own convert on its rows of the draws;
 17. training from a dataset through the CLI (rvc_tpu_torch.cli.main, in
     process) at 40k_v2, full width: a HuBERT .safetensors, an rmvpe.pt and a
     pretrained G and D (one tensor each of another shape) written with
     random weights; `preprocess` of the first 32 s of assets/speech_65s.wav
     at 40 kHz (clip, feature and f0 counts equal); `train` for 2 epochs at
     batch 4 from the
     pretrained G and D, saving every epoch (steps/s, audio trained per s,
     peak memory, one step's stages and each stage's median over the steps
     on the card and on the host; losses finite; kernels 4-7 launched as
     the structure says; state_N, losses.json, model_best.pth, model.pth);
     the multi-tensor AdamW against the per-tensor loop on one step's
     gradients (values, ms and launches of each); the epoch-1 checkpoint
     restored into a fresh Trainer bit for bit and epoch 2 run again within
     1e-3 of the uninterrupted run's losses; `index`, and k-means of 200001
     x 768 seeded rows to 10000 centroids in 20 iterations (inertia never
     rising, no NaN); `convert` of 10 s with the exported model and index
     (kernels 1-3 launched as the structure says, 40 kHz of the expected
     length), and 1.5 s card vs CPU within phase 5's 4 LSB;
 18. every f0 method and the host library: the port's rvc_host.cpp built by
     g++ and held against its numpy versions (the int16 quantization and
     the slicer's tags equal, the frame RMS within 5e-6); phase 4's
     converter with random CREPE nets (full and tiny, from seeds) converts
     10 s with each of pm, dio, harvest, crepe, crepe-tiny, mangio-crepe
     (hop 64), mangio-crepe-tiny, rmvpe+ and the median of rmvpe, harvest and
     crepe-tiny (kernels 1-3 launched as in phase 4, the output checked as
     there, RTF); each method's f0 of 10 s timed alone (CUDA events) with
     the kernels one call runs (torch.profiler); each method's f0 on the card
     against the CPU's on 1.5 s of speech and of a harmonic glide (CREPE
     full and mangio-crepe on 0.5 s of each): the same voicing and f0
     within the CPU tests' bars on 99% of the frames; the hybrid conversion
     of 1.5 s card vs CPU within phase 5's 4 LSB; infer_mix with one-hot
     weights against infer at that speaker;
 19. training in bfloat16 (the JAX trainer's dtype on its accelerator):
     kernels 4-7 in their bf16 form at phase 7's shapes against their plain
     versions (the bf16 unit kernel forward of every decoder chain; its
     backward, kernel 4 in float32 at bf16(0.1) and kernel 5 at bf16(0.1),
     by check_chain_grads at that slope; kernels 6 and 7 on every WN group
     through the group's bf16 route: the skip, the group's last x, dx and
     every weight gradient for both cotangents), each with its ms, packing
     ms apart and bound (one bf16 pass for the forward, three TF32 passes
     for the float32 work of the others); Trainer(preset("48k_v2"),
     dtype=bfloat16) on phase 7's batches: one warm-up step and 5 timed
     (steps/s beside phase 7's float32 rate, peak memory, each stage's
     CUDA-event ms, losses finite, every parameter with a gradient, the
     launches exact: a bf16 unit launch per residual unit, a kernel 4 and a
     kernel 5 launch per chain, a kernel 6 and a kernel 7 launch per WN
     group); one bf16 step card vs CPU on phase 8's batch, within bars from
     the CPU's own bf16-to-float32 distance (run_train_bf16); the whole
     posterior WN stack's bf16 gradients through kernels 6 and 7 against
     the plain float32 stack, within twice the plain bf16 stack's own
     distance, and the kernel groups fed the plain stack's x and dx between
     groups against the plain bf16 stack (check_wn_stack_bf16); and
     scripts/bench_torch_train.py's line, in bf16;
 20. every loss, and a no-f0 model, trained on the card: 48k_v2 with the
     gradient penalty and the HPSS, TSI and TEFS aux losses at weight 1 and
     the multi-scale mel loss, on phase 7's batches, one warm-up step and 3
     timed in float32 and in bf16 (losses finite, the aux losses and the
     penalty nonzero, every parameter with a gradient, kernels 4-7 launched
     as phases 7 and 19 count them, steps/s, peak memory and each stage's
     median beside phases 7 and 19), each new loss's cost alone, one step
     card vs CPU at phase 8's batch (phase 8's bars; in bf16 twice the
     CPU's own bf16-to-float32 distance); then 40k v1 with use_f0 = False
     (the no-f0 synthesizer) on an 8-clip 40 kHz dataset, 3 steps in each
     dtype with the same checks, its export (f0 0) loaded back through the
     port's loader equal to the trainer's weights, one step card vs CPU in
     each dtype (run_every_loss, run_nof0);
 21. 32k_v2 and 48k v1, never run on the card before, at full width: 3 s
     converted with exact kernel 1-3 launches and card vs CPU within phase
     5's 4 LSB, one training step card vs CPU within phase 8's bars
     (run_unchecked_presets);
 22. separation at full width (run_separation): a seeded 4-band VR
     CascadedASPPNet written as a UVR5 .pth and a seeded MDX-Net
     ConvTDFNetTrim written as an anonymous .onnx separate 30 s of stereo
     44.1 kHz (the speech fixture at two delays over a harmonic
     accompaniment) through load_separator, VR also with tta and MDX with
     denoise: RTF (best and median of 3 after a set-up call; tta and denoise
     one timed call), each stage's
     CUDA-event ms, the network's TFLOP/s, peak memory, the busy share under
     the profiler; card vs CPU on one window of the song a route within
     phase 5's 4 LSB;
     the CLI's separate on both routes within 4 LSB of load_separator on the
     same downmix; kernels 1-8 launched no time in the phase.
 23. separation with Demucs at full width (run_demucs): a seeded HTDemucs
     (htdemucs's layout, 7.8 s training segment) and HDemucs (hdemucs_mmi's
     layout, 10 s) written as demucs .th packages (float16, the class
     pickled as demucs's own), a Conv-TasNet .th (a bare state dict, 8 s)
     and a bag .yaml of four HTDemucs with htdemucs_ft's weights separate
     phase 22's song (30 s; the bag 10 s) through load_separator: RTF (best
     and median of 3 after a set-up call), each stage's CUDA-event ms
     (chunking, STFT, network, iSTFT, overlap-add, int16; the host the
     rest), the network's TFLOP/s, peak memory, the busy share; card vs CPU
     on one segment a model within phase 5's 4 LSB, HTDemucs also with 2
     shifts; the Wiener filter at HDemucs's spectrogram card vs CPU;
     Conv-TasNet's depthwise convs shifted against cuDNN's grouped conv;
     the CLI's separate on the HTDemucs file; kernels 1-8 launched no time.
 24. the RoFormers at full width (run_roformer): a seeded BS-RoFormer at
     the ep_317 layout (dim 512, depth 12, 62 bands, 8 heads of 64, mask
     depth 2) as a Lightning .ckpt and a Mel-Band RoFormer at the JAX
     defaults (dim 384, depth 6, 60 bands) as a bare state dict without
     freq_indices, weights at the JAX initializer's scale, separate phase
     22's song (30 s) through load_separator: the loader's config, RTF (best
     and median of 3 after a set-up call), each stage's CUDA-event ms
     (chunking, STFT, network, iSTFT, overlap-add, int16; the host the
     rest), TFLOP/s, peak memory, busy share; the stems' response to a
     perturbation of 1e-7 of the spectrogram on a window of the song
     (reported); card vs CPU on one 8 s window within phase 5's 4 LSB
     (the first ROFORMER_CPU_DEPTH layers of each model, for the CPU's
     time; a seeded -60 dB floor under the song, whose empty bands
     otherwise carry the STFT's rounding); the CLI's separate on both
     files; the Karafan recipe on 10 s at speed_preset("Fast") with the Mel
     model for vocals (cut_off 16000: both SRS passes) and phase 22's MDX
     net for music (wall, the extractors' share, the stems' peaks);
     pitch_shift by +12 and -5 semitones on 30 s of stereo, card vs CPU
     with the floor within 2e-3 relative L2 (the song as it is reported:
     its silent frames' phases are the roundings'); kernels 1-8 launched no
     time;
 25. the node graph (``rvc_tpu_torch.graph``) on the card at full width, on
     files the earlier phases wrote (phase 13's 48k_v2 .pth, HuBERT
     .safetensors, rmvpe.pt and bank, phase 22's VR .pth and 30 s song,
     phase 17's source clip): LoadAudio -> UVR5 -> LoadRVCModel, LoadHubert,
     PitchParams (RMVPE) -> Convert on the vocals -> MergeAudio with the
     instrumentals -> PreviewAudio (wav); then ProcessDataset (pm) ->
     TrainModel (40k_v2, 1 epoch) -> TrainIndex -> Convert with the exported
     .pth and its index. Convert must launch kernels 1-3 (float32 bank:
     nearest_rows) as many times as the model's structure asks and equal
     VoiceConverter.convert on the same arrays within the direct call's own
     spread over six calls (cuDNN's engines may sum with atomics); TrainModel must
     launch kernels 4-7 as phase 7 counts them; a repeated Convert and UVR5
     must hit the node cache (no counted launch, no kernel the profiler
     sees); every cached model must sit on the card. Prints each node's
     seconds, the RTF of the node against the direct call and
     max_memory_allocated;
 26. separation in bf16 (run_separation_bf16): phases 22-24's VR, MDX,
     HTDemucs, HDemucs, Conv-TasNet, BS-RoFormer and Mel-Band RoFormer files
     through load_separator(..., dtype=torch.bfloat16) on the 30 s song,
     nothing cut: every module of each network in bf16, its outputs
     finite, each int16 stem within 5e-2 relative L2 of the same call's
     float32 stems (phases 22-24); RTF (best and median of 3 after a set-up
     call) beside float32's, stages, TFLOP/s, peak memory, busy share; one
     window a route in bf16 card vs CPU within 5e-2 relative L2 (phase
     12's bar; the RoFormers' first ROFORMER_CPU_DEPTH layers, as phase
     24's); the HDemucs BLSTM's recurrence through layers.lstm (a CUDA
     graph, equal bit for bit to its steps launched one by one) against
     cuDNN's float32 and bf16 LSTMs (times and distances); kernels 1-8
     launched no time.
 27. several cards on the one card (run_several_cards; parallel/mesh.py):
     Trainer(preset("48k_v2"), world=) on phase 7's batch of 4, (a) in a
     world of 1 over NCCL equal to the plain step bit for bit, (b) over two
     ranks spawned on cuda:0 over gloo (2 rows each, 4 steps): the first
     step against one process's at batch 4 on the same draws within phase
     8's bars, the ranks' parameters equal, kernels 4-7 launched on each
     rank as phase 7 counts a step, each rank's median step ms and its
     gradient all-reduces' ms; (c) convert_batch of 8 songs of 10 s with
     devices=[cuda:0, cuda:0] int16-equal to devices=None (both on cuDNN's
     deterministic engines), kernels 1-3 launched once a replica, each
     call's RTF and peak memory;
 28. speech to text (run_whisper): Whisper medium (24 + 24 layers at width
     1024, the multilingual vocabulary) with random weights drawn on the
     card, written as an OpenAI-format .pt and loaded by load_whisper and
     RVC_TPU_LoadWhisper; the encoder on 30 s of speech card vs CPU within
     1e-4 relative L2; greedy, beam (5) and timestamp decoding of 48 tokens
     and the fallback ladder at (0, 0.2) on the card, the greedy tokens
     teacher-forced through the CPU decoder (argmax equal wherever the top
     two logits differ by more than 1e-4); RVC_TPU_Transcribe end to end on
     the 30 s clip, then RVC_TPU_TranscriptionEncoder; encoder ms, tokens/s,
     the node's wall, peak memory; kernels 1-8 launched no time;
 29. lip sync (run_musetalk): checkpoints of seeded weights at full width
     (the SD VAE at sd-vae-ft-mse widths with the older attention names,
     the MuseTalk UNet in float16, S3FD, BiSeNet with its training heads,
     FAN with 4 modules, Whisper tiny); 50 synthetic 512x512 frames and 2 s
     of speech through RVC_TPU_MuseImageFeatures (S3FD),
     RVC_TPU_MuseAudioFeatures and RVC_TPU_MuseTalk (BiSeNet, batch 8): 50
     frames of the input's shape, finite, in [0, 1]; frames/s;
     MuseTalkPipeline.process with S3FD, FAN and BiSeNet by stage (pasted
     on the drawn face's box: S3FD's seeded boxes sit on its anchors);
     get_landmarks; the VAE's and the UNet's ms and TFLOP/s at batch 8
     (FLOPs counted on the meta device); peak memory; each network card vs
     CPU on 2 frames within 1e-4 relative L2, BiSeNet's classes and FAN's
     landmarks equal on 99.9%, the pasted frames within 2 LSB; kernels 1-8
     launched no time.
Then one JSON line with the kernels, and the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero before that.
A kernel's time beside its yardsticks (previous_ms, mma_sync_ms) is
reported, with whether the kernel is below them, and fails no run: these
are times on a shared host, and a narrow margin moves between runs.
Without a CUDA card it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
import wave
from fractions import Fraction

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


def timed(fn, reps: int = 10, warmup: int = 2, device_only: bool = False) -> float:
    """Milliseconds per call: CUDA events around ``reps`` calls after warm-up.
    With ``device_only`` the card first sleeps (about 2 ms a call) while the
    host queues the calls, so that they run back to back and the events time
    the device's work alone, not the host's enqueueing."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if device_only:
        torch.cuda._sleep(int(4e6 * reps))
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


SASS_OPS = {"HGMMA": ("HGMMA",), "bulk copies": ("UBLKCP", "UTMALDG"), "HMMA": ("HMMA",)}


def sass_counts() -> dict:
    """Per kernel (template arguments dropped) of the built library, how many
    of its SASS instructions are wgmma (HGMMA), bulk or tensor copies
    (UBLKCP, UTMALDG) and mma.sync (HMMA), from cuobjdump -sass."""
    from rvc_tpu_torch.ops import _cuda

    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    lib = os.path.join(_cuda.build_info["path"], "librvc_kernels.so")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = _cuda._kernel_name(line.split("Function :")[1].strip()).split("<")[0]
            counts.setdefault(name, dict.fromkeys(SASS_OPS, 0))
        elif name:
            for op, words in SASS_OPS.items():
                counts[name][op] += any(w in line for w in words)
    return counts


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


# ---- the yardsticks: kernels that redesigned ones replaced, on no path of
# the port, launched only here and timed in turns with their successors ----
UNCOUNTED = types.SimpleNamespace(launches=0)


def simt_taps(w):
    """A conv's (O, I, k) weights as the SIMT unit kernel reads them, (k, I, O)."""
    return w.permute(2, 1, 0).contiguous()


def previous_f32(x, chains):
    """Kernel 1 in float32 through the SIMT unit kernel it replaced (still
    kernel 4's), ``rvc_resblock_unit_simt``."""
    from rvc_tpu_torch.ops import resblock as rb

    return rb._run_units(x, chains, "rvc_resblock_unit_simt", simt_taps, UNCOUNTED)


def pack_bf16_sync_weights(w):
    """A conv's (O, I, k) float32 weights as the bf16 unit kernel on mma.sync
    (the yardstick) reads them: for each tap j, k16 step s (inputs
    16s..16s+15), n8 tile n of outputs and lane 4g + t of a warp, the four
    bf16 values w[8n + g, 16s + 4t + e, j], e = 0..3 (the B fragment of
    mma.m16n8k16 with k relabelled as in ``csrc/mma.cuh``).
    (k, I/16, O/8, 8, 4, 4) bf16."""
    import torch

    O, I, k = w.shape
    v = w.to(torch.bfloat16).permute(2, 1, 0).reshape(k, I // 16, 4, 4, O // 8, 8)
    return v.permute(0, 1, 4, 5, 2, 3).contiguous()  # j, s, n, g, t, e


def previous_bf16(x, chains):
    """Kernels 1 (bf16) and 8 as first written, on mma.sync
    (``rvc_resblock_unit_bf16_sync``): a launch per residual unit, the same
    rounding as the wgmma unit kernel that replaced it."""
    from rvc_tpu_torch.ops import resblock as rb

    return rb._run_units(x, chains, "rvc_resblock_unit_bf16_sync", pack_bf16_sync_weights,
                         UNCOUNTED)


def attention_simt(q, k, v, ek, ev, lengths, *, window: int, scale: float):
    """Kernel 2 in float32 as first written, on the float32 SIMT pipes
    (``rvc_banded_attention_simt``); what ``banded_rel_attention`` returns."""
    import torch

    from rvc_tpu_torch.ops import _cuda

    B, H, T, D = q.shape
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _cuda.library().rvc_banded_attention_simt(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ek.data_ptr(), ev.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, H, T, D, window, float(scale), _cuda.stream_ptr(q))
    _cuda.check(err, "banded_attention_simt launch")
    return out


def previous_chain(x, convs):
    """Kernel 4's first version, the SIMT unit kernel a launch per unit
    (``rvc_resblock1_fwd_simt``): what ``fused_resblock1`` returns. Its
    weights, (2n, k, C, C) [conv][tap][in][out], are laid out outside the
    timed calls by ``simt_chain_weights``."""
    import torch

    from rvc_tpu_torch.ops import _cuda

    taps, bias, dil = simt_chain_weights(convs) if isinstance(convs, list) else convs
    n = len(dil)
    B, T, C = x.shape
    hs = x.new_empty((max(n - 1, 1), B, T, C))
    out = torch.empty_like(x)
    err = _cuda.library().rvc_resblock1_fwd_simt(
        x.data_ptr(), hs.data_ptr(), out.data_ptr(), taps.data_ptr(), bias.data_ptr(), B, T, C,
        taps.shape[1], n, dil, _cuda.stream_ptr(x))
    _cuda.check(err, "resblock1_fwd_simt launch")
    return out


def simt_chain_weights(convs):
    """A chain's weights as the SIMT kernels read them: taps (2n, k, C, C)
    [conv][tap][in][out], biases (2n, C), the units' dilations as a C array."""
    import ctypes

    import torch

    taps = torch.stack([w for w, _, _, _ in convs]).permute(0, 3, 2, 1).contiguous()
    bias = torch.stack([b for _, b, _, _ in convs]).contiguous()
    dil = (ctypes.c_int * (len(convs) // 2))(*[d for _, _, _, d in convs[0::2]])
    return taps, bias, dil


def mma_sync_chain(x, convs):
    """The chain through kernel 1's float32 unit on mma.sync in 3xTF32
    (``rvc_resblock_unit``), a launch per unit; its weights packed
    once per set of weights, as kernel 1 packs them."""
    from rvc_tpu_torch.ops import resblock as rb

    return rb._run_units(x, [convs], "rvc_resblock_unit", rb.pack_tf32_weights, UNCOUNTED)


def attention_bf16_sync(q, k, v, ek, ev, lengths, *, window: int, scale: float):
    """Kernel 2 in bf16's first version (``rvc_banded_attention_bf16_sync``):
    64 query rows a block, Q.K^T twice, K and V loaded between barriers."""
    import torch

    from rvc_tpu_torch.models.layers import rounded
    from rvc_tpu_torch.ops import _cuda

    B, H, T, D = q.shape
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _cuda.library().rvc_banded_attention_bf16_sync(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ek.data_ptr(), ev.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, H, T, D, window, rounded(scale, q.dtype), _cuda.stream_ptr(q))
    _cuda.check(err, "banded_attention_bf16_sync launch")
    return out


def check_resblock(vc, shapes, gen) -> dict:
    import torch

    from rvc_tpu_torch.ops import resblock as rb
    from rvc_tpu_torch.ops.resblock import fused_resblock_group, resblock_group_plain


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
        prev_ms = timed(lambda: previous_f32(x, chains), reps=5)
        ms = timed(lambda: fused_resblock_group(x, chains), reps=5)
        ms = min(ms, timed(lambda: fused_resblock_group(x, chains), reps=5))
        prev_ms = min(prev_ms, timed(lambda: previous_f32(x, chains), reps=5))
        # the split and packing of the stage's weights, done once per set of
        # weights (ops/resblock.py::packed), so in no kernel_ms: timed apart
        pack_ms = timed(lambda: [rb.pack_tf32_weights(w) for c in chains for w, _, _, _ in c])
        plain_ms = timed(lambda: resblock_group_plain(x, chains), reps=5)
        b_ms, b_by = bound_tc(2 * macs, nbytes)
        f32_ms = bound(2 * macs, nbytes)[0]
        say(f"  resblock stage {i + 1}: x ({N}, {T}, {C}), {len(chains)} chains -> "
            f"max_abs_err {err:.3g} (tolerance {tol:.3g}), kernel_ms {ms:.3f}, "
            f"previous_ms {prev_ms:.3f} (kernel below it: {ms < prev_ms}), weight packing "
            f"{pack_ms:.3f} ms once per set of weights (in neither), "
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
    prev = attention_simt(*args, **kw)
    torch.cuda.synchronize()
    prev_err = (prev - ref).abs().max().item()
    # the kernel and the SIMT kernel it replaced, in turns
    run = lambda: banded_rel_attention(*args, **kw)  # noqa: E731
    run_prev = lambda: attention_simt(*args, **kw)  # noqa: E731
    prev_ms = timed(run_prev)
    ms = min(timed(run), timed(run))
    prev_ms = min(prev_ms, timed(run_prev))
    plain_ms = timed(lambda: banded_rel_attention_plain(*args, **kw))
    b_ms, b_by = bound_tc(flops, nbytes)
    f32_ms = bound(flops, nbytes)[0]
    n_layers = len(attn)
    grid = (-(-T // 32), N * H)
    say(f"  banded attention: q ({N}, {H}, {T}, {D}), lengths {shapes['p_len'].tolist()} -> "
        f"max_abs_err {err:.3g} (tolerance {tol:.3g}), kernel_ms {ms:.4f} (grid {grid} of 2 "
        f"warps, {flops / ms / 1e9:.1f} TFLOP/s), previous_ms {prev_ms:.4f} (the SIMT kernel, "
        f"its max_abs_err {prev_err:.3g}; kernel below it: {ms < prev_ms}), "
        f"plain_ms {plain_ms:.3f}, bound_ms {b_ms:.4f} ({b_by}), bound_f32_ms {f32_ms:.4f}, "
        f"library_ms none; x {n_layers} layers")
    if not err <= tol:
        fail("banded attention disagrees with its plain version")
    return dict(max_abs_err=err, ms=ms * n_layers, plain_ms=plain_ms * n_layers,
                previous_ms=prev_ms * n_layers, bound_ms=b_ms * n_layers, bound_by=b_by,
                bound_f32_ms=f32_ms * n_layers)


def check_nearest(vc, shapes, gen) -> dict:
    """Holds the kernel's rows against the plain version's. A query whose two
    best plain distances lie within float32 rounding of each other (1e-5
    relative) may pick either row; every other row must be identical. An
    int8 bank is searched as it is and dequantized; a float32 bank (the
    command line's) as it is."""
    import torch

    from rvc_tpu_torch.ops import retrieval

    if isinstance(vc.index_bank, tuple):
        bank_q, scales = vc.index_bank
        bank_f = bank_q.float() * scales
        modes = ("int8", "float32")
    else:
        bank_f, modes = vc.index_bank, ("float32",)
    N, D = bank_f.shape
    NQ = shapes["N"] * shapes["T50"]
    feats = torch.randn(NQ, D, generator=gen).to(vc.device)
    results = {}
    for mode in modes:
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


# ---- bfloat16 (phases 9-12) ----
# A bf16 kernel and its plain version round at the same points and differ
# only in the order of float32 sums: a rounding flips by one bf16 ulp now and
# then, and through a chain of wide convs each flip moves what it reaches by
# a fraction of an ulp and flips more (tests/test_torch_gpu.py measured this:
# after a stage of three chains at C = 256, 7% of elements lie more than one
# ulp apart, for the plain version on the card against the CPU as for the
# kernel against the plain version). So a bf16 kernel is held by size: the
# relative L2 distance within one bf16 ulp (2^-8), the largest difference
# within 2e-2 of the largest magnitude (5 ulps there).
BF16_L2 = 2.0 ** -8
BF16_MAX = 2e-2
BF16_CPU_L2 = 5e-2  # phase 12, over the int16 waveform: see there


def bf16_agreement(got, ref) -> tuple[float, float, float]:
    """(max |got - ref| / max |ref|, relative L2, share of elements more than
    one bf16 ulp apart) of two bf16 tensors."""
    import torch

    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=2.0 ** -126))) - 7)
    return ((diff.max() / ref.abs().max()).item(), (diff.norm() / ref.norm()).item(),
            (diff > ulp).float().mean().item())


def bound_bf16(flops: float, nbytes: float) -> tuple[float, str]:
    """one bf16 pass on the tensor cores"""
    return bound(flops, nbytes, PEAK_BF16)


def check_resblock_bf16(vc, shapes, gen) -> tuple[dict, dict]:
    """Kernel 1 in bf16 on each decoder stage, and kernel 8 on each of the
    stage's chains, at the 30 s bf16 conversion's shapes, against their plain
    versions. Beside each, in the same run: the unit kernel on mma.sync
    (previous_ms, timed in turns with the wgmma kernel), the float32 kernel
    on the same values (kernel 1, and kernel 4 for a chain), and the packing
    of the weights for each unit kernel, done once per set of weights and so
    in neither time."""
    import torch

    from rvc_tpu_torch.ops import resblock as rb

    dec = vc.synth.dec
    nk = dec.num_kernels
    N, T = shapes["N"], shapes["Tp"]
    keys = ("ms", "previous_ms", "pack_ms", "previous_pack_ms", "plain_ms", "float32_ms",
            "bound_ms", "flops", "bytes", "err")
    tot = {name: dict.fromkeys(keys, 0.0) for name in ("group", "chain")}
    for i, rate in enumerate(dec.upsample_rates):
        T = T * rate
        chains = [blk.chain() for blk in dec.resblocks[i * nk:(i + 1) * nk]]
        C = chains[0][0][0].shape[0]
        x = torch.randn(N, T, C, generator=gen).to(vc.device).bfloat16()
        x32 = x.float()
        for name, calls in (("group", [chains]), ("chain", [[c] for c in chains])):
            for cs in calls:
                if name == "group":
                    run, plain = (lambda: rb.fused_resblock_group(x, cs),
                                  lambda: rb.resblock_group_plain(x, cs))
                    run32 = lambda: rb.fused_resblock_group(x32, cs)  # noqa: E731
                else:
                    run, plain = (lambda: rb.fused_resblock1_v2(x, cs[0]),
                                  lambda: rb.fused_resblock1_plain(x, cs[0]))
                    run32 = lambda: rb.fused_resblock1(x32, cs[0])  # noqa: E731
                prev = lambda: previous_bf16(x, cs)  # noqa: E731
                got = run()
                torch.cuda.synchronize()
                ref = plain()
                rel, l2, beyond = bf16_agreement(got, ref)
                if not (l2 <= BF16_L2 and rel <= BF16_MAX):
                    fail(f"bf16 {name} kernel disagrees with its plain version at stage "
                         f"{i + 1}: max {rel:.3g}, relative L2 {l2:.3g}")
                # the wgmma unit kernel and the mma.sync one, in turns
                prev_ms = timed(prev, reps=5)
                ms = min(timed(run, reps=5), timed(run, reps=5))
                prev_ms = min(prev_ms, timed(prev, reps=5))
                ms32 = timed(run32, reps=5)
                plain_ms = timed(plain, reps=3)
                weights = [w for c in cs for w, _, _, _ in c]
                pack_ms = timed(lambda: [rb.pack_bf16_weights(w) for w in weights])
                prev_pack_ms = timed(lambda: [pack_bf16_sync_weights(w) for w in weights])
                macs = sum(w.shape[2] for c in cs for (w, _, _, _) in c) * C * C * N * T
                nbytes = 2 * x.numel() * 2 + sum(w.numel() * 2 + b.numel() * 4
                                                 for c in cs for (w, b, _, _) in c)
                b_ms = bound_bf16(2 * macs, nbytes)[0]
                t = tot[name]
                for k, v in (("ms", ms), ("previous_ms", prev_ms), ("pack_ms", pack_ms),
                             ("previous_pack_ms", prev_pack_ms), ("plain_ms", plain_ms),
                             ("float32_ms", ms32), ("bound_ms", b_ms), ("flops", 2 * macs),
                             ("bytes", nbytes)):
                    t[k] += v
                t["err"] = max(t["err"], (got.float() - ref.float()).abs().max().item())
                del got, ref
                say(f"  bf16 {'kernel 1' if name == 'group' else 'kernel 8'} stage {i + 1}: x "
                    f"({N}, {T}, {C}), {len(cs)} chain(s) -> max {rel:.3g} of the largest, "
                    f"relative L2 {l2:.3g}, beyond one ulp {beyond:.3%} (tolerance "
                    f"{BF16_MAX} / {BF16_L2:.3g}), kernel_ms {ms:.3f} "
                    f"({2 * macs / ms / 1e9:.1f} TFLOP/s), previous_ms {prev_ms:.3f} "
                    f"({2 * macs / prev_ms / 1e9:.1f} TFLOP/s; kernel below it: {ms < prev_ms}), "
                    f"weight packing {pack_ms:.3f} ms (the mma.sync kernel's layout "
                    f"{prev_pack_ms:.3f}) once per set of weights, in neither, float32 kernel "
                    f"{ms32:.3f}, plain_ms "
                    f"{plain_ms:.3f}, bound_ms {b_ms:.3f}")
        del x, x32
    for name, t in tot.items():
        what = (f"kernel 1 over the {len(dec.upsample_rates)} stages" if name == "group"
                else f"kernel 8 over the {len(dec.resblocks)} chains")
        say(f"  bf16 {what}: "
            f"kernel_ms {t['ms']:.3f} ({t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s), previous_ms "
            f"{t['previous_ms']:.3f} ({t['ms'] / t['previous_ms']:.2f} of it), packing "
            f"{t['pack_ms']:.3f} ms (the mma.sync kernel's {t['previous_pack_ms']:.3f}), bound_ms "
            f"{t['bound_ms']:.3f}")
    return tuple(dict(max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                      previous_ms=t["previous_ms"], pack_ms=t["pack_ms"],
                      bound_ms=t["bound_ms"], bound_by=bound_bf16(t["flops"], t["bytes"])[1],
                      float32_ms=t["float32_ms"], library_ms=None)
                 for t in (tot["group"], tot["chain"]))


def check_attention_bf16(vc, shapes_by_sec: dict, gen) -> dict:
    """Kernel 2 in bf16 against its plain version at the 30 s and the 10 s
    bf16 conversion's shapes, with its first version (previous_ms, in turns)
    and the float32 kernel on the same values. The entry's times are the 30 s
    conversion's; the 10 s ones beside them."""
    import torch

    from rvc_tpu_torch.ops.attention import banded_rel_attention, banded_rel_attention_plain

    attn = vc.synth.enc_p.encoder.attn_layers
    layer = attn[0]
    n_layers = len(attn)
    H, D, w = layer.n_heads, layer.k_channels, layer.window_size
    ek, ev = (e[0].detach().bfloat16().contiguous() for e in (layer.emb_rel_k, layer.emb_rel_v))
    kw = dict(window=w, scale=D ** -0.5)
    entry = {}
    for sec in (30, 10):
        shapes = shapes_by_sec[sec]
        N, T = shapes["N"], shapes["Tp"]
        q, k, v = (torch.randn(N, H, T, D, generator=gen).to(vc.device).bfloat16()
                   for _ in range(3))
        lengths = torch.as_tensor(shapes["p_len"], device=vc.device)
        args = (q, k, v, ek, ev, lengths)
        args32 = tuple(a.float() for a in args[:5]) + (lengths,)
        got = banded_rel_attention(*args, **kw)
        again = banded_rel_attention(*args, **kw)
        torch.cuda.synchronize()
        ref = banded_rel_attention_plain(*args, **kw)
        rel, l2, beyond = bf16_agreement(got, ref)
        prev = attention_bf16_sync(*args, **kw)
        torch.cuda.synchronize()
        p_rel, p_l2, _ = bf16_agreement(prev, ref)
        W = 2 * w + 1
        flops = N * H * (4 * T * T * D + 4 * T * W * D + 5 * T * T)
        nbytes = 4 * N * H * T * D * 2 + 2 * W * D * 2 + N * 4
        # the kernel and its first version, in turns
        run = lambda: banded_rel_attention(*args, **kw)  # noqa: E731
        run_prev = lambda: attention_bf16_sync(*args, **kw)  # noqa: E731
        prev_ms = timed(run_prev)
        ms = min(timed(run), timed(run))
        prev_ms = min(prev_ms, timed(run_prev))
        ms32 = timed(lambda: banded_rel_attention(*args32, **kw))
        plain_ms = timed(lambda: banded_rel_attention_plain(*args, **kw))
        b_ms, b_by = bound_bf16(flops, nbytes)
        say(f"  bf16 banded attention at the {sec} s shapes: q ({N}, {H}, {T}, {D}), lengths "
            f"{shapes['p_len'].tolist()} -> max {rel:.3g} of the largest, relative L2 {l2:.3g}, "
            f"beyond one ulp {beyond:.3%} (tolerance {BF16_MAX} / {BF16_L2:.3g}), two calls "
            f"bit-identical {torch.equal(got, again)}, kernel_ms {ms:.4f} "
            f"({flops / ms / 1e9:.1f} TFLOP/s), previous_ms {prev_ms:.4f} (the first bf16 kernel, max "
            f"{p_rel:.3g}, relative L2 {p_l2:.3g}; kernel below it: {ms < prev_ms}), float32 "
            f"kernel {ms32:.4f}, plain_ms {plain_ms:.3f}, bound_ms {b_ms:.4f} ({b_by}); "
            f"x {n_layers} layers: {ms * n_layers:.3f} ms against {prev_ms * n_layers:.3f}")
        if not (l2 <= BF16_L2 and rel <= BF16_MAX):
            fail(f"bf16 banded attention disagrees with its plain version at the {sec} s shapes")
        if not torch.equal(got, again):
            fail("two calls of bf16 banded attention differ")
        if sec == 30:
            entry = dict(max_abs_err=(got.float() - ref.float()).abs().max().item(),
                         ms=ms * n_layers, plain_ms=plain_ms * n_layers,
                         previous_ms=prev_ms * n_layers, bound_ms=b_ms * n_layers,
                         bound_by=b_by, float32_ms=ms32 * n_layers, library_ms=None)
        else:
            entry.update(ms_10s=ms * n_layers, previous_ms_10s=prev_ms * n_layers)
        del q, k, v, got, again, ref, prev
    return entry


def bench_v2_stages() -> None:
    """Kernel 8 against the float32 chain kernel and, in turns, the mma.sync unit
    kernel at the seven stages of scripts/bench_resblock_v2.py
    (scripts/bench_torch_resblock_v2.py)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_torch_resblock_v2", os.path.join(REPO, "scripts", "bench_torch_resblock_v2.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for r in mod.run(reps=3, beside=lambda x, convs: previous_bf16(x, [convs])):
        flops = 2 * r["shape"][0] * r["shape"][1] * r["shape"][2] ** 2 * r["k"] * 6
        say(f"  {r['label']:16s} x {r['shape']} bf16: kernel 8 {r['v2_ms']:.3f} ms "
            f"({flops / r['v2_ms'] / 1e9:.1f} TFLOP/s), previous_ms {r['beside_ms']:.3f} (the "
            f"mma.sync unit, {flops / r['beside_ms'] / 1e9:.1f} TFLOP/s; kernel below it: "
            f"{r['v2_ms'] < r['beside_ms']}), float32 chain kernel {r['f32_ms']:.3f} ms "
            f"({r['f32_ms'] / r['v2_ms']:.2f}x), max err vs plain {r['max_rel_err']:.3g} of the "
            f"largest, bit-identical to plain {r['exact']}")
        if not r["max_rel_err"] <= BF16_MAX:
            fail(f"kernel 8 disagrees with its plain version at {r['label']}")


def counted_convert(vc, audio, settings, counters: dict) -> tuple[np.ndarray, int, dict, float]:
    """One conversion with every count set to 0 just before it and read just
    after: (out, sr, launches, wall s)."""
    import torch

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    out, sr = vc.convert(audio, settings=settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, sr, {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}, wall


def launch_counters() -> dict:
    """name -> (wrapper, count attribute) of every kernel of conversion."""
    from rvc_tpu_torch.ops import attention, resblock, retrieval

    return {"fused_resblock_group": (resblock.fused_resblock_group, "launches"),
            "fused_resblock_group[bf16]": (resblock.fused_resblock_group, "launches_bf16"),
            "fused_resblock1": (resblock.fused_resblock1, "launches"),
            "fused_resblock1_v2": (resblock.fused_resblock1_v2, "launches"),
            "banded_rel_attention": (attention.banded_rel_attention, "launches"),
            "banded_rel_attention[bf16]": (attention.banded_rel_attention, "launches_bf16"),
            "nearest_rows_q": (retrieval.nearest_rows_q, "launches")}


def scaled(got, ref) -> tuple[float, float]:
    """(max |got - ref|, max |ref|)."""
    return (got - ref).abs().max().item(), max(ref.abs().max().item(), 1e-6)


# ---- a user's model files (phases 13-15): written here as the reference's
# tools write them, read back through the port's loaders ----
def write_safetensors(path: str, tensors: dict, metadata: dict) -> None:
    """The safetensors format, F32 or F16: an 8-byte little-endian header
    length, a JSON header (dtype, shape, data_offsets; __metadata__), the
    raw buffers in order (the card's machine has no safetensors package)."""
    import struct

    header, blobs, off = {}, [], 0
    for name in sorted(tensors):
        a = np.ascontiguousarray(tensors[name])
        b = a.tobytes()
        header[name] = {"dtype": {"float32": "F32", "float16": "F16"}[a.dtype.name],
                        "shape": list(a.shape), "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    header["__metadata__"] = metadata
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)))
        f.write(h)
        for b in blobs:
            f.write(b)


def fold(sd: dict) -> dict:
    """{X.weight_g, X.weight_v} -> X.weight = g v / (|v| + 1e-12), the norm
    over every axis but 0, in float32; every array float32."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            continue
        v = np.asarray(v, np.float32)
        if k.endswith(".weight_v"):
            g = np.asarray(sd[k[:-2] + "_g"], np.float32)
            out[k[:-2]] = g * v / (np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim)),
                                                  keepdims=True)) + 1e-12)
        else:
            out[k] = v
    return out


def write_rvc_pth(path: str, kw: dict, version: str, seed: int) -> dict:
    """A reference inference checkpoint of Synthesizer(**kw) with random
    weights: fp16, every weight-normed layer as weight_g/weight_v (g drawn
    around 1, so that the fold matters), the FFN convs as conv_1/conv_2,
    the positional config with sr as "48k". Returns the file's fp16 values
    folded in float32: what its loader must give."""
    import torch

    from rvc_tpu_torch.models.layers import init_random_, live_weight_norm_
    from rvc_tpu_torch.models.synthesizer import Synthesizer

    synth = init_random_(live_weight_norm_(Synthesizer(**kw)), seed)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in synth.state_dict().items():
        a = v.numpy()
        if k.endswith(".weight_g"):
            a = a * rng.uniform(0.5, 1.5, a.shape)
        sd[k] = a.astype(np.float16)
    sr = kw["sr"]
    config = [kw["spec_channels"], kw["segment_size"], kw["inter_channels"],
              kw["hidden_channels"], kw["filter_channels"], kw["n_heads"], kw["n_layers"],
              kw["kernel_size"], kw["p_dropout"], kw["resblock"],
              list(kw["resblock_kernel_sizes"]), [list(d) for d in kw["resblock_dilation_sizes"]],
              list(kw["upsample_rates"]), kw["upsample_initial_channel"],
              list(kw["upsample_kernel_sizes"]), 109, kw["gin_channels"],
              f"{sr // 1000}k" if sr in (32000, 40000, 48000) else sr]
    torch.save({"weight": {k: torch.from_numpy(v) for k, v in sd.items()}, "config": config,
                "info": "random", "sr": config[-1], "f0": int(kw["use_f0"]),
                "version": version}, path)
    return fold(sd)


def write_hubert_safetensors(path: str, cfg, seed: int) -> dict:
    """A ContentVec/HuBERT file as HF writes it: 12 layers, final_proj, the
    positional conv's weight norm over dim 2 as weight_g (1, 1, k) and
    weight_v, the HF config in the metadata; random weights, F32. Returns
    what its loader must give (the positional conv folded)."""
    import dataclasses

    from rvc_tpu_torch.models.hubert import HubertEncoder
    from rvc_tpu_torch.models.layers import init_random_

    sd = {k: v.numpy() for k, v in init_random_(HubertEncoder(cfg, "v2"), seed)
          .state_dict().items()}
    rng = np.random.default_rng(seed)
    last = cfg.num_hidden_layers - 1
    for k in [k for k in sd if k.startswith("encoder.layers.10.")]:
        sd[k.replace("layers.10.", f"layers.{last}.")] = sd[k].copy()
    sd["final_proj.weight"] = (0.02 * rng.standard_normal(
        (cfg.classifier_proj_size, cfg.hidden_size))).astype(np.float32)
    sd["final_proj.bias"] = np.zeros(cfg.classifier_proj_size, np.float32)
    pc = "encoder.pos_conv_embed.conv."
    v = sd.pop(pc + "weight") * rng.uniform(0.5, 1.5, (1, 1, cfg.num_conv_pos_embeddings))
    v = v.astype(np.float32)
    sd[pc + "weight_v"] = v
    sd[pc + "weight_g"] = (np.sqrt(np.sum(v * v, axis=(0, 1), keepdims=True))
                           * rng.uniform(0.5, 1.5, (1, 1, v.shape[2]))).astype(np.float32)
    write_safetensors(path, sd, {"config": json.dumps(
        {**dataclasses.asdict(cfg), "model_type": "hubert"})})
    out = dict(sd)
    g, v = out.pop(pc + "weight_g"), out.pop(pc + "weight_v")
    out[pc + "weight"] = g * v / (np.sqrt(np.sum(v * v, axis=(0, 1), keepdims=True)) + 1e-12)
    return out


def write_rmvpe_pt(path: str, seed: int) -> dict:
    """rmvpe.pt as the reference ships it: the bare E2E state_dict, batch
    norms with num_batches_tracked; random weights. Returns its float32
    arrays without num_batches_tracked."""
    import torch

    from rvc_tpu_torch.models.layers import init_random_
    from rvc_tpu_torch.models.rmvpe import RMVPE

    sd = dict(init_random_(RMVPE(), seed).model.state_dict())
    for k in [k for k in sd if k.endswith("running_mean")]:
        sd[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(100)
    torch.save(sd, path)
    return {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def resblock1_backward_simt(x, hs, gy, convs, packs=None):
    """Kernel 5 as PR 5 wrote it, on the float32 SIMT pipes
    (``rvc_resblock1_bwd_simt``): on no path of the port, timed here beside
    kernel 5 as its same-run yardstick. ``packs``: its weights as
    ``simt_backward_weights`` lays them out (laid out here when not given).
    Returns what ``fused_resblock1_backward`` returns."""
    import torch

    from rvc_tpu_torch.ops import _cuda

    B, T, C = x.shape
    k = convs[0][2]
    taps, taps_t, bias, dil = simt_backward_weights(convs) if packs is None else packs
    lib = _cuda.library()
    work = x.new_empty(lib.rvc_resblock1_bwd_simt_workspace(B, T, C, k))
    dx, dw, db = torch.empty_like(x), x.new_empty(taps.shape), x.new_empty(bias.shape)
    err = lib.rvc_resblock1_bwd_simt(
        x.data_ptr(), hs.data_ptr(), gy.contiguous().data_ptr(), taps.data_ptr(),
        taps_t.data_ptr(), bias.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        work.data_ptr(), work.numel(), B, T, C, k, len(dil), dil, _cuda.stream_ptr(x))
    _cuda.check(err, "resblock1_bwd_simt launch")
    return dx, dw.permute(0, 3, 2, 1), db


def simt_backward_weights(convs):
    """Kernel 5's SIMT yardstick's weights: the taps and biases of
    ``simt_chain_weights``, the flipped transposed taps (WT[c][j][o][i] =
    W[c][k-1-j][i][o]) and the dilations."""
    taps, bias, dil = simt_chain_weights(convs)
    return taps, taps.flip(1).transpose(2, 3).contiguous(), bias, dil


def wn_forward_simt(x, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths, *,
                    kernel_size: int):
    """Kernel 6 as first written, on the float32 SIMT pipes
    (``rvc_wn_fwd_simt``, a launch per layer): on no path of the port, timed
    here beside kernel 6 as its same-run yardstick. Returns what
    ``wavenet._forward`` returns: (out, xs, pre)."""
    import torch

    from rvc_tpu_torch.ops import _cuda

    B, T, C = x.shape
    L = w_res.shape[0]
    args = [t.contiguous() for t in (w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2)]
    lens = lengths.to(torch.int32).contiguous()
    xs = x.new_empty((max(L - 1, 1), B, T, C))
    pre = x.new_empty((2, L, B, T, C))
    out = torch.empty_like(x)
    err = _cuda.library().rvc_wn_fwd_simt(
        x.data_ptr(), xs.data_ptr(), pre[0].data_ptr(), pre[1].data_ptr(), out.data_ptr(),
        *[t.data_ptr() for t in args], lens.data_ptr(), B, T, C, kernel_size, L,
        _cuda.stream_ptr(x))
    _cuda.check(err, "wn_fwd_simt launch")
    return out, xs, pre


def wn_grids(B: int, T: int, C: int) -> str:
    """Kernel 6's grids, as csrc/wavenet.cu's rvc_wn_fwd picks them: 128-row
    blocks over the B T rows, outputs in blocks of 48 where they divide the
    launch's N (2C; C in the last layer's 1x1), else 32, else 16."""
    rows = -(-B * T // 128)
    nb = lambda n: 48 if n % 48 == 0 else 32 if n % 32 == 0 else 16  # noqa: E731
    return (f"in-conv and 1x1 {rows} x {2 * C // nb(2 * C)} = "
            f"{rows * (2 * C // nb(2 * C))} blocks, the last 1x1 {rows} x {C // nb(C)} = "
            f"{rows * (C // nb(C))}, for 132 SMs ({rows * 128 - B * T} of {rows * 128} rows "
            f"past B T)")


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
                     bound_f32_ms=0.0, previous_ms=0.0, pack_ms=0.0, mma_sync_ms=0.0)
           for key in ("fwd", "bwd")}
    kinks = dict(near_zero=0, explained=0, worst=0.0)
    for i, rate in enumerate(dec.upsample_rates):
        T *= rate
        stage = {key: dict(ms=0.0, previous_ms=0.0, mma_sync_ms=0.0, pack_ms=0.0)
                 for key in ("fwd", "bwd")}
        for blk in dec.resblocks[i * nk:(i + 1) * nk]:
            with torch.no_grad():
                convs = [(w.detach().clone(), b.detach().clone(), k, d)
                         for w, b, k, d in blk.chain()]
            C, k, n = convs[0][0].shape[0], convs[0][2], len(convs) // 2
            params = [t for w, b, _, _ in convs for t in (w, b)]
            x = torch.randn(B, T, C, generator=gen).to(dev)
            gy = torch.randn(B, T, C, generator=gen).to(dev)
            y, hs = rb._resblock1_forward(x, convs)
            y_again = rb.fused_resblock1(x, convs)
            dx, dw, db = rb.fused_resblock1_backward(x, hs, gy, convs)
            torch.cuda.synchronize()
            if not torch.equal(y, y_again):
                fail(f"two calls of kernel 4 differ at C={C}, k={k}")
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
            # kernel 4 and the two chains it is held against, in turns: the
            # SIMT chain it replaced and kernel 1's float32 unit on mma.sync;
            # each one's weights laid out before the timed calls (kernel 4's
            # and the mma.sync unit's by the packing cache)
            simt_w = simt_chain_weights(convs)
            run4 = lambda: rb.fused_resblock1(x, convs)  # noqa: E731
            run_prev4 = lambda: previous_chain(x, simt_w)  # noqa: E731
            run_mma4 = lambda: mma_sync_chain(x, convs)  # noqa: E731
            prev4, mma4 = timed(run_prev4, reps=5), timed(run_mma4, reps=5)
            ms4 = min(timed(run4, reps=5), timed(run4, reps=5))
            mma4, prev4 = min(mma4, timed(run_mma4, reps=5)), min(prev4, timed(run_prev4, reps=5))
            # the packing of the chain's weights: once a training step
            pack4 = timed(lambda: rb.pack_chain_weights([w for w, _, _, _ in convs]), reps=5)
            plain4 = timed(lambda: rb.fused_resblock1_plain(x, convs), reps=5)
            # kernel 5 and the SIMT backward it replaced, in turns, each on
            # weights laid out before the timed calls
            packs5, simt5 = rb.pack_backward_weights(convs), simt_backward_weights(convs)
            run5 = lambda: rb.fused_resblock1_backward(x, hs, gy, convs, packs5)  # noqa: E731
            run_prev = lambda: resblock1_backward_simt(x, hs, gy, convs, simt5)  # noqa: E731
            prev5 = timed(run_prev, reps=5)
            ms5 = min(timed(run5, reps=5), timed(run5, reps=5))
            prev5 = min(prev5, timed(run_prev, reps=5))
            pack5 = timed(lambda: rb.pack_backward_weights(convs), reps=5)
            for key, vals in (("fwd", dict(ms=ms4, previous_ms=prev4, mma_sync_ms=mma4,
                                           pack_ms=pack4)),
                              ("bwd", dict(ms=ms5, previous_ms=prev5, pack_ms=pack5))):
                for name, val in vals.items():
                    stage[key][name] += val
                    if name != "ms":
                        tot[key][name] += val
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
            say(f"  chain x ({B}, {T}, {C}), k {k}: kernel 4 ms {ms4:.3f} (previous_ms "
                f"{prev4:.3f}, mma_sync_ms {mma4:.3f}, packing {pack4:.3f}, plain {plain4:.3f}, "
                f"err {err:.3g}), kernel 5 ms {ms5:.3f} (previous_ms {prev5:.3f}, packing "
                f"{pack5:.3f}, plain {plain5:.3f}; pre-activations "
                f"near 0 {counts['near_zero']}, elements beyond {GRAD_TOL} {counts['explained']}, "
                f"left after the fit {counts['worst']:.3g}), "
                f"bounds {bound_tc(*cost['fwd'])[0]:.3f} / {bound_tc(*cost['bwd'])[0]:.3f} ms "
                f"(float32 {bound(*cost['fwd'])[0]:.3f} / {bound(*cost['bwd'])[0]:.3f})")
        f4, b5 = stage["fwd"], stage["bwd"]
        n_ch = len(dec.resblocks[i * nk:(i + 1) * nk])
        say(f"  kernel 4, stage {i + 1} ({n_ch} chains): kernel_ms {f4['ms']:.3f}, previous_ms "
            f"{f4['previous_ms']:.3f}, mma_sync_ms {f4['mma_sync_ms']:.3f} (kernel below both: "
            f"{f4['ms'] < min(f4['previous_ms'], f4['mma_sync_ms'])}), pack_ms "
            f"{f4['pack_ms']:.3f}")
        say(f"  kernel 5, stage {i + 1} ({n_ch} chains): kernel_ms {b5['ms']:.3f}, previous_ms "
            f"{b5['previous_ms']:.3f} (kernel below it: {b5['ms'] < b5['previous_ms']}), "
            f"pack_ms {b5['pack_ms']:.3f}")
    say(f"  kernel 5 over all chains: {kinks['explained']} elements of dx, dW and db beyond "
        f"{GRAD_TOL} of their largest magnitude, explained by fitting the cotangents at "
        f"{kinks['near_zero']} pre-activations near 0; the worst element left after the fit "
        f"{kinks['worst']:.3g} of its largest magnitude")
    return _train_results(tot)


def _train_results(tot) -> tuple[dict, dict]:
    """The forward's and the backward's entries of the kernels line, with
    previous_ms (the SIMT yardstick), pack_ms and, where timed, mma_sync_ms."""
    return tuple(dict(max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                      bound_ms=t["bound_ms"], bound_by=bound_tc(t["flops"], t["bytes"])[1],
                      bound_f32_ms=t["bound_f32_ms"], library_ms=None,
                      **{k: t[k] for k in ("previous_ms", "mma_sync_ms", "pack_ms")
                         if t.get(k)})
                 for t in tot.values())


def wn_launches_per_step(synth) -> int:
    """Kernel 6's (and kernel 7's) launches in a training step: each WN
    stack runs as groups of at most GROUP_SIZE layers, a launch a group."""
    from rvc_tpu_torch.ops.wavenet import GROUP_SIZE

    return sum(-(-m.n_layers // GROUP_SIZE) for m in synth.modules()
               if type(m).__name__ == "WN")


def wn_stacks(trainer, lengths, T: int, gen):
    """Each WN stack of the generator (the posterior encoder's 16 layers,
    each flow's 3) with random conditioning at the training batch's lengths:
    (C, k, its fused_wn weights, lengths on the card, the mask (B, 1, T))."""
    import torch

    dev = trainer.device
    synth = trainer.synth
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None]).float()[:, None]
    for stack in [synth.enc_q.enc] + [f.enc for f in synth.flow.flows if hasattr(f, "enc")]:
        g = torch.randn(len(lengths), stack.cond_layer.in_channels, 1, generator=gen).to(dev)
        with torch.no_grad():
            *ws, lengths_t = [a.detach().clone() for a in stack.fused_args(mask, g)]
        yield stack.hidden_channels, stack.kernel_size, ws, lengths_t, mask


def check_wn_train(trainer, lengths, T: int, gen) -> tuple[dict, dict]:
    """Kernels 6 (a group of WN layers) and 7 (its VJP) on every group of
    every WN stack of the generator, as training runs them (the posterior
    encoder's 16 layers as two groups of 8, the first also giving its last
    x to the second; each flow's 3 as one) at the training batch's shape
    and lengths: values and that x, then dx and every weight and
    conditioning gradient for the cotangents of the skip and of that x, on
    kernel 6's saved values, against autograd of the plain group."""
    import torch

    from rvc_tpu_torch.ops import wavenet as wn

    dev = trainer.device
    B = len(lengths)
    tot = {key: dict(ms=0.0, plain_ms=0.0, flops=0.0, bytes=0.0, err=0.0, bound_ms=0.0,
                     bound_f32_ms=0.0, previous_ms=0.0, pack_ms=0.0) for key in ("fwd", "bwd")}
    timed_for = {}
    for C, k, ws_all, lengths_t, mask in wn_stacks(trainer, lengths, T, gen):
        lens = lengths_t
        for ws, final in wn.groups(*ws_all, k):
            L = ws[4].shape[0]
            x = torch.randn(B, T, C, generator=gen).to(dev) * mask.transpose(1, 2)
            gy = torch.randn(B, T, C, generator=gen).to(dev)
            gyx = torch.randn(B, T, C, generator=gen).to(dev) if final else None
            y, xs, pre, *xf = wn._forward(x, *ws, lengths_t, k, final=final)
            again = wn._forward(x, *ws, lengths_t, k, final=final)
            simt = wn_forward_simt(x, *ws, lengths_t, kernel_size=k)
            got = wn.fused_wn_backward(x, xs, pre, gy, *ws, lengths_t, kernel_size=k, gyx=gyx)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip([y, xs, pre, *xf], again)):
                fail(f"two calls of kernel 6 differ (L={L})")
            y_ref, xf_ref = wn._layers_plain(x, *ws, lengths_t, k)
            g_ref = wn.fused_wn_backward_plain(x, xs, pre, gy, *ws, lengths_t, kernel_size=k,
                                               gyx=gyx)
            err, sc = scaled(y, y_ref)
            if final:
                err_x, sc_x = scaled(xf[0], xf_ref)
                if not err_x <= VALUE_TOL * sc_x:
                    fail(f"kernel 6's last x disagrees with its plain version (L={L}): "
                         f"{err_x:.3g} > {VALUE_TOL} x {sc_x:.3g}")
            if not err <= VALUE_TOL * sc:
                fail(f"kernel 6 disagrees with its plain version (L={L}): {err:.3g} > "
                     f"{VALUE_TOL} x {sc:.3g}")
            # the yardstick computes the same function and keeps the same values
            kept = [(y, simt[0]), (pre, simt[2])] + ([(xs, simt[1])] if L > 1 else [])
            vs_simt = max(e / s_ for e, s_ in (scaled(a, b) for a, b in kept))
            if not vs_simt <= VALUE_TOL:
                fail(f"kernel 6 and its yardstick differ (L={L}): {vs_simt:.3g} of the largest "
                     f"magnitude > {VALUE_TOL}")
            gerrs = [scaled(a, r) for a, r in zip(got, g_ref)]
            names = ("dx", "dWa", "dWb", "dBab", "dG", "dWres", "dWskip", "dBrs")
            for name, (e, s_) in zip(names, gerrs):
                if not e <= GRAD_TOL * s_:
                    fail(f"kernel 7 disagrees with autograd of the plain group (L={L}) in "
                         f"{name}: {e:.3g} > {GRAD_TOL} x {s_:.3g}")
            tot["fwd"]["err"] = max(tot["fwd"]["err"], err)
            tot["bwd"]["err"] = max([tot["bwd"]["err"]] + [e for e, _ in gerrs])
            act, wts = B * T * C * 4, sum(w.numel() for w in ws) * 4
            rows = B * T
            cost = {"fwd": (L * rows * (4 * k * C * C + 4 * C * C),
                            (3 * L + 1 + final) * act + wts),
                    "bwd": (L * rows * (8 * k * C * C + 8 * C * C),
                            (3 * L + 2 + final) * act + 2 * wts)}
            if (L, final) not in timed_for:  # groups of one depth share shapes: time one
                # kernel 6 on weights packed before the timed calls and the SIMT
                # forward it replaced, in turns; the packing (once a training
                # step) apart; device time alone for all of kernel 6's row
                w_a, w_b, _, _, w_res, w_skip, _ = ws
                packs6 = wn.pack_forward_weights(w_a, w_b, w_res, w_skip, k, final)
                run6 = lambda: wn._forward(x, *ws, lengths_t, k, packs6, final)  # noqa: E731
                run_prev6 = lambda: wn_forward_simt(x, *ws, lengths_t, kernel_size=k)  # noqa: E731
                prev6 = timed(run_prev6, reps=5, device_only=True)
                ms6 = min(timed(run6, reps=10, device_only=True),
                          timed(run6, reps=10, device_only=True))
                prev6 = min(prev6, timed(run_prev6, reps=5, device_only=True))
                pack6 = timed(lambda: wn.pack_forward_weights(w_a, w_b, w_res, w_skip, k, final),
                              reps=5, device_only=True)
                plain6 = timed(lambda: wn._layers_plain(x, *ws, lengths_t, k), reps=5,
                               device_only=True)
                # kernel 7 on weights packed before the timed calls, and the SIMT
                # backward it replaced, in turns; the packing apart
                packs7 = wn.pack_backward_weights(w_a, w_b, w_res, w_skip, k)
                run7 = lambda: wn.fused_wn_backward(x, xs, pre, gy, *ws, lengths_t,  # noqa: E731
                                                    kernel_size=k, packs=packs7, gyx=gyx)
                run_prev = lambda: wn_backward_simt(x, xs, pre, gy, *ws, lengths_t,  # noqa: E731
                                                    kernel_size=k)
                prev7 = timed(run_prev, reps=5)
                ms7 = min(timed(run7, reps=5), timed(run7, reps=5))
                prev7 = min(prev7, timed(run_prev, reps=5))
                pack7 = timed(lambda: wn.pack_backward_weights(w_a, w_b, w_res, w_skip, k),
                              reps=5)
                plain7 = timed(lambda: wn.fused_wn_backward_plain(
                    x, xs, pre, gy, *ws, lengths_t, kernel_size=k, gyx=gyx), reps=5)
                timed_for[L, final] = (ms6, plain6, prev6, pack6, ms7, plain7, prev7, pack7)
                say(f"  WN group x ({B}, {T}, {C}), L {L}{', its last x wanted' if final else ''}, "
                    f"lengths {lens.tolist()}: kernel 6 ms {ms6:.4f} (previous_ms {prev6:.4f}, "
                    f"kernel below it: {ms6 < prev6}; plain {plain6:.4f}, kernel below it: "
                    f"{ms6 < plain6}; packing {pack6:.4f}; bound {bound_tc(*cost['fwd'])[0]:.4f}; "
                    f"err {err:.3g} of the largest, {vs_simt:.3g} against the yardstick in out, "
                    f"xs, pre; grids: {wn_grids(B, T, C)}), kernel 7 ms {ms7:.3f} (previous_ms "
                    f"{prev7:.3f}, kernel below it: {ms7 < prev7}; packing {pack7:.3f}; plain "
                    f"{plain7:.3f}, worst grad err {max(e / s_ for e, s_ in gerrs):.3g} of its "
                    f"largest magnitude)")
            ms6, plain6, prev6, pack6, ms7, plain7, prev7, pack7 = timed_for[L, final]
            for key, prev, pack in (("fwd", prev6, pack6), ("bwd", prev7, pack7)):
                tot[key]["previous_ms"] += prev
                tot[key]["pack_ms"] += pack
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


def make_dataset(root: str, data, feature_dim: int = 768, use_f0: bool = True) -> str:
    """An RVCDataset on disk: len(CLIP_SECONDS) clips of the speech fixture
    resampled to the data's rate and written as float32 wavs (as
    preprocessing writes them), seeded random features of ``feature_dim`` at
    50 Hz and, with ``use_f0``, f0 of 100-300 Hz with its coarse bins.
    Returns the filelist's path."""
    from fractions import Fraction

    import torch
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    from rvc_tpu_torch.pitch.extractor import coarse_f0
    from rvc_tpu_torch.train.data import write_filelist

    ratio = Fraction(data.sampling_rate, 16000)
    rng = np.random.default_rng(0)
    rows = []
    for i, sec in enumerate(CLIP_SECONDS):
        clip = resample_poly(speech(float(sec), 5.0 + 7.0 * i), ratio.numerator,
                             ratio.denominator).astype(np.float32)
        frames = len(clip) // data.hop_length
        f0 = rng.uniform(100.0, 300.0, frames).astype(np.float32)
        paths = [os.path.join(root, f"{i}{ext}") for ext in
                 (".wav", ".feat.npy", ".pitch.npy", ".pitchf.npy")]
        wavfile.write(paths[0], data.sampling_rate, clip)
        np.save(paths[1], rng.standard_normal((frames // 2 + 1, feature_dim)).astype(np.float32))
        if not use_f0:
            rows.append("|".join(paths[:2]) + "|0")
            continue
        np.save(paths[2], coarse_f0(torch.from_numpy(f0)).numpy().astype(np.int32))
        np.save(paths[3], f0)
        rows.append("|".join(paths) + "|0")
    filelist = os.path.join(root, "filelist.txt")
    write_filelist(filelist, rows)
    return filelist


SEED7 = {}  # seed 7's initial weights by model and data configuration
DRAWN = {}  # initial weights by model and data configuration and seed


def seeded_state(trainer, seed: int, steps_per_epoch: int = 100):
    """``trainer.init_state(seed=seed)``, its weights drawn once a model and
    data configuration and seed and loaded by later calls (the same weights;
    the draws take seconds at full width)."""
    key = (repr(trainer.config.model), repr(trainer.config.data), seed)
    if key not in DRAWN:
        state = trainer.init_state(seed=seed, steps_per_epoch=steps_per_epoch)
        DRAWN[key] = tuple({k: v.detach().cpu().numpy() for k, v in m.state_dict().items()}
                           for m in (trainer.synth, trainer.disc))
        return state
    return trainer.init_state(seed=seed, steps_per_epoch=steps_per_epoch,
                              state_g=DRAWN[key][0], state_d=DRAWN[key][1])


def train_step_run(cfg, small: dict, dev: str, dtype,
                   multiscale: bool = False) -> tuple[dict, list, float]:
    """One training step from seed 7's weights on ``small`` with seed 3's
    draws (with ``multiscale`` the multi-scale mel loss): (metrics, the
    updated parameters of G and D on the CPU, seconds). The weights are
    drawn once a configuration and loaded by its later runs."""
    from rvc_tpu_torch.train.step import Trainer

    t0 = time.perf_counter()
    tr = Trainer(cfg, dtype=dtype, device=dev)
    if multiscale:
        tr.use_multiscale()
    key = (repr(cfg.model), repr(cfg.data))
    if key in SEED7:
        st = tr.init_state(seed=7, state_g=SEED7[key][0], state_d=SEED7[key][1])
    else:
        st = tr.init_state(seed=7)
        SEED7[key] = tuple({k: v.detach().cpu().numpy() for k, v in m.state_dict().items()}
                           for m in (tr.synth, tr.disc))
    st, m = tr.step(st, small, draws=tr.draws(small, seed=3))
    params = [p.detach().cpu() for p in list(tr.synth.parameters()) +
              list(tr.disc.parameters())]
    return {k: float(v) for k, v in m.items() if k != "viz"}, params, time.perf_counter() - t0


def step_distance(a, b, lr: float) -> tuple[float, float, float, float]:
    """Two training steps' runs (metrics, parameters): (the losses' largest
    difference relative to max(1, |loss|), the gradient norms' largest
    relative difference, the parameters' largest difference, the share of
    parameter elements more than 0.01 lr apart)."""
    import torch

    (ma, pa), (mb, pb) = a, b
    loss = max(abs(ma[k] - mb[k]) / max(1.0, abs(mb[k])) for k in mb
               if not k.startswith("grad_norm"))
    norm = max(abs(ma[k] - mb[k]) / abs(mb[k]) for k in ("grad_norm_g", "grad_norm_d"))
    delta = torch.cat([(x - y).abs().flatten() for x, y in zip(pa, pb)])
    return loss, norm, delta.max().item(), (delta > 0.01 * lr).float().mean().item()


def small_batch(batch: dict, frames: int = 48, hop: int = 480) -> dict:
    """The first sample of a training batch cut to ``frames`` frames."""
    small = {}
    for key, v in batch.items():
        v = np.asarray(v)[:1]
        if key in ("phone", "pitch", "pitchf", "spec"):
            v = v[:, :frames]
        elif key == "wave":
            v = v[:, :frames * hop]
        elif key.endswith("lengths"):
            v = np.minimum(v, frames * (hop if key == "wave_lengths" else 1))
        small[key] = v
    return small


def check_train_vs_cpu(cfg, batch: dict, label: str = "[8/29]",
                       multiscale: bool = False) -> tuple:
    """One training step on the card and on the CPU (plain versions) from the
    same weights, batch and draws, at batch 1 and 48 frames. Returns the
    batch and the CPU run (the bf16 bars of check_train_bf16_vs_cpu are taken
    from its distance to the CPU's bf16 run)."""
    import torch

    small = small_batch(batch, hop=cfg.data.hop_length)
    (mg, pg, tg), (mc, pc, tc) = (train_step_run(cfg, small, dev, torch.float32, multiscale)
                                  for dev in ("cuda", "cpu"))
    lr = cfg.train.learning_rate
    loss_err, norm_err, worst, share = step_distance((mg, pg), (mc, pc), lr)
    say(f"{label} one training step, batch 1, 48 frames, card vs CPU: losses within "
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
    return small, (mc, pc)


def training_counters() -> dict:
    """The launch counters a training step may move (the decoder chains'
    forward in bf16, kernel 4 (the forward in float32, the recompute in
    bf16), kernel 5, kernels 6 and 7) beside those it must not (the
    inference kernels')."""
    from rvc_tpu_torch.ops import resblock, wavenet

    return {**launch_counters(),
            "fused_resblock1_train[bf16]": (resblock.fused_resblock1_train, "launches_bf16"),
            "fused_resblock1_backward": (resblock.fused_resblock1_backward, "launches"),
            "fused_wn": (wavenet.fused_wn, "launches"),
            "fused_wn_backward": (wavenet.fused_wn_backward, "launches")}


def expected_training_launches(trainer, steps: int) -> dict:
    """What ``steps`` training steps must launch, from the model's structure:
    in float32 a kernel 4 and a kernel 5 launch per ResBlock1 chain; in bf16
    a bf16 unit launch per residual unit, and per chain a kernel 4 launch
    (the float32 recompute) and a kernel 5 launch; a kernel 6 and a kernel 7
    launch per WN group; nothing else."""
    import torch

    dec = trainer.synth.dec
    n_chains, n_units = len(dec.resblocks), sum(len(rb.convs1) for rb in dec.resblocks)
    n_wn = wn_launches_per_step(trainer.synth)
    out = dict.fromkeys(training_counters(), 0)
    out.update({"fused_resblock1": n_chains * steps, "fused_resblock1_backward": n_chains * steps,
                "fused_wn": n_wn * steps, "fused_wn_backward": n_wn * steps})
    if trainer.dtype == torch.bfloat16:
        out["fused_resblock1_train[bf16]"] = n_units * steps
    return out


def run_training(trainer, batches: list, card: str, label: str,
                 name: str = "48k_v2") -> dict:
    """One warm-up step on batches[0] and a timed step on each later batch;
    returns the timed steps' ``launches``, ``rate`` (steps/s), each stage's
    median CUDA-event ms (``stages``, printed), ``peak`` memory (GiB), their
    ``losses`` and the last ``state``."""
    import torch

    state = seeded_state(trainer, 0, steps_per_epoch=len(batches))
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
    counters = training_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    walls, losses, stages = [], [], []
    for batch in batches[1:]:
        events = []
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch, events=events)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        stages.append({name: a.elapsed_time(b) for (_, a), (name, b)
                       in zip(events[:-1], events[1:])})
        vals = {k: float(v) for k, v in m.items() if k != "viz"}
        losses.append(vals)
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"a loss is not finite: {vals}")
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    steps = len(walls)
    expected = expected_training_launches(trainer, steps)
    cfg = trainer.config
    audio_s = TRAIN_BATCH * cfg.train.segment_size / cfg.data.sampling_rate
    total = sum(walls)
    say(f"[{label}] training {name} in {str(trainer.dtype).split('.')[-1]}, batch {TRAIN_BATCH}, "
        f"padded to {np.shape(batches[1]['spec'])[1]} frames: {steps} steps, wall s "
        f"{[round(w, 4) for w in walls]}, {steps / total:.3f} steps/s, "
        f"{audio_s * steps / total:.3f} s of audio (the sliced segments) trained per s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches { {k: v for k, v in launches.items() if v} }; {card}")
    medians = {stage: round(float(np.median([st[stage] for st in stages])), 3)
               for stage in stages[0]}
    say(f"  stages, median over the timed steps (CUDA events, ms): {medians}")
    for i, vals in enumerate(losses):
        say(f"  step {i + 1}: " + ", ".join(f"{k} {v:.5g}" for k, v in vals.items()))
    if launches != expected:
        fail(f"training kernel launches {launches}, expected {expected}")
    return dict(launches=launches, rate=steps / total, stages=medians, losses=losses,
                peak=torch.cuda.max_memory_allocated() / 2**30, state=state)


# ---- phase 19: training in bfloat16 ----


def check_chain_train_bf16(trainer, gen) -> tuple[dict, dict]:
    """Kernel 4 in bf16 (the bf16 unit kernel, a launch a unit) and its
    backward (kernel 4 in float32 at bf16(0.1) recomputing the unit inputs,
    then kernel 5 at bf16(0.1), on x and the cotangent upcast, dx cast to
    bf16) on every ResBlock1 chain of the decoder at phase 7's shapes, each
    against its plain version: the value within phase 9's bf16 bars, the
    gradients by check_chain_grads at bf16(0.1). Times per training step,
    the weights' packing (every step in training) apart."""
    import torch

    from rvc_tpu_torch.ops import resblock as rb

    bf16, dev = torch.bfloat16, trainer.device
    dec = trainer.synth.dec
    nk = dec.num_kernels
    B, T = TRAIN_BATCH, trainer.seg_frames
    tot = {key: dict(ms=0.0, plain_ms=0.0, pack_ms=0.0, flops=0.0, bytes=0.0, bound_ms=0.0,
                     err=0.0) for key in ("fwd", "bwd")}
    kinks = dict(near_zero=0, worst=0.0)
    for i, rate in enumerate(dec.upsample_rates):
        T *= rate
        for blk in dec.resblocks[i * nk:(i + 1) * nk]:
            with torch.no_grad():
                convs = [(w.detach().clone(), b.detach().clone(), k, d)
                         for w, b, k, d in blk.chain()]
            C, k, n = convs[0][0].shape[0], convs[0][2], len(convs) // 2
            x = torch.randn(B, T, C, generator=gen).to(dev).to(bf16)
            gy = torch.randn(B, T, C, generator=gen).to(dev).to(bf16)
            x32, gy32 = x.float(), gy.float()
            with torch.no_grad():
                y = rb.fused_resblock1_train(x, convs)
            y_ref = rb.fused_resblock1_plain(x, convs)
            rel, l2, beyond = bf16_agreement(y, y_ref)
            if not (l2 <= BF16_L2 and rel <= BF16_MAX):
                fail(f"kernel 4 in bf16 disagrees with its plain version at C={C}, k={k}: max "
                     f"{rel:.3g}, relative L2 {l2:.3g}")

            def backward(packs=None, cast=True):  # the route's backward, as in training
                _, hs = rb._resblock1_forward(x.float(), convs, rb.BF16_SLOPE)
                dx, dw, db = rb.fused_resblock1_backward(x.float(), hs, gy.float(), convs,
                                                         packs, slope=rb.BF16_SLOPE)
                return dx.to(bf16) if cast else dx, dw, db

            # dx before its cast to bf16: the cast rounds both versions alike
            got = backward(cast=False)
            ref = rb.fused_resblock1_backward_plain(x32, None, gy32, convs, rb.BF16_SLOPE)
            msg, counts = rb.check_chain_grads(x32, convs, got, ref, GRAD_TOL,
                                               slope=rb.BF16_SLOPE)
            if msg:
                fail(f"the bf16 chain's backward disagrees with its plain version at C={C}, "
                     f"k={k}: {msg} ({counts})")
            kinks["near_zero"] += counts["near_zero"]
            kinks["worst"] = max(kinks["worst"], counts["worst"])
            weights = [w for w, _, _, _ in convs]
            run4 = lambda: rb._run_units(x, [convs], "rvc_resblock_unit_bf16",  # noqa: E731
                                         rb.pack_bf16_weights, UNCOUNTED)
            ms4 = min(timed(run4, reps=3), timed(run4, reps=3))
            pack4 = timed(lambda: [rb.pack_bf16_weights(w) for w in weights], reps=3)
            plain4 = timed(lambda: rb.fused_resblock1_plain(x, convs), reps=3)
            packs5 = rb.pack_backward_weights(convs)
            ms5 = min(timed(lambda: backward(packs5), reps=3),
                      timed(lambda: backward(packs5), reps=3))
            pack5 = timed(lambda: (rb.pack_chain_weights(weights),
                                   rb.pack_backward_weights(convs)), reps=3)
            plain5 = timed(lambda: rb.fused_resblock1_backward_plain(
                x.float(), None, gy.float(), convs, rb.BF16_SLOPE), reps=3)
            act16 = B * T * C * 2
            wts = sum(w.numel() + b.numel() for w, b, _, _ in convs) * 4
            conv = 2 * k * C * C * B * T  # flops of one conv
            # the forward one bf16 pass; the backward's float32 work (the
            # recompute, 2n convs, and kernel 5's 5n) three TF32 passes
            b4 = bound_bf16(2 * n * conv, 2 * act16 + wts)
            b5 = bound_tc(7 * n * conv, 3 * act16 + 2 * wts)
            err4 = (y.float() - y_ref.float()).abs().max().item()
            err5 = max(scaled(a, r)[0] for a, r in zip(got, ref))
            for key, ms, plain, pack, flops, nbytes, bnd, err in (
                    ("fwd", ms4, plain4, pack4, 2 * n * conv, 2 * act16 + wts, b4[0], err4),
                    ("bwd", ms5, plain5, pack5, 7 * n * conv, 3 * act16 + 2 * wts, b5[0],
                     err5)):
                t = tot[key]
                for name, v in (("ms", ms), ("plain_ms", plain), ("pack_ms", pack),
                                ("flops", flops), ("bytes", nbytes), ("bound_ms", bnd)):
                    t[name] += v
                t["err"] = max(t["err"], err)
            say(f"  bf16 chain x ({B}, {T}, {C}), k {k}: forward (bf16 unit kernel) ms {ms4:.3f} "
                f"(max {rel:.3g} of the largest, relative L2 {l2:.3g}, beyond one ulp "
                f"{beyond:.3%}; packing {pack4:.3f}, plain {plain4:.3f}, bound {b4[0]:.3f}), "
                f"backward (kernel 4 and kernel 5 at bf16(0.1)) ms {ms5:.3f} (pre-activations "
                f"near 0 {counts['near_zero']}, left after the fit {counts['worst']:.3g}; "
                f"packing {pack5:.3f}, plain {plain5:.3f}, bound {b5[0]:.3f})")
            del x, gy, x32, gy32
    say(f"  the bf16 chains' backward: the worst element left after fitting "
        f"{kinks['near_zero']} pre-activations near 0: {kinks['worst']:.3g} of its largest "
        f"magnitude (tolerance {GRAD_TOL})")
    return tuple(dict(max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                      pack_ms=t["pack_ms"], bound_ms=t["bound_ms"],
                      bound_by=(bound_bf16 if key == "fwd" else bound_tc)(t["flops"],
                                                                          t["bytes"])[1],
                      library_ms=None)
                 for key, t in tot.items())


def check_wn_train_bf16(trainer, lengths, T: int, gen) -> tuple[dict, dict]:
    """Kernels 6 and 7 in bf16 on every group of every WN stack (the
    posterior encoder's 16 layers in two groups, each flow's 3 in one) at
    phase 7's shapes, through the group's autograd route: x in bf16, upcast,
    kernel 6, the skip and the group's last x rounded to bf16; kernel 7 on
    both cotangents upcast, dx rounded. Against autograd of the plain group
    in bf16: the skip, the last x and dx within phase 9's bf16 bars, the
    float32 weight and conditioning gradients within GRAD_TOL. A group's
    input is the kernel's last x of the group before it. Times (device time
    alone for kernel 6, as in phase 6) with the weights' packing apart."""
    import torch

    from rvc_tpu_torch.ops import wavenet as wn

    bf16 = torch.bfloat16
    dev = trainer.device
    B = len(lengths)
    tot = {key: dict(ms=0.0, plain_ms=0.0, pack_ms=0.0, flops=0.0, bytes=0.0, bound_ms=0.0,
                     err=0.0) for key in ("fwd", "bwd")}
    timed_for = {}
    for C, k, ws_all, lens, mask in wn_stacks(trainer, lengths, T, gen):
        x = (torch.randn(B, T, C, generator=gen).to(dev) * mask.transpose(1, 2)).to(bf16)
        for ws, final in wn.groups(*ws_all, k):
            L = ws[4].shape[0]
            gy = torch.randn(B, T, C, generator=gen).to(dev).to(bf16)
            gyx = torch.randn(B, T, C, generator=gen).to(dev).to(bf16) if final else None
            runs = []
            for group in (wn._group_card, wn._group_plain):
                xg = x.clone().requires_grad_()
                wg = [t.clone().requires_grad_() for t in ws]
                skip, x_out = group(xg, *wg, lens, k, final)
                outs, cots = ([skip, x_out], [gy, gyx]) if final else ([skip], [gy])
                grads = torch.autograd.grad(outs, [xg] + wg, cots, allow_unused=True)
                runs.append(([o.detach() for o in outs],
                             [torch.zeros_like(t) if g is None else g
                              for t, g in zip([xg] + wg, grads)]))
            torch.cuda.synchronize()
            (outs, grads), (outs_ref, grads_ref) = runs
            worst = 0.0
            for name, a, r in zip(("skip", "last x", "dx"), outs + grads[:1],
                                  outs_ref + grads_ref[:1]):
                rel, l2, beyond = bf16_agreement(a, r)
                worst = max(worst, rel)
                if not (l2 <= BF16_L2 and rel <= BF16_MAX):
                    fail(f"kernels 6/7 in bf16 disagree with their plain version (L={L}) in "
                         f"{name}: max {rel:.3g}, relative L2 {l2:.3g}")
            names = ("dWa", "dWb", "dBab", "dG", "dWres", "dWskip", "dBrs")
            gerrs = [scaled(a, r) for a, r in zip(grads[1:], grads_ref[1:])]
            for name, (e, s_) in zip(names, gerrs):
                if not e <= GRAD_TOL * s_:
                    fail(f"kernel 7 in bf16 disagrees with its plain version (L={L}) in "
                         f"{name}: {e:.3g} > {GRAD_TOL} x {s_:.3g}")
            gworst = max(e / s_ for e, s_ in gerrs)
            err6 = max((a.float() - r.float()).abs().max().item()
                       for a, r in zip(outs, outs_ref))
            err7 = max([(grads[0].float() - grads_ref[0].float()).abs().max().item()]
                       + [e for e, _ in gerrs])
            act16, act, wts = B * T * C * 2, B * T * C * 4, sum(w.numel() for w in ws) * 4
            rows = B * T
            cost = {"fwd": (L * rows * (4 * k * C * C + 4 * C * C), (2 + final) * act16 + wts),
                    "bwd": (L * rows * (8 * k * C * C + 8 * C * C),
                            (3 + final) * act16 + 2 * wts)}
            if (L, final) not in timed_for:
                w_a, w_b, _, _, w_res, w_skip, _ = ws
                packs6 = wn.pack_forward_weights(w_a, w_b, w_res, w_skip, k, final)
                packs7 = wn.pack_backward_weights(w_a, w_b, w_res, w_skip, k)

                def fwd6():  # the group's forward in bf16, its weights packed
                    out = wn._forward(x.float(), *ws, lens, k, packs6, final)
                    return [t.to(bf16) for t in (out[0], *out[3:])], out

                kept = fwd6()[1]

                def bwd7():
                    g = wn.fused_wn_backward(
                        x.float(), kept[1], kept[2], gy.float(), *ws, lens, kernel_size=k,
                        packs=packs7, gyx=None if gyx is None else gyx.float())
                    return g[0].to(bf16), g[1:]

                ms6 = min(timed(fwd6, reps=5, device_only=True),
                          timed(fwd6, reps=5, device_only=True))
                pack6 = timed(lambda: wn.pack_forward_weights(w_a, w_b, w_res, w_skip, k, final),
                              reps=3, device_only=True)
                plain6 = timed(lambda: wn._group_plain(x, *ws, lens, k, final), reps=3,
                               device_only=True)
                ms7 = min(timed(bwd7, reps=3), timed(bwd7, reps=3))
                pack7 = timed(lambda: wn.pack_backward_weights(w_a, w_b, w_res, w_skip, k),
                              reps=3)
                plain7 = timed(lambda: wn.fused_wn_backward_plain(
                    x.float(), None, None, gy.float(), *ws, lens, kernel_size=k,
                    gyx=None if gyx is None else gyx.float()), reps=3)
                timed_for[L, final] = (ms6, plain6, pack6, ms7, plain7, pack7)
                say(f"  bf16 WN group x ({B}, {T}, {C}), L {L}"
                    f"{', its last x wanted' if final else ''}: kernel 6 ms {ms6:.4f} (plain "
                    f"{plain6:.4f}, packing {pack6:.4f}, bound {bound_tc(*cost['fwd'])[0]:.4f}), "
                    f"kernel 7 ms {ms7:.3f} (plain {plain7:.3f}, packing {pack7:.3f}, bound "
                    f"{bound_tc(*cost['bwd'])[0]:.4f}); worst of skip, last x, dx {worst:.3g} "
                    f"of the largest, of the weight gradients {gworst:.3g}")
            ms6, plain6, pack6, ms7, plain7, pack7 = timed_for[L, final]
            for key, ms, plain, pack, err in (("fwd", ms6, plain6, pack6, err6),
                                              ("bwd", ms7, plain7, pack7, err7)):
                t = tot[key]
                flops, nbytes = cost[key]
                for name, v in (("ms", ms), ("plain_ms", plain), ("pack_ms", pack),
                                ("flops", flops), ("bytes", nbytes),
                                ("bound_ms", bound_tc(flops, nbytes)[0])):
                    t[name] += v
                t["err"] = max(t["err"], err)
            if final:
                x = outs[1]  # the next group's input: this group's last x, from the kernel
    return tuple(dict(max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                      pack_ms=t["pack_ms"], bound_ms=t["bound_ms"],
                      bound_by=bound_tc(t["flops"], t["bytes"])[1], library_ms=None)
                 for t in tot.values())


STACK_MARGIN = 2.0  # see check_wn_stack_bf16
STACK_NAMES = ("dx", "dWa", "dWb", "dBab", "dG", "dWres", "dWskip", "dBrs")


def wn_stack_grads(x, ws, lens, k: int, gy, group_size: int | None = None) -> dict:
    """The gradients of <stack(x), gy> for x and the seven fused_wn weights
    (each float32): the plain stack in float32 ("f32") and in bf16
    ("plain16"), fused_wn in bf16, kernels 6 and 7 by groups ("card16"), and
    the kernel groups fed the plain bf16 stack's x between groups, its
    value swapped in and the gradient passed through ("fed_x"), and fed
    also the plain stack's gradient with respect to that x ("fed_x_dx"):
    then each group sees the plain stack's input and cotangent."""
    import torch

    from rvc_tpu_torch.ops import wavenet as wn

    gs = wn.GROUP_SIZE if group_size is None else group_size
    x16 = x.to(torch.bfloat16)
    xd = x16.detach().requires_grad_()
    entries, skip, xp = [], None, xd
    for gw, final in wn.groups(*[t.detach() for t in ws], k, gs):
        entries.append(xp)
        if xp is not xd:
            xp.retain_grad()
        sk, xp = wn._group_plain(xp, *gw, lens, k, final)
        skip = sk if skip is None else skip + sk
    torch.autograd.backward(skip.float(), gy)
    boundary = [(e.detach(), e.grad) for e in entries]

    def fed(with_dx: bool):
        def run(xg, *wg):
            skip = xc = None
            for (gw, final), (xe, ge) in zip(wn.groups(*wg, k, gs), boundary):
                if xc is None:
                    xin = xg
                else:
                    xin = xc + (xe - xc).detach()
                    if with_dx:
                        xin.register_hook(lambda g, ge=ge: ge)
                sk, xc = wn._group_card(xin, *gw, lens, k, final)
                skip = sk if skip is None else skip + sk
            return skip
        return run

    def stack(fn):
        return lambda xg, *wg: fn(xg, *wg, lens, kernel_size=k, group_size=gs)

    def grads(fn, xin):
        xg = xin.detach().clone().requires_grad_()
        wg = [t.detach().clone().requires_grad_() for t in ws]
        out = torch.autograd.grad(fn(xg, *wg).float(), [xg] + wg, gy, allow_unused=True)
        return [torch.zeros_like(t) if g is None else g.float() for t, g in zip([xg] + wg, out)]

    return {"f32": grads(stack(wn.fused_wn_plain), x.float()),
            "plain16": grads(stack(wn.fused_wn_plain), x16),
            "card16": grads(stack(wn.fused_wn), x16),
            "fed_x": grads(fed(False), x16), "fed_x_dx": grads(fed(True), x16)}


def stack_distances(runs: dict) -> dict:
    """From wn_stack_grads' runs: each gradient's relative L2 distance to the
    float32 one, for the kernel route ("card16") and the plain bf16 route
    ("plain16"); and the weight gradients' worst max |diff| relative to the
    largest magnitude against the plain bf16 route, for the kernel route and
    the two fed routes."""
    def rel(a, r):
        return ((a - r).norm() / r.norm().clamp_min(1e-30)).item()

    out = {key: [rel(a, r) for a, r in zip(runs[key], runs["f32"])]
           for key in ("card16", "plain16")}
    for key in ("card16", "fed_x", "fed_x_dx"):
        out[f"{key}_vs_plain16"] = max(e / m for e, m in (
            scaled(a, r) for a, r in zip(runs[key][1:], runs["plain16"][1:])))
    return out


def check_wn_stack_bf16(trainer, lengths, T: int, gen) -> dict:
    """The whole posterior WN stack in bf16 (16 layers, two groups of 8 at
    phase 7's shapes) through fused_wn, kernels 6 and 7 by groups with x
    rounded to bf16 between them, against the plain float32 stack on the
    same x and cotangent: dx and each weight and conditioning gradient within
    STACK_MARGIN times the plain bf16 stack's own relative L2 distance to
    that float32 result, measured here. The kernel route rounds where the
    plain bf16 route rounds (the x between groups, the skip sum, dx), so its
    distance to float32 is of the same size; the triangle inequality through
    the plain bf16 result bounds it by that distance plus the kernel's
    distance to the plain bf16 result, another set of roundings of that
    size: hence 2. Then the cause of the whole stack's distance to the plain
    bf16 stack's weight gradients (the guess: one-ulp flips of the bf16 x
    between groups): the kernel groups fed the plain stack's x between
    them, and then its x and the gradient there too (wn_stack_grads),
    against the group bar GRAD_TOL; reported, and the first bar fails the
    run."""
    import torch

    from rvc_tpu_torch.ops import wavenet as wn

    C, k, ws, lens, mask = next(wn_stacks(trainer, lengths, T, gen))
    B = len(lengths)
    dev = trainer.device
    x = torch.randn(B, T, C, generator=gen).to(dev) * mask.transpose(1, 2)
    gy = torch.randn(B, T, C, generator=gen).to(dev)
    dist = stack_distances(wn_stack_grads(x, ws, lens, k, gy))
    torch.cuda.synchronize()
    say(f"  bf16 WN stack whole (x ({B}, {T}, {C}), {ws[4].shape[0]} layers in groups of "
        f"{wn.GROUP_SIZE}) against the plain float32 stack, relative L2: "
        + ", ".join(f"{n} {g:.3g} (bar {STACK_MARGIN} x {o:.3g})"
                    for n, g, o in zip(STACK_NAMES, dist["card16"], dist["plain16"]))
        + f"; the weight gradients against the plain bf16 stack's, worst of the largest: "
        f"{dist['card16_vs_plain16']:.3g}; fed the plain stack's x between groups "
        f"{dist['fed_x_vs_plain16']:.3g}, its x and dx {dist['fed_x_dx_vs_plain16']:.3g} (the "
        f"group bar {GRAD_TOL})")
    if not all(g <= STACK_MARGIN * o for g, o in zip(dist["card16"], dist["plain16"])):
        fail("the whole bf16 WN stack's gradients are farther from float32 than the bar")
    return dist


def run_bench_train(card: str) -> None:
    """scripts/bench_torch_train.py in this process, in bf16: its JSON line."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_torch_train", os.path.join(REPO, "scripts", "bench_torch_train.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    t0 = time.perf_counter()
    line = bench.run(TRAIN_BATCH, "bfloat16")
    say(f"  scripts/bench_torch_train.py (bf16, batch {TRAIN_BATCH}) in "
        f"{time.perf_counter() - t0:.1f} s; {card}:")
    say(json.dumps(line))


def run_train_bf16(cfg, batches: list, small: dict, cpu32, card: str, checks: dict,
                   rate32: float) -> dict:
    """Phase 19: training in bfloat16. The bf16 forms of kernels 4-7 at phase
    7's shapes against their plain versions; Trainer(preset("48k_v2"),
    dtype=bfloat16) on phase 7's batches (one warm-up step, TRAIN_STEPS
    timed, exact launches, every parameter with a gradient, losses finite,
    each stage's CUDA-event ms); one step card vs CPU in bf16 on phase 8's
    batch, weights and draws (check_train_bf16_vs_cpu's bars); the training
    bench's line. Returns run_training's result."""
    import torch

    from rvc_tpu_torch.train.step import Trainer

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    trainer = Trainer(cfg, dtype=bf16, device="cuda")
    seeded_state(trainer, 0)
    gen = torch.Generator().manual_seed(19)
    say(f"[19/29] training in bf16: kernels 4-7 in their bf16 form at phase 7's shapes "
        f"(trainer built in {time.perf_counter() - t0:.1f} s)")
    checks["chain_bf16"], checks["chain_bwd_bf16"] = check_chain_train_bf16(trainer, gen)
    checks["wn_bf16"], checks["wn_bwd_bf16"] = check_wn_train_bf16(
        trainer, batches[0]["spec_lengths"], np.shape(batches[0]["spec"])[1], gen)
    checks["wn_stack_bf16"] = check_wn_stack_bf16(
        trainer, batches[0]["spec_lengths"], np.shape(batches[0]["spec"])[1], gen)
    torch.cuda.empty_cache()
    run = run_training(trainer, batches, card, "19/29")
    say(f"  bf16 {run['rate']:.3f} steps/s against float32 {rate32:.3f} (phase 7, this run); "
        f"{card}")
    del trainer
    torch.cuda.empty_cache()
    check_train_bf16_vs_cpu(cfg, small, cpu32)
    run_bench_train(card)
    return run


def check_train_bf16_vs_cpu(cfg, small: dict, cpu32, multiscale: bool = False,
                            factor: float = 1.0) -> None:
    """One bf16 training step on the card and on the CPU on check_train_vs_cpu's
    batch, weights and draws, within bars from the CPU's own distance between
    its bf16 and its float32 step (``cpu32``, check_train_vs_cpu's CPU run):
    losses within max(1e-3, ``factor`` x that distance) relative to
    max(1, |loss|); gradient norms within max(1e-2, ``factor`` x that
    distance) relative; parameters within 2.01 lr (Adam's first update moves
    each by about lr, so a flipped gradient sign moves two runs 2 lr apart)
    with at most max(1%, that share) of elements more than 0.01 lr apart. So
    the card's bf16 step must agree with the CPU's bf16 step at least as
    closely as phase 8's float32 bars ask, or as the CPU's own bf16 step
    agrees with its float32 one (``factor`` 1, phase 19's rule). ``factor``
    2 is the CPU bf16 tests' rule (tests/test_torch_bf16_train_step.py): two
    bf16 runs that round apart lie up to twice as far apart as either lies
    from float32 (the triangle inequality through the float32 run)."""
    import torch

    bf16 = torch.bfloat16
    lr = cfg.train.learning_rate
    (mg, pg, tg), (mc, pc, tc) = (train_step_run(cfg, small, dev, bf16, multiscale)
                                  for dev in ("cuda", "cpu"))
    own = step_distance((mc, pc), cpu32, lr)
    bars = (max(1e-3, factor * own[0]), max(1e-2, factor * own[1]), 2.01 * lr,
            max(0.01, own[3]))
    got = step_distance((mg, pg), (mc, pc), lr)
    apart = {k: round(abs(mg[k] - mc[k]) / max(1.0, abs(mc[k])), 6) for k in mc
             if not k.startswith("grad_norm")}
    say(f"  one bf16 training step, batch 1, 48 frames, card vs CPU, each loss apart "
        f"(relative): {apart}; the CPU's own bf16 against float32: "
        f"{ {k: round(abs(mc[k] - cpu32[0][k]) / max(1.0, abs(cpu32[0][k])), 6) for k in apart} }")
    say(f"  one bf16 training step, batch 1, 48 frames, card vs CPU: losses within {got[0]:.3g} "
        f"(bar {bars[0]:.3g}), gradient norms within {got[1]:.3g} (bar {bars[1]:.3g}), "
        f"parameters max |diff| {got[2]:.3g} (bar {bars[2]:.3g}), share above 0.01 lr "
        f"{got[3]:.4%} (bar {bars[3]:.4%}); the CPU's own bf16 against float32: losses "
        f"{own[0]:.3g}, norms {own[1]:.3g}, share {own[3]:.4%}; card run {tg:.1f} s, CPU run "
        f"{tc:.1f} s")
    if not all(g <= b for g, b in zip(got, bars)):
        fail("the card's bf16 training step disagrees with the CPU's")


# ---- phase 20: every loss, and a no-f0 model, trained on the card ----

PHASE20_STEPS = 2  # timed steps a dtype


def all_losses(cfg):
    """``cfg`` with the gradient penalty and the HPSS, TSI and TEFS aux losses
    at weight 1 (combined_aux_loss's own default weight)."""
    import dataclasses

    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, c_gp=1.0, c_hd=1.0, c_tsi=1.0, c_tefs=1.0))


def loss_costs(cfg, batch: dict, card: str) -> dict:
    """Each new loss alone at phase 7's segment shapes (batch 4, 17280
    samples), forward and backward, CUDA events: the TEFS loss (its FFTs),
    the harmonic loss (its mels and 2 x 5 median pools), the TSI loss, the
    six-scale mel loss; and the gradient penalty (the discriminator on the
    interpolation, its input gradient with a graph, the double backward
    into the discriminator's parameters) against the discriminator's loss
    alone."""
    import torch

    from rvc_tpu_torch.models.discriminator import MultiPeriodDiscriminator
    from rvc_tpu_torch.models.layers import init_random_
    from rvc_tpu_torch.train import losses as L

    d, t = cfg.data, cfg.train
    gen = torch.Generator().manual_seed(20)
    B, seg = TRAIN_BATCH, t.segment_size
    real = torch.from_numpy(np.asarray(batch["wave"])[:, :seg].copy()).cuda()
    fake = (0.1 * torch.randn(B, seg, generator=gen)).cuda().requires_grad_()
    data = dict(n_mels=d.n_mel_channels, sample_rate=d.sampling_rate, n_fft=d.filter_length,
                hop_length=d.hop_length, win_length=d.win_length, fmin=d.mel_fmin,
                fmax=d.mel_fmax, eps=t.eps)
    msml = L.MultiScaleMelLoss(d.sampling_rate)
    only = {"tefs": dict(c_tefs=1.0, c_hd=0.0, c_tsi=0.0),
            "harmonic": dict(c_tefs=0.0, c_hd=1.0, c_tsi=0.0),
            "tsi": dict(c_tefs=0.0, c_hd=0.0, c_tsi=1.0)}

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(), fake)

    out = {name: timed(fwd_bwd(lambda w=w: sum(L.combined_aux_loss(real, fake, **w, **data))),
                       reps=5)
           for name, w in only.items()}
    out["multiscale_mel"] = timed(fwd_bwd(lambda: msml(fake, real)), reps=5)
    disc = init_random_(MultiPeriodDiscriminator(cfg.model.version), 1).cuda()
    params = list(disc.parameters())
    real3, fake3 = real[:, None], fake.detach()[:, None]
    alpha = torch.rand(B, 1, 1, generator=gen).cuda()

    def disc_loss():
        return torch.autograd.grad(L.discriminator_loss(*disc(real3, fake3)[:2])[0], params)

    def with_penalty():
        loss = L.discriminator_loss(*disc(real3, fake3)[:2])[0]
        interp = (alpha * real3 + (1 - alpha) * fake3).requires_grad_()
        (gx,) = torch.autograd.grad(L.discriminator_loss(*disc(real3, interp)[:2])[0], interp,
                                    create_graph=True)
        gp = torch.mean((torch.sqrt(torch.sum(gx.reshape(B, -1) ** 2, -1) + 1e-12) - 1) ** 2)
        return torch.autograd.grad(loss + gp, params)

    out["discriminator_loss"] = timed(disc_loss, reps=3)
    out["discriminator_loss_with_penalty"] = timed(with_penalty, reps=3)
    say(f"  each new loss alone, forward and backward, batch {B} x {seg} samples (CUDA events, "
        f"ms): " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()) + f"; {card}")
    return out


def run_every_loss(cfg, batches: list, card: str, base: dict, checks: dict) -> None:
    """Phase 20, first part: 48k_v2 at full width with every loss on
    (all_losses, use_multiscale) on phase 7's batches, one warm-up step and
    PHASE20_STEPS timed, in float32 and in bf16: losses finite, the harmonic,
    TSI and TEFS losses and the penalty nonzero in every timed step, every
    parameter with a gradient, kernels 4-7 launched as phases 7 and 19 count
    them (the losses launch none), steps/s and each stage's median beside
    phases 7 and 19 (``base``); each new loss's cost alone; one step card vs
    CPU at phase 8's batch in float32 (phase 8's bars) and in bf16
    (check_train_bf16_vs_cpu's)."""
    import torch

    from rvc_tpu_torch.train.step import Trainer

    cfg = all_losses(cfg)
    say(f"[20/29] every loss: 48k_v2 with c_gp = c_hd = c_tsi = c_tefs = 1 and the multi-scale "
        f"mel loss, on phase 7's batches")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        trainer = Trainer(cfg, dtype=dtype, device="cuda")
        trainer.use_multiscale()
        run = run_training(trainer, batches[:1 + PHASE20_STEPS], card, "20/29",
                           "48k_v2 with every loss")
        penalty = float(run["state"].balancer_d.hist_losses[1])
        zero = [k for vals in run["losses"] for k in ("harmonic_loss", "tsi_loss", "tefs_loss")
                if vals[k] == 0]
        ref = base[name]
        say(f"  {name}: {run['rate']:.3f} steps/s against {ref['rate']:.3f} without the new "
            f"losses (phase {ref['phase']}, this run); peak {run['peak']:.2f} GiB against "
            f"{ref['peak']:.2f}; the last step's penalty {penalty:.5g}; each stage's median "
            f"ms, this phase - phase {ref['phase']}: "
            + str({k: round(v - ref["stages"][k], 3) for k, v in run["stages"].items()}))
        if zero or not (math.isfinite(penalty) and penalty > 0):
            fail(f"a new loss is zero: {zero}, penalty {penalty}")
        checks[f"every_loss_{name}"] = dict(rate=run["rate"], stages=run["stages"],
                                            peak=run["peak"])
        del trainer, run
        torch.cuda.empty_cache()
    checks["loss_costs"] = loss_costs(cfg, batches[0], card)
    small, cpu32 = check_train_vs_cpu(cfg, batches[0], "  [20/29] every loss:", True)
    # the aux and multi-scale losses are taken on the bf16 generated slice:
    # the CPU bf16 tests' factor 2 (check_train_bf16_vs_cpu)
    check_train_bf16_vs_cpu(cfg, small, cpu32, True, factor=2.0)


def run_nof0(tmp: str, card: str, checks: dict) -> None:
    """Phase 20, second part: preset("40k") (reference configs/40k.json, v1)
    with use_f0 = False at full width, the no-f0 synthesizer (Generator, no
    pitch embedding) trained on an 8-clip 40 kHz dataset made as phase 7
    makes its own (256-dim features, no f0 files): one warm-up step and
    PHASE20_STEPS timed in float32 and in bf16, with phase 7's checks and
    exact launches (kernels 4 and 5 once a chain, 6 and 7 once a group of 8
    WN layers); one step card vs CPU at batch 1 x 48 frames in both dtypes;
    the float32 run's .pth exported (f0 0) and loaded back through the
    port's loader into the converter's synthesizer, whose weights must equal
    the trainer's (fp16, weight norm folded)."""
    import dataclasses

    import torch

    from rvc_tpu_torch.config import preset
    from rvc_tpu_torch.train.data import BucketBatcher, RVCDataset
    from rvc_tpu_torch.train.step import Trainer

    base = preset("40k")
    cfg = dataclasses.replace(base, model=dataclasses.replace(base.model, use_f0=False))
    filelist = make_dataset(tmp, cfg.data, feature_dim=cfg.model.feature_dim, use_f0=False)
    batcher = BucketBatcher(RVCDataset(filelist, cfg.data, use_f0=False), TRAIN_BATCH,
                            seed=1234)
    batches = [b for e in range(1 + PHASE20_STEPS) for b in batcher.epoch(e)][
        :1 + PHASE20_STEPS]
    say(f"[20/29] no f0: 40k v1 with use_f0 = False on {len(CLIP_SECONDS)} clips at "
        f"{cfg.data.sampling_rate} Hz, batches of {np.shape(batches[0]['spec'])[:2]} frames, "
        f"keys {sorted(batches[0])}")
    if "pitch" in batches[0] or "pitchf" in batches[0]:
        fail("the no-f0 dataset gave pitch")
    for dtype in (torch.float32, torch.bfloat16):
        trainer = Trainer(cfg, dtype=dtype, device="cuda")
        if type(trainer.synth.dec).__name__ != "Generator":
            fail(f"the no-f0 decoder is {type(trainer.synth.dec).__name__}")
        run = run_training(trainer, batches, card, "20/29", "40k no-f0")
        checks[f"nof0_{str(dtype).split('.')[-1]}"] = dict(rate=run["rate"],
                                                           launches=run["launches"])
        if dtype == torch.float32:
            check_export(cfg, trainer, tmp, filelist)
        del trainer, run
        torch.cuda.empty_cache()
    small, cpu32 = check_train_vs_cpu(cfg, batches[0], "  [20/29] no f0:")
    check_train_bf16_vs_cpu(cfg, small, cpu32)


def check_export(cfg, trainer, tmp: str, filelist: str) -> None:
    """The trainer's generator exported as train_model exports it, loaded
    back through the port's loader into a converter's synthesizer (as
    VoiceConverter.from_state_dicts builds it); fails unless the file says
    the model's f0 flag and the weights equal the trainer's (fp16, weight
    norm folded)."""
    from rvc_tpu_torch.compat import torch_import as ti
    from rvc_tpu_torch.models.layers import load_numpy_state_dict
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.pipelines.train import TrainRunConfig, _export

    path = _export(cfg, trainer, TrainRunConfig(model_dir=tmp, filelist=filelist))
    state, meta = ti.load_rvc_checkpoint(path)
    kw = ti.synthesizer_kwargs_from_config(meta["config"], meta["version"], meta["f0"])
    synth = load_numpy_state_dict(Synthesizer(**kw), state)
    live = {k: v.detach().cpu().half().float().numpy()
            for k, v in trainer.synth.state_dict().items() if not k.startswith("enc_q.")}
    want = ti.fold_pairs(live)
    got = {k: v.numpy() for k, v in synth.state_dict().items()}
    same = set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    say(f"  exported {os.path.basename(path)}: f0 {meta['f0']}, version {meta['version']}, "
        f"{len(state)} tensors; the converter's synthesizer ({type(synth.dec).__name__}, "
        f"use_f0 {synth.use_f0}) equals the trainer's weights (fp16, folded): {same}")
    if meta["f0"] != int(cfg.model.use_f0) or synth.use_f0 != cfg.model.use_f0 or not same:
        fail("the exported model does not load back as trained")


# ---- phase 21: the presets never run on the card before ----


def synthetic_batch(cfg, frames: int = 48, seed: int = 21) -> dict:
    """One training sample of ``frames`` frames at the preset's rate: the
    speech fixture resampled, its spectrogram, seeded random features of the
    preset's width and f0 of 100-300 Hz with its coarse bins."""
    from fractions import Fraction

    import torch
    from scipy.signal import resample_poly

    from rvc_tpu_torch.pitch.extractor import coarse_f0
    from rvc_tpu_torch.train.data import spectrogram_np

    d = cfg.data
    ratio = Fraction(d.sampling_rate, 16000)
    wave = resample_poly(speech((frames + 1) * d.hop_length / d.sampling_rate, 20.0),
                         ratio.numerator, ratio.denominator).astype(np.float32)
    spec = spectrogram_np(wave, d.filter_length, d.hop_length, d.win_length)[:frames]
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(100.0, 300.0, frames).astype(np.float32)
    lens = np.array([frames], np.int32)
    return dict(phone=rng.standard_normal((1, frames, cfg.model.feature_dim)).astype(np.float32),
                phone_lengths=lens, spec=spec[None].astype(np.float32), spec_lengths=lens,
                wave=wave[None, :frames * d.hop_length], wave_lengths=lens * d.hop_length,
                sid=np.zeros(1, np.int32), pitch=coarse_f0(torch.from_numpy(f0)).numpy()[None]
                .astype(np.int32), pitchf=f0[None])


MAIN_CONVERTER = {}  # the host's copy of the main path's converter


def main_converter(device: str, dtype=None):
    """make_random_converter("48k_v2", seed=0, chunking=CHUNKING,
    index_rows=BANK_ROWS, device=device, dtype=dtype): the weights are drawn
    once, on the host, and each call copies them (the same converter, built
    in a second rather than ten)."""
    import copy

    import torch

    from rvc_tpu_torch.pipelines.convert import (VoiceConverter, make_random_converter,
                                                 synth_kwargs_from_config)
    from rvc_tpu_torch.pitch.extractor import PitchExtractor

    if "host" not in MAIN_CONVERTER:
        MAIN_CONVERTER["host"] = make_random_converter(
            "48k_v2", seed=0, chunking=CHUNKING, index_rows=BANK_ROWS, device="cpu")
    host = MAIN_CONVERTER["host"]
    dtype = dtype or torch.float32
    vc = VoiceConverter(copy.deepcopy(host.synth), synth_kwargs_from_config(host.config),
                        copy.deepcopy(host.hubert),
                        PitchExtractor(copy.deepcopy(host.pitch.rmvpe), dtype=dtype),
                        config=host.config, device=device, seed=host.seed, dtype=dtype)
    vc.index_bank = tuple(t.to(vc.device) for t in host.index_bank)
    return vc


def cpu_copy(vc, synth_kwargs: dict):
    """``vc`` on the CPU (plain versions): its modules and retrieval bank
    copied, not drawn again."""
    import copy

    from rvc_tpu_torch.pipelines.convert import VoiceConverter

    cpu = VoiceConverter(copy.deepcopy(vc.synth), synth_kwargs, copy.deepcopy(vc.hubert),
                         copy.deepcopy(vc.pitch), config=vc.config, device="cpu", seed=vc.seed,
                         dtype=vc.dtype)
    cpu.index_bank = tuple(t.cpu() for t in vc.index_bank)
    return cpu


def run_unchecked_presets(settings, card: str) -> dict:
    """Phase 21: 32k_v2 (upsampling by kernels 20 and 16 at strides 10 and
    8) and 48k v1 (five stages, segment 11520) at full width with seeded
    random weights: 3 s converted with exact kernel 1-3 launches, card vs
    CPU within phase 5's 4 LSB; one training step card vs CPU at batch 1 x 48
    frames within phase 8's bars. Returns the conversions' kernel launches."""
    import torch

    from rvc_tpu_torch.config import preset
    from rvc_tpu_torch.pipelines.convert import make_random_converter, synth_kwargs_from_config

    clip3 = speech(3.0, 40.0)
    launched = {}
    for name, seed in (("32k_v2", 21), ("48k", 22)):
        t0 = time.perf_counter()
        vc = make_random_converter(name, seed=seed, chunking=CHUNKING, index_rows=BANK_ROWS,
                                   device="cuda")
        dec = vc.synth.dec
        say(f"[21/29] {name} at full width (converter built in {time.perf_counter() - t0:.1f} "
            f"s): upsampling {list(dec.upsample_rates)}, decoder stages of "
            f"{[rb.convs1[0].weight.shape[0] for rb in dec.resblocks[::dec.num_kernels]]} "
            f"channels, segment {preset(name).train.segment_size} samples")
        counters = launch_counters()
        expected = {**dict.fromkeys(counters, 0),
                    "fused_resblock_group": sum(len(rb.convs1) for rb in dec.resblocks),
                    "banded_rel_attention": len(vc.synth.enc_p.encoder.attn_layers),
                    "nearest_rows_q": 1}
        timed_convert(name, vc, clip3, 3.0, settings, counters, expected, card)
        launched[name] = {k: v for k, v in expected.items() if v}
        card_vs_cpu(name, vc, cpu_copy(vc, synth_kwargs_from_config(preset(name))), clip3,
                    settings)
        del vc, dec
        torch.cuda.empty_cache()
        check_train_vs_cpu(preset(name), synthetic_batch(preset(name)), f"  [21/29] {name}:")
    return launched


def run_bf16(clips: dict, settings, card: str, rtf32: dict, checks: dict) -> dict:
    """Phases 9-12: the bf16 kernels, the bf16 main path on both decoder
    routes, and a card-vs-CPU bf16 conversion. Fills ``checks`` with the
    bf16 kernels' entries; returns their launches on their main paths."""
    import torch

    from rvc_tpu_torch.ops.filters import butter_highpass_host
    from rvc_tpu_torch.pipelines.convert import WINDOW

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    vc = main_converter("cuda", bf16)
    say(f"bf16 converter built in {time.perf_counter() - t0:.1f} s")
    shapes = path_shapes(vc, clips[30])
    say(f"[9/29] bf16 kernels at the 30 s bf16 conversion's shapes: {shapes['N']} chunks, "
        f"{shapes['Tp']} frames at 100 Hz")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        checks["resblock_bf16"], checks["chain_v2"] = check_resblock_bf16(vc, shapes, gen)
        checks["attention_bf16"] = check_attention_bf16(
            vc, {30: shapes, 10: path_shapes(vc, clips[10])}, gen)
        say("  kernel 8 at the seven stages of scripts/bench_resblock_v2.py (B 4, S 1):")
        bench_v2_stages()
    torch.cuda.empty_cache()

    dec = vc.synth.dec
    units = sum(len(rb.convs1) for rb in dec.resblocks)
    layers = len(vc.synth.enc_p.encoder.attn_layers)
    counters = launch_counters()
    nothing = dict.fromkeys(counters, 0)
    expected = {True: {**nothing, "fused_resblock_group[bf16]": units,
                       "banded_rel_attention[bf16]": layers, "nearest_rows_q": 1},
                False: {**nothing, "fused_resblock1_v2": units,
                        "banded_rel_attention[bf16]": layers, "nearest_rows_q": 1}}

    # 10. the bf16 main path, default route (kernel 1 in bf16)
    outs = {}
    for sec, audio in clips.items():
        t0 = time.perf_counter()
        vc.convert(audio, settings=settings)  # first call at this length: set-up
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        out, sr, launched, wall = counted_convert(vc, audio, settings, counters)
        walls = [wall]
        for _ in range(2):  # the spread of the wall time, uncounted
            walls.append(counted_convert(vc, audio, settings, counters)[3])
        wall = float(np.median(walls))
        spans = vc.spans(butter_highpass_host(audio))
        Tp = path_shapes(vc, audio)["Tp"]
        expect = sum(min((e - b) // WINDOW, Tp) * (sr // 100) - 2 * vc.t_pad_tgt
                     for b, e in spans)
        peak = int(np.abs(out.astype(np.int32)).max())
        say(f"[10/29] convert {sec} s in bf16: {len(spans)} chunks, {len(out)} samples at "
            f"{sr} Hz, peak {peak}, wall ms {[round(w * 1e3, 2) for w in walls]} (median "
            f"{wall * 1e3:.2f}; first call {first * 1e3:.1f}), RTF {sec / wall:.2f}x (float32 "
            f"in this run {rtf32[sec]:.2f}x), max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"{ {k: v for k, v in launched.items() if v} }; {card}")
        if sr != 48000 or out.dtype != np.int16 or len(out) != expect:
            fail(f"bf16 output is {out.dtype} at {sr} Hz, {len(out)} samples; the spans "
                 f"give {expect} at 48000 Hz")
        if peak <= 0:
            fail("silent bf16 output")
        if launched != expected[True]:
            fail(f"bf16 kernel launches {launched}, expected {expected[True]}")
        outs[sec] = out
    main_launches = {k: launched[k] for k in ("fused_resblock_group[bf16]",
                                              "banded_rel_attention[bf16]")}

    # 11. the fuse_group=False route: kernel 8 per ResBlock, bit-identical
    audio = clips[30]
    again = counted_convert(vc, audio, settings, counters)[0]
    vc.synth.dec.fuse_group = False
    vc.convert(audio, settings=settings)  # set-up
    out, sr, launched, wall = counted_convert(vc, audio, settings, counters)
    vc.synth.dec.fuse_group = True
    same = bool(np.array_equal(out, outs[30]))
    say(f"[11/29] convert 30 s in bf16 with fuse_group=False: wall ms {wall * 1e3:.2f} "
        f"(RTF {30 / wall:.2f}x), launches { {k: v for k, v in launched.items() if v} }, "
        f"bit-identical to the default route: {same} (the default route against itself: "
        f"{bool(np.array_equal(again, outs[30]))})")
    if launched != expected[False]:
        fail(f"fuse_group=False launches {launched}, expected {expected[False]}")
    if not same:
        fail("the fuse_group=False route is not bit-identical to the default route")
    main_launches["fused_resblock1_v2"] = launched["fused_resblock1_v2"]

    # 12. 3 s in bf16 on the card and on the CPU, on the card's f0
    ref_clip = speech(3.0, 40.0)
    f0s = []
    method_fn = vc.pitch.method_fn

    def recording(*args):
        fn = method_fn(*args)
        return lambda chunks: f0s.append(fn(chunks)) or f0s[-1]

    vc.pitch.method_fn = recording
    out_gpu, _ = vc.convert(ref_clip, settings=settings)
    vc.pitch.method_fn = method_fn
    f0_card = f0s[0].cpu()
    del vc
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = main_converter("cpu", bf16)
    chunks, _ = cpu.chunks(ref_clip)
    f0_cpu = cpu.pitch.method_fn("rmvpe", 50.0, 1100.0)(chunks)
    differ = float(torch.mean((torch.abs(f0_cpu - f0_card)
                               > 1e-2 * torch.clamp(f0_card, min=1.0)).float()))
    cpu.pitch.method_fn = lambda *args: (lambda chunks: f0_card)
    out_cpu, _ = cpu.convert(ref_clip, settings=settings)
    a, b = out_gpu.astype(np.float64), out_cpu.astype(np.float64)
    l2 = float(np.linalg.norm(a - b) / np.linalg.norm(b)) if a.shape == b.shape else math.inf
    say(f"[12/29] 3 s in bf16 on the card vs the CPU, on the card's f0 (RMVPE's own bf16 f0 "
        f"differs on {differ:.2%} of frames between them): {len(out_gpu)} vs {len(out_cpu)} "
        f"samples, relative L2 {l2:.4g} (tolerance {BF16_CPU_L2}: bf16 roundings flip "
        f"between the card's sums and the CPU's and the flips travel through the decoder; "
        f"at tiny width the port and the JAX package, two such orders, stay 1.4e-2 apart, "
        f"and a wrong kernel moves it by O(1)), max |diff| {np.abs(a - b).max():.0f} LSB; "
        f"CPU run {time.perf_counter() - t0:.1f} s")
    if not l2 <= BF16_CPU_L2:
        fail("the card's bf16 conversion disagrees with the CPU's")
    return main_launches


def card_vs_cpu(label: str, vc, cpu, clip, settings) -> int:
    """The same clip converted on the card and on the CPU (plain versions,
    the same weights and draws); fails beyond phase 5's 4 LSB."""
    out_gpu, _ = vc.convert(clip, settings=settings)
    t0 = time.perf_counter()
    out_cpu, _ = cpu.convert(clip, settings=settings)
    tol = 4
    if out_gpu.shape != out_cpu.shape:
        fail(f"{label}: the card gave {out_gpu.shape}, the CPU {out_cpu.shape}")
    diff = np.abs(out_gpu.astype(np.int32) - out_cpu.astype(np.int32))
    say(f"  {label}: {len(clip) / 16000:g} s on the card vs the CPU: {len(out_gpu)} samples, max |diff| "
        f"{diff.max()} LSB, share above {tol} LSB {np.mean(diff > tol):.4%} (tolerance "
        f"{tol} LSB, as phase 5's); CPU run {time.perf_counter() - t0:.1f} s")
    if diff.max() > tol:
        fail(f"{label}: the card's conversion disagrees with the CPU's")
    return int(diff.max())


def timed_convert(label: str, vc, audio, seconds: float, settings, counters: dict,
                  expected: dict, card: str) -> float:
    """A set-up call, a counted and timed call whose launches must be
    ``expected``, two more timed; the output checked as phase 4 checks it.
    Returns the RTF of the median wall time."""
    import torch

    from rvc_tpu_torch.ops.filters import butter_highpass_host
    from rvc_tpu_torch.pipelines.convert import WINDOW

    vc.convert(audio, settings=settings)
    torch.cuda.synchronize()
    out, sr, launched, wall = counted_convert(vc, audio, settings, counters)
    walls = [wall] + [counted_convert(vc, audio, settings, counters)[3] for _ in range(2)]
    wall = float(np.median(walls))
    spans = vc.spans(butter_highpass_host(audio))
    Tp = path_shapes(vc, audio)["Tp"]
    expect = sum(min((e - b) // WINDOW, Tp) * (sr // 100) - 2 * vc.t_pad_tgt for b, e in spans)
    peak = int(np.abs(out.astype(np.int32)).max())
    say(f"  {label}: convert {seconds:g} s: {len(spans)} chunks, {len(out)} samples at {sr} "
        f"Hz, peak {peak}, wall ms {[round(w * 1e3, 2) for w in walls]} (median "
        f"{wall * 1e3:.2f}), RTF {seconds / wall:.2f}x, launches "
        f"{ {k: v for k, v in launched.items() if v} }; {card}")
    if sr != vc.tgt_sr or out.dtype != np.int16 or len(out) != expect or peak <= 0:
        fail(f"{label}: output {out.dtype} at {sr} Hz, {len(out)} samples, peak {peak}; "
             f"the spans give {expect} at {vc.tgt_sr} Hz")
    if launched != expected:
        fail(f"{label}: kernel launches {launched}, expected {expected}")
    return seconds / wall


def run_files(tmp: str, settings, card: str, checks: dict) -> dict:
    """Phases 13-15: models loaded from a user's files. 13: the command line
    on a full-width 48k_v2 .pth, a HuBERT .safetensors, an rmvpe.pt and a
    float32 bank, against a converter built in memory from the same arrays;
    14: a 32k v1 model (five decoder stages, the last at C = 16; HuBERT
    layer 9 with final_proj, D = 256) with its kernels held at its shapes;
    15: a 40k v1 no-f0 model. Adds to ``checks``; returns the RTFs."""
    import dataclasses

    import torch

    from rvc_tpu_torch.cli import main as cli
    from rvc_tpu_torch.compat import torch_import as ti
    from rvc_tpu_torch.config import preset
    from rvc_tpu_torch.io.audio import load_input_audio, save_input_audio
    from rvc_tpu_torch.models.hubert import HubertConfig
    from rvc_tpu_torch.ops import retrieval
    from rvc_tpu_torch.pipelines.convert import (ConvertSettings, VoiceConverter,
                                                 synth_kwargs_from_config)
    from scipy import signal
    from scipy.io import wavfile

    path = {k: os.path.join(tmp, n) for k, n in (
        ("48k_v2", "48k_v2.pth"), ("32k", "32k.pth"), ("40k", "40k_nof0.pth"),
        ("hubert", "hubert_base.safetensors"), ("rmvpe", "rmvpe.pt"), ("bank", "bank.npy"),
        ("input", "in_44k1_stereo.wav"), ("out", "out.wav"), ("ref", "ref.wav"))}
    t0 = time.perf_counter()
    kw48 = synth_kwargs_from_config(preset("48k_v2"))
    synth48 = write_rvc_pth(path["48k_v2"], kw48, "v2", seed=10)
    hub_cfg = HubertConfig()
    hub_state = write_hubert_safetensors(path["hubert"], hub_cfg, seed=11)
    rmvpe_state = write_rmvpe_pt(path["rmvpe"], seed=12)
    bank = np.random.default_rng(13).standard_normal((BANK_ROWS, 768)).astype(np.float32)
    np.save(path["bank"], bank)
    mono = signal.resample_poly(speech(30.0, 20.0), 441, 160)
    wavfile.write(path["input"], 44100, (np.stack([mono, 0.7 * np.roll(mono, 441)], 1)
                                         * 32000).astype(np.int16))
    sizes = {k: round(os.path.getsize(p) / 2**20, 1) for k, p in path.items()
             if os.path.exists(p)}
    say(f"[13/29] model files written in {time.perf_counter() - t0:.1f} s (MiB: {sizes})")

    # 13. the command line, in process, every count set to 0 just before
    counters = {**launch_counters(), "nearest_rows": (retrieval.nearest_rows, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    argv = ["convert", path["input"], path["out"], "--model", path["48k_v2"], "--hubert",
            path["hubert"], "--rmvpe", path["rmvpe"], "--index", path["bank"],
            "--resample-sr", "44100"]
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    ref_vc = VoiceConverter.from_state_dicts(synth48, kw48, hub_state, hub_cfg, rmvpe_state,
                                             index_bank=bank, device="cuda")
    units = sum(len(rb.convs1) for rb in ref_vc.synth.dec.resblocks)
    layers = len(ref_vc.synth.enc_p.encoder.attn_layers)
    expected = {**dict.fromkeys(counters, 0), "fused_resblock_group": units,
                "banded_rel_attention": layers, "nearest_rows": 1}
    audio, sr = load_input_audio(path["input"], 16000)
    ref, ref_sr = ref_vc.convert(audio, sr, ConvertSettings(resample_sr=44100))
    save_input_audio(path["ref"], (ref, ref_sr))
    got_sr, got = wavfile.read(path["out"])
    want_sr, want = wavfile.read(path["ref"])
    lsb = (float(np.abs(got.astype(np.float64) - want).max() * 32768)
           if got.shape == want.shape else math.inf)
    say(f"  the CLI: 30 s of 44.1 kHz stereo -> {len(got)} samples at {got_sr} Hz in "
        f"{wall:.2f} s (loading the files, building, the first call's set-up, "
        f"converting, writing), launches { {k: v for k, v in launched.items() if v} }; "
        f"against from_state_dicts on the same arrays and the same 16 kHz audio: max |diff| "
        f"{lsb:.3g} LSB of the written float wav (tolerance 1 LSB: the same weights, draws "
        f"and kernels; identical is expected)")
    if got_sr != want_sr or got_sr != 44100 or not lsb <= 1:
        fail("the CLI's output differs from the in-memory converter's")
    if launched != expected:
        fail(f"the CLI's kernel launches {launched}, expected {expected}")
    with torch.no_grad():
        f32 = check_nearest(ref_vc, path_shapes(ref_vc, audio), torch.Generator().manual_seed(4))
    checks["nearest"]["cli_float32_bank"] = {k: f32["float32"][k] for k in
                                             ("max_abs_err", "ms", "plain_ms", "bound_ms")}
    checks["nearest"]["cli_float32_bank"]["launches"] = launched["nearest_rows"]
    del ref_vc
    torch.cuda.empty_cache()

    # 14. 32k v1 from files: five stages down to C = 16, D = 256
    rtf = {}
    bank256 = np.random.default_rng(14).standard_normal((BANK_ROWS, 256)).astype(np.float32)
    clip10, clip3 = speech(10.0, 0.0), speech(3.0, 40.0)
    hub_file = ti.load_hubert_safetensors(path["hubert"])
    rm_file = ti.load_rmvpe(path["rmvpe"])
    for key, version, f0, seed in (("32k", "v1", True, 15), ("40k", "v1", False, 16)):
        kw = dict(synth_kwargs_from_config(preset(key)), use_f0=f0)
        write_rvc_pth(path[key], kw, version, seed)
        state, meta = ti.load_rvc_checkpoint(path[key])
        kw_file = ti.synthesizer_kwargs_from_config(meta["config"], meta["version"], meta["f0"])
        if kw_file != kw:
            fail(f"{key}: the file's kwargs {kw_file} are not the preset's {kw}")
        args = (state, kw_file, *hub_file, rm_file if f0 else None)
        opts = dict(index_bank=bank256, index_int8=True, config=dataclasses.replace(
            preset(key), **dict(zip(("x_pad", "x_query", "x_center", "x_max"), CHUNKING))))
        vc = VoiceConverter.from_state_dicts(*args, **opts, device="cuda")
        dec = vc.synth.dec
        label = f"{key} {version}" + ("" if f0 else " no-f0")
        phase = 14 if f0 else 15
        say(f"[{phase}/29] {label} from files: decoder stages of "
            f"{[rb.convs1[0].weight.shape[0] for rb in dec.resblocks[::dec.num_kernels]]} "
            f"channels, HuBERT features D = {vc.hubert.cfg.classifier_proj_size}, "
            f"{type(dec).__name__}")
        if f0:
            shapes = path_shapes(vc, clip10)
            gen = torch.Generator().manual_seed(5)
            with torch.no_grad():
                c = check_resblock(vc, shapes, gen)
                group, _ = check_resblock_bf16(vc, shapes, gen)
                near = check_nearest(vc, shapes, gen)
            checks["resblock"]["32k_v1"] = {k: c[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                              "bound_ms")}
            checks["resblock_bf16"]["32k_v1"] = {k: group[k] for k in ("max_abs_err", "ms",
                                                                       "plain_ms", "bound_ms")}
            checks["nearest"]["d256"] = {k: near["int8"][k] for k in ("max_abs_err", "ms",
                                                                      "plain_ms", "bound_ms")}
        counters = launch_counters()
        expected = {**dict.fromkeys(counters, 0),
                    "fused_resblock_group": sum(len(rb.convs1) for rb in dec.resblocks),
                    "banded_rel_attention": len(vc.synth.enc_p.encoder.attn_layers),
                    "nearest_rows_q": 1}
        rtf[label] = timed_convert(label, vc, clip10, 10.0, settings, counters, expected, card)
        cpu = VoiceConverter.from_state_dicts(*args, **opts, device="cpu")
        card_vs_cpu(label, vc, cpu, clip3, settings)
        del vc, cpu
        torch.cuda.empty_cache()
    return rtf


BATCH_L2 = BF16_CPU_L2 + 1.5e-5


def run_batch(settings, card: str) -> dict:
    """Phase 16: convert_batch of 8 songs of 10 s in bf16 (the bench's
    throughput configuration): aggregate RTF, the stats' shares, the
    launches of one counted batch, and each song against its own convert on
    its rows of the batch's draws at the batch's chunk length, both scaled
    by their peaks."""
    import torch

    vc = main_converter("cuda", torch.bfloat16)
    songs = [speech(10.0, 3.0 * i) for i in range(8)]
    stats: dict = {}
    vc.convert_batch(songs, settings=settings, stats=stats)  # set-up
    counters = launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    walls, shares = [], []
    for i in range(4):
        t0 = time.perf_counter()
        got = vc.convert_batch(songs, settings=settings, stats=stats)
        walls.append(time.perf_counter() - t0)
        shares.append((stats["device_s"], stats["download_s"], stats["dispatch_s"]))
        if i == 0:
            launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    dec = vc.synth.dec
    expected = {**dict.fromkeys(counters, 0),
                "fused_resblock_group[bf16]": sum(len(rb.convs1) for rb in dec.resblocks),
                "banded_rel_attention[bf16]": len(vc.synth.enc_p.encoder.attn_layers),
                "nearest_rows_q": 1}
    best, med = 80.0 / min(walls), 80.0 / float(np.median(walls))
    dev_s, down_s, disp_s = shares[int(np.argmin(walls))]
    say(f"[16/29] convert_batch of 8 songs of 10 s in bf16: {stats['n_chunks']} chunks of "
        f"{stats['chunk_samples']} samples, wall ms {[round(w * 1e3, 2) for w in walls]}, "
        f"aggregate RTF best {best:.2f}x, median {med:.2f}x; stats of the best: device_s "
        f"{dev_s:.4f} ({dev_s / min(walls):.1%} of the wall), download_s {down_s:.4f} "
        f"({down_s / min(walls):.1%}), dispatch_s {disp_s:.4f} ({disp_s / min(walls):.1%}), "
        f"download {stats['download_bytes'] / 2**20:.1f} MiB; launches "
        f"{ {k: v for k, v in launched.items() if v} }; {card}")
    if launched != expected:
        fail(f"convert_batch launches {launched}, expected {expected}")
    L = stats["chunk_samples"]
    Tp = path_shapes(vc, songs[0])["Tp"]
    draws = vc.draws(len(songs), Tp)
    worst = 0.0
    for i, (song, (b16, sr)) in enumerate(zip(songs, got)):
        one, sr1 = vc.convert(song, settings=settings, bucket_samples=L,
                              draws={k: v[i:i + 1] for k, v in draws.items()})
        if sr != sr1 or b16.shape != one.shape:
            fail(f"song {i}: the batch gave {b16.shape} at {sr} Hz, convert {one.shape}")
        a, b = b16 / np.abs(b16).max(), one / np.abs(one).max()
        worst = max(worst, float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    say(f"  each song of the batch against its own convert on its rows of the draws, both "
        f"scaled by their peaks: worst relative L2 {worst:.4g} (tolerance {BATCH_L2:.4g}: the "
        f"JAX package's own distance between the two on the CPU, 1.5e-5 in float32 on the "
        f"same draws (tests/test_torch_convert_batch.py: the batch's int16 quantization), "
        f"plus phase 12's bf16 bar, for bf16 roundings that flip between the batch's GEMM "
        f"shapes and one song's)")
    if not worst <= BATCH_L2:
        fail("convert_batch disagrees with per-song convert")
    return dict(agg_rtf_best=best, agg_rtf_median=med, device_s=dev_s, download_s=down_s,
                dispatch_s=disp_s)


# ---- phase 17: training a 40k_v2 model from a dataset through the CLI ----
TRAIN_PRESET = "40k_v2"
TRAIN_SOURCE_SECONDS = 32.0  # of the speech fixture, sliced into 16 clips
ADAMW_TOL = dict(atol=1e-7, rtol=1e-6)  # tests/test_torch_optimizer.py's bar
KMEANS_ROWS, KMEANS_DIM, KMEANS_CLUSTERS, KMEANS_ITERS = 200_001, 768, 10_000, 20


def write_pretrained(path_g: str, path_d: str, cfg, seed: int) -> tuple[str, str]:
    """A reference pretrained G (with its posterior encoder) and D of ``cfg``
    with random weights, as training files ({"model": state_dict,
    "iteration", "optimizer", "learning_rate"}), one tensor of each of
    another shape than the model's. Returns the two mismatched names."""
    import torch

    from rvc_tpu_torch.models.discriminator import MultiPeriodDiscriminator
    from rvc_tpu_torch.models.layers import init_random_, live_weight_norm_
    from rvc_tpu_torch.models.synthesizer import Synthesizer
    from rvc_tpu_torch.pipelines.convert import synth_kwargs_from_config

    g = init_random_(live_weight_norm_(Synthesizer(**synth_kwargs_from_config(cfg),
                                                   posterior=True)), seed)
    d = init_random_(MultiPeriodDiscriminator(cfg.model.version), seed + 1)
    odd = []
    for module, path, key in ((g, path_g, "emb_g.weight"), (d, path_d, None)):
        sd = {k: v.clone() for k, v in module.state_dict().items()}
        key = key or next(reversed(sd))
        sd[key] = torch.zeros((sd[key].shape[0] + 1,) + tuple(sd[key].shape[1:]))
        torch.save({"model": sd, "iteration": 0, "optimizer": {}, "learning_rate": 1e-4}, path)
        odd.append(key)
    return odd[0], odd[1]


def kernel_launches(fn) -> int | None:
    """Kernels the card ran in one call of ``fn`` (torch.profiler); None when
    the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type.name == "CUDA"
            and not e.name.startswith(("Memcpy", "Memset")))
    return n or None


def check_adamw(trainer, state, batch, card: str) -> dict:
    """The multi-tensor AdamW against the per-tensor loop (its plain version)
    on one step's gradients of G and of D, each from a copy of the state
    after that step: parameters, moments and the gradient norm, both
    updates' ms (CUDA events) and launches an update (torch.profiler)."""
    import torch

    from rvc_tpu_torch.train.step import AdamW, MultiTensorAdamW

    state, _ = trainer.step(state, batch, keep_grads=True)
    out = {}
    for key, opt in (("g", state.opt_g), ("d", state.opt_d)):
        grads = trainer.grads[key]
        runs = {}
        for cls in (MultiTensorAdamW, AdamW):
            o = cls([p.detach().clone() for p in opt.params], opt.schedule,
                    (opt.b1, opt.b2), opt.eps, opt.wd)
            o.m = [t.clone() for t in opt.m]
            o.v = [t.clone() for t in opt.v]
            o.count = opt.count
            norm = float(o.step(grads))
            result = (o.params, o.m, o.v)
            # time further updates on other copies, from the same state
            t = cls([p.detach().clone() for p in opt.params], opt.schedule)
            t.m = [x.clone() for x in opt.m]
            t.v = [x.clone() for x in opt.v]
            runs[cls.__name__] = (result, norm, timed(lambda: t.step(grads), reps=5),
                                  kernel_launches(lambda: t.step(grads)))
        (multi, n_m, ms_m, l_m), (plain, n_p, ms_p, l_p) = runs.values()
        worst, diff = -math.inf, 0.0
        for xs, ys in zip(multi, plain):
            for x, y in zip(xs, ys):
                d = (x - y).abs()
                worst = max(worst, (d - ADAMW_TOL["rtol"] * y.abs()).max().item())
                diff = max(diff, d.max().item())
        norm_err = abs(n_m - n_p) / max(n_p, 1e-30)
        # the least bytes an update moves: p, g, m, v read once, p, m, v written
        b_ms = 7 * 4 * sum(p.numel() for p in opt.params) / HBM * 1e3
        out[key] = dict(tensors=len(opt.params), max_abs_err=diff, norm_rel_err=norm_err,
                        ms=ms_m, plain_ms=ms_p, bound_ms=b_ms, launches=l_m, plain_launches=l_p)
        say(f"  AdamW of {'G' if key == 'g' else 'D'} ({len(opt.params)} tensors): multi-tensor "
            f"{ms_m:.3f} ms (bound {b_ms:.3f}, bytes), {l_m if l_m else 'not measured'} kernel "
            f"launches an update; per "
            f"tensor (plain) {ms_p:.3f} ms, {l_p if l_p else 'not measured'} launches; "
            f"parameters and moments max |diff| {diff:.3g}, largest |diff| - "
            f"{ADAMW_TOL['rtol']} |x| {worst:.3g} (tolerance {ADAMW_TOL['atol']}), gradient norm "
            f"{n_m:.6g} vs {n_p:.6g} (relative {norm_err:.3g}, tolerance 1e-5); {card}")
        if not (worst <= ADAMW_TOL["atol"] and norm_err <= 1e-5):
            fail(f"the multi-tensor AdamW of {key.upper()} disagrees with the per-tensor loop")
    trainer.grads = None
    return out


def run_train_from_dataset(tmp: str, settings, card: str, checks: dict) -> dict:
    """Phase 17: preprocess the speech fixture at 40 kHz, train 40k_v2 from a
    pretrained G and D for 2 epochs, resume epoch 2 from the epoch-1
    checkpoint, index the features (and k-means at the reference's scale),
    convert with the exported model: all through the port's CLI, on the
    card, at full width. Returns the training kernels' launches."""
    import dataclasses

    import torch

    from rvc_tpu_torch.cli import main as cli
    from rvc_tpu_torch.compat import torch_import as ti
    from rvc_tpu_torch.config import preset
    from rvc_tpu_torch.models.hubert import HubertConfig
    from rvc_tpu_torch.ops import resblock, retrieval, wavenet
    from rvc_tpu_torch.ops.filters import butter_highpass_host
    from rvc_tpu_torch.pipelines.convert import WINDOW, VoiceConverter
    from rvc_tpu_torch.retrieval.index import _kmeans
    from rvc_tpu_torch.train import step as step_mod
    from rvc_tpu_torch.train.checkpoints import restore_train_state
    from rvc_tpu_torch.train.data import BucketBatcher, RVCDataset
    from scipy.io import wavfile

    path = {k: os.path.join(tmp, n) for k, n in (
        ("src", "src"), ("exp", "exp"), ("run", "run"), ("hubert", "hubert.safetensors"),
        ("rmvpe", "rmvpe.pt"), ("G", "G_pretrained.pth"), ("D", "D_pretrained.pth"),
        ("in", "in10.wav"), ("out", "out10.wav"))}
    cfg = preset(TRAIN_PRESET)
    t0 = time.perf_counter()
    os.makedirs(path["src"])
    wavfile.write(os.path.join(path["src"], "speech.wav"), 16000,
                  (speech(TRAIN_SOURCE_SECONDS, 0.0) * 32768).astype(np.int16))
    hub_state = write_hubert_safetensors(path["hubert"], HubertConfig(), seed=21)
    rmvpe_state = write_rmvpe_pt(path["rmvpe"], seed=22)
    odd_g, odd_d = write_pretrained(path["G"], path["D"], cfg, seed=23)
    say(f"[17/29] train {TRAIN_PRESET} from a dataset through the CLI: HuBERT, RMVPE and a "
        f"pretrained G and D ({odd_g} and {odd_d} of another shape) written in "
        f"{time.perf_counter() - t0:.1f} s")

    # preprocess
    t0 = time.perf_counter()
    cli.main(["preprocess", path["src"], path["exp"], "--sr", "40k", "--hubert", path["hubert"],
              "--rmvpe", path["rmvpe"]])
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    n_clips = sum(f.endswith(".wav") for f in os.listdir(os.path.join(path["exp"], "0_gt_wavs")))
    n_files = {sub: len(os.listdir(os.path.join(path["exp"], sub)))
               for sub in ("3_feature768", "2a_f0", "2b-f0nsf")}
    say(f"  preprocess: the first {TRAIN_SOURCE_SECONDS:g} s of assets/speech_65s.wav at 40 kHz "
        f"-> {n_clips} clips, feature and f0 "
        f"files {n_files}, {pre_s:.2f} s (slicing, writing, HuBERT and RMVPE on the card, the "
        f"filelist)")
    if n_clips < 10 or any(n != n_clips for n in n_files.values()):
        fail("preprocess: the feature and f0 files do not match the clips")

    # train, every step recorded: wall (synchronized), losses; from step 3 on
    # each stage's ms on the card (CUDA events) and on the host (the clock
    # read at the same marks)
    rec = {"walls": [], "losses": [], "stages": [], "host": [], "marks": []}
    original, mark = step_mod.Trainer.step, step_mod._mark

    def marked(events, name):
        mark(events, name)
        if events is not None:
            rec["marks"].append(time.perf_counter())

    def recorded(self, state, batch, draws=None, keep_grads=False, events=None):
        ev = [] if len(rec["walls"]) >= 2 else events
        rec["marks"] = []
        t = time.perf_counter()
        out = original(self, state, batch, draws=draws, keep_grads=keep_grads, events=ev)
        torch.cuda.synchronize()
        rec["walls"].append(time.perf_counter() - t)
        rec["losses"].append({k: float(v) for k, v in out[1].items() if k != "viz"})
        if ev:
            names = [name for name, _ in ev[1:]]
            rec["stages"].append(dict(zip(names, (a.elapsed_time(b) for (_, a), (_, b)
                                                  in zip(ev[:-1], ev[1:])))))
            rec["host"].append(dict(zip(names, ((b - a) * 1e3 for a, b
                                                in zip(rec["marks"][:-1], rec["marks"][1:])))))
        return out

    counters = {"fused_resblock1": resblock.fused_resblock1,
                "fused_resblock1_backward": resblock.fused_resblock1_backward,
                "fused_wn": wavenet.fused_wn, "fused_wn_backward": wavenet.fused_wn_backward}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_mod.Trainer.step, step_mod._mark = recorded, marked
    t0 = time.perf_counter()
    try:
        cli.main(["train", os.path.join(path["exp"], "filelist.txt"), path["run"], "--preset",
                  TRAIN_PRESET, "--batch-size", str(TRAIN_BATCH), "--epochs", "2",
                  "--save-every", "1", "--pretrained-g", path["G"], "--pretrained-d", path["D"]])
    finally:
        step_mod.Trainer.step, step_mod._mark = original, mark
    train_s = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = len(rec["walls"])
    per_epoch = steps // 2
    walls = rec["walls"][1:]
    audio_s = TRAIN_BATCH * cfg.train.segment_size / cfg.data.sampling_rate
    stages = {name: round(ms, 3) for name, ms in rec["stages"][0].items()}
    median = {which: {name: round(float(np.median([r[name] for r in rec[which]])), 3)
                      for name in stages} for which in ("stages", "host")}
    trainer = step_mod.Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=2, batch_size=TRAIN_BATCH)), device="cuda")
    n_chains = len(trainer.synth.dec.resblocks)
    n_wn = wn_launches_per_step(trainer.synth)
    expected = {k: expected_training_launches(trainer, steps)[k] for k in counters}
    run_files = sorted(os.listdir(path["run"]))
    say(f"  train: {steps} steps ({per_epoch} an epoch, batch {TRAIN_BATCH}), {train_s:.2f} s in "
        f"all (building, warm start, checkpoints, exports); steps after the first: wall s "
        f"{[round(w, 4) for w in walls]}, {len(walls) / sum(walls):.3f} steps/s, "
        f"{audio_s * len(walls) / sum(walls):.3f} s of audio trained per s; "
        f"max_memory_allocated {peak:.2f} GiB; launches {launched} (decoder chains {n_chains}, "
        f"WN groups {n_wn} a step); files {run_files}; {card}")
    say(f"  stages of step 3 (CUDA events, ms): {stages}")
    say(f"  stages, median of steps 3-{steps} (ms): CUDA events {median['stages']}; host clock "
        f"at the same marks {median['host']}")
    for i, vals in enumerate(rec["losses"]):
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"step {i}: a loss is not finite: {vals}")
    say("  losses (loss_gen_all, loss_mel) by step: "
        f"{[(round(v['loss_gen_all'], 4), round(v['loss_mel'], 4)) for v in rec['losses']]}")
    if launched != expected:
        fail(f"training kernel launches {launched}, expected {expected}")
    ckpts = sorted((int(f.split("_")[1]), f) for f in run_files if f.startswith("state_"))
    if [s for s, _ in ckpts] != [per_epoch, 2 * per_epoch] or not all(
            f in run_files for f in ("losses.json", "model_best.pth", "model.pth")):
        fail(f"the run wrote {run_files}")

    # the optimizer on the card, on a fresh trainer's step
    filelist = os.path.join(path["exp"], "filelist.txt")
    batcher = BucketBatcher(RVCDataset(filelist, cfg.data), TRAIN_BATCH, seed=cfg.train.seed)
    adamw = check_adamw(trainer, trainer.init_state(seed=3, steps_per_epoch=per_epoch),
                        next(iter(batcher.epoch(0))), card)

    # resume epoch 2 from the epoch-1 checkpoint in a fresh trainer
    del trainer
    torch.cuda.empty_cache()
    trainer = step_mod.Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=2, batch_size=TRAIN_BATCH)), device="cuda")
    state = trainer.init_state(seed=5, steps_per_epoch=per_epoch)
    ckpt = os.path.join(path["run"], ckpts[0][1])
    state = restore_train_state(ckpt, trainer, state)
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    live = {**{f"synth.{k}": v for k, v in trainer.synth.state_dict().items()},
            **{f"disc.{k}": v for k, v in trainer.disc.state_dict().items()}}
    want = {**{f"synth.{k}": v for k, v in saved["synth"].items()},
            **{f"disc.{k}": v for k, v in saved["disc"].items()}}
    for name, opt in (("opt_g", state.opt_g), ("opt_d", state.opt_d)):
        for which in ("m", "v"):
            live.update({f"{name}.{which}{i}": t for i, t in enumerate(getattr(opt, which))})
            want.update({f"{name}.{which}{i}": t for i, t in enumerate(saved[name][which])})
    for name in ("balancer_g", "balancer_d"):
        live.update({f"{name}{i}": t for i, t in enumerate(getattr(state, name))})
        want.update({f"{name}{i}": t for i, t in enumerate(saved[name])})
    unequal = [k for k in want if not torch.equal(live[k].cpu(), want[k])]
    if unequal or live.keys() != want.keys() or state.step != per_epoch:
        fail(f"the restored state differs from the checkpoint: {unequal[:8]}")
    resumed = []
    for batch in batcher.epoch(1):
        state, m = trainer.step(state, batch, draws=trainer.draws(batch, state.step))
        resumed.append({k: float(v) for k, v in m.items() if k != "viz"})
    straight = rec["losses"][per_epoch:]
    err = max(abs(a[k] - b[k]) / max(1.0, abs(b[k])) for a, b in zip(resumed, straight)
              for k in b if not k.startswith("grad_norm"))
    say(f"  resume: {len(want)} tensors of {ckpts[0][1]} restored bit for bit; epoch 2 again "
        f"({len(resumed)} steps): losses within {err:.3g} of the uninterrupted run's (relative, "
        f"of max(1, |loss|); tolerance 1e-3, as phase 8's: cuDNN's weight gradients may sum "
        f"in another order from run to run)")
    if len(resumed) != len(straight) or not err <= 1e-3:
        fail("the resumed epoch disagrees with the uninterrupted run")
    del trainer, state
    torch.cuda.empty_cache()

    # index, then k-means at the reference's scale
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cli.main(["index", path["exp"]])
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    bank = np.load(os.path.join(path["exp"], "index.npy"))
    feats = np.random.default_rng(24).standard_normal((KMEANS_ROWS, KMEANS_DIM), np.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = torch.from_numpy(feats).cuda()
    # from the initial rows train_index draws above max_rows (its seed, 0)
    init_idx = np.random.default_rng(0).choice(KMEANS_ROWS, KMEANS_CLUSTERS, replace=False)
    inertia = []
    centroids = _kmeans(data, data[torch.from_numpy(init_idx).cuda()], KMEANS_CLUSTERS,
                        KMEANS_ITERS, inertia=inertia)
    torch.cuda.synchronize()
    km_s = time.perf_counter() - t0
    km_peak = torch.cuda.max_memory_allocated() / 2**30
    rises = [i for i in range(1, len(inertia)) if inertia[i] > inertia[i - 1] * (1 + 1e-6)]
    nan = bool(torch.isnan(centroids).any().item())
    say(f"  index: {bank.shape[0]} x {bank.shape[1]} bank from the features in {index_s:.2f} s; "
        f"k-means of {KMEANS_ROWS} x {KMEANS_DIM} seeded rows (train_index's branch above "
        f"max_rows) to {KMEANS_CLUSTERS} centroids, {KMEANS_ITERS} iterations: {km_s:.2f} s "
        f"(upload and inertia trace included), max_memory_allocated {km_peak:.2f} GiB; inertia "
        f"{[round(x, 1) for x in inertia]}, rises beyond 1e-6 relative {rises}, NaN "
        f"centroids {nan}; {card}")
    if (bank.shape[1] != 768 or rises or nan or len(inertia) != KMEANS_ITERS
            or tuple(centroids.shape) != (KMEANS_CLUSTERS, KMEANS_DIM)):
        fail("the index or k-means failed its checks")
    del data, centroids
    torch.cuda.empty_cache()

    # convert 10 s with the exported model and the index through the CLI
    clip10, clip_cpu = speech(10.0, 30.0), speech(1.5, 50.0)
    wavfile.write(path["in"], 16000, (clip10 * 32768).astype(np.int16))
    conv = {**launch_counters(), "nearest_rows": (retrieval.nearest_rows, "launches")}
    for fn, attr in conv.values():
        setattr(fn, attr, 0)
    model = os.path.join(path["run"], "model.pth")
    t0 = time.perf_counter()
    cli.main(["convert", path["in"], path["out"], "--model", model, "--hubert", path["hubert"],
              "--rmvpe", path["rmvpe"], "--index", os.path.join(path["exp"], "index.npy")])
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    launched_c = {k: getattr(fn, attr) for k, (fn, attr) in conv.items()}
    state_c, meta = ti.load_rvc_checkpoint(model)
    kw = ti.synthesizer_kwargs_from_config(meta["config"], meta["version"], meta["f0"])
    args = (state_c, kw, hub_state, HubertConfig(), rmvpe_state)
    vc = VoiceConverter.from_state_dicts(*args, index_bank=bank, device="cuda")
    dec = vc.synth.dec
    expected_c = {**dict.fromkeys(conv, 0),
                  "fused_resblock_group": sum(len(rb.convs1) for rb in dec.resblocks),
                  "banded_rel_attention": len(vc.synth.enc_p.encoder.attn_layers),
                  "nearest_rows": 1}
    out, sr = vc.convert(clip10, settings=settings)
    spans = vc.spans(butter_highpass_host(clip10))
    Tp = path_shapes(vc, clip10)["Tp"]
    expect = sum(min((e - b) // WINDOW, Tp) * (sr // 100) - 2 * vc.t_pad_tgt for b, e in spans)
    got_sr, got = wavfile.read(path["out"])
    say(f"  convert 10 s with the exported model.pth and index.npy through the CLI: {len(got)} "
        f"samples at {got_sr} Hz written in {conv_s:.2f} s (files read, converter built, "
        f"set-up, converting); the same files in memory: {out.dtype} at {sr} Hz, {len(out)} "
        f"samples (the spans give {expect}), peak {int(np.abs(out.astype(np.int32)).max())}; "
        f"launches {launched_c} (expected {expected_c})")
    if (got_sr != sr or sr != cfg.data.sampling_rate or out.dtype != np.int16
            or not len(got) == len(out) == expect or np.abs(out).max() <= 0):
        fail("the trained model's conversion failed its checks")
    if launched_c != expected_c:
        fail(f"the CLI's kernel launches {launched_c}, expected {expected_c}")
    cpu = VoiceConverter.from_state_dicts(*args, index_bank=bank, device="cpu")
    lsb = card_vs_cpu(f"{TRAIN_PRESET} trained", vc, cpu, clip_cpu, settings)
    del vc, cpu
    torch.cuda.empty_cache()
    checks["train_40k_v2"] = dict(clips=n_clips, steps=steps, adamw=adamw, lsb=lsb)
    return launched


# ---- phase 18: every f0 method, infer_mix and the host library ----
F0_METHODS = ("pm", "dio", "harvest", "crepe", "crepe-tiny", "mangio-crepe",
              "mangio-crepe-tiny", "rmvpe+", ("rmvpe", "harvest", "crepe-tiny"))
MANGIO_HOP = 64
# f0 card vs CPU, as the CPU tests hold the port against JAX: the same voicing
# and within the method's relative bar on at least F0_SHARE of the frames
# (tests/test_torch_pitch_methods.py: 1e-4 for the classical methods and
# the merge; tests/test_torch_crepe.py: 1e-5 for crepe; tests/
# test_torch_hubert_rmvpe.py: 1e-5 for rmvpe)
F0_SHARE = 0.99
RMS_REL = 5e-6  # the host library's double sums against numpy's float32 ones
F0_TIMED_SECONDS = 10.0   # each method's f0 timed alone
F0_CPU_SECONDS = 1.5      # card vs CPU (CREPE full: 0.5 s)


def f0_label(method) -> str:
    return method if isinstance(method, str) else "+".join(method)


def f0_rel(method) -> float:
    return 1e-5 if isinstance(method, str) and ("crepe" in method or "rmvpe" in method) else 1e-4


def f0_agreement(got: np.ndarray, ref: np.ndarray, rel: float) -> tuple[int, int]:
    """(frames with the same voicing and f0 within ``rel``, frames)."""
    same = (got > 0) == (ref > 0)
    close = np.abs(got - ref) <= rel * np.maximum(np.abs(ref), 1e-6)
    return int(np.sum(same & (close | (ref <= 0)))), ref.size


def glide(seconds: float) -> np.ndarray:
    """Six harmonics of a pitch gliding from 120 to 300 Hz, at 16 kHz."""
    t = np.arange(int(seconds * 16000)) / 16000
    phase = 2 * np.pi * np.cumsum(120.0 + 180.0 * t / t[-1]) / 16000
    x = sum(0.7 ** (h - 1) * np.sin(h * phase) for h in range(1, 7))
    return (0.3 * x / np.abs(x).max()).astype(np.float32)


def check_host_library() -> dict:
    """The port's host library, built here with g++, against its numpy plain
    versions on the speech fixture."""
    from rvc_tpu_torch import native
    from rvc_tpu_torch.ops import filters, slicer

    t0 = time.perf_counter()
    lib = native.library()
    build_s = time.perf_counter() - t0
    x = speech(30.0, 10.0)
    q, peak = filters.peak_quantize_i16(x)
    nq, npeak = filters.peak_quantize_i16_numpy(x)
    sl = slicer.Slicer(sr=16000, threshold=-50, min_length=1500, min_interval=400,
                       hop_size=15, max_sil_kept=500)
    rms = slicer.frame_rms(x, sl.win_size, sl.hop_size)
    nrms = slicer.frame_rms_numpy(x, sl.win_size, sl.hop_size)
    rms_err = float(np.max(np.abs(rms - nrms) / np.maximum(nrms, 1e-9)))
    tags, ntags = sl._silence_tags(rms), sl._silence_tags_numpy(rms)
    say(f"[18/29] host library {os.path.relpath(lib._name, REPO)} built and loaded in "
        f"{build_s:.2f} s: peak_quantize_i16 on 30 s equal to numpy's {np.array_equal(q, nq)} "
        f"(peak {peak} / {npeak}); frame_rms of {len(rms)} frames within {rms_err:.3g} "
        f"relative of numpy's float32 sums (tolerance {RMS_REL}); the slicer's {len(tags)} "
        f"silence tags equal to the Python loop's {tags == ntags}")
    if not (np.array_equal(q, nq) and peak == npeak and rms_err <= RMS_REL and tags == ntags
            and len(tags) > 0):
        fail("the host library disagrees with its numpy versions")
    return dict(build_s=build_s, rms_rel=rms_err, tags=len(tags))


def with_crepe(vc, device: str):
    """Random CREPE nets (full and tiny, from seeds, positive running
    variances) on ``vc``'s pitch extractor."""
    from rvc_tpu_torch.models import crepe
    from rvc_tpu_torch.models.layers import load_numpy_state_dict

    for attr, capacity, seed in (("crepe", "full", 5), ("crepe_tiny", "tiny", 6)):
        net = load_numpy_state_dict(crepe.CrepeNet(capacity), crepe.random_state_dict(capacity, seed))
        setattr(vc.pitch, attr, net.to(device).eval())
    return vc


def run_f0_methods(card: str) -> dict:
    """Phase 18: the host library; each f0 method converting 10 s on phase
    4's converter (kernels 1-3 launched as there), its f0 of 30 s timed
    alone with its kernel count; each method's f0 card vs CPU; a 3 s hybrid
    conversion card vs CPU; infer_mix with one-hot weights against infer."""
    import copy

    import torch

    from rvc_tpu_torch.pipelines.convert import ConvertSettings, synth_kwargs_from_config
    from rvc_tpu_torch.pitch.extractor import PitchExtractor, coarse_f0

    out = {"host": check_host_library()}
    t0 = time.perf_counter()
    vc = with_crepe(main_converter("cuda"), "cuda")
    say(f"  converter with CREPE full and tiny built in {time.perf_counter() - t0:.1f} s")
    counters = launch_counters()
    dec = vc.synth.dec
    expected = {**dict.fromkeys(counters, 0),
                "fused_resblock_group": sum(len(rb.convs1) for rb in dec.resblocks),
                "banded_rel_attention": len(vc.synth.enc_p.encoder.attn_layers),
                "nearest_rows_q": 1}
    clip10 = speech(10.0, 0.0)
    a_timed = torch.from_numpy(speech(F0_TIMED_SECONDS, 10.0))[None].cuda()
    cpu_pitch = PitchExtractor(**{k: copy.deepcopy(getattr(vc.pitch, k)).cpu()
                                  for k in ("rmvpe", "crepe", "crepe_tiny")}).to("cpu")
    a_cpu = torch.from_numpy(np.stack([speech(F0_CPU_SECONDS, 40.0), glide(F0_CPU_SECONDS)]))
    for method in F0_METHODS:
        label = f0_label(method)
        settings = ConvertSettings(**dict(SETTINGS, f0_method=method,
                                          crepe_hop_length=MANGIO_HOP))
        rtf = timed_convert(label, vc, clip10, 10.0, settings, counters, expected, card)

        def f0_of(audio, pitch=vc.pitch, method=method):
            return pitch.compute(audio, method, "median", 50.0, 1100.0, 3, MANGIO_HOP)

        ms = timed(lambda: f0_of(a_timed), reps=3, warmup=1)
        n_kernels = kernel_launches(lambda: f0_of(a_timed))
        # CREPE full (and its mangio form): 0.5 s on the CPU
        clip = a_cpu[:, :8000] if method in ("crepe", "mangio-crepe") else a_cpu
        got = f0_of(clip.cuda()).cpu().numpy()
        t1 = time.perf_counter()
        ref = f0_of(clip, cpu_pitch).numpy()
        n_ok, n = f0_agreement(got, ref, f0_rel(method))
        say(f"    f0 of {F0_TIMED_SECONDS:g} s alone: {ms:.2f} ms (CUDA events, mean of 3 after a "
            f"warm-up), "
            f"{n_kernels} kernels in one call (torch.profiler); card vs CPU on "
            f"{clip.shape[1] / 16000:g} s: {n_ok} of {n} frames agree (voicing, and f0 within "
            f"{f0_rel(method):g} relative; bar {F0_SHARE:.0%}), {int((ref > 0).sum())} voiced "
            f"(speech and a harmonic glide); "
            f"CPU {time.perf_counter() - t1:.1f} s")
        if got.shape != ref.shape or n_ok < F0_SHARE * n or not (ref > 0).any():
            fail(f"{label}: the card's f0 disagrees with the CPU's")
        out[label] = dict(rtf_10s=rtf, f0_ms=ms, kernels=n_kernels, agree=n_ok, frames=n)

    walls = {k: 10.0 / v["rtf_10s"] for k, v in out.items() if "rtf_10s" in v}
    say("  f0's share of the 10 s conversion's wall (the wall beyond pm's, whose f0 is the "
        "cheapest): " + ", ".join(f"{k} {(w - walls['pm']) / w:.1%}" for k, w in walls.items()
                                  if k != "pm"))

    # the hybrid conversion, card vs CPU
    hybrid = ConvertSettings(**dict(SETTINGS, f0_method=list(F0_METHODS[-1])))
    t0 = time.perf_counter()
    cpu = cpu_copy(vc, synth_kwargs_from_config(vc.config))  # the same weights, copied
    say(f"  CPU converter copied in {time.perf_counter() - t0:.1f} s")
    out["hybrid_lsb"] = card_vs_cpu(f0_label(F0_METHODS[-1]), vc, cpu,
                                    speech(F0_CPU_SECONDS, 40.0), hybrid)
    del cpu

    # infer_mix with one-hot weights against infer at that sid
    gen = torch.Generator().manual_seed(8)
    T, sid = 300, 5 % vc.synth.emb_g.num_embeddings
    feats = torch.randn(1, T, vc.synth.enc_p.emb_phone.in_features, generator=gen).cuda()
    lens = torch.tensor([T]).cuda()
    f0 = (150 + 50 * torch.rand(1, T, generator=gen)).cuda()
    draws = {k: v.cuda() for k, v in dict(
        eps=torch.randn(1, vc.synth.enc_p.out_channels, T, generator=gen),
        rand_ini=torch.rand(1, 1, generator=gen),
        noise=torch.randn(1, T * dec.upp, 1, generator=gen)).items()}
    mix = torch.zeros(1, vc.synth.emb_g.num_embeddings).cuda()
    mix[0, sid] = 1.0
    with torch.no_grad():
        a = vc.synth.infer_mix(feats, lens, coarse_f0(f0), f0, mix, **draws)[0]
        b = vc.synth.infer(feats, lens, coarse_f0(f0), f0, torch.tensor([sid]).cuda(), **draws)[0]
    err, scale = scaled(a, b)
    say(f"  infer_mix with one-hot weights at sid {sid} against infer: {tuple(a.shape)}, max "
        f"|diff| {err:.3g} of {scale:.3g} (bit for bit: {torch.equal(a, b)}; tolerance "
        f"{VALUE_TOL} of the largest)")
    if not err <= VALUE_TOL * scale:
        fail("infer_mix with one-hot weights disagrees with infer")
    out["infer_mix_err"] = err
    del vc
    torch.cuda.empty_cache()
    return out


# ---- phase 22: separation (the VR and MDX-Net routes) ----

def lively_array(name: str, shape, rng) -> np.ndarray:
    """A separation net's parameter drawn so that activations neither vanish
    nor saturate (random weights at 0.02 leave every mask at 0.5): kernels
    N(0, 2 / fan_in), norm gains and running variances U(0.5, 1.5), shifts,
    biases and running means N(0, 0.1)."""
    shape = tuple(shape)
    if len(shape) >= 2:
        return (rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))).astype(np.float32)
    if name in ("weight", "running_var"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


def lively_state(module, seed: int) -> dict:
    """{name: array} for every entry of ``module``'s state_dict, by
    ``lively_array`` in state_dict order."""
    rng = np.random.default_rng(seed)
    return {k: lively_array(k.rsplit(".", 1)[-1], t.shape, rng)
            for k, t in module.state_dict().items()}


def write_vr_pth(path: str, n_fft: int, seed: int) -> dict:
    """A UVR5 VR ``.pth`` as the reference saves it: CascadedASPPNet(n_fft)'s
    state_dict with the training-only aux outputs and num_batches_tracked,
    ``lively_state`` weights. Returns the arrays the net takes."""
    import torch

    from rvc_tpu_torch.models.vr_network import CascadedASPPNet

    state = lively_state(CascadedASPPNet(n_fft), seed)
    saved = {k: torch.from_numpy(v) for k, v in state.items()}
    saved["aux1_out.weight"] = torch.zeros(2, 32, 1, 1)
    saved["aux2_out.weight"] = torch.zeros(2, 32, 1, 1)
    for k in [k for k in state if k.endswith("running_mean")]:
        saved[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(100)
    torch.save(saved, path)
    return state


def _pb_varint(v: int) -> bytes:
    out = b""
    while True:
        low, v = v & 0x7F, v >> 7
        out += bytes([low | (0x80 if v else 0)])
        if not v:
            return out


def _pb_field(num: int, wire: int, payload: bytes) -> bytes:
    key = _pb_varint((num << 3) | wire)
    return key + (_pb_varint(len(payload)) + payload if wire == 2 else payload)


def write_mdx_onnx(path: str, net, seed: int) -> dict:
    """A UVR MDX ``.onnx`` with anonymous initializers (``onnx::W_i``), the
    form the UVR exports take, so that the structural route maps it: one
    node a parameter in ``net``'s forward order (Conv, ConvTranspose, MatMul
    storing (in, out), a norm's Mul and Add, or BatchNormalization), raw
    float32 data. ``lively_state`` weights; returns them."""
    from rvc_tpu_torch.compat.onnx_import import trace_order

    state = lively_state(net, seed)
    names = list(trace_order(net))
    inits, nodes, i = [], [], 0

    def tensor(name, arr):
        buf = b"".join(_pb_field(1, 0, _pb_varint(d)) for d in arr.shape)
        buf += _pb_field(2, 0, _pb_varint(1)) + _pb_field(8, 2, name.encode())
        buf += _pb_field(9, 2, np.ascontiguousarray(arr, np.float32).tobytes())
        return _pb_field(5, 2, buf)

    def node(op, inputs):
        buf = b"".join(_pb_field(1, 2, x.encode()) for x in inputs)
        buf += _pb_field(2, 2, f"y{len(nodes)}".encode()) + _pb_field(4, 2, op.encode())
        return _pb_field(1, 2, buf)

    while i < len(names):
        a = state[names[i]]
        if a.ndim == 1 and names[i + 2:i + 3] and names[i + 2].endswith("running_mean"):
            group = [f"onnx::W_{i + j}" for j in range(4)]
            inits += [tensor(n, state[names[i + j]]) for j, n in enumerate(group)]
            nodes.append(node("BatchNormalization", ["x", *group]))
            i += 4
            continue
        name = f"onnx::W_{i}"
        if a.ndim == 4:
            op = "ConvTranspose" if names[i].startswith("us.") else "Conv"
        elif a.ndim == 2:
            op, a = "MatMul", a.T
        else:
            op = "Mul" if names[i].endswith("weight") else "Add"
        inits.append(tensor(name, a))
        nodes.append(node(op, ["x", name]))
        i += 1
    with open(path, "wb") as f:
        f.write(_pb_field(7, 2, b"".join(nodes + inits)))
    return state


def network_flops(make_net, shape, device: str = "meta") -> float:
    """Multiply-adds x 2 of one forward of the net ``make_net()`` returns,
    on an input of ``shape`` (or inputs of a list of shapes), counted from
    the shapes each conv, transposed conv, linear, LSTM and attention
    (``models.htdemucs``'s ``MultiheadAttention`` and ``LocalState``
    products, the RoFormers' ``Attention``, MuseTalk's VAE and UNet
    attention) sees, by forward hooks. On the meta device no arithmetic runs; ``device`` "cuda" runs
    one forward of the net, which may be one that exists already (meta
    unrolls an LSTM step by step on the host)."""
    import torch
    from torch import nn

    from rvc_tpu_torch.models.bs_roformer import Attention as RoformerAttention
    from rvc_tpu_torch.models.htdemucs import LocalState, MultiheadAttention
    from rvc_tpu_torch.models.musetalk.unet import CrossAttention
    from rvc_tpu_torch.models.musetalk.vae import AttentionBlock

    total = [0.0]

    def hook(m, inp, out):
        x = inp[0]
        if isinstance(m, nn.modules.conv._ConvTransposeNd):
            total[0] += 2.0 * x.numel() * m.out_channels // m.groups * math.prod(m.kernel_size)
        elif isinstance(m, nn.modules.conv._ConvNd):
            total[0] += 2.0 * out.numel() * m.in_channels // m.groups * math.prod(m.kernel_size)
        elif isinstance(m, nn.Linear):
            total[0] += 2.0 * out.numel() * m.in_features
        elif isinstance(m, nn.LSTM):  # (T, B, I) in, per direction 4H x (I + H) a step
            steps, H = x.shape[0] * x.shape[1], m.hidden_size
            for layer in range(m.num_layers):
                i = m.input_size if layer == 0 else 2 * H
                total[0] += 2.0 * 2 * steps * 4 * H * (i + H)
        elif isinstance(m, MultiheadAttention):  # in-projections, q k^T, p v
            (B, Tq, C), Tk = x.shape, inp[1].shape[1]
            total[0] += 2.0 * B * C * C * (Tq + 2 * Tk) + 4.0 * B * Tq * Tk * C
        elif isinstance(m, LocalState):  # k^T q and w content over (B, C, T)
            B, C, T = x.shape
            total[0] += 4.0 * B * T * T * C
        elif isinstance(m, RoformerAttention):  # q k^T and p v a head (projections: Linear)
            B, N, _ = x.shape
            total[0] += 4.0 * B * m.heads * N * N * m.dim_head
        elif isinstance(m, AttentionBlock):  # q k^T and p v over the H W positions
            B, C, H, W = x.shape
            total[0] += 4.0 * B * (H * W) ** 2 * C
        elif isinstance(m, CrossAttention):  # q k^T and p v over the heads (projections: Linear)
            B, T, _ = x.shape
            total[0] += 4.0 * B * T * (inp[1] if len(inp) > 1 else x).shape[1] * m.to_q.out_features

    kinds = (nn.modules.conv._ConvNd, nn.Linear, nn.LSTM, MultiheadAttention, LocalState,
             RoformerAttention, AttentionBlock, CrossAttention)
    shapes = shape if isinstance(shape[0], (tuple, list)) else [shape]
    with torch.device(device):
        net = make_net()
        handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, kinds)]
        try:
            with torch.no_grad():
                net(*[torch.empty(s) for s in shapes])
        finally:
            for h in handles:
                h.remove()
    return total[0]


def song_stereo(seconds: float) -> np.ndarray:
    """(2, T) float32 at 44.1 kHz: the speech fixture (from 5 s in) at 0 and
    3 ms of delay on the left and right, each over a seeded harmonic
    "instrumental" (five partials of 110 Hz, seeded phases a channel, a
    slow swell), peak 0.9."""
    from scipy import signal as ss

    voice = ss.resample_poly(speech(seconds, 5.0), 441, 160).astype(np.float64)
    t = np.arange(voice.size) / 44100
    rng = np.random.default_rng(22)
    chans = []
    for delay in (0, 132):
        v = np.concatenate([np.zeros(delay), voice[: voice.size - delay]])
        inst = sum(0.15 / k * np.sin(2 * np.pi * 110 * k * t + rng.uniform(0, 2 * np.pi))
                   for k in range(1, 6)) * (0.6 + 0.4 * np.sin(2 * np.pi * 0.25 * t))
        chans.append(v + inst)
    out = np.stack(chans)
    return (0.9 * out / np.abs(out).max()).astype(np.float32)


def stage_ms(events: list) -> dict:
    """Milliseconds between consecutive (stage, CUDA event) marks, summed
    by the stage each interval ends."""
    out: dict = {}
    for (_, a), (name, b) in zip(events, events[1:]):
        out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    return out


def busy_share(fn) -> tuple[float, float, list]:
    """(busy ms, wall ms, the 5 kernels with the most device time as (ms,
    calls, name)) of one call of ``fn`` under torch.profiler. Busy is the
    union of the device's activity intervals (cuDNN and cuFFT may run
    kernels side by side, so their sum can exceed the wall); 0 where the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy, end = 0.0, -math.inf
    by_name: dict = {}
    for e in sorted(device, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        total = by_name.setdefault(e.name, [0.0, 0])
        total[0] += b - a
        total[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return busy / 1e3, wall, [(t / 1e3, n, k[:60]) for k, (t, n) in top]


SEP_SECONDS = 30.0
SEP_TOL = 4  # LSB, card vs CPU: phase 5's bar


def stem_lsb(a: dict, b: dict) -> dict:
    """max |a - b| in LSB of each int16 stem of ``a`` (a separator's output);
    fails on another shape."""
    out = {}
    for stem in (k for k in a if k not in ("sr", "input_audio")):
        x, y = a[stem][0], b[stem][0]
        if x.shape != y.shape or x.dtype != np.int16 or y.dtype != np.int16:
            fail(f"{stem}: {x.dtype} {x.shape} against {y.dtype} {y.shape}")
        out[stem] = int(np.abs(x.astype(np.int32) - y.astype(np.int32)).max())
    return out


def check_stems(out: dict, n_in: int, hop: int, label: str) -> None:
    """int16 stems at 44.1 kHz, within a hop of the input's length, not
    silent, not equal to each other."""
    v, i = out["vocals"][0], out["instrumentals"][0]
    if out["sr"] != 44100 or v.dtype != np.int16 or i.dtype != np.int16:
        fail(f"{label}: stems are {v.dtype}/{i.dtype} at {out['sr']} Hz")
    if not (abs(len(v) - n_in) <= hop and len(i) == len(v)):
        fail(f"{label}: stems of {len(v)} and {len(i)} samples from {n_in}")
    if np.abs(v).max() == 0 or np.abs(i).max() == 0 or np.array_equal(v, i):
        fail(f"{label}: a silent stem, or two equal stems")


def write_song_wav(path: str, song: np.ndarray) -> None:
    """(2, T) float at 44.1 kHz -> a stereo int16 wav."""
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(44100)
        f.writeframes((song.T * 32767).astype(np.int16).tobytes())


def check_cli_separate(tmp: str, wav: str, path: str, sep, label: str, channels: int) -> None:
    """The CLI's ``separate`` on ``wav`` with the model at ``path``: its
    vocals.wav and instrumentals.wav against ``sep``'s stems (the separator
    load_separator builds) on the file's downmix, both written by
    save_input_audio (peak-scaled), the difference in LSB of ``sep``'s
    int16 stem; ``channels`` a wav."""
    from scipy.io import wavfile

    from rvc_tpu_torch.cli import main as cli
    from rvc_tpu_torch.io.audio import load_input_audio, save_input_audio

    outdir = os.path.join(tmp, f"stems_{label}")
    t1 = time.perf_counter()
    cli.main(["separate", wav, outdir, "--model", path])
    took = time.perf_counter() - t1
    ref = sep.run_inference(*load_input_audio(wav))
    lsb = {}
    for stem in ("vocals", "instrumentals"):
        want = os.path.join(tmp, f"{label}_{stem}_ref.wav")
        save_input_audio(want, ref[stem])
        rate, got = wavfile.read(os.path.join(outdir, f"{stem}.wav"))
        _, exp = wavfile.read(want)
        if rate != 44100 or got.shape != exp.shape or (got.shape + (1,))[1] != channels:
            fail(f"CLI {label} {stem}.wav: {got.shape} at {rate} Hz, expected {exp.shape}")
        scale = np.abs(ref[stem][0]).max() / max(np.abs(exp).max(), 1e-9)
        lsb[stem] = float(np.abs(got.astype(np.float64) - exp).max() * scale)
    say(f"  CLI separate --model {os.path.basename(path)}: {took:.1f} s; its wavs against "
        f"load_separator's on the same downmix: max |diff| "
        + ", ".join(f"{k} {v:.2f}" for k, v in lsb.items()) + f" LSB (tolerance {SEP_TOL})")
    if max(lsb.values()) > SEP_TOL:
        fail(f"CLI {label}: its stems disagree with load_separator's")


def run_separation(tmp: str, card: str) -> dict:
    """Phase 22: separation at full width through load_separator and the
    CLI, on both routes: RTF, stages, peak memory and busy share; card vs
    CPU on one window a route; kernels 1-8 launched no time. Returns, by
    route, the set-up call's stems, the network's FLOPs a window and the
    model file (for phase 26)."""
    import torch

    from rvc_tpu_torch.models.mdx_net import ConvTDFNetTrim
    from rvc_tpu_torch.models.vr_network import CascadedASPPNet
    from rvc_tpu_torch.ops.bands import FOURBAND_V2_PARAM
    from rvc_tpu_torch.pipelines.separate import load_separator, route_separator

    counters = training_counters()  # every kernel wrapper of the port
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    n_fft_vr = FOURBAND_V2_PARAM["bins"] * 2
    paths = {"VR": os.path.join(tmp, "HP2-4BAND-3090_4band_v2.pth"),
             "MDX": os.path.join(tmp, "UVR-MDX-NET-Inst_full.onnx")}
    write_vr_pth(paths["VR"], n_fft_vr, seed=22)
    write_mdx_onnx(paths["MDX"], ConvTDFNetTrim(), seed=23)
    song = song_stereo(SEP_SECONDS)
    flops = {"VR": network_flops(lambda: CascadedASPPNet(n_fft_vr), (1, 2, 673, 512)),
             "MDX": network_flops(ConvTDFNetTrim, (1, 4, 256, 3072))}
    say(f"[22/29] separation at full width: VR CascadedASPPNet({n_fft_vr}) from a .pth "
        f"(4band_v2, {FOURBAND_V2_PARAM['bins'] + 1} bins, window 512, offset 128, agg 10, mirroring), "
        f"{flops['VR'] / 1e9:.1f} GFLOP a window; MDX ConvTDFNetTrim(11 blocks, l 3, g 32, "
        f"bn 8, dim_f 3072, GroupNorm2) from an anonymous .onnx (dim_t 256, n_fft 6144, hop "
        f"1024, 15 s chunks, 1 s margin), {flops['MDX'] / 1e9:.1f} GFLOP a window; "
        f"{SEP_SECONDS:.0f} s of stereo 44.1 kHz; files written in "
        f"{time.perf_counter() - t0:.1f} s")
    hop = {"VR": 480, "MDX": 0}
    kept = {}
    t1 = time.perf_counter()
    seps = {kind: load_separator(route_separator(path), path, 10.0)  # the card
            for kind, path in paths.items()}
    say(f"  both separators loaded from their files in {time.perf_counter() - t1:.1f} s")
    for label, kind, opt in (("VR", "VR", None), ("VR tta", "VR", "tta"),
                             ("MDX", "MDX", None), ("MDX denoise", "MDX", "denoise")):
        sep = seps[kind]
        if opt:
            setattr(sep, opt, True)
        t1 = time.perf_counter()
        out = sep.run_inference(song, 44100)  # first call: set-up
        first = time.perf_counter() - t1
        check_stems(out, song.shape[1], hop[kind], label)
        if not opt:
            kept[kind] = {"out": out, "flops": flops[kind], "path": paths[kind]}
        net = sep.model if kind == "VR" else sep.net
        windows = [0]
        hook = net.register_forward_pre_hook(
            lambda m, a: windows.__setitem__(0, windows[0] + a[0].shape[0]))
        torch.cuda.reset_peak_memory_stats()
        walls, stages = [], {}
        for _ in range(1 if opt else 3):  # tta and denoise: one timed run
            events = []
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            again = sep.run_inference(song, 44100, events=events)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            stages = stage_ms(events)
            stages["host and gaps"] = walls[-1] * 1e3 - events[0][1].elapsed_time(events[-1][1])
        hook.remove()
        rerun = stem_lsb(out, again)
        if max(rerun.values()) > SEP_TOL:
            fail(f"{label}: two runs on the card differ by {rerun} LSB")
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the profiler on the plain runs only (tta and denoise repeat them)
        busy, wall, top = (0.0, 1.0, []) if opt else busy_share(
            lambda: sep.run_inference(song, 44100))
        n_win = windows[0] // len(walls)  # network forwards of one window a run (twice with denoise)
        nets = n_win * flops[kind]
        say(f"  {label}: RTF best {SEP_SECONDS / min(walls):.2f}x, median "
            f"{SEP_SECONDS / float(np.median(walls)):.2f}x (walls ms "
            f"{[round(w * 1e3, 2) for w in walls]}; first call {first * 1e3:.1f}); stages ms "
            f"(CUDA events, last run): "
            + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
            + f"; network {n_win} window forwards, {nets / 1e12:.3f} TFLOP, "
            f"{nets / stages['network'] / 1e9:.1f} TFLOP/s; peak {peak:.2f} GiB; device busy "
            + (f"{busy / wall:.1%} ({busy:.2f} of {wall:.2f} ms under the profiler)" if busy > 0
               else "not measured" + (" (the plain run's is above)" if opt else
                                      " (the profiler saw no device time)"))
            + f"; the set-up call against the last, max |diff| {rerun} LSB; {card}")
        if top:
            say("    top kernels (ms, calls): "
                + "; ".join(f"{ms:.2f} x{n} {k}" for ms, n, k in top))
        if not opt:
            kept[kind].update(rtf=SEP_SECONDS / min(walls), network_ms=stages["network"])
        if opt:
            setattr(sep, opt, False)
        torch.cuda.empty_cache()

    # card against CPU on one window a route, on the song itself (VR 2.5 s:
    # 230 frames, 3 s would be two 256-frame windows; MDX 3 s of its 5.78 s
    # window)
    cpus = {kind: load_separator(route_separator(path), path, 10.0, device="cpu")
            for kind, path in paths.items()}
    for kind, seconds in (("VR", 2.5), ("MDX", 3.0)):
        clip = song[:, : int(seconds * 44100)]
        t1 = time.perf_counter()
        got, ref = (sep.run_inference(clip, 44100) for sep in (seps[kind], cpus[kind]))
        lsb = stem_lsb(got, ref)
        say(f"  {kind} {seconds} s on the card vs the CPU: max |diff| {lsb} LSB (tolerance "
            f"{SEP_TOL} LSB, phase 5's: the same float32 math summed in another order); "
            f"{time.perf_counter() - t1:.1f} s")
        if max(lsb.values()) > SEP_TOL:
            fail(f"{kind}: the card's stems disagree with the CPU's")
    del cpus

    # the command line, on the song's file: its downmix, as the JAX CLI's
    wav = os.path.join(tmp, "song.wav")
    write_song_wav(wav, song)
    for kind in ("VR", "MDX"):
        check_cli_separate(tmp, wav, paths[kind], seps[kind], kind, channels=1)

    launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    say(f"  kernel launches in phase 22: {launched}")
    if any(launched.values()):
        fail("separation launched a kernel of the conversion or training path")
    return kept


# ---- phase 23: separation with Demucs (HTDemucs, HDemucs, Conv-TasNet, a bag) ----

DEMUCS_SOURCES = ["drums", "bass", "other", "vocals"]


def write_demucs_th(path: str, klass: str, kwargs: dict, state: dict, half: bool = True) -> None:
    """A demucs v3/v4 package as ``demucs.states.serialize_model`` saves
    one: {klass, args, kwargs, state (float16 with ``half``),
    training_args}, the class pickled by reference to a stub of the name
    ``klass`` gives (e.g. "demucs.htdemucs.HTDemucs"). Modules that are not
    registered yet are registered only while saving, so the loader's own
    unpickling path finds none of them."""
    import torch

    module, name = klass.rsplit(".", 1)
    parts = module.split(".")
    added = []
    try:
        for i in range(len(parts)):
            m = ".".join(parts[: i + 1])
            if m not in sys.modules:
                sys.modules[m] = types.ModuleType(m)
                added.append(m)
        mod = sys.modules[module]
        cls = getattr(mod, name, None)
        if cls is None:
            cls = type(name, (), {"__module__": module, "__qualname__": name})
            setattr(mod, name, cls)
        dt = torch.float16 if half else torch.float32
        torch.save({"klass": cls, "args": [], "kwargs": dict(kwargs),
                    "state": {k: torch.from_numpy(np.asarray(v)).to(dt) for k, v in state.items()},
                    "training_args": {}}, path)
    finally:
        for m in reversed(added):
            del sys.modules[m]


def write_demucs_model(path: str, klass: str, kwargs: dict, seed: int) -> dict:
    """A seeded ``HTDemucs``/``HDemucs`` (``klass``'s last name) written by
    ``write_demucs_th`` in float16, ``lively_state`` weights. Returns the
    state as the file holds it, in float32."""
    from rvc_tpu_torch.compat.torch_import import htdemucs_kwargs_from_meta
    from rvc_tpu_torch.models import htdemucs

    name = klass.rsplit(".", 1)[1]
    net = getattr(htdemucs, name)(**htdemucs_kwargs_from_meta({"klass": name,
                                                                "kwargs": kwargs}))
    state = {k: v.astype(np.float16).astype(np.float32)
             for k, v in lively_state(net, seed).items()}
    write_demucs_th(path, klass, kwargs, state)
    return state


def write_tasnet_th(path: str, cfg: dict, seed: int) -> dict:
    """A seeded Conv-TasNet ``.th`` as demucs v2 released them: the bare
    state_dict, ``lively_state`` weights (``cfg``: the ConvTasNet keywords)."""
    import torch

    from rvc_tpu_torch.models.tasnet import ConvTasNet

    state = lively_state(ConvTasNet(**cfg), seed)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path)
    return state


def write_demucs_bag(folder: str, name: str, kwargs: dict, seed: int, weights: list) -> str:
    """A bag of ``len(weights)`` seeded HTDemucs: ``<name>.yaml`` in demucs's
    form (``models`` a flow list of signatures, ``weights`` a flow list of
    rows over several lines with trailing commas, as demucs's
    ``htdemucs_ft.yaml``) beside ``<signature>-<hash>.th`` members."""
    sigs = [f"{0xf7e0c4bc + seed + i:08x}" for i in range(len(weights))]
    for i, sig in enumerate(sigs):
        write_demucs_model(os.path.join(folder, f"{sig}-{i:08x}.th"), "demucs.htdemucs.HTDemucs",
                           kwargs, seed + i)
    rows = "".join(f"    [{', '.join(f'{w:.1f}'[:-1] if w == int(w) else str(w) for w in row)}],\n"
                   for row in weights)
    path = os.path.join(folder, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(f"models: [{', '.join(repr(s) for s in sigs)}]\nweights: [\n{rows}]\n")
    return path


# the released htdemucs packages' kwargs where they differ from HTDemucs's
# defaults, and options the loader must drop or refuse (all off)
HTDEMUCS_KW = dict(sources=DEMUCS_SOURCES, audio_channels=2, samplerate=44100,
                   segment=Fraction(39, 5), use_train_segment=True, t_sparse_self_attn=False,
                   t_sparse_cross_attn=False, t_cape_augment=[0.0, 500.0], rescale=0.1)
HDEMUCS_KW = dict(sources=DEMUCS_SOURCES, audio_channels=2, samplerate=44100, segment=10)
FT_WEIGHTS = [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0],
              [0.0, 0.0, 0.0, 1.0]]  # htdemucs_ft.yaml's rows
WIENER_TOL = 1e-4  # of the largest magnitude, card vs CPU: complex64 EM at full size


def check_demucs_stems(out: dict, n_in: int, label: str, sources=DEMUCS_SOURCES) -> None:
    """Every source and the instrumentals: stereo int16 of the input's
    length at 44.1 kHz, not silent; vocals and instrumentals differ."""
    stems = [k for k in out if k not in ("sr", "input_audio")]
    if stems != list(sources) + ["instrumentals"] or out["sr"] != 44100:
        fail(f"{label}: stems {stems} at {out['sr']} Hz")
    for k in stems:
        a = out[k][0]
        if a.dtype != np.int16 or a.shape != (2, n_in) or np.abs(a).max() == 0:
            fail(f"{label}: {k} is {a.dtype} {a.shape}, peak {np.abs(a).max()}")
    if np.array_equal(out["vocals"][0], out["instrumentals"][0]):
        fail(f"{label}: vocals equal instrumentals")


def demucs_models(sep) -> list:
    return [s.model for s in sep.sub] if sep.sub else [sep.model]


def run_demucs(tmp: str, card: str) -> dict:
    """Phase 23: Demucs separation at full width through load_separator and
    the CLI: an HTDemucs and an HDemucs package, a Conv-TasNet and a bag of
    four HTDemucs; RTF, stages, peak memory, busy share and TFLOP/s; card vs
    CPU on one segment a model (HTDemucs also with 2 shifts); the Wiener
    filter and Conv-TasNet's two depthwise forms on the card; kernels 1-8
    launched no time. Returns, by model but the bag, the set-up call's stems
    of the 30 s song, the FLOPs a chunk and the file (for phase 26)."""
    import torch

    from rvc_tpu_torch.models.tasnet import depthwise, depthwise_conv1d
    from rvc_tpu_torch.ops.wiener import wiener
    from rvc_tpu_torch.pipelines.separate import DemucsSeparator, load_separator, route_separator

    counters = training_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    paths = {"HTDemucs": os.path.join(tmp, "htdemucs.th"),
             "HDemucs": os.path.join(tmp, "hdemucs_mmi.th"),
             "Conv-TasNet": os.path.join(tmp, "tasnet.th")}
    write_demucs_model(paths["HTDemucs"], "demucs.htdemucs.HTDemucs", HTDEMUCS_KW, seed=31)
    write_demucs_model(paths["HDemucs"], "demucs.hdemucs.HDemucs", HDEMUCS_KW, seed=32)
    write_tasnet_th(paths["Conv-TasNet"], {}, seed=33)
    paths["bag"] = write_demucs_bag(tmp, "htdemucs_ft", HTDEMUCS_KW, 34, FT_WEIGHTS)
    song = song_stereo(SEP_SECONDS)
    written = time.perf_counter() - t0
    t1 = time.perf_counter()
    seps = {label: load_separator(route_separator(path), path)  # the card
            for label, path in paths.items()}
    say(f"[23/29] Demucs at full width: HTDemucs (channels 48, depth 4, nfft 4096, 5 "
        f"transformer layers of 384 x 8 heads, segment {float(HTDEMUCS_KW['segment'])} s with "
        f"use_train_segment), HDemucs (depth 6, BLSTM and LocalState from layer 4, 10 s "
        f"segments), Conv-TasNet (N 256, L 20, B 256, H 512, P 3, X 10, R 4, gLN, 8 s), a bag of "
        f"4 HTDemucs (htdemucs_ft's one-hot weights); files written in {written:.1f} s, loaded "
        f"in {time.perf_counter() - t1:.1f} s")
    kept = {}
    for label, sep in seps.items():
        sec = 10.0 if label == "bag" else SEP_SECONDS
        clip = song[:, : int(sec * 44100)]
        models = demucs_models(sep)
        flops = network_flops(lambda: models[0], (1, 2, sep.segment_samples), device="cuda")
        t1 = time.perf_counter()
        out = sep.run_inference(clip, 44100)  # first call: set-up
        first = time.perf_counter() - t1
        check_demucs_stems(out, clip.shape[1], label)
        if label != "bag":
            kept[label] = {"out": out, "flops": flops, "path": paths[label]}
        chunks = [0]
        hooks = [m.register_forward_pre_hook(
            lambda m, a: chunks.__setitem__(0, chunks[0] + a[0].shape[0])) for m in models]
        torch.cuda.reset_peak_memory_stats()
        walls, stages = [], {}
        for _ in range(3):
            events = []
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            again = sep.run_inference(clip, 44100, events=events)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            stages = stage_ms(events)
            stages["host and gaps"] = walls[-1] * 1e3 - events[0][1].elapsed_time(events[-1][1])
        for h in hooks:
            h.remove()
        rerun = stem_lsb(out, again)
        if max(rerun.values()) > SEP_TOL:
            fail(f"{label}: two runs on the card differ by {rerun} LSB")
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy, wall, top = busy_share(lambda: sep.run_inference(clip, 44100))
        n_chunks = chunks[0] // 3
        nets = n_chunks * flops
        say(f"  {label} on {sec:.0f} s: RTF best {sec / min(walls):.2f}x, median "
            f"{sec / float(np.median(walls)):.2f}x (walls ms {[round(w * 1e3, 2) for w in walls]}; "
            f"first call {first * 1e3:.1f}); stages ms (CUDA events, last run): "
            + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
            + f"; network {n_chunks} chunks of {sep.segment_samples} samples, "
            f"{flops / 1e9:.1f} GFLOP a chunk, {nets / 1e12:.3f} TFLOP, "
            f"{nets / stages['network'] / 1e9:.1f} TFLOP/s; peak {peak:.2f} GiB; device busy "
            + (f"{busy / wall:.1%} ({busy:.2f} of {wall:.2f} ms under the profiler)" if busy > 0
               else "not measured (the profiler saw no device time)")
            + f"; the set-up call against the last, max |diff| {max(rerun.values())} LSB; {card}")
        if top:
            say("    top kernels (ms, calls): " + "; ".join(f"{ms:.2f} x{n} {k}" for ms, n, k in top))
        if label in kept:
            kept[label].update(rtf=sec / min(walls), network_ms=stages["network"])
        torch.cuda.empty_cache()

    # card against CPU on one segment a model: the clip and the 0.5 s shift
    # pad make one chunk (the bag: one a member); HTDemucs also with 2 shifts
    for label, shifts in (("HTDemucs", 1), ("HTDemucs", 2), ("HDemucs", 1), ("Conv-TasNet", 1),
                          ("bag", 1)):
        path = paths[label]
        got, ref = (DemucsSeparator(path, shifts=shifts, device=dev) for dev in ("cuda", "cpu"))
        clip = song[:, 44100: 44100 + got.segment_samples - 22050]
        t1 = time.perf_counter()
        lsb = stem_lsb(got.run_inference(clip, 44100), ref.run_inference(clip, 44100))
        say(f"  {label}{' shifts 2' if shifts > 1 else ''} on {clip.shape[1] / 44100:.2f} s, "
            f"card vs CPU: max |diff| {lsb} LSB (tolerance {SEP_TOL}); "
            f"{time.perf_counter() - t1:.1f} s")
        if max(lsb.values()) > SEP_TOL:
            fail(f"{label}: the card's stems disagree with the CPU's")
        del got, ref

    # the Wiener EM at HDemucs's spectrogram (a 10 s chunk: 431 frames, 2048
    # bins, stereo, 4 sources), as a cac=False model with wiener_iters 1 runs it
    gen = np.random.default_rng(23)
    mix = ((gen.standard_normal((1, 431, 2048, 2)) + 1j * gen.standard_normal((1, 431, 2048, 2)))
           * 10).astype(np.complex64)
    mag = np.abs(gen.standard_normal((1, 431, 2048, 2, 4)) * 5).astype(np.float32)
    mix_c, mag_c = torch.from_numpy(mix).cuda(), torch.from_numpy(mag).cuda()
    got = torch.view_as_real(wiener(mag_c, mix_c, 1)).cpu()
    ref = torch.view_as_real(wiener(torch.from_numpy(mag), torch.from_numpy(mix), 1))
    err = float((got - ref).abs().max() / ref.abs().max())
    ms = timed(lambda: wiener(mag_c, mix_c, 1), reps=5, warmup=1)
    say(f"  wiener (1 EM iteration, 431 x 2048 x 2 x 4) card vs CPU: max |diff| {err:.3g} of the "
        f"largest (tolerance {WIENER_TOL:g}); {ms:.2f} ms on the card")
    if not err <= WIENER_TOL:
        fail("the card's Wiener filter disagrees with the CPU's")
    del mix_c, mag_c

    # Conv-TasNet's depthwise dilated conv at the 30 s run's shape: cuDNN's
    # grouped conv it runs against the JAX package's shifted multiply-adds,
    # summed over X
    y = torch.randn(5, 512, 35279, device="cuda")
    w = torch.randn(512, 1, 3, device="cuda") / 3 ** 0.5
    forms = {name: sum(timed(lambda: f(y, w, 2 ** x), reps=5, warmup=1) for x in range(10))
             for name, f in (("shifted", depthwise), ("grouped conv1d", depthwise_conv1d))}
    say("  Conv-TasNet depthwise convs of one repeat (X = 10, dilations 1-512, (5, 512, 35279)), "
        "ms: " + ", ".join(f"{k} {v:.3f}" for k, v in forms.items())
        + " (the port runs the grouped conv1d)")
    del y

    # the command line on the song's file: its downmix, as the JAX CLI's
    wav = os.path.join(tmp, "song.wav")
    write_song_wav(wav, song)
    check_cli_separate(tmp, wav, paths["HTDemucs"], seps["HTDemucs"], "HTDemucs", channels=2)

    launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    say(f"  kernel launches in phase 23: {launched}")
    if any(launched.values()):
        fail("Demucs separation launched a kernel of the conversion or training path")
    return kept


# ---- phase 24: BS-RoFormer and Mel-Band RoFormer, the Karafan recipe, pitch_shift ----

def roformer_weights(model, seed: int) -> dict:
    """{name: array} for every entry of a RoFormer's state_dict at the JAX
    initializer's scale: each Linear's weight and bias uniform in
    +-1/sqrt(fan_in), every RMSNorm gamma ones; drawn in state_dict order
    from ``seed``. ``model`` may live on the meta device."""
    from torch import nn

    rng = np.random.default_rng(seed)
    fan_in = {name: m.in_features for name, m in model.named_modules()
              if isinstance(m, nn.Linear)}
    out = {}
    for key, t in model.state_dict().items():
        owner, leaf = key.rsplit(".", 1)
        if leaf == "gamma":
            out[key] = np.ones(tuple(t.shape), np.float32)
        else:
            bound = np.float32(1.0 / math.sqrt(fan_in[owner]))
            u = rng.random(tuple(t.shape), dtype=np.float32)
            out[key] = (2 * bound) * u - bound
    return out


def write_roformer_ckpt(path: str, state: dict, cfg, lightning: bool,
                        freq_indices: bool = False) -> None:
    """A UVR/MSST ``.ckpt`` of a RoFormer's ``state`` ({lucidrains name:
    array}) with the buffers a released file carries beside the weights
    (each attention's ``rotary_embed.freqs``; with ``freq_indices``, a Mel
    model's band layout): as Lightning saves it, {"state_dict": {"model." +
    name: tensor}, ...}, or the bare state dict."""
    import torch

    sd = {k: torch.from_numpy(v) for k, v in state.items()}
    rot = 1.0 / 10000 ** (torch.arange(0, cfg.dim_head, 2).float() / cfg.dim_head)
    for k in [k for k in state if k.endswith(".to_qkv.weight")]:
        sd[k.replace("to_qkv.weight", "rotary_embed.freqs")] = rot
    if freq_indices:
        sd["freq_indices"] = torch.tensor(cfg.freq_indices, dtype=torch.long)
    if lightning:
        sd = {"epoch": 317, "global_step": 0, "pytorch-lightning_version": "2.1.0",
              "state_dict": {"model." + k: v for k, v in sd.items()}}
    torch.save(sd, path)


ROFORMER_FLOOR_DB = -60.0  # a seeded noise floor under the card-vs-CPU window
ROFORMER_CPU_DEPTH = 2  # layers of the card-vs-CPU windows (phases 24 and 26): the CPU's
# time grows with the depth, and the first layers meet every kind of module
KARAFAN_SECONDS = 10.0
STRETCH_TOL = 2e-3  # relative L2, card vs CPU: the CPU tests' bar against JAX
# (a seeded floor under the card-vs-CPU window and pitch_shift's song; see run_roformer)


def roformer_config_line(cfg) -> str:
    """A RoFormer config's fields, the Mel layout's tuples summarized."""
    import dataclasses

    out = []
    for k, v in dataclasses.asdict(cfg).items():
        if k in ("freq_indices", "band_widths"):
            v = f"{len(v)} entries" if k == "freq_indices" else f"{len(v)} bands, {sum(v)} entries"
        elif k == "freqs_per_bands":
            v = f"{len(v)} bands over {sum(v)} bins"
        out.append(f"{k} {v}")
    return ", ".join(out)


def rounding_response(sep, window: np.ndarray) -> int:
    """max |diff| in LSB between the stems of ``window`` (one segment) through
    ``sep``'s network and those of its spectrogram plus seeded noise of 1e-7
    of its largest value, each stem scaled to int16 as ``run_inference``
    scales it."""
    import torch

    from rvc_tpu_torch.models.bs_roformer import pack_spec, unpack_spec
    from rvc_tpu_torch.pipelines.separate import stereo_int16

    x = torch.from_numpy(np.ascontiguousarray(window)).to(sep.device)[None]
    spec = pack_spec(x, sep.cfg)
    g = torch.Generator(device=sep.device).manual_seed(7)
    noise = torch.randn(spec.shape, generator=g, device=sep.device) * 1e-7 * spec.abs().amax()
    with torch.no_grad():
        a, b = (stereo_int16(unpack_spec(sep.model(s), sep.cfg, x.shape[-1])[:, 0])
                for s in (spec, spec + noise))
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def run_roformer(tmp: str, card: str) -> dict:
    """Phase 24: BS-RoFormer (the ep_317 layout) and Mel-Band RoFormer (the
    JAX defaults) written as .ckpt files with seeded weights at the JAX
    initializer's scale, separating phase 22's 30 s song through
    load_separator and the CLI: the loader's config, RTF, stages, TFLOP/s,
    busy share and peak memory; card vs CPU on one 8 s window; the Karafan
    recipe on 10 s (the Mel model for vocals, phase 22's MDX net for music);
    pitch_shift card vs CPU; kernels 1-8 launched no time. Returns, by
    model, the set-up call's stems, the FLOPs a window and the file (for
    phase 26)."""
    import torch

    from rvc_tpu_torch.models.bs_roformer import BSRoformer, BSRoformerConfig
    from rvc_tpu_torch.models.mdx_net import ConvTDFNetTrim
    from rvc_tpu_torch.models.mel_roformer import MelBandRoformer, MelRoformerConfig
    from rvc_tpu_torch.ops.stretch import pitch_shift
    from rvc_tpu_torch.pipelines import karafan
    from rvc_tpu_torch.pipelines.separate import load_separator, route_separator

    counters = training_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    models = {"BS-RoFormer": (BSRoformer, BSRoformerConfig(), "model_bs_roformer_ep_317_sdr_12.9755.ckpt",
                              True, 41),
              "Mel-RoFormer": (MelBandRoformer, MelRoformerConfig(), "MelBandRoformer.ckpt",
                               False, 42)}
    paths, states, flops = {}, {}, {}
    for label, (cls, cfg, name, lightning, seed) in models.items():
        with torch.device("meta"):
            states[label] = roformer_weights(cls(cfg), seed)
        paths[label] = os.path.join(tmp, name)
        write_roformer_ckpt(paths[label], states[label], cfg, lightning=lightning)
        flops[label] = network_flops(lambda: cls(cfg), (1, 801, 2050, 2))
    song = song_stereo(SEP_SECONDS)
    written = time.perf_counter() - t0
    t1 = time.perf_counter()
    seps = {label: load_separator(route_separator(path), path) for label, path in paths.items()}
    say(f"[24/29] RoFormers at full width: a BS-RoFormer as a Lightning .ckpt and a Mel-Band "
        f"RoFormer as a bare state dict without freq_indices, seeded weights at the JAX "
        f"initializer's scale (uniform +-1/sqrt(fan_in), gamma 1); written in {written:.1f} s, "
        f"loaded in {time.perf_counter() - t1:.1f} s; {SEP_SECONDS:.0f} s of stereo 44.1 kHz "
        f"(phase 22's song)")
    for label, sep in seps.items():
        if sep.cfg != models[label][1]:
            fail(f"{label}: the loader read {sep.cfg}, the file holds {models[label][1]}")
        n_params = sum(p.numel() for p in sep.model.parameters())
        say(f"  {label} ({type(sep).__name__}, {n_params / 1e6:.1f} M parameters): the "
            f"loader's config: {roformer_config_line(sep.cfg)}; {flops[label] / 1e12:.3f} TFLOP "
            f"a {sep.segment}-sample window (801 frames)")

    kept = {}
    for label, sep in seps.items():
        t1 = time.perf_counter()
        out = sep.run_inference(song, 44100)  # first call: set-up
        first = time.perf_counter() - t1
        check_demucs_stems(out, song.shape[1], label, sources=["vocals"])
        kept[label] = {"out": out, "flops": flops[label], "path": paths[label]}
        windows = [0]
        hook = sep.model.register_forward_pre_hook(
            lambda m, a: windows.__setitem__(0, windows[0] + a[0].shape[0]))
        torch.cuda.reset_peak_memory_stats()
        walls, stages = [], {}
        for _ in range(3):
            events = []
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            again = sep.run_inference(song, 44100, events=events)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            stages = stage_ms(events)
            stages["host and gaps"] = walls[-1] * 1e3 - events[0][1].elapsed_time(events[-1][1])
        hook.remove()
        rerun = stem_lsb(out, again)
        if max(rerun.values()) > SEP_TOL:
            fail(f"{label}: two runs on the card differ by {rerun} LSB")
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy, wall, top = busy_share(lambda: sep.run_inference(song, 44100))
        n_win = windows[0] // 3
        nets = n_win * flops[label]
        say(f"  {label} on {SEP_SECONDS:.0f} s: RTF best {SEP_SECONDS / min(walls):.2f}x, median "
            f"{SEP_SECONDS / float(np.median(walls)):.2f}x (walls ms "
            f"{[round(w * 1e3, 2) for w in walls]}; first call {first * 1e3:.1f}); stages ms "
            f"(CUDA events, last run): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
            + f"; network {n_win} windows, {nets / 1e12:.3f} TFLOP, "
            f"{nets / stages['network'] / 1e9:.1f} TFLOP/s; peak {peak:.2f} GiB; device busy "
            + (f"{busy / wall:.1%} ({busy:.2f} of {wall:.2f} ms under the profiler)" if busy > 0
               else "not measured (the profiler saw no device time)")
            + f"; the set-up call against the last, max |diff| {max(rerun.values())} LSB; {card}")
        if top:
            say("    top kernels (ms, calls): " + "; ".join(f"{ms:.2f} x{n} {k}" for ms, n, k in top))
        kept[label].update(rtf=SEP_SECONDS / min(walls), network_ms=stages["network"])
        torch.cuda.empty_cache()

    # card against CPU on one 8 s window, the same weights. The song is band-
    # limited at 8 kHz (the speech fixture is 16 kHz): its empty bands hold the
    # STFT's rounding, which each band's RMSNorm scales to unit norm, so the
    # stems follow cuFFT's or pocketfft's roundings there (shown below); with
    # a seeded floor at ROFORMER_FLOOR_DB every band holds signal
    window = song[:, 44100: 44100 + seps["BS-RoFormer"].segment]
    floor = 10 ** (ROFORMER_FLOOR_DB / 20) * np.random.default_rng(24).standard_normal(window.shape)
    clip = (window + floor).astype(np.float32)
    for label, sep in seps.items():
        say(f"  {label}: the stems of the song's window as it is moved by "
            f"{rounding_response(sep, window)} LSB by a perturbation of 1e-7 of the "
            f"spectrogram's largest value (the STFT's rounding), on the card")
    for label, sep in seps.items():
        cut = dataclasses.replace(sep.cfg, depth=ROFORMER_CPU_DEPTH)
        state = {k: v for k, v in states[label].items()
                 if not (k.startswith("layers.") and int(k.split(".")[1]) >= cut.depth)}
        card_sep = type(sep)(state, cut)
        cpu_sep = type(sep)(state, cut, device="cpu")
        got = card_sep.run_inference(clip, 44100)
        t1 = time.perf_counter()
        ref = cpu_sep.run_inference(clip, 44100)
        lsb = stem_lsb(got, ref)
        say(f"  {label} on one {clip.shape[1] / 44100:.0f} s window with the floor, card vs CPU "
            f"(the first {cut.depth} of its {sep.cfg.depth} layers): max |diff| {lsb} LSB "
            f"(tolerance {SEP_TOL}); CPU {time.perf_counter() - t1:.1f} s")
        if max(lsb.values()) > SEP_TOL:
            fail(f"{label}: the card's stems disagree with the CPU's")
        del card_sep, cpu_sep

    # the command line on the song's file: its downmix doubled to stereo
    wav = os.path.join(tmp, "song.wav")
    write_song_wav(wav, song)
    for label, path in paths.items():
        check_cli_separate(tmp, wav, path, seps[label], label, channels=2)
    del states

    # the Karafan recipe: the Mel model's vocals (band-limited at 16 kHz, so
    # both SRS passes run, each as two denoise passes) and phase 22's MDX net
    mdx_path = os.path.join(tmp, "UVR-MDX-NET-Inst_full.onnx")
    write_mdx_onnx(mdx_path, ConvTDFNetTrim(), seed=23)
    mdx = load_separator(route_separator(mdx_path), mdx_path)
    spent, calls = [0.0], [0]

    def extractor(fn):
        def run(mix):
            t1 = time.perf_counter()
            out = fn(torch.from_numpy(np.ascontiguousarray(mix, np.float32)).cuda()).cpu().numpy()
            spent[0] += time.perf_counter() - t1
            calls[0] += 1
            return out
        return run

    mel = seps["Mel-RoFormer"]
    pipe = karafan.KarafanPipeline(
        vocal=[karafan.KarafanModel(extractor(lambda x: mel.demix(x)[0]), name="mel_roformer",
                                    cut_off=16000)],
        music=[karafan.KarafanModel(extractor(mdx.demix), name="mdx_inst")],
        config=karafan.speed_preset("Fast"))
    clip = song[:, : int(KARAFAN_SECONDS * 44100)]
    stages = {}
    pipe.separate(clip, 44100)  # set-up
    spent[0], calls[0] = 0.0, 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = pipe.separate(clip, 44100, stages=stages)
    wall = time.perf_counter() - t1
    peaks = {k: int(np.abs(out[k][0].astype(np.int32)).max()) for k in ("vocals", "instrumentals")}
    say(f"  Karafan (speed_preset Fast: vocal bigshifts 1 and SRS 1, music 1) on "
        f"{KARAFAN_SECONDS:.0f} s, Mel-RoFormer vocals (cut_off 16000) and the MDX net's music: "
        f"wall {wall:.2f} s, {calls[0]} extractor calls {spent[0]:.2f} s "
        f"({spent[0] / wall:.1%} of the wall; the rest the host's filters, resampling and "
        f"ensembles), stems' peaks {peaks} (int16, mono), stages "
        + ", ".join(f"{k} {np.shape(v)}" for k, v in stages.items() if v is not None))
    if any(v == 0 for v in peaks.values()) or len(out["vocals"][0]) != clip.shape[1]:
        fail("Karafan: a silent stem or another length")
    del mdx, pipe

    # pitch_shift on 30 s of stereo, card vs CPU. The speech fixture holds
    # digital silence (bins fall to 1e-8): a silent frame's atan2 phase is
    # the rounding's, and the phase vocoder carries it into every later frame
    # of the bin, so the song as it is is only reported; with the floor every
    # frame holds signal
    floored = song + 10 ** (ROFORMER_FLOOR_DB / 20) * np.random.default_rng(25).standard_normal(
        song.shape)
    for n_steps in (12.0, -5.0):
        errs = []
        for y in (torch.from_numpy(song), torch.from_numpy(floored.astype(np.float32))):
            ref = pitch_shift(y, 44100, n_steps)
            yc = y.cuda()
            got = pitch_shift(yc, 44100, n_steps).cpu()
            if got.shape != y.shape:
                fail(f"pitch_shift {n_steps}: {tuple(got.shape)} from {tuple(y.shape)}")
            errs.append(float((got - ref).norm() / ref.norm()))
        ms = timed(lambda: pitch_shift(yc, 44100, n_steps), reps=3, warmup=1)
        say(f"  pitch_shift {n_steps:+g} semitones on {SEP_SECONDS:.0f} s of stereo: {ms:.2f} ms on "
            f"the card (CUDA events, 3 after a warm-up); card vs CPU relative L2 {errs[1]:.3g} "
            f"with the {ROFORMER_FLOOR_DB:g} dB floor (tolerance {STRETCH_TOL:g}, the CPU tests' "
            f"bar against JAX), {errs[0]:.3g} on the song as it is (not held: its silent frames' "
            f"phases are the roundings')")
        if not errs[1] <= STRETCH_TOL:
            fail(f"pitch_shift {n_steps}: the card disagrees with the CPU")

    launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    say(f"  kernel launches in phase 24: {launched}")
    if any(launched.values()):
        fail("RoFormer separation launched a kernel of the conversion or training path")
    return kept


# ---- phase 25: the node graph ----

NODE_SECONDS = 10.0  # the clip the trained model converts


def run_nodes(files: dict, work: str, card: str) -> dict:
    """Phase 25: the port's ComfyUI nodes chained as a user's graph on the
    card (``nodes.DEVICE`` None), on ``files`` the earlier phases wrote;
    outputs under ``work``. Fails unless Convert launches kernels 1-3 and
    equals the direct converter within the direct call's own spread over
    six calls, TrainModel launches kernels
    4-7, repeated Convert and UVR5 calls hit the cache, and every model the
    nodes cached sits on the card. Returns the launches of the first
    Convert and of TrainModel."""
    import torch

    from rvc_tpu_torch.compat import torch_import as ti
    from rvc_tpu_torch.graph import nodes
    from rvc_tpu_torch.io.audio import load_input_audio
    from rvc_tpu_torch.ops import retrieval
    from rvc_tpu_torch.pipelines.convert import ConvertSettings, VoiceConverter
    from rvc_tpu_torch.train import step as step_mod

    if nodes.DEVICE is not None:
        fail(f"the node layer's device is {nodes.DEVICE!r}, not the card")
    counters = {**training_counters(), "nearest_rows": (retrieval.nearest_rows, "launches")}

    def counted(fn):
        """fn() with every count set to 0 just before and read just after:
        (result, seconds synchronized, the counts that moved)."""
        for wrapper, attr in counters.values():
            setattr(wrapper, attr, 0)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, {k: getattr(w, a) for k, (w, a) in counters.items() if getattr(w, a)}

    def conversion_launches(synth) -> dict:
        return {"fused_resblock_group": sum(len(rb.convs1) for rb in synth.dec.resblocks),
                "banded_rel_attention": len(synth.enc_p.encoder.attn_layers),
                "nearest_rows": 1}

    def cache_hit(label: str, fn) -> None:
        """A repeated node call: no counted launch and no kernel on the card."""
        (_, wall, moved) = counted(fn)
        seen = kernel_launches(fn)
        say(f"  {label} again: {wall * 1e3:.2f} ms, counted launches {moved}, kernels the "
            f"profiler saw {seen or 0}")
        if moved or seen:
            fail(f"the repeated {label} was not a cache hit")

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    say(f"[25/29] the node graph on the card: phase 22's VR .pth and {SEP_SECONDS:.0f} s song, "
        f"phase 13's 48k_v2 .pth, HuBERT, rmvpe.pt and {BANK_ROWS}-row float32 bank, phase 17's "
        f"{TRAIN_SOURCE_SECONDS:g} s source clip")

    # LoadAudio -> UVR5
    (song,), t_load, _ = counted(lambda: nodes.LoadAudioNode().load(files["song"], 44100))
    song_s = song["waveform"].shape[-1] / 44100
    (vocals, inst), t_uvr, moved = counted(
        lambda: nodes.UVR5Node().split(song, files["vr"], 10.0))
    say(f"  LoadAudio {t_load:.2f} s ({song_s:.1f} s at 44.1 kHz, the downmix); UVR5 {t_uvr:.2f} s "
        f"(the .pth loaded, the first call's set-up, separating: RTF {song_s / t_uvr:.2f}x), "
        f"vocals peak {np.abs(vocals['waveform']).max():.3f}, counted launches {moved}")
    if moved or vocals["waveform"].shape != inst["waveform"].shape or not all(
            np.isfinite(x["waveform"]).all() and np.abs(x["waveform"]).max() > 0
            for x in (vocals, inst)):
        fail("UVR5 failed its checks")
    cache_hit("UVR5", lambda: nodes.UVR5Node().split(song, files["vr"], 10.0))

    # LoadRVCModel + LoadHubert + PitchParams -> Convert on the vocals
    (model,) = nodes.RVCModelLoaderNode().load(files["model"], files["bank"])
    (hubert,) = nodes.HubertLoaderNode().load(files["hubert"])
    settings = dict(f0_method="rmvpe", f0_autotune=False, merge_type="median", index_rate=0.75,
                    filter_radius=3, resample_sr=0, rms_mix_rate=0.25, protect=0.33,
                    crepe_hop_length=160)
    (pp,) = nodes.PitchExtractionParamsNode().load(**settings, rmvpe_path=files["rmvpe"])
    (converted,), t_first, moved = counted(
        lambda: nodes.RVCNode().convert(vocals, model, hubert, 0, pp))
    launched = dict(moved)
    expected = conversion_launches(model()["synth"])
    say(f"  Convert, first call {t_first:.2f} s (the files read, the converter built, set-up, "
        f"converting {song_s:.1f} s); launches {moved} (expected {expected})")
    if moved != expected:
        fail(f"Convert's kernel launches {moved}, expected {expected}")
    on_card = {type(m).__name__: next(m.parameters()).device.type for m in (
        model()["synth"], hubert()["encoders"]["v2"],
        *(v for v in nodes._CACHE.values() if isinstance(v, torch.nn.Module)))}
    vc_node = [v for v in nodes._CACHE.values() if isinstance(v, VoiceConverter)]
    seps = [v for v in nodes._CACHE.values() if hasattr(v, "run_inference")
            and not isinstance(v, VoiceConverter)]
    devices = {*on_card.values(), *(v.device.type for v in vc_node + seps)}
    say(f"  cached: {len(vc_node)} converter, {len(seps)} separator, modules {on_card}")
    if devices != {"cuda"} or len(vc_node) != 1 or len(seps) != 1:
        fail(f"the nodes' models are not all on the card: {devices}")
    cache_hit("Convert", lambda: nodes.RVCNode().convert(vocals, model, hubert, 0, pp))

    # the node against the direct call on the same arrays
    wav = vocals["waveform"][0, 0]
    state, meta = ti.load_rvc_checkpoint(files["model"])
    kw = ti.synthesizer_kwargs_from_config(meta["config"], meta["version"], meta["f0"])
    hub_state, hub_cfg = ti.load_hubert_safetensors(files["hubert"])
    direct = VoiceConverter.from_state_dicts(state, kw, hub_state, hub_cfg,
                                             ti.load_rmvpe(files["rmvpe"]),
                                             index_bank=np.load(files["bank"]), device="cuda")
    s = ConvertSettings(**settings)
    (want, want_sr), _, _ = counted(lambda: direct.convert(wav, 44100, s))  # set-up
    walls = {"node": [], "direct": []}
    repeats = [want]
    for key in (1, 2, 3):  # in turns; each node call a new key: it converts, built already
        (again, _), t_direct, _ = counted(lambda: direct.convert(wav, 44100, s))
        repeats.append(again)
        (shifted,), t_node, moved = counted(
            lambda: nodes.RVCNode().convert(vocals, model, hubert, key, pp))
        walls["direct"].append(t_direct)
        walls["node"].append(t_node)
        if moved != expected or not np.isfinite(shifted["waveform"]).all():
            fail(f"Convert with f0_up_key {key} failed its checks: launches {moved}")
    repeats += [direct.convert(wav, 44100, s)[0] for _ in range(2)]
    got = converted["waveform"][0, 0]
    # cuDNN may pick engines that sum with atomics (conversions leave it free;
    # scripts/bench_torch_cudnn_pin.py times the deterministic engines), so the
    # bar is the direct call's own run-to-run spread over its six calls
    spread = max(int(np.abs(a.astype(np.int32) - b).max())
                 for i, a in enumerate(repeats) for b in repeats[i + 1:])
    same = converted["sample_rate"] == want_sr and got.shape == want.shape
    node_lsb = (min(int(np.abs(np.rint(got * 32768.0).astype(np.int32) - r).max())
                    for r in repeats) if same else None)
    rtf = {k: song_s / float(np.median(v)) for k, v in walls.items()}
    say(f"  Convert against VoiceConverter.convert on the same arrays: {len(want)} samples at "
        f"{want_sr} Hz, the node's first call {node_lsb} LSB from the nearest of the direct "
        f"call's {len(repeats)} (tolerance: their own spread, {spread} LSB); RTF node "
        f"{rtf['node']:.2f}x (f0_up_key 1-3, the converter cached; walls ms "
        f"{[round(w * 1e3, 2) for w in walls['node']]}) against the direct call "
        f"{rtf['direct']:.2f}x ({[round(w * 1e3, 2) for w in walls['direct']]}), medians of 3 "
        f"in turns; {card}")
    if not same or node_lsb > spread:
        fail(f"the Convert node differs from VoiceConverter.convert: {node_lsb} LSB from the "
             f"direct call, whose own calls are {spread} LSB apart")
    del direct
    torch.cuda.empty_cache()

    # MergeAudio -> PreviewAudio
    t0 = time.perf_counter()
    (mixed,) = nodes.MergeAudioNode().merge(converted, inst, 44100)
    tempdir, tempfile.tempdir = tempfile.tempdir, work  # the preview copy: under work
    try:
        preview = nodes.PreviewAudioNode().save_audio(mixed, "node_graph", "wav",
                                                      output_dir=os.path.join(work, "output"))
    finally:
        tempfile.tempdir = tempdir
    out_path, out_audio = preview["result"]
    back, back_sr = load_input_audio(out_path)
    say(f"  MergeAudio + PreviewAudio {time.perf_counter() - t0:.2f} s: {out_path} "
        f"({back.shape[-1] / back_sr:.2f} s at {back_sr} Hz), preview {preview['ui']['preview']}")
    if back_sr != 44100 or not np.isfinite(back).all() or abs(
            back.shape[-1] / back_sr - out_audio["waveform"].shape[-1] / 44100) > 1e-3:
        fail("the previewed mix failed its checks")

    # ProcessDataset -> TrainModel -> TrainIndex -> Convert with the exported model
    exp = os.path.join(work, "exp")
    (dataset,), t_pre, moved_pre = counted(lambda: nodes.ProcessDatasetNode().process(
        files["src"], exp, "40k", hubert, "pm", "v2"))
    n_clips = len(os.listdir(os.path.join(exp, "0_gt_wavs")))
    trainers, original = [], step_mod.Trainer.step

    def recorded(self, *args, **kwargs):
        trainers.append(self)
        return original(self, *args, **kwargs)

    step_mod.Trainer.step = recorded
    try:
        (pth,), t_train, moved = counted(lambda: nodes.TrainModelNode().train(
            dataset, "node_voice", epochs=1, batch_size=TRAIN_BATCH, save_every_epoch=1))
    finally:
        step_mod.Trainer.step = original
    steps = len(trainers)
    want_train = {k: v for k, v in expected_training_launches(trainers[0], steps).items() if v}
    del trainers
    say(f"  ProcessDataset {t_pre:.2f} s ({n_clips} clips, HuBERT v2 and pm on the card, "
        f"launches {moved_pre}); TrainModel {t_train:.2f} s (40k_v2, 1 epoch of {steps} steps "
        f"at batch {TRAIN_BATCH}: building, steps, checkpoint, export), launches {moved} "
        f"(expected {want_train})")
    if moved != want_train or not steps or not os.path.isfile(pth):
        fail(f"TrainModel's kernel launches {moved}, expected {want_train}")
    launched.update(moved)
    (index,), t_index, _ = counted(lambda: nodes.TrainIndexNode().train_index(dataset))
    (trained,) = nodes.RVCModelLoaderNode().load(pth, index)
    clip = nodes.to_audio_dict(speech(NODE_SECONDS, 30.0), 16000)
    (out,), t_conv, moved = counted(lambda: nodes.RVCNode().convert(clip, trained, hubert, 0, pp))
    expected = conversion_launches(trained()["synth"])
    n_out = out["waveform"].shape[-1]
    say(f"  TrainIndex {t_index:.2f} s ({trained()['index_bank'].shape[0]} rows); Convert "
        f"{NODE_SECONDS:g} s with the exported .pth and its index {t_conv:.2f} s (loading, "
        f"building, set-up, converting): {n_out} samples at {out['sample_rate']} Hz, peak "
        f"{np.abs(out['waveform']).max():.3f}, launches {moved} (expected {expected})")
    if (moved != expected or out["sample_rate"] != 40000 or not np.isfinite(out["waveform"]).all()
            or abs(n_out / 40000 - NODE_SECONDS) > 0.05 or np.abs(out["waveform"]).max() <= 0):
        fail("the trained model's Convert failed its checks")
    say(f"  phase 25: {time.perf_counter() - t_phase:.1f} s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the nodes' cache holds every "
        f"model: {len(nodes._CACHE)} entries); {card}")
    nodes._CACHE.clear()
    torch.cuda.empty_cache()
    return launched


# ---- phase 26: separation in bfloat16 ----

SEP_BF16_L2 = 5e-2  # relative L2 of an int16 stem from the same call's float32 one:
# the bf16 conversion's bar (phase 12, PERF.md §2)


def lstm_forms(module, x) -> str:
    """The recurrent step of ``module`` (a bidirectional ``nn.LSTM``) on x
    (T, B, I) four ways, each timed on the card and held against the first
    by relative L2: cuDNN in float32, ``layers.lstm`` in bf16 (the bf16
    route's: JAX's roundings, replayed as a CUDA graph), its steps launched
    one by one (``lstm_steps``, which must give the graph's bits), and
    cuDNN's bf16 LSTM on a bf16 copy of the weights (as RMVPE's bf16 BiGRU
    runs on cast weights), which does not round h and c as JAX's scan
    does."""
    import copy

    import torch

    from rvc_tpu_torch.models.layers import lstm, lstm_steps

    bf = torch.bfloat16
    module16 = copy.deepcopy(module).to(bf)
    module16.flatten_parameters()
    forms = {"cuDNN float32": lambda: module(x.float())[0],
             "layers.lstm bf16 (CUDA graph)": lambda: lstm(module, x, bf),
             "lstm_steps bf16 (no graph)": lambda: lstm_steps(module, x, bf),
             "cuDNN bf16": lambda: module16(x.to(bf))[0]}
    with torch.no_grad():
        ref = forms["cuDNN float32"]().float()
        if not torch.equal(forms["layers.lstm bf16 (CUDA graph)"](),
                           forms["lstm_steps bf16 (no graph)"]()):
            fail("layers.lstm's CUDA graph gives other bits than its steps")
        out = []
        for name, fn in forms.items():
            err = float((fn().float() - ref).norm() / ref.norm())
            ms = timed(fn, reps=3, warmup=1)
            out.append(f"{name} {ms:.2f} ms (relative L2 from float32 {err:.3g})")
    return "; ".join(out) + "; the graph's output equal to the steps' bit for bit"


def stem_l2(a: dict, b: dict) -> dict:
    """Relative L2 of each int16 stem of ``a`` (a separator's output) from
    ``b``'s; fails on another shape."""
    out = {}
    for stem in (k for k in b if k not in ("sr", "input_audio")):
        x, y = (np.asarray(d[stem][0], np.float64) for d in (a, b))
        if x.shape != y.shape:
            fail(f"{stem}: {x.shape} against {y.shape}")
        out[stem] = float(np.linalg.norm(x - y) / np.linalg.norm(y))
    return out


def bf16_window(label: str, sep, song: np.ndarray) -> np.ndarray:
    """The clip of ``song`` that phases 22-24 hold card against CPU on, for
    route ``label``: one window or segment of it."""
    if label in ("VR", "MDX"):
        return song[:, : int((2.5 if label == "VR" else 3.0) * 44100)]
    if "RoFormer" not in label:
        return song[:, 44100: 44100 + sep.segment_samples - 22050]
    window = song[:, 44100: 44100 + sep.segment]
    floor = 10 ** (ROFORMER_FLOOR_DB / 20) * np.random.default_rng(24).standard_normal(window.shape)
    return (window + floor).astype(np.float32)


def run_separation_bf16(routes: dict, card: str) -> None:
    """Phase 26: every separation route through load_separator(...,
    dtype=bfloat16) at full width on phases 22-24's files and 30 s song:
    RTF (best and median of 3 after a set-up call), stages, the network's
    TFLOP/s beside the same call's float32 run, peak memory, busy share; the
    networks' outputs finite and each int16 stem within SEP_BF16_L2 relative
    L2 of phases 22-24's float32 stems (``routes``: by route, those stems,
    the network's FLOPs a window or chunk, the file, the float32 RTF and
    network ms); one window a route card vs CPU in bf16; the HDemucs BLSTM's
    four forms; kernels 1-8 launched no time."""
    import torch

    from rvc_tpu_torch.models import demucs as demucs_module
    from rvc_tpu_torch.pipelines.separate import load_separator, route_separator

    counters = training_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    song = song_stereo(SEP_SECONDS)
    say(f"[26/29] separation in bf16 at full width through load_separator(..., "
        f"dtype=torch.bfloat16): {', '.join(routes)} on phases 22-24's files and "
        f"{SEP_SECONDS:.0f} s song; each stem against the same call's float32 stems (phases "
        f"22-24) within {SEP_BF16_L2:g} relative L2")
    captured = []
    for label, f32 in routes.items():
        path = f32["path"]
        t1 = time.perf_counter()
        sep = load_separator(route_separator(path), path, 10.0, dtype=torch.bfloat16)
        loaded = time.perf_counter() - t1
        nets = ([sep.model] if label in ("VR", "BS-RoFormer", "Mel-RoFormer") else
                [sep.net] if label == "MDX" else demucs_models(sep))
        if any(getattr(m, "dtype", None) != torch.bfloat16 for net in nets for m in net.modules()):
            fail(f"{label}: a module of the network does not compute in bf16")
        finite = []
        hooks = [net.register_forward_hook(
            lambda m, a, y: finite.append(torch.isfinite(y).all())) for net in nets]
        record = demucs_module.lstm
        if label == "HDemucs":  # the first BLSTM's input, for lstm_forms below
            def capture(module, x, dtype):
                if not captured:
                    captured.append((module, x))
                return record(module, x, dtype)
            demucs_module.lstm = capture
        try:
            t1 = time.perf_counter()
            out = sep.run_inference(song, 44100)  # first call: set-up
            first = time.perf_counter() - t1
        finally:
            demucs_module.lstm = record
            for h in hooks:
                h.remove()
        if not finite or not all(bool(f) for f in finite):
            fail(f"{label}: the bf16 network gave a value that is not finite")
        if label in ("VR", "MDX"):
            check_stems(out, song.shape[1], 480 if label == "VR" else 0, label)
        else:
            check_demucs_stems(out, song.shape[1], label, sources=(
                ["vocals"] if "RoFormer" in label else DEMUCS_SOURCES))
        l2 = stem_l2(out, f32["out"])
        windows = [0]
        hooks = [net.register_forward_pre_hook(
            lambda m, a: windows.__setitem__(0, windows[0] + a[0].shape[0])) for net in nets]
        torch.cuda.reset_peak_memory_stats()
        walls, stages = [], {}
        for _ in range(3):
            events = []
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sep.run_inference(song, 44100, events=events)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            stages = stage_ms(events)
            stages["host and gaps"] = walls[-1] * 1e3 - events[0][1].elapsed_time(events[-1][1])
        for h in hooks:
            h.remove()
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy, wall, top = busy_share(lambda: sep.run_inference(song, 44100))
        n_win = windows[0] // 3
        flop = n_win * f32["flops"]
        say(f"  {label} bf16 on {SEP_SECONDS:.0f} s: RTF best {SEP_SECONDS / min(walls):.2f}x, "
            f"median {SEP_SECONDS / float(np.median(walls)):.2f}x (float32 best "
            f"{f32['rtf']:.2f}x, this run) (walls ms {[round(w * 1e3, 2) for w in walls]}; "
            f"loaded in {loaded:.1f} s, first call {first * 1e3:.1f}); stages ms (CUDA events, "
            f"last run): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
            + f"; network {n_win} window forwards, {flop / 1e12:.3f} TFLOP, "
            f"{flop / stages['network'] / 1e9:.1f} TFLOP/s (float32 {f32['network_ms']:.2f} ms, "
            f"{flop / f32['network_ms'] / 1e9:.1f} TFLOP/s); peak {peak:.2f} GiB; device busy "
            + (f"{busy / wall:.1%} ({busy:.2f} of {wall:.2f} ms under the profiler)" if busy > 0
               else "not measured (the profiler saw no device time)")
            + "; relative L2 from the float32 stems "
            + ", ".join(f"{k} {v:.4g}" for k, v in l2.items())
            + f" (tolerance {SEP_BF16_L2:g}); {card}")
        if top:
            say("    top kernels (ms, calls): " + "; ".join(f"{ms:.2f} x{n} {k}" for ms, n, k in top))
        if not max(l2.values()) <= SEP_BF16_L2:
            fail(f"{label}: the bf16 stems are {l2} from the float32 stems")
        # one window in bf16 on the card against the CPU, as phase 12 holds
        # the bf16 conversion
        clip = bf16_window(label, sep, song)
        cpu = load_separator(route_separator(path), path, 10.0, device="cpu",
                             dtype=torch.bfloat16)
        depth = ""
        if "RoFormer" in label:  # the first layers only, as phase 24's window
            depth = f" (the first {ROFORMER_CPU_DEPTH} of its {len(sep.model.layers)} layers)"
            for s_ in (sep, cpu):
                s_.model.layers = s_.model.layers[:ROFORMER_CPU_DEPTH]
        got = sep.run_inference(clip, 44100)
        t1 = time.perf_counter()
        cpu_l2 = stem_l2(got, cpu.run_inference(clip, 44100))
        say(f"  {label} bf16 on {clip.shape[1] / 44100:.2f} s{depth}, card vs CPU: relative L2 "
            + ", ".join(f"{k} {v:.4g}" for k, v in cpu_l2.items())
            + f" (tolerance {SEP_BF16_L2:g}, phase 12's: bf16 roundings flip between the "
            f"card's sums and the CPU's); CPU {time.perf_counter() - t1:.1f} s")
        if not max(cpu_l2.values()) <= SEP_BF16_L2:
            fail(f"{label}: the card's bf16 stems disagree with the CPU's")
        del sep, nets, cpu
        torch.cuda.empty_cache()

    if not captured:
        fail("HDemucs in bf16 ran no BLSTM step")
    module, x = captured[0]
    say(f"  HDemucs's first BLSTM ({module.num_layers} layers of {module.hidden_size} a "
        f"direction, {x.shape[0]} steps x {x.shape[1]} sequences), its recurrence four ways: "
        + lstm_forms(module, x))
    del captured
    launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    say(f"  kernel launches in phase 26: {launched}")
    if any(launched.values()):
        fail("bf16 separation launched a kernel of the conversion or training path")


# ---- phase 27: several cards (torch.distributed in place of the dp mesh) ----
DP_STEPS = 4  # a rank's steps in phase 27(b): the first checked, the rest timed


def dp_rank(world, cfg, batches: list, draws: list, keep: int) -> dict:
    """A rank of phase 27(b): ``parallel.dryrun.dp_steps`` from seed 0's
    weights with kernels 4-7 counted over its steps."""
    skip_default_init()
    from rvc_tpu_torch.ops import _cuda
    from rvc_tpu_torch.parallel.dryrun import dp_steps

    _cuda.library()
    return dp_steps(world, cfg, batches, draws, keep_params=keep, counters=training_counters(),
                    events=True, device=world.device)


def dp_world_of_one(world, cfg, batches: list, draws: list) -> dict:
    """Phase 27(a) in a world of 1 (NCCL): the plain step and the dp step on
    the same batch and draws, with cuDNN's and PyTorch's deterministic
    algorithms (by default the step is not reproducible on the card: cuDNN's
    weight gradients sum with atomics, so two plain steps differ in the last
    bits), kernels 4-7 counted in each."""
    import torch

    skip_default_init()
    from rvc_tpu_torch.ops import _cuda
    from rvc_tpu_torch.parallel.dryrun import dp_steps

    _cuda.library()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    kw = dict(keep_params=1, counters=training_counters(), device=world.device)
    dp_steps(None, cfg, batches, draws, **kw)  # set-up: the first step's cuDNN plans
    plain = dp_steps(None, cfg, batches, draws, **kw)
    return {"plain": plain, "dp": dp_steps(world, cfg, batches, draws, events=True, **kw)}


def params_distance(a: dict, b: dict, lr: float) -> tuple[float, float]:
    """(the largest difference of two runs' parameters, the share of
    elements more than 0.01 lr apart)."""
    import torch

    delta = torch.cat([(a[k] - b[k]).abs().flatten() for k in b])
    return delta.max().item(), (delta > 0.01 * lr).float().mean().item()


def run_several_cards(cfg, batches: list, card: str, tmp: str) -> dict:
    """Phase 27: the dp step and the chunk batch over several devices, on
    the one card. (a) a world of 1 over NCCL: Trainer(world=) on phase 7's
    batch equal to the plain step bit for bit (dp_world_of_one); (b) two ranks sharing cuda:0
    over gloo (NCCL refuses two ranks on one device), 2 rows each, DP_STEPS
    steps: the first against the one-process step at batch 4 on the same
    draws at phase 8's bars, the ranks' parameters equal, kernels 4-7
    counted on each rank; (c) convert_batch of 8 songs of 10 s with
    devices=[cuda:0, cuda:0] against devices=None, int16 equal on cuDNN's
    deterministic engines. Returns the launches."""
    import torch

    from rvc_tpu_torch.parallel import mesh
    from rvc_tpu_torch.pipelines.convert import ConvertSettings
    from rvc_tpu_torch.train.step import Trainer

    lr = cfg.train.learning_rate
    steps = batches[1:1 + DP_STEPS]
    host = Trainer(cfg, device="cpu")  # the global draws, and the model's structure
    draws = [host.draws(b, 3 + i) for i, b in enumerate(steps)]
    expected = expected_training_launches(host, 1)

    # (a) a world of 1 over NCCL (a spawned rank, deterministic algorithms:
    # cuBLAS reads its workspace setting when the process starts it)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        (r,) = mesh.spawn(dp_world_of_one, 1, "cuda:0", args=(cfg, steps[:1], draws[:1]),
                          rendezvous_dir=tmp)
    finally:
        del os.environ["CUBLAS_WORKSPACE_CONFIG"]
    plain, one = r["plain"], r["dp"]
    same = (one["metrics"] == plain["metrics"] and one["digest"] == plain["digest"]
            and all(torch.equal(one["params"][0][k], plain["params"][0][k])
                    for k in plain["params"][0]))
    ar = sum(v for k, v in one["stages"][0].items() if k.endswith("all-reduce"))
    say(f"[27/29] several cards, 48k_v2 at batch {TRAIN_BATCH} on phase 7's batch: (a) a world "
        f"of 1 over NCCL, cuDNN's and PyTorch's deterministic algorithms on: the dp step bit for "
        f"bit the plain step: {same} (metrics, every parameter, digest); step ms "
        f"{one['wall_ms'][0]:.2f} against {plain['wall_ms'][0]:.2f}, the two gradient "
        f"all-reduces {ar:.3f} ms (CUDA events); launches "
        f"{ {k: v for k, v in one['launches'].items() if v} }; {card}")
    if not same:
        fail("the dp step at world size 1 differs from the plain step")
    if one["launches"] != expected or plain["launches"] != expected:
        fail(f"kernel launches {one['launches']} / {plain['launches']}, expected {expected}")

    # (b) two ranks on cuda:0 over gloo, against one process at batch 4
    t0 = time.perf_counter()
    ranks = mesh.spawn(dp_rank, 2, "cuda:0", args=(cfg, steps, draws, 1), backend="gloo",
                       rendezvous_dir=tmp)
    spawn_s = time.perf_counter() - t0
    ma, mb = ranks[0]["metrics"][0], plain["metrics"][0]
    loss_err = max(abs(ma[k] - mb[k]) / max(1.0, abs(mb[k])) for k in mb
                   if not k.startswith("grad_norm"))
    norm_err = max(abs(ma[k] - mb[k]) / abs(mb[k]) for k in ("grad_norm_g", "grad_norm_d"))
    worst, share = params_distance(ranks[0]["params"][0], plain["params"][0], lr)
    equal = ranks[0]["digest"] == ranks[1]["digest"] and \
        ranks[0]["metrics"] == ranks[1]["metrics"]
    per_rank = [float(np.median(r["wall_ms"][1:])) for r in ranks]
    ar_ms = [float(np.median([sum(v for k, v in st.items() if k.endswith("all-reduce"))
                              for st in r["stages"][1:]])) for r in ranks]
    expected_b = expected_training_launches(host, DP_STEPS)
    del host
    say(f"  (b) two ranks on cuda:0 over gloo, {TRAIN_BATCH // 2} rows each, {DP_STEPS} steps "
        f"(spawned and run in {spawn_s:.1f} s): the first step against one process's at batch "
        f"{TRAIN_BATCH} on the same draws: losses within {loss_err:.3g} (relative, of max(1, "
        f"|loss|); tolerance 1e-3), gradient norms within {norm_err:.3g} (tolerance 1e-2), "
        f"parameters max |diff| {worst:.3g} (tolerance 2.01 lr = {2.01 * lr:.3g}), share above "
        f"0.01 lr {share:.4%} (tolerance 1%); the ranks' metrics and parameters equal: {equal}; "
        f"median step ms per rank over steps 2-{DP_STEPS} {[round(x, 2) for x in per_rank]} "
        f"(host clock, synchronized; one process at batch {TRAIN_BATCH}: "
        f"{plain['wall_ms'][0]:.2f} ms, its first step), of which the gradient all-reduces "
        f"{[round(x, 2) for x in ar_ms]} ms (CUDA events; gloo copies each model's flat "
        f"gradients to the host and back); launches per rank "
        f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}; {card}")
    if not (loss_err <= 1e-3 and norm_err <= 1e-2 and worst <= 2.01 * lr and share <= 0.01):
        fail("the two-rank dp step disagrees with one process's step")
    if not equal:
        fail("the two ranks' parameters differ")
    if any(r["launches"] != expected_b for r in ranks):
        fail(f"a rank's kernel launches differ from {expected_b}")

    # (c) convert_batch over [cuda:0, cuda:0] against one device
    vc = main_converter("cuda")
    settings = ConvertSettings(**SETTINGS)
    songs = [speech(10.0, 3.0 * i) for i in range(8)]
    conv_counters = {k: launch_counters()[k] for k in
                     ("fused_resblock_group", "banded_rel_attention", "nearest_rows_q")}
    outs, walls, launched = {}, {}, {}
    for label, devices in (("one", None), ("split", ["cuda:0", "cuda:0"])):
        vc.devices = devices
        vc.convert_batch(songs, settings=settings)  # set-up (the replicas are copied here)
        for fn, attr in conv_counters.values():
            setattr(fn, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs[label] = vc.convert_batch(songs, settings=settings)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        launched[label] = {k: getattr(fn, attr) for k, (fn, attr) in conv_counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        say(f"  (c) convert_batch of 8 songs of 10 s, devices={devices}: wall "
            f"{walls[label] * 1e3:.2f} ms, aggregate RTF {80.0 / walls[label]:.2f}x, launches "
            f"{launched[label]}, max_memory_allocated {peak:.2f} GiB")
    # the outputs compared come from calls on cuDNN's deterministic engines:
    # its free engines sum with atomics, and a float32 convert_batch is then
    # 1 LSB from itself run to run (ROADMAP §3; the timed calls above stay free)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, devices in (("one", None), ("split", ["cuda:0", "cuda:0"])):
            vc.devices = devices
            outs[label] = vc.convert_batch(songs, settings=settings)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    equal = all(np.array_equal(a, b) and sa == sb for (a, sa), (b, sb)
                in zip(outs["one"], outs["split"]))
    lsb = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
              for (a, _), (b, _) in zip(outs["one"], outs["split"]))
    say(f"  the split chunk batch's int16 output equal to one device's, both on cuDNN's "
        f"deterministic engines: {equal} (max |diff| {lsb} LSB; RMVPE once over the undivided "
        f"batch, HuBERT, kernels 1-3 and the rest of the synthesizer on each replica's rows); "
        f"{card}")
    if not equal:
        fail("convert_batch over two devices differs from one device's")
    if launched["split"] != {k: 2 * v for k, v in launched["one"].items()}:
        fail(f"the replicas launched {launched['split']}, not twice {launched['one']}")
    vc.devices = None
    del vc
    torch.cuda.empty_cache()
    return {"dp_rank": ranks[0]["launches"], "replicas": launched["split"]}


# ---- phase 28: speech to text (Whisper medium and the STT nodes) ----
WHISPER_LEN = 48  # tokens a decode: random weights never emit EOT


def whisper_pt(path: str, dims, seed: int) -> None:
    """An OpenAI-format ``.pt`` (``dims``, ``model_state_dict``) of random
    weights drawn on the card from ``seed``: N(0, 0.02) matrices and
    embeddings, zero biases, unit norm gains, the encoder's sinusoids."""
    import dataclasses

    import torch

    from rvc_tpu_torch.models.whisper import Whisper

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}
    for k, v in Whisper(dims).state_dict().items():
        leaf = k.split(".")
        if k == "encoder.positional_embedding":
            sd[k] = v
        elif leaf[-2].endswith("ln") or leaf[-2] == "ln_post":
            sd[k] = torch.ones_like(v) if leaf[-1] == "weight" else torch.zeros_like(v)
        elif leaf[-1] == "bias":
            sd[k] = torch.zeros_like(v)
        else:
            sd[k] = (0.02 * torch.randn(v.shape, generator=gen, device="cuda")).cpu()
    torch.save({"dims": dataclasses.asdict(dims), "model_state_dict": sd}, path)


def run_whisper(tmp: str, card: str) -> None:
    """Phase 28: Whisper medium (24 + 24 layers at width 1024, the
    multilingual vocabulary) from an OpenAI-format .pt of random weights,
    loaded by load_whisper and by RVC_TPU_LoadWhisper: the encoder on 30 s
    of speech card vs CPU within 1e-4 relative L2; greedy, beam (5) and
    timestamp decoding on the card, the greedy tokens teacher-forced
    through the CPU decoder (argmax equal wherever the top two differ by
    more than 1e-4); the fallback ladder at (0, 0.2); RVC_TPU_Transcribe
    end to end on the 30 s clip; no kernel of the repository launched."""
    import torch

    from rvc_tpu_torch.graph import NODE_CLASS_MAPPINGS, nodes
    from rvc_tpu_torch.models import whisper as W
    from rvc_tpu_torch.ops import retrieval

    dims = W.WHISPER_SIZES["medium"]
    path = os.path.join(tmp, "medium.pt")
    t0 = time.perf_counter()
    whisper_pt(path, dims, seed=11)
    write_s = time.perf_counter() - t0
    counters = {**training_counters(), "nearest_rows": (retrieval.nearest_rows, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, got_dims = W.load_whisper(path)
    load_s = time.perf_counter() - t0
    if got_dims != dims or next(model.parameters()).device.type != "cuda":
        fail(f"load_whisper gave {got_dims} on {next(model.parameters()).device}")
    n_params = sum(p.numel() for p in model.parameters())
    audio = speech(30.0, 20.0)
    mel = W.log_mel_spectrogram(torch.from_numpy(audio).cuda()[None])
    with torch.no_grad():
        enc_ms = timed(lambda: model.embed_audio(mel), reps=3, warmup=1)
        enc = model.embed_audio(mel).cpu()
    cpu_model, _ = W.load_whisper(path, device="cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        enc_cpu = cpu_model.embed_audio(mel.cpu())
    cpu_s = time.perf_counter() - t0
    rel = float(torch.linalg.vector_norm(enc - enc_cpu) / torch.linalg.vector_norm(enc_cpu))
    enc_params = sum(p.numel() for p in model.encoder.parameters())
    flops = 2 * enc_params * 1500 + 4 * dims.n_audio_layer * 1500 ** 2 * dims.n_audio_state
    say(f"[28/29] Whisper medium ({n_params / 1e6:.1f} M parameters; .pt written in "
        f"{write_s:.1f} s, loaded in {load_s:.1f} s): the encoder on 30 s {enc_ms:.2f} ms "
        f"({flops / enc_ms / 1e9:.1f} TFLOP/s in float32, TF32 off), card vs CPU relative L2 "
        f"{rel:.3g} (tolerance 1e-4; CPU {cpu_s:.1f} s); {card}")
    if not (rel <= 1e-4 and torch.isfinite(enc).all()):
        fail("Whisper's encoder on the card disagrees with the CPU's")

    sot = (50258, 50259, 50359, 50363)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = W.greedy_decode(model, mel, max_len=WHISPER_LEN)
    greedy_s = time.perf_counter() - t0
    seq = torch.tensor([list(sot) + toks[0].tolist()])
    with torch.no_grad():
        logits = cpu_model.logits(seq, enc_cpu)[0, len(sot) - 1:len(sot) - 1 + toks.shape[1]]
    top2 = torch.topk(logits, 2).values
    close = (top2[:, 0] - top2[:, 1] <= 1e-4).numpy()
    agree = (torch.argmax(logits, -1).numpy() == toks[0]) | close
    t0 = time.perf_counter()
    beam, beam_lp = W.beam_decode(model, mel, beam_size=5, max_len=WHISPER_LEN)
    beam_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    segs = W.decode_with_timestamps(model, mel, max_len=WHISPER_LEN)
    ts_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fb, info = W.decode_with_fallback(model, mel, temperatures=(0.0, 0.2), max_len=WHISPER_LEN)
    fb_s = time.perf_counter() - t0
    say(f"  decoding {WHISPER_LEN} tokens on the card: greedy {greedy_s:.2f} s "
        f"({WHISPER_LEN / greedy_s:.1f} tokens/s, one row), beam of 5 {beam_s:.2f} s "
        f"({len(beam) / beam_s:.1f} tokens/s; avg log p {beam_lp:.3f}), timestamps {ts_s:.2f} s "
        f"({len(segs[0])} segments), the fallback at (0, 0.2) {fb_s:.2f} s (ended at T "
        f"{info['temperature']}, compression {info['compression_ratio']:.2f}); the greedy "
        f"tokens teacher-forced through the CPU decoder: argmax equal at "
        f"{int(agree.sum())}/{len(agree)} steps ({int(close.sum())} within 1e-4 of a tie)")
    if not agree.all() or toks.shape != (1, WHISPER_LEN) or len(beam) != WHISPER_LEN:
        fail("Whisper's decoding on the card disagrees with the CPU's")
    del cpu_model

    nodes.DEVICE = None
    t0 = time.perf_counter()
    (loader,) = NODE_CLASS_MAPPINGS["RVC_TPU_LoadWhisper"]().load(path)
    entry = loader()
    node_load_s = time.perf_counter() - t0
    wav = nodes.to_audio_dict(audio, 16000)
    node = NODE_CLASS_MAPPINGS["RVC_TPU_Transcribe"]()
    node.transcribe(wav, loader)  # set-up
    t0 = time.perf_counter()
    transcription, frames = node.transcribe(wav, loader)
    torch.cuda.synchronize()
    node_s = time.perf_counter() - t0
    prompts = NODE_CLASS_MAPPINGS["RVC_TPU_TranscriptionEncoder"]().get_prompt(
        transcription, use_tags=True)
    launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    say(f"  RVC_TPU_LoadWhisper {node_load_s:.1f} s (on {next(entry['model'].parameters()).device}"
        f", kept in the node cache); RVC_TPU_Transcribe on 30 s: {node_s:.2f} s "
        f"({len(transcription['chunks'])} chunk, {len(transcription['text'])} characters of "
        f"random tokens, {frames} s), the encoder node's {prompts[3]} prompt(s); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
        f"launches in phase 28: {launched}; {card}")
    if next(entry["model"].parameters()).device.type != "cuda" or frames != 30:
        fail("the STT nodes did not run on the card")
    if any(launched.values()):
        fail("speech to text launched a kernel of the conversion or training path")
    nodes._CACHE.clear()
    del model, entry, loader
    torch.cuda.empty_cache()


# ---- phase 29: lip sync (MuseTalk: the VAE, the UNet, S3FD, BiSeNet, FAN) ----
MUSE_FRAMES = 50     # 2 s of video at 25 fps
MUSE_SIDE = 512      # frame side
MUSE_TOL = 1e-4      # relative L2 of a network's output, card vs CPU: float32 summed in
# another order (the CPU tests hold the port to JAX within 1e-5)
MUSE_LSB = 2         # pasted uint8 frames, card vs CPU: the CPU tests' bar against JAX
MUSE_AGREE = 0.999   # share of BiSeNet's classes and FAN's landmarks equal card vs CPU


def musetalk_state(module, seed: int, device: str = "cuda") -> dict:
    """Seeded weights of a MuseTalk network, drawn on ``device`` in
    state_dict order: N(0, 2 / fan_in) for a weight of two or more axes,
    norm gains 1 + N(0, 0.1²), biases N(0, 0.05²), BatchNorm means
    N(0, 0.1²) and variances 1 + U(0, 0.2), S3FD's L2Norm scales as built
    (10, 8, 5). Activations keep their scale through every depth, so the
    class maps and landmarks are not ties."""
    import torch

    from rvc_tpu_torch.models.musetalk.face import L2Norm

    gen = torch.Generator(device=device).manual_seed(seed)
    scales = {f"{name}.weight" for name, m in module.named_modules() if isinstance(m, L2Norm)}
    out = {}
    for k, t in module.state_dict().items():
        leaf, shape = k.rsplit(".", 1)[-1], tuple(t.shape)
        randn = torch.randn(shape, generator=gen, device=device)
        if k in scales:
            v = t.to(device).clone()
        elif leaf == "running_var":
            v = 1 + 0.2 * torch.rand(shape, generator=gen, device=device)
        elif leaf == "running_mean":
            v = 0.1 * randn
        elif len(shape) >= 2:
            v = randn * math.sqrt(2.0 / math.prod(shape[1:]))
        elif leaf == "bias":
            v = 0.05 * randn
        else:
            v = 1 + 0.1 * randn
        out[k] = v
    return out


def write_musetalk_files(folder: str, seed: int, device: str = "cuda", vae_cfg=None,
                         unet_cfg=None, fan_modules: int = 4) -> dict:
    """Checkpoints of seeded weights as the releases ship them, in ``folder``:
    the VAE (diffusers names, the mid block's attention under the older
    names ``query``/``key``/``value``/``proj_attn``), the UNet (float16),
    S3FD, BiSeNet (with its training heads ``conv_out16``/``conv_out32``
    and ``num_batches_tracked``) and FAN. S3FD's box regressions are drawn
    at 1e-4 of the rest (the input's pixels are of order 100), and the three
    coarsest scales' class heads too, their face logit lowered by 10 (no
    candidate there passes the 0.05 threshold): seeded weights put
    the best candidate anywhere, a box far from its anchor can miss the
    frame, and so can those scales' anchors: fc6 (padding 3 and no
    dilation, as face-alignment's S3FD and the JAX package build it) makes
    their maps 4 wider than the frame's share. Returns {kind: path}."""
    import torch

    from rvc_tpu_torch.models.musetalk import face, unet, vae

    made = {"vae": vae.AutoencoderKL(vae_cfg or vae.VAEConfig()),
            "unet": unet.UNet2DCondition(unet_cfg or unet.UNetConfig()),
            "s3fd": face.S3FD(), "bisenet": face.BiSeNet(), "fan": face.FAN(fan_modules)}
    paths = {}
    for i, (kind, module) in enumerate(made.items()):
        sd = {k: v.cpu() for k, v in musetalk_state(module, seed + i, device).items()}
        if kind == "vae":
            old = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.",
                   ".to_out.0.": ".proj_attn."}
            for k in [k for k in sd if ".attentions." in k]:
                new = k
                for a, b in old.items():
                    new = new.replace(a, b)
                sd[new] = sd.pop(k)
        elif kind == "unet":
            sd = {k: v.half() for k, v in sd.items()}
        elif kind == "s3fd":  # each candidate near its anchor, so that every box meets the frame
            sd = {k: v * 1e-4 if "_mbox_loc." in k else v for k, v in sd.items()}
            for head in ("fc7", "conv6_2", "conv7_2"):
                sd[f"{head}_mbox_conf.weight"] *= 1e-4
                sd[f"{head}_mbox_conf.bias"][1] -= 10.0
        elif kind == "bisenet":
            aux = face.BiSeNetOutput(128, 64, 19)
            for head in ("conv_out16", "conv_out32"):
                sd.update({f"{head}.{k}": v.cpu() for k, v in
                           musetalk_state(aux, seed + 10, device).items()})
            for k in [k for k in sd if k.endswith("running_mean")]:
                sd[k.replace("running_mean", "num_batches_tracked")] = torch.tensor(100)
        name = {"vae": "diffusion_pytorch_model.bin", "unet": "pytorch_model.bin",
                "s3fd": "s3fd.pth", "bisenet": "79999_iter.pth", "fan": "2DFAN4.pth"}[kind]
        paths[kind] = os.path.join(folder, name)
        torch.save(sd, paths[kind])
    return paths


MUSE_FACE = (0.2, 0.27)  # the drawn face's half width and half height, in frame sides


def muse_face_centre(i: int) -> tuple[float, float]:
    """The drawn face's centre in frame ``i``, in frame sides."""
    return 0.5 + 0.02 * np.sin(i / 7), 0.48 + 0.01 * np.cos(i / 5)


def muse_face_box(i: int, side: int) -> tuple[int, int, int, int]:
    """The box (x1, y1, x2, y2) of the face drawn in frame ``i``."""
    (cx, cy), (ax, ay) = muse_face_centre(i), MUSE_FACE
    return (int((cx - ax) * side), int((cy - ay) * side), int(np.ceil((cx + ax) * side)),
            int(np.ceil((cy + ay) * side)))


def muse_frames(n: int, side: int, seed: int) -> np.ndarray:
    """(n, side, side, 3) uint8 RGB: a lit gradient background, a skin-toned
    face that drifts a few pixels, eyes, and a mouth that opens and closes
    at about 4 Hz, under seeded noise of +-6."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    out = np.empty((n, side, side, 3), np.uint8)
    for i in range(n):
        img = np.stack([60 + 80 * xx, 90 + 60 * yy, 140 - 50 * xx], -1)
        cx, cy = muse_face_centre(i)
        face_ = ((xx - cx) / MUSE_FACE[0]) ** 2 + ((yy - cy) / MUSE_FACE[1]) ** 2 < 1
        img[face_] = (205, 160, 130)
        for ex in (cx - 0.08, cx + 0.08):
            img[((xx - ex) / 0.03) ** 2 + ((yy - cy + 0.07) / 0.015) ** 2 < 1] = (40, 30, 30)
        open_ = 0.01 + 0.03 * abs(np.sin(i * np.pi * 4 / 25))
        img[((xx - cx) / 0.07) ** 2 + ((yy - cy - 0.13) / open_) ** 2 < 1] = (120, 40, 50)
        img += rng.uniform(-6, 6, img.shape)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def rel_l2(a, b) -> float:
    import torch

    a, b = (torch.as_tensor(np.asarray(x.detach().cpu() if hasattr(x, "detach") else x),
                            dtype=torch.float64) for x in (a, b))
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def run_musetalk(tmp: str, card: str) -> None:
    """Phase 29: lip sync at full width on the card, from checkpoint files of
    seeded weights (the VAE at sd-vae-ft-mse widths, the UNet at
    UNetConfig(), S3FD, BiSeNet with 19 classes, FAN with 4 modules, Whisper
    tiny through RVC_TPU_LoadWhisper): MUSE_FRAMES synthetic frames and 2 s
    of speech through RVC_TPU_MuseImageFeatures (S3FD), ..._MuseAudioFeatures
    and ..._MuseTalk (the parser, batch 8); MuseTalkPipeline.process with
    S3FD, FAN and the parser for its stages, at the drawn face's size;
    get_landmarks. Each network card vs CPU on 2 frames within MUSE_TOL,
    BiSeNet's classes and FAN's landmarks equal on MUSE_AGREE of them, the
    pasted frames within MUSE_LSB; no kernel of the repository launched."""
    import torch

    from rvc_tpu_torch.graph import NODE_CLASS_MAPPINGS, musetalk_nodes, nodes
    from rvc_tpu_torch.models import whisper as W
    from rvc_tpu_torch.models.musetalk import face, unet, vae
    from rvc_tpu_torch.ops import retrieval
    from rvc_tpu_torch.ops.image import resize
    from rvc_tpu_torch.pipelines import musetalk as P

    device = "cuda"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    paths = write_musetalk_files(tmp, seed=29)
    paths["whisper"] = os.path.join(tmp, "tiny.pt")
    whisper_pt(paths["whisper"], W.WHISPER_SIZES["tiny"], seed=30)
    write_s = time.perf_counter() - t0
    sizes = {k: os.path.getsize(p) / 2**20 for k, p in paths.items()}
    counters = {**training_counters(), "nearest_rows": (retrieval.nearest_rows, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats()

    frames = muse_frames(MUSE_FRAMES, MUSE_SIDE, seed=29)
    audio = speech(MUSE_FRAMES / 25.0, 12.0)
    images = frames.astype(np.float32) / 255.0
    (whisper,) = NODE_CLASS_MAPPINGS["RVC_TPU_LoadWhisper"]().load(paths["whisper"])
    wav = nodes.to_audio_dict(audio, 16000)
    t0 = time.perf_counter()
    coords, _ = NODE_CLASS_MAPPINGS["RVC_TPU_MuseImageFeatures"]().process(
        images, face_model_path=paths["s3fd"], use_cache=False)
    feats, n_feat = NODE_CLASS_MAPPINGS["RVC_TPU_MuseAudioFeatures"]().extract(wav, whisper)
    (out,) = NODE_CLASS_MAPPINGS["RVC_TPU_MuseTalk"]().process(
        images, wav, whisper, paths["vae"], paths["unet"],
        parsing_model_path=paths["bisenet"], coords=coords, batch_size=8)
    torch.cuda.synchronize()
    node_s = time.perf_counter() - t0  # the first call: the loads and cuDNN's plans too
    say(f"[29/29] lip sync at full width: checkpoints written in {write_s:.1f} s ("
        + ", ".join(f"{k} {v:.1f} MiB" for k, v in sizes.items()) + f"); {MUSE_FRAMES} frames "
        f"{MUSE_SIDE}x{MUSE_SIDE} and {len(audio) / 16000:.1f} s of speech through "
        f"RVC_TPU_MuseImageFeatures (S3FD), RVC_TPU_MuseAudioFeatures ({n_feat} frames of "
        f"{feats.shape[1]} x {feats.shape[2]}) and RVC_TPU_MuseTalk (BiSeNet, batch 8): "
        f"{node_s:.1f} s with the loads; {card}")
    if out.shape != images.shape or not np.isfinite(out).all() or out.min() < 0 or out.max() > 1:
        fail(f"RVC_TPU_MuseTalk gave {out.shape}, range [{out.min()}, {out.max()}]")
    if n_feat != MUSE_FRAMES or len(coords) != MUSE_FRAMES:
        fail(f"{n_feat} feature windows and {len(coords)} boxes for {MUSE_FRAMES} frames")

    # the pipeline with detection, landmarks and the parser, by stage, on the
    # networks the nodes keep (and FAN), warm. S3FD runs on every frame and
    # its time counts, but its seeded boxes sit on its anchors (the box heads
    # are quiet), far smaller than the drawn face; the stages after it take
    # the drawn face's box, so that the crops, the blur and the paste run at
    # a face's size
    m = whisper()
    a2f = P.Audio2Feature(m["model"], m["dims"], device=device)
    nets = {k: musetalk_nodes._model(kind, paths[kind]) for k, kind in
            (("vae", "vae"), ("unet", "unet"), ("face", "s3fd"), ("parse", "bisenet"))}
    nets["fan"] = face.load_fan(paths["fan"], device=device)
    pipe = P.MuseTalkPipeline(nets["vae"], nets["unet"], a2f, face=nets["face"],
                              parse=nets["parse"], fan=nets["fan"], device=device)
    lms, found = [], []
    landmarks, detect = pipe.get_landmarks, pipe.detect_faces
    pipe.get_landmarks = lambda *a, **k: lms.extend(landmarks(*a, **k)) or lms
    faces = [muse_face_box(i, MUSE_SIDE) for i in range(MUSE_FRAMES)]
    pipe.detect_faces = lambda fr: found.extend(detect(fr)) or faces[:len(fr)]
    stages: dict = {}
    t0 = time.perf_counter()
    got = pipe.process(list(frames), audio, stages=stages)
    wall = time.perf_counter() - t0
    del pipe.get_landmarks, pipe.detect_faces
    refined = [P.refine_box_with_landmarks(b, p_) for b, p_ in zip(faces, lms)]

    def sides(bs):
        return "x".join(f"{np.median([b[k + 2] - b[k] for b in bs]):.0f}" for k in (0, 1))

    say(f"  MuseTalkPipeline.process with S3FD, FAN (get_landmarks: {len(lms)} x "
        f"{lms[0].shape}) and BiSeNet: {wall:.2f} s = {len(got) / wall:.2f} frames/s end to end; "
        f"median box w x h px: S3FD's {sides(found)} (not used), the drawn face's "
        f"{sides(faces)}, after FAN {sides(refined)}; stages ms (the card synchronized at each "
        f"end): " + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in stages.items()))
    if len(got) != MUSE_FRAMES or any(f.shape != frames[0].shape for f in got):
        fail("MuseTalkPipeline.process gave frames of another count or shape")
    if len(lms) != MUSE_FRAMES or not all(np.isfinite(p_).all() for p_ in lms):
        fail("get_landmarks gave no finite 68 points a frame")

    # the networks alone, batch 8, and their FLOPs counted on the meta device
    B = 8
    x8 = torch.randn(B, 3, 256, 256, device=device)
    lat8 = torch.randn(B, 8, 32, 32, device=device)
    ctx8 = torch.randn(B, 10, 384, device=device)
    z8 = torch.randn(B, 4, 32, 32, device=device)
    t8 = torch.zeros(B, device=device)
    with torch.no_grad():
        enc_ms = timed(lambda: nets["vae"].encode(x8), reps=3, warmup=1)
        dec_ms = timed(lambda: nets["vae"].decode(z8), reps=3, warmup=1)
        unet_ms = timed(lambda: nets["unet"](lat8, t8, ctx8), reps=3, warmup=1)
    enc_f = network_flops(lambda: vae.Encoder(vae.VAEConfig()), (B, 3, 256, 256))
    dec_f = network_flops(lambda: vae.Decoder(vae.VAEConfig()), (B, 4, 32, 32))
    unet_f = network_flops(lambda: unet.UNet2DCondition(unet.UNetConfig()),
                           [(B, 8, 32, 32), (B,), (B, 10, 384)])
    n_unet = sum(p.numel() for p in nets["unet"].parameters())
    n_vae = sum(p.numel() for p in nets["vae"].parameters())
    say(f"  batch {B}, CUDA events (3 after a warm-up), float32 with TF32 off: VAE encode "
        f"{enc_ms:.2f} ms ({enc_f / 1e12:.3f} TFLOP, {enc_f / enc_ms / 1e9:.1f} TFLOP/s), VAE "
        f"decode {dec_ms:.2f} ms ({dec_f / 1e12:.3f} TFLOP, {dec_f / dec_ms / 1e9:.1f} TFLOP/s), "
        f"UNet {unet_ms:.2f} ms ({unet_f / 1e12:.3f} TFLOP, {unet_f / unet_ms / 1e9:.1f} "
        f"TFLOP/s); UNet {n_unet / 1e6:.1f} M parameters, VAE {n_vae / 1e6:.1f} M; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # card against CPU: each network on 2 frames with the same weights
    t0 = time.perf_counter()
    cpu = {"vae": vae.AutoencoderKL(nets["vae"].cfg), "unet": unet.UNet2DCondition(nets["unet"].cfg),
           "face": face.S3FD(), "parse": face.BiSeNet(), "fan": face.FAN(nets["fan"].num_modules)}
    for k, net in cpu.items():
        net.load_state_dict(nets[k].state_dict())
        net.eval()
    two = list(frames[:2])
    S = MUSE_SIDE  # the second box leaves the frame
    given = [(S * 30 // 100, S * 27 // 100, S * 72 // 100, S * 78 // 100),
             (S * 58 // 100, S * 49 // 100, S * 105 // 100, S * 104 // 100)]
    crops = [f[y1:y2, x1:x2] for f, (x1, y1, x2, y2) in zip(two, given)]
    cpu_pipe = P.MuseTalkPipeline(cpu["vae"], cpu["unet"], P.Audio2Feature(
        W.load_whisper(paths["whisper"], device="cpu")[0], device="cpu"),
        parse=cpu["parse"], device="cpu")
    card_pipe = P.MuseTalkPipeline(nets["vae"], nets["unet"], a2f, parse=nets["parse"],
                                   device=device)
    # the VAE's encode and decode and the UNet on both devices through the
    # pipelines (the same crops; each device's own latents downstream), the
    # VAE's outputs kept on the way
    seen, hooks = {}, []

    def unet_out(key):
        def hook(module, args, out):
            seen[key] = out
        return hook

    for side, p_ in (("card", card_pipe), ("cpu", cpu_pipe)):
        for name in ("encode", "decode"):
            def kept(z, fn=getattr(p_.vae, name), key=(side, name)):
                seen[key] = fn(z)
                return seen[key]
            setattr(p_.vae, name, kept)
        hooks.append(p_.unet.register_forward_hook(unet_out((side, "UNet"))))
    short = audio[: int(0.2 * 16000)]  # 10 rows at 50 Hz: 5 frames of features
    try:
        pasted = [p_.process(two, short, boxes=given) for p_ in (card_pipe, cpu_pipe)]
    finally:
        for p_, hook in zip((card_pipe, cpu_pipe), hooks):
            del p_.vae.encode, p_.vae.decode
            hook.remove()
    lsb = max(int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())
              for a, b in zip(*pasted))
    dists = {"VAE encode": rel_l2(seen["card", "encode"], seen["cpu", "encode"]),
             "UNet": rel_l2(seen["card", "UNet"], seen["cpu", "UNet"]),
             "VAE decode": rel_l2(seen["card", "decode"], seen["cpu", "decode"])}
    pin = np.stack([(resize(im, (512, 512)).astype(np.float32) / 255.0 - P.FaceParser._MEAN)
                    / P.FaceParser._STD for im in two]).transpose(0, 3, 1, 2)
    fan_in = np.stack([resize(c, (256, 256)).astype(np.float32) / 255.0
                       for c in crops]).transpose(0, 3, 1, 2)

    def both(name, fn):
        with torch.no_grad():
            a = fn(nets, device)
            b = fn(cpu, "cpu")
        if isinstance(a, list):
            dists[name] = max(rel_l2(u, v) for u, v in zip(a, b))
        else:
            dists[name] = rel_l2(a, b)
        return a, b

    s3fd_in = pipe._s3fd_input(two).cpu()
    both("S3FD (12 maps)", lambda n, d: n["face"](s3fd_in.to(d)))
    logits, logits_cpu = both("BiSeNet", lambda n, d: n["parse"](torch.from_numpy(pin).to(d)))
    heat, heat_cpu = both("FAN", lambda n, d: n["fan"](torch.from_numpy(fan_in).to(d)))
    cls_eq = float((logits.argmax(1).cpu() == logits_cpu.argmax(1)).float().mean())
    lm_eq = float((face.heatmaps_to_landmarks(heat).cpu()
                   == face.heatmaps_to_landmarks(heat_cpu)).all(-1).float().mean())
    say("  card vs CPU on 2 frames at full width, relative L2: "
        + ", ".join(f"{k} {v:.3g}" for k, v in dists.items())
        + f" (tolerance {MUSE_TOL:g}); BiSeNet's classes equal at {cls_eq:.4%} of pixels, FAN's "
        f"landmarks at {lm_eq:.4%} of points (bar {MUSE_AGREE:.1%}); the pasted frames (boxes "
        f"given, the parser) within {lsb} LSB (tolerance {MUSE_LSB}); CPU part "
        f"{time.perf_counter() - t0:.1f} s")
    if not (max(dists.values()) <= MUSE_TOL and cls_eq >= MUSE_AGREE and lm_eq >= MUSE_AGREE
            and lsb <= MUSE_LSB):
        fail("lip sync on the card disagrees with the CPU")
    launched = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    say(f"  kernel launches in phase 29: {launched}; phase 29 {time.perf_counter() - t_phase:.1f} "
        f"s, max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")
    if any(launched.values()):
        fail("lip sync launched a kernel of the conversion or training path")
    nodes._CACHE.clear()
    del nets, cpu, pipe, card_pipe, cpu_pipe, a2f, m, whisper
    torch.cuda.empty_cache()


def keep(path: str, folder: str) -> str:
    """``path`` moved into ``folder`` (out of a phase's temporary directory,
    for a later phase); returns its new path."""
    dest = os.path.join(folder, os.path.basename(path))
    os.replace(path, dest)
    return dest


def skip_default_init() -> None:
    """For this process, torch's default parameter initialization (the
    ``torch.nn.init`` calls in each layer's constructor) writes nothing.
    Every module this script builds has each parameter drawn (init_random_,
    the writers' draws) or loaded strictly (load_state_dict) before use; the
    defaults cost ~50 s of random numbers that nothing read (cProfile of
    the whole script on the card)."""
    from torch.nn import init

    def keep(tensor, *args, **kwargs):
        return tensor

    for name in ("uniform_", "normal_", "trunc_normal_", "constant_", "ones_", "zeros_",
                 "xavier_uniform_", "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
                 "orthogonal_"):
        setattr(init, name, keep)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    skip_default_init()
    clock = [time.perf_counter()]

    def lap(label: str) -> None:
        """Seconds since the last lap, for the phases named by ``label``."""
        now = time.perf_counter()
        say(f"  {label} took {now - clock[0]:.1f} s")
        clock[0] = now

    # 1. the card
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    say(f"[1/29] card: {name}, {count} device(s); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(card)

    # 2. the build
    from rvc_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    info = _cuda.build_info
    say(f"[2/29] build: {'cached' if info['cached'] else 'nvcc'} {info['seconds']:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")
    say("ptxas: " + "; ".join(info["ptxas"]))
    say("ptxas C7515 (wgmma serialized): " + (", ".join(info["serialized"]) or "none"))
    sass = sass_counts()
    unit, attn = sass.get("resblock_unit_wgmma_kernel"), sass.get("banded_attention_tc_kernel")
    chain, attn16 = sass.get("chain_conv_kernel"), sass.get("attn_pv_kernel")
    gate, res_skip = sass.get("wn_gate_kernel"), sass.get("wn_res_skip_kernel")
    say(f"sass: the bf16 unit kernel (kernels 1 and 8) {unit}, kernel 4's conv kernel {chain}, "
        f"kernel 6's in-conv {gate} and res/skip 1x1 {res_skip}, "
        f"kernel 2 in float32 {attn}, kernel 2 in bf16 (its P.V launch) {attn16} and its stats "
        f"launch {sass.get('attn_stats_kernel')}")
    if not all(kern and kern["HGMMA"] and kern["bulk copies"]
               for kern in (unit, chain, gate, res_skip)):
        fail("a unit or conv kernel lacks wgmma or bulk copies")
    if not (attn and attn["HMMA"] and attn16 and attn16["HMMA"]):
        fail("kernel 2 lacks mma.sync")

    from rvc_tpu_torch.ops import attention, resblock, retrieval
    from rvc_tpu_torch.ops.filters import butter_highpass_host
    from rvc_tpu_torch.pipelines.convert import WINDOW, ConvertSettings

    t0 = time.perf_counter()
    vc = main_converter("cuda")
    say(f"converter built in {time.perf_counter() - t0:.1f} s")
    clips = {10: speech(10.0, 0.0), 30: speech(30.0, 10.0)}

    lap("phases 1-2 and the converter")

    # 3. kernels against their plain versions at the 30 s conversion's shapes
    shapes = path_shapes(vc, clips[30])
    say(f"[3/29] kernels at the 30 s conversion's shapes: {shapes['N']} chunks, "
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
    lap("phase 3")

    # 4. the main path
    counters = {"resblock": resblock.fused_resblock_group,
                "attention": attention.banded_rel_attention,
                "nearest": retrieval.nearest_rows_q}
    settings = ConvertSettings(**SETTINGS)
    launches = {}
    rtf32 = {}
    for sec, audio in clips.items():
        t0 = time.perf_counter()
        vc.convert(audio, settings=settings)  # first call at this length: set-up
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        for fn in counters.values():
            fn.launches = 0
        others = {k: c for k, c in launch_counters().items()
                  if k not in ("fused_resblock_group", "banded_rel_attention", "nearest_rows_q")}
        for fn, attr in others.values():  # the other routes' kernels: none in float32
            setattr(fn, attr, 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, sr = vc.convert(audio, settings=settings)
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t0]
        launches = {k: fn.launches for k, fn in counters.items()}
        stray = {k: getattr(fn, attr) for k, (fn, attr) in others.items() if getattr(fn, attr)}
        if stray:
            fail(f"the float32 conversion launched other routes' kernels: {stray}")
        for _ in range(2):  # the spread of the wall time, uncounted
            t0 = time.perf_counter()
            vc.convert(audio, settings=settings)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        rtf32[sec] = sec / wall
        spans = vc.spans(butter_highpass_host(audio))
        Tp = path_shapes(vc, audio)["Tp"]
        expect = sum(min((e - b) // WINDOW, Tp) * (sr // 100) - 2 * vc.t_pad_tgt
                     for b, e in spans)
        peak = int(np.abs(out.astype(np.int32)).max())
        say(f"[4/29] convert {sec} s: {len(spans)} chunks, {len(out)} samples at {sr} Hz, "
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

    lap("phase 4")

    # 5. the card's conversion against the CPU's (plain versions) on 3 s
    ref_clip = speech(3.0, 40.0)
    out_gpu, _ = vc.convert(ref_clip, settings=settings)
    t0 = time.perf_counter()
    cpu = main_converter("cpu")
    out_cpu, _ = cpu.convert(ref_clip, settings=settings)
    diff = np.abs(out_gpu.astype(np.int32) - out_cpu.astype(np.int32))
    tol = 4
    say(f"[5/29] 3 s on the card vs the CPU: {len(out_gpu)} vs {len(out_cpu)} samples, "
        f"max |diff| {diff.max()} LSB, share above {tol} LSB {np.mean(diff > tol):.4%} "
        f"(tolerance {tol} LSB: the same float32 math summed in another order, "
        f"~1e-5 relative before the int16 scaling); CPU run "
        f"{time.perf_counter() - t0:.1f} s")
    if out_gpu.shape != out_cpu.shape or diff.max() > tol:
        fail("the card's conversion disagrees with the CPU's")

    del vc, cpu
    torch.cuda.empty_cache()
    lap("phase 5")

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
    seeded_state(trainer, 0)
    say(f"dataset of {len(CLIP_SECONDS)} clips, {len(batches)} batches, trainer built in "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"[6/29] training kernels at the training run's shapes: batch {TRAIN_BATCH}, "
        f"segment {cfg.train.segment_size} samples, WN over {np.shape(batches[0]['spec'])[1]} "
        f"frames")
    gen = torch.Generator().manual_seed(2)
    checks["chain"], checks["chain_bwd"] = check_resblock_train(trainer, gen)
    checks["wn"], checks["wn_bwd"] = check_wn_train(
        trainer, batches[0]["spec_lengths"], np.shape(batches[0]["spec"])[1], gen)
    per_step = {"chain": len(trainer.synth.dec.resblocks),
                "wn": wn_launches_per_step(trainer.synth)}
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
            + (f"mma_sync_ms {c['mma_sync_ms']:.3f} (kernel below it: "
               f"{c['ms'] < c['mma_sync_ms']}), " if "mma_sync_ms" in c else "")
            + (f"pack_ms {c['pack_ms']:.3f} per step (apart), " if "pack_ms" in c else "")
            + f"launches per step {per_step[key.split('_')[0]]}")

    lap("phase 6 and the dataset")

    # 7. the training path
    run32 = run_training(trainer, batches, card, "7/29")
    trained, rate32 = run32["launches"], run32["rate"]
    launches = {"fused_resblock_group": launches["resblock"],
                "banded_rel_attention": launches["attention"],
                "nearest_rows_q": launches["nearest"],
                **{k: trained[k] for k in ("fused_resblock1", "fused_resblock1_backward",
                                           "fused_wn", "fused_wn_backward")}}
    del trainer
    torch.cuda.empty_cache()
    lap("phase 7")

    # 8. the card's training step against the CPU's
    small, cpu32 = check_train_vs_cpu(cfg, batches[0])
    lap("phase 8")

    # 9-12. conversion in bfloat16 (the JAX package's bench configuration)
    launches.update(run_bf16(clips, settings, card, rtf32, checks))
    lap("phases 9-12")

    # 13-15. models from a user's files; 16. convert_batch in bf16
    kept = os.path.join(tmp.name, "kept")  # files phase 25 reads again
    os.makedirs(kept)
    with tempfile.TemporaryDirectory(prefix="rvc_files_") as files:
        run_files(files, settings, card, checks)
        node_files = {k: keep(os.path.join(files, n), kept) for k, n in (
            ("model", "48k_v2.pth"), ("hubert", "hubert_base.safetensors"),
            ("rmvpe", "rmvpe.pt"), ("bank", "bank.npy"))}
    lap("phases 13-15")
    run_batch(settings, card)
    lap("phase 16")

    # 17. training 40k_v2 from a dataset through the CLI, then convert with it
    with tempfile.TemporaryDirectory(prefix="rvc_train_") as work:
        trained40 = run_train_from_dataset(work, settings, card, checks)
        node_files["src"] = keep(os.path.join(work, "src"), kept)
    for key, kname in (("chain", "fused_resblock1"), ("chain_bwd", "fused_resblock1_backward"),
                       ("wn", "fused_wn"), ("wn_bwd", "fused_wn_backward")):
        checks[key]["launches_40k_v2"] = trained40[kname]
    lap("phase 17")

    # 18. every f0 method, infer_mix and the host library
    run_f0_methods(card)
    lap("phase 18")

    # 19. training in bfloat16
    run16 = run_train_bf16(cfg, batches, small, cpu32, card, checks, rate32)
    launches.update({f"{k}[bf16]" if not k.endswith("]") else k: run16["launches"][k]
                     for k in ("fused_resblock1_train[bf16]", "fused_resblock1",
                               "fused_resblock1_backward", "fused_wn", "fused_wn_backward")})
    checks["wn_bwd_bf16"]["whole_stack"] = checks.pop("wn_stack_bf16")
    lap("phase 19")

    # 20. every loss, and a no-f0 model, trained on the card
    base = {"float32": dict(run32, phase=7), "bfloat16": dict(run16, phase=19)}
    del run32, run16
    run_every_loss(cfg, batches, card, base, checks)
    with tempfile.TemporaryDirectory(prefix="rvc_nof0_") as work:
        run_nof0(work, card, checks)
    for key, kname in (("chain", "fused_resblock1"), ("chain_bwd", "fused_resblock1_backward"),
                       ("wn", "fused_wn"), ("wn_bwd", "fused_wn_backward")):
        checks[key]["launches_40k_nof0"] = checks["nof0_float32"]["launches"][kname]
    lap("phase 20")

    # 21. 32k_v2 and 48k v1, converting and training one step, card vs CPU
    for preset_name, counts in run_unchecked_presets(settings, card).items():
        for key, kname in (("resblock", "fused_resblock_group"),
                           ("attention", "banded_rel_attention"), ("nearest", "nearest_rows_q")):
            checks[key][f"launches_{preset_name}"] = counts[kname]
    lap("phase 21")

    # 22. separation: the VR and MDX-Net routes through load_separator and the CLI
    # (each route's float32 stems, FLOPs, times and file kept for phase 26)
    sep32 = {}
    with tempfile.TemporaryDirectory(prefix="rvc_sep_") as work:
        sep32.update(run_separation(work, card))
        for route in sep32.values():
            route["path"] = keep(route["path"], kept)
        node_files.update(vr=sep32["VR"]["path"], song=keep(os.path.join(work, "song.wav"), kept))
    lap("phase 22")

    # 23. separation with Demucs: HTDemucs, HDemucs, Conv-TasNet and a bag
    with tempfile.TemporaryDirectory(prefix="rvc_demucs_") as work:
        demucs32 = run_demucs(work, card)
        for route in demucs32.values():
            route["path"] = keep(route["path"], kept)
    sep32.update(demucs32)
    lap("phase 23")

    # 24. BS-RoFormer and Mel-Band RoFormer, the Karafan recipe, pitch_shift
    with tempfile.TemporaryDirectory(prefix="rvc_roformer_") as work:
        roformer32 = run_roformer(work, card)
        for route in roformer32.values():
            route["path"] = keep(route["path"], kept)
    sep32.update(roformer32)
    lap("phase 24")

    # 25. the node graph: separate, convert, mix, preview; dataset, train, index, convert
    with tempfile.TemporaryDirectory(prefix="rvc_nodes_") as work:
        node_launches = run_nodes(node_files, work, card)
    for key, kname in (("resblock", "fused_resblock_group"), ("attention", "banded_rel_attention"),
                       ("nearest", "nearest_rows"), ("chain", "fused_resblock1"),
                       ("chain_bwd", "fused_resblock1_backward"), ("wn", "fused_wn"),
                       ("wn_bwd", "fused_wn_backward")):
        checks[key]["launches_nodes"] = node_launches[kname]
    lap("phase 25")

    # 26. separation in bf16 on every route, against phases 22-24's float32 stems
    run_separation_bf16(sep32, card)
    del sep32
    lap("phase 26")

    # 27. several cards: the dp step (NCCL at world size 1, two gloo ranks on cuda:0)
    # and convert_batch's chunk batch over two devices
    with tempfile.TemporaryDirectory(prefix="rvc_dp_") as work:
        dp = run_several_cards(cfg, batches, card, work)
    for key, kname in (("chain", "fused_resblock1"), ("chain_bwd", "fused_resblock1_backward"),
                       ("wn", "fused_wn"), ("wn_bwd", "fused_wn_backward")):
        checks[key]["launches_dp_rank"] = dp["dp_rank"][kname]
    for key, kname in (("resblock", "fused_resblock_group"), ("attention", "banded_rel_attention"),
                       ("nearest", "nearest_rows_q")):
        checks[key]["launches_replicas"] = dp["replicas"][kname]
    lap("phase 27")

    # 28. speech to text: Whisper medium, its decoders and the STT nodes
    with tempfile.TemporaryDirectory(prefix="rvc_stt_") as work:
        run_whisper(work, card)
    lap("phase 28")

    # 29. lip sync: the VAE, the UNet, S3FD, BiSeNet and FAN through the MuseTalk nodes
    with tempfile.TemporaryDirectory(prefix="rvc_muse_") as work:
        run_musetalk(work, card)
    lap("phase 29")

    kernels = []
    meta = {
        "resblock": ("fused_resblock_group", "rvc_tpu_torch/csrc/resblock_group.cu",
                     "rvc_tpu/ops/pallas_resblock.py:591"),
        "attention": ("banded_rel_attention", "rvc_tpu_torch/csrc/banded_attention.cu",
                      "rvc_tpu/ops/pallas_attention.py:156"),
        "nearest": ("nearest_rows_q", "rvc_tpu_torch/csrc/nearest_rows.cu",
                    "rvc_tpu/ops/pallas_retrieval.py:99"),
        "chain": ("fused_resblock1", "rvc_tpu_torch/csrc/resblock_chain.cu",
                  "rvc_tpu/ops/pallas_resblock.py:86"),
        "chain_bwd": ("fused_resblock1_backward", "rvc_tpu_torch/csrc/resblock_bwd.cu",
                      "rvc_tpu/ops/pallas_resblock.py:223"),
        "wn": ("fused_wn", "rvc_tpu_torch/csrc/wavenet.cu", "rvc_tpu/ops/pallas_wavenet.py:56"),
        "wn_bwd": ("fused_wn_backward", "rvc_tpu_torch/csrc/wavenet.cu",
                   "rvc_tpu/ops/pallas_wavenet.py:152"),
        "resblock_bf16": ("fused_resblock_group[bf16]", "rvc_tpu_torch/csrc/resblock_group.cu",
                          "rvc_tpu/ops/pallas_resblock.py:591"),
        "attention_bf16": ("banded_rel_attention[bf16]",
                           "rvc_tpu_torch/csrc/banded_attention.cu",
                           "rvc_tpu/ops/pallas_attention.py:156"),
        "chain_v2": ("fused_resblock1_v2", "rvc_tpu_torch/csrc/resblock_group.cu",
                     "scripts/bench_resblock_v2.py:36"),
        "chain_bf16": ("fused_resblock1_train[bf16]", "rvc_tpu_torch/csrc/resblock_group.cu",
                       "rvc_tpu/ops/pallas_resblock.py:86"),
        "chain_bwd_bf16": ("fused_resblock1_backward[bf16]", "rvc_tpu_torch/csrc/resblock_bwd.cu",
                           "rvc_tpu/ops/pallas_resblock.py:223"),
        "wn_bf16": ("fused_wn[bf16]", "rvc_tpu_torch/csrc/wavenet.cu",
                    "rvc_tpu/ops/pallas_wavenet.py:56"),
        "wn_bwd_bf16": ("fused_wn_backward[bf16]", "rvc_tpu_torch/csrc/wavenet.cu",
                        "rvc_tpu/ops/pallas_wavenet.py:152"),
    }
    checks["chain_bwd_bf16"]["recompute_launches"] = launches["fused_resblock1[bf16]"]
    for key, (kname, src, replaces) in meta.items():
        c = checks[key]
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[kname], "max_abs_err": c["max_abs_err"],
                        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                        "bound_by": c["bound_by"], "library_ms": c.get("library_ms"),
                        **{k: c[k] for k in ("bound_f32_ms", "previous_ms", "mma_sync_ms",
                                             "pack_ms", "float32_ms", "ms_10s",
                                             "previous_ms_10s", "32k_v1", "d256",
                                             "cli_float32_bank", "launches_40k_v2",
                                             "launches_40k_nof0", "launches_32k_v2",
                                             "launches_48k", "launches_nodes",
                                             "launches_dp_rank", "launches_replicas",
                                             "whole_stack",
                                             "recompute_launches") if k in c}})
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
