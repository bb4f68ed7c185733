"""Vocal / instrumental separation: the VR, MDX-Net, Demucs and RoFormer routes.

Counterpart of ``rvc_tpu/pipelines/separate.py`` (the reference's
``uvr5_cli.py``, ``lib/separators.py`` and ``demucs/apply.py``) for its
``vr``, ``vr_new``, ``mdx``, ``demucs``, ``bs_roformer`` and ``mel_roformer`` kinds:

  * ``VRSeparator``: the 4-band ``CascadedASPPNet`` route. Per-band STFTs
    build the composite magnitude spectrogram (``ops.bands``), the network
    predicts a mask over 512-frame windows, and the masked spectrogram goes
    back through the per-band iSTFTs with the high end mirrored. Band
    analysis, network and synthesis run on the separator's device; the
    windows go through the network together, ``VR_WINDOWS_PER_CALL`` at a
    time. The JAX package's one batch also carries a last window whose
    output it crops away whole; the port runs the reference's window count.
    (The JAX package's ``FusedVRSeparator`` fuses this chain for the TPU's
    link: the same function, not ported as a second class.)
  * ``MDXSeparator``: the Conv-TDF route. The song is cut into ``chunks``-
    second segments overlapping by ``margin`` samples, each segment into
    windows that go through the complex-as-channels STFT, the network and
    the iSTFT, ``MDX_WINDOWS_PER_CALL`` windows at a time; the margins are
    trimmed and the segments joined. The JAX package pads the window count
    to a multiple of 8 so that its compiled shapes are reused; each window
    is its own sample, so the port runs the windows there are.
  * ``route_separator`` picks the kind from the model file's name, and
    ``load_separator`` builds the separator from the file
    (``rvc_tpu/graph/nodes.py::_load_separator``); the ``bs_roformer`` and
    ``mel_roformer`` kinds are the separators of ``models/bs_roformer.py``
    and ``models/mel_roformer.py``.

Every separator runs on the card unless ``device="cpu"`` is asked for, and
raises without a card (``device.resolve_device``). ``dtype`` (float32 by
default, or bfloat16) is its network's compute dtype, as the JAX
separators' ``dtype``: the parameters stay float32 and are cast at use
(``models.layers.set_dtype_``); the STFTs, the masks' products with the
spectrogram, the iSTFTs, the overlap-adds and int16 stay float32. ``run_inference(audio,
sr, events=)`` appends (stage, CUDA event) pairs to ``events`` when given:
"start", then "analysis", "network" and "synthesis" as each stage's work
is queued (the MDX stages once per group of windows; Demucs's stages are
its own, ``DemucsSeparator.run_inference``).
"""
from __future__ import annotations

import glob
import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as _ss

from ..compat.onnx_import import convtdf_state_from_onnx
from ..compat.torch_import import (htdemucs_kwargs_from_meta, load_bs_roformer, load_demucs_v4,
                                   load_mel_roformer, load_tasnet, load_vr_pth, read_demucs_bag)
from ..device import mark, resolve_device, set_float32_math
from ..io.audio import remix_audio
from ..models.bs_roformer import BSRoformerSeparator
from ..models.demucs import apply_model
from ..models.htdemucs import HDemucs, HTDemucs
from ..models.layers import load_numpy_state_dict, set_dtype_
from ..models.mdx_net import ConvTDFNetTrim, MDXSpectrogram
from ..models.mel_roformer import MelRoformerSeparator
from ..models.tasnet import ConvTasNet
from ..models.vr_network import CascadedASPPNet
from ..ops import bands as B
from ..ops.resample import resample

VR_WINDOWS_PER_CALL = 4    # 512-frame windows of the 4-band layout a network call
# (keeps a long song's activations from growing with its length; the size of
# the group was not measured: at 30 s on the card the peak is cuDNN's
# workspace for the dilated depthwise convs, the same at 4 or 16 windows)
MDX_WINDOWS_PER_CALL = 8   # 256-frame windows of 3072 bins a network call


def make_padding(width: int, cropsize: int, offset: int) -> tuple[int, int, int]:
    """(left, right, roi_size) of the window padding (reference
    spec_utils.make_padding)."""
    left = offset
    roi_size = cropsize - left * 2
    if roi_size == 0:
        roi_size = cropsize
    right = roi_size - (width % roi_size) + left
    return left, right, roi_size


class VRSeparator:
    """CascadedASPPNet inference over the multi-band composite spectrogram.
    ``state_dict``: {reference name: array} (``compat.torch_import.
    load_vr_pth``); ``model_params``: the band layout (``ops.bands.
    ModelParameters``, 2-band ``DEFAULT_PARAM`` if None). In bfloat16 the
    mask comes out of the network in float32 (the aggressiveness exponent
    is taken there, as JAX's float32 ``value`` promotes it)."""

    def __init__(self, state_dict: dict, model_params: B.ModelParameters | None = None,
                 agg: float = 10.0, window_size: int = 512, tta: bool = False,
                 high_end_process: str = "mirroring", device=None,
                 dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        set_float32_math()
        self.mp = model_params or B.ModelParameters()
        self.model = set_dtype_(CascadedASPPNet(self.mp.param["bins"] * 2), dtype)
        load_numpy_state_dict(self.model, state_dict)
        self.model.to(self.device).eval()
        self.offset = self.model.offset
        self.window_size = window_size
        self.agg = agg
        self.tta = tta
        self.high_end_process = high_end_process

    def _predict_mask(self, X_pad: torch.Tensor, roi_size: int, n_window: int,
                      aggressiveness: dict) -> torch.Tensor:
        """The mask over ``n_window`` windows of X_pad (2, bins, frames),
        window i covering frames [i roi, i roi + window_size), each cropped by
        the model's offset on both sides and joined: (2, bins, n_window roi)."""
        ws = self.window_size
        wins = X_pad[..., : (n_window - 1) * roi_size + ws].unfold(2, ws, roi_size)
        wins = wins.permute(2, 0, 1, 3)  # (N, 2, bins, ws)
        masks = [self.model(wins[i: i + VR_WINDOWS_PER_CALL].contiguous(), aggressiveness)
                 for i in range(0, n_window, VR_WINDOWS_PER_CALL)]
        mask = torch.cat(masks)[..., self.offset: ws - self.offset]
        return mask.permute(1, 2, 0, 3).reshape(2, mask.shape[2], -1)

    @torch.no_grad()
    def separate_spec(self, X_spec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Composite complex spectrogram (2, bins + 1, frames) ->
        (instrumental, vocal) spectrograms: the mask times the mix's
        magnitude, with the mix's phase (magnitude * exp(i angle)), and the
        rest. The reference's net returns mask * mix; the JAX package's
        takes mask * max|X| in every bin (ROADMAP §3, "Kept in mind")."""
        X_mag = X_spec.abs()
        X_phase = torch.angle(X_spec)
        coef = X_mag.max()
        X_pre = X_mag / torch.clamp(coef, min=1e-9)
        n_frame = X_pre.shape[2]
        pad_l, pad_r, roi = make_padding(n_frame, self.window_size, self.offset)
        n_window = -(-n_frame // roi)
        agg = {"split_bin": self.mp.param["band"][1]["crop_stop"], "value": self.agg / 100.0}
        pred = self._predict_mask(F.pad(X_pre, (pad_l, pad_r)), roi, n_window, agg)
        pred = pred[..., :n_frame]
        if self.tta:
            X_pad2 = F.pad(X_pre, (pad_l + roi // 2, pad_r + roi // 2))
            pred2 = self._predict_mask(X_pad2, roi, n_window + 1, agg)
            pred = 0.5 * (pred + pred2[..., roi // 2:][..., :n_frame])
        y_spec = (pred * X_mag) * torch.exp(1j * X_phase)
        return y_spec, X_spec - y_spec

    @torch.no_grad()
    def run_inference(self, audio: np.ndarray, sr: int, events: list | None = None) -> dict:
        """audio (T,), (1, T) or (2, T) at any rate -> {"sr", "vocals",
        "instrumentals" (int16 mono, each as (audio, sr)), "input_audio"}
        (reference UVR5Base.run_inference, lib/separators.py:186-247); one
        channel is doubled."""
        p = self.mp.param
        bands_n = len(p["band"])
        ms, msb2, rev = p["mid_side"], p["mid_side_b2"], p["reverse"]
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        if audio.shape[0] == 1:
            audio = np.vstack([audio, audio])
        x = torch.from_numpy(audio).to(self.device)
        mark(events, "start")
        X_wave, X_spec = {}, {}
        input_high_end = input_high_end_h = None
        for d in range(bands_n, 0, -1):
            bp = p["band"][d]
            if d == bands_n:
                X_wave[d] = resample(x, sr, bp["sr"])
            else:
                X_wave[d] = resample(X_wave[d + 1], p["band"][d + 1]["sr"], bp["sr"])
            X_spec[d] = B.wave_to_spectrogram(X_wave[d], bp["hl"], bp["n_fft"], ms, msb2, rev)
            if d == bands_n and self.high_end_process != "none":
                input_high_end_h = (bp["n_fft"] // 2 - bp["crop_stop"]) + (
                    p["pre_filter_stop"] - p["pre_filter_start"])
                input_high_end = X_spec[d][:, bp["n_fft"] // 2 - input_high_end_h:
                                           bp["n_fft"] // 2]
        X_spec_m = B.combine_spectrograms(X_spec, self.mp)
        mark(events, "analysis")
        y_spec, v_spec = self.separate_spec(X_spec_m)
        mark(events, "network")
        waves = {}
        for name, spec in (("instrumentals", y_spec), ("vocals", v_spec)):
            if self.high_end_process.startswith("mirroring") and input_high_end is not None:
                he = B.mirroring(self.high_end_process, spec, input_high_end, self.mp)
                waves[name] = B.cmb_spectrogram_to_wave(spec, self.mp, input_high_end_h, he)
            else:
                waves[name] = B.cmb_spectrogram_to_wave(spec, self.mp)
        mark(events, "synthesis")
        out = {"sr": p["sr"]}
        for name, wav in waves.items():
            out[name] = remix_audio((wav.cpu().numpy(), p["sr"]), to_int16=True, axis=0)
        out["input_audio"] = (audio, sr)
        return out


def _to_stereo_44k(audio: np.ndarray, sr: int) -> np.ndarray:
    """(C, T) -> (2, T) float32 at 44.1 kHz, channels kept (a mono input
    doubled), through scipy's resample_poly (rvc_tpu/pipelines/karafan.py:131)."""
    audio = np.atleast_2d(np.asarray(audio, np.float32))
    if audio.shape[0] == 1:
        audio = np.vstack([audio, audio])
    if sr != 44100:
        g = math.gcd(sr, 44100)
        audio = _ss.resample_poly(audio, 44100 // g, sr // g, axis=-1).astype(np.float32)
    return audio


def stereo_int16(stems: torch.Tensor) -> np.ndarray:
    """(N, C, T) float -> (N, C, T) int16 on the host, each stem divided by
    its peak over 0.95 where that is above 1, times 32768, clipped to
    +-32767 (the JAX package's ``_stereo_int16``, on the stems' device)."""
    peak = stems.abs().amax(dim=(1, 2), keepdim=True) / 0.95
    scaled = stems / torch.where(peak > 1, peak, torch.ones_like(peak))
    return (scaled * 32768.0).clamp(-32767, 32767).to(torch.int16).cpu().numpy()


class MDXSeparator:
    """Conv-TDF demixer with chunk/margin segments (reference MDXModel).
    ``weights``: the path of a UVR MDX ``.onnx`` file, or {name: array} for
    ``net`` (a ``ConvTDFNetTrim``, the UVR MDX-Net Inst layout if None). In
    bfloat16 the network's output goes up to float32 before the iSTFT."""

    def __init__(self, weights, dim_f: int = 3072, dim_t: int = 256, n_fft: int = 6144,
                 hop: int = 1024, stem_name: str = "Vocals", compensation: float = 1.0,
                 margin: int = 44100, chunks: int = 15, denoise: bool = False,
                 net: ConvTDFNetTrim | None = None, device=None,
                 dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        set_float32_math()
        self.spec = MDXSpectrogram(dim_f, 2 ** dim_t if dim_t < 32 else dim_t, n_fft, hop)
        self.net = set_dtype_(net or ConvTDFNetTrim(dim_f=dim_f), dtype)
        if isinstance(weights, str):
            weights = convtdf_state_from_onnx(weights, self.net)
        load_numpy_state_dict(self.net, weights)
        self.net.to(self.device).eval()
        self.stem_name = stem_name
        self.compensation = compensation
        self.margin = margin
        self.chunks = chunks
        self.denoise = denoise

    def _run(self, waves: torch.Tensor, events: list | None) -> torch.Tensor:
        """(N, 2, chunk_size) windows -> the predicted stem's windows."""
        sp = self.spec
        spek = sp.pack(waves) * self.compensation
        spek[..., :3] = 0  # the three lowest bins (reference lib/mdx.py:137)
        mark(events, "analysis")
        if self.denoise:
            pred = self.net(spek) * 0.5 - self.net(-spek) * 0.5
        else:
            pred = self.net(spek)
        mark(events, "network")
        out = sp.unpack(pred)
        mark(events, "synthesis")
        return out

    @torch.no_grad()
    def demix(self, mix: torch.Tensor, events: list | None = None) -> torch.Tensor:
        """mix (2, T) at 44.1 kHz on the separator's device -> the predicted
        stem (2, T)."""
        sp = self.spec
        n_sample = mix.shape[1]
        chunk_size = self.chunks * 44100 if self.chunks > 0 else n_sample
        margin = min(self.margin, chunk_size)
        segments = []
        for skip in range(0, n_sample, chunk_size):
            start = max(0, skip - (margin if skip else 0))
            end = min(skip + chunk_size + margin, n_sample)
            segments.append((start, end, 0 if skip == 0 else margin))
            if end == n_sample:
                break
        windows, counts = [], []
        for start, end, _ in segments:
            n = end - start
            pad = sp.gen_size - n % sp.gen_size
            seg = F.pad(mix[:, start:end], (sp.trim, pad + sp.trim))
            w = seg.unfold(1, sp.chunk_size, sp.gen_size).transpose(0, 1)  # (N, 2, chunk)
            windows.append(w)
            counts.append(w.shape[0])
        batch = torch.cat(windows)
        tar = torch.cat([self._run(batch[i: i + MDX_WINDOWS_PER_CALL], events)
                         for i in range(0, len(batch), MDX_WINDOWS_PER_CALL)])
        tar = tar[..., sp.trim: -sp.trim]  # (N, 2, gen_size)
        outs, off = [], 0
        for i, ((start, end, head), cnt) in enumerate(zip(segments, counts)):
            seg = tar[off: off + cnt].transpose(0, 1).reshape(2, -1)[:, : end - start]
            off += cnt
            tail = None if (i == len(segments) - 1 or margin == 0) else -margin
            outs.append(seg[:, head:tail] / self.compensation)
        return torch.cat(outs, dim=-1)

    @torch.no_grad()
    def run_inference(self, audio: np.ndarray, sr: int, events: list | None = None) -> dict:
        """audio (T,) or (C, T) at any rate -> {"sr": 44100, "vocals",
        "instrumentals" (int16 mono, each as (audio, sr)), "input_audio"}."""
        mix = _to_stereo_44k(audio, sr)
        x = torch.from_numpy(mix).to(self.device)
        mark(events, "start")
        primary = self.demix(x, events)
        secondary = x[:, : primary.shape[1]] - primary
        primary, secondary = primary.cpu().numpy(), secondary.cpu().numpy()
        vocals, instrumental = ((secondary, primary) if "instrument" in self.stem_name.lower()
                                else (primary, secondary))
        return {"sr": 44100,
                "vocals": remix_audio((vocals, 44100), to_int16=True, axis=0),
                "instrumentals": remix_audio((instrumental, 44100), to_int16=True, axis=0),
                "input_audio": (mix, 44100)}


class DemucsSeparator:
    """The Demucs route (reference demucs/apply.py's drive): ``apply_model``
    over the song's chunks with the model from ``model_path``, one of
      * a demucs v3/v4 ``.th`` package: ``HTDemucs`` for that ``klass``,
        else ``HDemucs`` (as the JAX package builds it), its segment the
        package's;
      * a demucs v2 Conv-TasNet ``.th`` (the file name holds "tasnet"), 8 s
        segments;
      * a bag of models: a ``.yaml`` (``models``: signatures, ``weights``:
        a row of per-source weights a model, ``segment``) beside the members'
        ``<signature>*.th``; the stems are the weighted per-source average.
    Every stem of the model is returned as stereo int16, and with a
    ``vocals`` source ``instrumentals`` = mix - vocals. ``dtype``: every
    model's compute dtype; the stems come out of each in float32."""

    def __init__(self, model_path: str, segment: float | None = None, overlap: float = 0.25,
                 shifts: int = 1, device=None, dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        set_float32_math()
        self.overlap, self.shifts = overlap, shifts
        self.sub: list[DemucsSeparator] = []
        self.weights: list = []
        self.model = None
        if "tasnet" in os.path.basename(model_path).lower():
            state, cfg = load_tasnet(model_path)
            n_src = cfg.pop("n_sources")
            sources = (("drums", "bass", "other", "vocals") if n_src == 4
                       else tuple(f"source_{i}" for i in range(n_src)))
            self.model = ConvTasNet(sources=sources, **cfg)
            self.samplerate = 44100
            # the reference's segment_length, 44100 * 2 * 4 samples over stereo: 8 s
            self.segment_samples = int(float(segment or 8.0) * self.samplerate)
        elif model_path.endswith((".yaml", ".yml")):
            bag = read_demucs_bag(model_path)
            folder = os.path.dirname(os.path.abspath(model_path))
            for sig in bag["models"]:
                found = (sorted(glob.glob(os.path.join(folder, f"{sig}*.th")))
                         or sorted(glob.glob(os.path.join(folder, f"{sig}*.ckpt"))))
                if not found:
                    raise FileNotFoundError(f"bag member {sig}*.th in {folder}")
                self.sub.append(DemucsSeparator(found[0], bag.get("segment", segment),
                                                overlap, shifts, self.device, dtype))
            sources = self.sub[0].sources
            self.samplerate = self.sub[0].samplerate
            self.segment_samples = self.sub[0].segment_samples
            self.weights = bag.get("weights") or [[1.0] * len(sources) for _ in self.sub]
        else:
            state, meta = load_demucs_v4(model_path)
            klass = HTDemucs if meta.get("klass", "HTDemucs") == "HTDemucs" else HDemucs
            self.model = klass(**htdemucs_kwargs_from_meta(meta))
            sources = meta.get("sources") or self.model.sources
            self.samplerate = int(meta.get("samplerate", 44100))
            seg = segment if segment is not None else meta.get("segment", 10.0)
            self.segment_samples = int(float(seg) * self.samplerate)
        if self.model is not None:
            load_numpy_state_dict(set_dtype_(self.model, dtype), state)
            self.model.to(self.device).eval()
        self.sources = list(sources)

    @torch.no_grad()
    def demix(self, mix: torch.Tensor, events: list | None = None) -> torch.Tensor:
        """mix (C, T) float32 on the separator's device -> stems (S, C, T);
        for a bag the weighted per-source average over its members."""
        if not self.sub:
            return apply_model(self.model, mix, self.segment_samples, overlap=self.overlap,
                               shifts=self.shifts, events=events)
        est = None
        for sep, w in zip(self.sub, self.weights):
            w = torch.tensor(w, dtype=torch.float32, device=mix.device)[:, None, None]
            out = sep.demix(mix, events) * w
            est = out if est is None else est + out
        totals = torch.tensor(np.sum(np.asarray(self.weights, np.float64), axis=0),
                              dtype=torch.float32, device=mix.device)
        return est / totals[:, None, None]

    @torch.no_grad()
    def run_inference(self, audio: np.ndarray, sr: int, events: list | None = None) -> dict:
        """audio (T,) or (C, T) at any rate -> {"sr", "input_audio", one
        (int16 (C, T), sr) per source, and "instrumentals" with a vocals
        source}. ``events``: "start", then per chunk group "chunking",
        "stft", "network", "istft" (the hybrids), "overlap-add", and "int16"."""
        mix = np.atleast_2d(np.asarray(audio, np.float32))
        if self.samplerate == 44100:
            mix = _to_stereo_44k(mix, sr)
        x = torch.from_numpy(mix).to(self.device)
        if self.samplerate != 44100:
            x = resample(x, sr, self.samplerate)
            if x.shape[0] == 1:
                x = torch.cat([x, x])
            mix = x.cpu().numpy()
        mark(events, "start")
        stems = self.demix(x, events)
        names = list(self.sources)
        if "vocals" in names:
            v = stems[names.index("vocals")]
            stems = torch.cat([stems, (x[:, : v.shape[1]] - v)[None]])
            names.append("instrumentals")
        ints = stereo_int16(stems)
        mark(events, "int16")
        out = {"sr": self.samplerate, "input_audio": (mix, self.samplerate)}
        out.update({name: (ints[i], self.samplerate) for i, name in enumerate(names)})
        return out


def route_separator(model_path: str) -> str:
    """The separator kind a model file's name asks for (reference
    uvr5_cli.py:24-64, with Demucs and RoFormer checkpoints)."""
    name = os.path.basename(model_path).lower()
    if "roformer" in name:
        return "mel_roformer" if "mel" in name else "bs_roformer"
    if name.endswith((".th", ".yaml")) or "demucs" in name or "tasnet" in name:
        return "demucs"
    if "mdx" in name:
        return "mdx"
    if any(k in name for k in ("reverb", "echo", "dereverb")):
        return "vr_new"
    return "vr"


def load_separator(kind: str, model_path: str, agg: float = 10.0, device=None,
                   dtype: torch.dtype = torch.float32):
    """A separator of ``kind`` (``route_separator``) from ``model_path``:
    ``vr`` and ``vr_new`` read a UVR5 ``.pth`` into the 4-band
    ``CascadedASPPNet`` (``ModelParameters(preset="4band_v2")``, ``agg``),
    ``mdx`` an ``.onnx`` into ``ConvTDFNetTrim`` at the UVR defaults,
    ``demucs`` a ``.th`` or a bag ``.yaml`` into a ``DemucsSeparator``,
    ``bs_roformer`` and ``mel_roformer`` a UVR/MSST ``.ckpt`` into a
    ``BSRoformerSeparator`` or ``MelRoformerSeparator`` (the architecture
    read from the tensors' shapes); its network computes in ``dtype``.

    bf16 is not faster for every route: the Demucs BLSTMs step JAX's
    roundings one recurrence at a time (``layers.lstm``; replayed as a CUDA
    graph on the card), and HDemucs in bf16 separated 30 s at 237x real
    time against 257x in float32 (chip_smoke phase 26, NVIDIA H100 80GB
    HBM3 at 700 W); the v2 Demucs, whose BLSTM steps alike, was not
    measured."""
    device = resolve_device(device)
    if kind in ("vr", "vr_new"):
        return VRSeparator(load_vr_pth(model_path), B.ModelParameters(preset="4band_v2"),
                           agg=agg, device=device, dtype=dtype)
    if kind == "mdx":
        return MDXSeparator(model_path, device=device, dtype=dtype)
    if kind == "demucs":
        return DemucsSeparator(model_path, device=device, dtype=dtype)
    if kind == "bs_roformer":
        return BSRoformerSeparator(*load_bs_roformer(model_path), device=device, dtype=dtype)
    if kind == "mel_roformer":
        return MelRoformerSeparator(*load_mel_roformer(model_path), device=device, dtype=dtype)
    raise ValueError(f"unknown separator kind {kind!r}")
