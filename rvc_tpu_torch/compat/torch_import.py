"""A user's model files -> the port's reference-named state_dicts.

Counterpart of ``rvc_tpu/compat/torch_import.py`` for the files the
conversion and separation paths read:

  * an RVC inference checkpoint ``.pth`` (``cpt["weight"]``, fp16, with
    ``weight_g``/``weight_v`` pairs, and a positional ``config`` list),
  * a ContentVec/HuBERT ``.safetensors`` in HF ``HubertModel`` names, with
    its HF config in the metadata,
  * an RMVPE ``.pt`` (the ``E2E`` state_dict, bare or under ``"model"``),
  * a torchcrepe state_dict (``conv1..conv6``, ``conv{i}_BN``,
    ``classifier``), full or tiny,
  * a UVR5 VR ``.pth`` (the separation route's ``CascadedASPPNet``),
  * a demucs v3/v4 ``.th`` package (``HDemucs``/``HTDemucs``) and a demucs
    v2 Conv-TasNet ``.th``,
  * a UVR/MSST BS-RoFormer or Mel-Band RoFormer ``.ckpt`` (lucidrains'
    names, bare or under a Lightning ``state_dict``), its architecture read
    from the tensors' shapes.

Each returns ``{name: float32 numpy array}`` under the names the port's
modules use, which ``pipelines.convert.VoiceConverter.from_state_dicts``
takes. For inference weight norm is folded as ``compat.weights.
fold_weight_norm`` folds it (``g * v / (|v| + 1e-12)``, the norm over every
axis but 0); ``fold=False`` keeps the pairs, for a training warm start.

The safetensors format is read here (an 8-byte little-endian header
length, a JSON header, the raw buffers), so the ``safetensors`` package is
not needed. ``torch.load`` runs with ``weights_only=True`` but on the
Demucs and RoFormer files: the other formats hold only tensors, numbers, strings, lists
and dicts, and such a file is then never unpickled into arbitrary objects.
A Demucs package pickles its model's class; its loader stubs the modules
the pickle names (as the JAX package's does) and reads only the class's
name.
"""
from __future__ import annotations

import importlib.machinery
import inspect
import json
import re
import struct
import sys
import types
from typing import Mapping

import numpy as np
import torch

from ..config import SR_MAP
from ..models.bs_roformer import BSRoformerConfig
from ..models.hubert import HubertConfig
from ..models.mel_roformer import MelRoformerConfig, mel_band_indices
from .weights import _norm_except_dim0


def _np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def fold_pairs(state: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Every ``X.weight_g``/``X.weight_v`` pair becomes ``X.weight``."""
    out = {}
    for k, v in state.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            base = k[: -len("_v")]
            g = np.asarray(state[base + "_g"], np.float32)
            v = np.asarray(v, np.float32)
            out[base] = g * v / (_norm_except_dim0(v) + 1e-12)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# RVC synthesizer (.pth inference format)
# ---------------------------------------------------------------------------

# the reference names the text encoder's FFN convs conv_1/conv_2; the JAX
# package's exporter writes them conv.1/conv.2 (rvc_tpu/compat/torch_export.py:16-23)
_FFN_DOTTED = re.compile(r"(\.ffn_layers\.\d+)\.conv\.([12])\.")


def synthesizer_state_from_checkpoint(weights: Mapping[str, object],
                                      fold: bool = True) -> dict[str, np.ndarray]:
    """Reference state_dict -> the port's names. Folded (inference), the
    posterior encoder is dropped, as the inference format has none."""
    sd = {_FFN_DOTTED.sub(r"\1.conv_\2.", k): _np32(v) for k, v in weights.items()}
    if not fold:
        return sd
    return {k: v for k, v in fold_pairs(sd).items() if not k.startswith("enc_q.")}


def load_rvc_checkpoint(path: str, fold: bool = True) -> tuple[dict[str, np.ndarray], dict]:
    """A reference RVC ``.pth`` -> (state_dict, metadata). The metadata has
    ``config`` (the positional list, its speaker count ``config[-3]`` taken
    from ``emb_g.weight``'s rows), ``sr``, ``f0``, ``version`` and ``n_spk``."""
    cpt = torch.load(path, map_location="cpu", weights_only=True)
    weights = cpt["weight"]
    n_spk = int(weights["emb_g.weight"].shape[0])
    config = list(cpt["config"])
    config[-3] = n_spk
    meta = {"config": config, "sr": cpt["config"][-1], "f0": cpt.get("f0", 1),
            "version": cpt.get("version", "v1"), "n_spk": n_spk}
    return synthesizer_state_from_checkpoint(weights, fold), meta


def synthesizer_kwargs_from_config(config: list, version: str, use_f0: bool) -> dict:
    """The positional reference config list -> ``Synthesizer`` kwargs (the
    order of the reference's ``SynthesizerTrn*`` constructors); ``sr`` may
    be given as "40k"."""
    (spec_channels, segment_size, inter_channels, hidden_channels, filter_channels,
     n_heads, n_layers, kernel_size, p_dropout, resblock, resblock_kernel_sizes,
     resblock_dilation_sizes, upsample_rates, upsample_initial_channel,
     upsample_kernel_sizes, spk_embed_dim, gin_channels, sr) = config
    if isinstance(sr, str):
        sr = SR_MAP[sr]
    return dict(
        spec_channels=spec_channels, segment_size=segment_size,
        inter_channels=inter_channels, hidden_channels=hidden_channels,
        filter_channels=filter_channels, n_heads=n_heads, n_layers=n_layers,
        kernel_size=kernel_size, p_dropout=p_dropout, resblock=resblock,
        resblock_kernel_sizes=tuple(resblock_kernel_sizes),
        resblock_dilation_sizes=tuple(map(tuple, resblock_dilation_sizes)),
        upsample_rates=tuple(upsample_rates), upsample_initial_channel=upsample_initial_channel,
        upsample_kernel_sizes=tuple(upsample_kernel_sizes), spk_embed_dim=spk_embed_dim,
        gin_channels=gin_channels, sr=sr, feature_dim=256 if version == "v1" else 768,
        use_f0=bool(use_f0))


# ---------------------------------------------------------------------------
# safetensors, HuBERT / ContentVec
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.int16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8}


def read_safetensors(path: str) -> tuple[dict[str, torch.Tensor], dict]:
    """(tensors by name, the header's ``__metadata__``). BF16 buffers are
    read as 16-bit integers and viewed as ``torch.bfloat16``."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    meta = header.pop("__metadata__", None) or {}
    out = {}
    for name, info in header.items():
        dt = info["dtype"]
        if dt not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {dt}")
        b, e = info["data_offsets"]
        arr = np.frombuffer(data[b:e], _ST_DTYPES[dt]).reshape(info["shape"]).copy()
        t = torch.from_numpy(arr)
        out[name] = t.view(torch.bfloat16) if dt == "BF16" else t
    return out, meta


_POS_CONV = "encoder.pos_conv_embed.conv."
# HF names match the port's modules; the positional conv's weight norm comes
# as weight_g/weight_v or as torch's parametrization (original0 = g, 1 = v)
_HUBERT_RENAMES = [
    (_POS_CONV + "parametrizations.weight.original0", _POS_CONV + "weight_g"),
    (_POS_CONV + "parametrizations.weight.original1", _POS_CONV + "weight_v"),
]


def hubert_state_from_hf(state: Mapping[str, object]) -> dict[str, np.ndarray]:
    """HF ``HubertModel`` state (+ ``final_proj``) -> the port's names, the
    positional conv's weight norm (over dim 2: g is (1, 1, k)) folded."""
    sd = {}
    for k, v in state.items():
        if "masked_spec_embed" in k:
            continue
        for old, new in _HUBERT_RENAMES:
            k = k.replace(old, new)
        sd[k] = _np32(v)
    if _POS_CONV + "weight_g" in sd:
        g, v = sd.pop(_POS_CONV + "weight_g"), sd.pop(_POS_CONV + "weight_v")
        axes = tuple(i for i, s in enumerate(g.shape) if s == 1)
        sd[_POS_CONV + "weight"] = g * v / (np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
                                            + 1e-12)
    return sd


def load_hubert_safetensors(path: str) -> tuple[dict[str, np.ndarray], HubertConfig]:
    """content-vec-best.safetensors -> (state_dict, HubertConfig from the
    metadata's ``config``, else the default)."""
    tensors, meta = read_safetensors(path)
    cfg = (HubertConfig.from_hf_dict(json.loads(meta["config"])) if "config" in meta
           else HubertConfig())
    return hubert_state_from_hf(tensors), cfg


# ---------------------------------------------------------------------------
# RMVPE
# ---------------------------------------------------------------------------

def load_rmvpe(path: str) -> dict[str, np.ndarray]:
    """rmvpe.pt (``E2E`` names, bare or as ``{"model": state_dict}``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and hasattr(sd["model"], "keys"):
        sd = sd["model"]
    return {k: _np32(v) for k, v in sd.items() if not k.endswith("num_batches_tracked")}


# ---------------------------------------------------------------------------
# CREPE
# ---------------------------------------------------------------------------

def load_crepe(path: str) -> dict[str, np.ndarray]:
    """A torchcrepe state_dict file (``full.pth`` / ``tiny.pth``), its names
    as they are, ``num_batches_tracked`` left out."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _np32(v) for k, v in sd.items() if not k.endswith("num_batches_tracked")}


# ---------------------------------------------------------------------------
# UVR5 VR networks
# ---------------------------------------------------------------------------

_VR_SKIP = re.compile(r"num_batches_tracked$|^aux\d?_out\.")


def load_vr_pth(path: str) -> dict[str, np.ndarray]:
    """A UVR5 VR ``.pth`` (the state_dict of the reference's
    ``CascadedASPPNet``), its names as they are; the training-only auxiliary
    outputs (``aux1_out``, ``aux2_out``) and ``num_batches_tracked`` left
    out, as the JAX package's loader leaves them. ``load_state_dict`` on the
    port's ``models.vr_network.CascadedASPPNet`` checks the names."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _np32(v) for k, v in sd.items() if not _VR_SKIP.search(k)}


# ---------------------------------------------------------------------------
# Demucs: v3/v4 packages and demucs v2 Conv-TasNet
# ---------------------------------------------------------------------------

_DEMUCS_STUBS = ("demucs", "demucs.htdemucs", "demucs.hdemucs", "demucs.demucs",
                 "demucs.transformer", "demucs.apply", "demucs.states", "demucs.tasnet")


def _install_stub_module(name: str) -> None:
    """Register an empty package ``name`` in ``sys.modules`` (unless a module
    of that name is there already) whose every attribute is a stub class of
    that name, so that unpickling a file that names a class of ``name``
    finds one. A class is made once per name, so a loaded package pickles
    again."""
    if name in sys.modules:
        return
    mod = types.ModuleType(name)
    mod.__spec__ = importlib.machinery.ModuleSpec(name, loader=None, is_package=True)
    mod.__path__ = []

    def _getattr(attr, _m=name, _mod=mod):
        if attr.startswith("__"):
            raise AttributeError(attr)
        kls = type(attr, (), {"__module__": _m, "__qualname__": attr})
        setattr(_mod, attr, kls)
        return kls

    mod.__getattr__ = _getattr
    sys.modules[name] = mod


def _load_pickled(path: str):
    """``torch.load`` of a demucs file, stubbing each module the pickle names
    and that is not importable (``demucs.*``, or a vendored prefix) and
    trying again. ``weights_only=False``: a package pickles its model's
    class (read here only for its ``__name__``), so load only files you
    trust, as with the reference."""
    for name in _DEMUCS_STUBS:
        _install_stub_module(name)
    for _ in range(8):
        try:
            return torch.load(path, map_location="cpu", weights_only=False)
        except ModuleNotFoundError as e:
            parts = (e.name or "").split(".")
            if not parts[0]:
                raise
            for i in range(len(parts)):
                _install_stub_module(".".join(parts[: i + 1]))
    raise RuntimeError(f"could not unpickle {path}")


def load_demucs_v4(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """A demucs v3/v4 ``.th`` package (``{klass, args, kwargs, state}``, the
    state often in float16) -> (float32 state_dict in the reference's names,
    meta). meta: ``klass`` (the class's ``__name__``), ``kwargs`` (the
    constructor's, ``sources`` from ``args[0]`` where only given there),
    ``sources``, ``samplerate``, ``segment`` (a ``Fraction`` made float). A
    bare state_dict gives meta {}. diffq-quantized packages raise."""
    pkg = _load_pickled(path)
    if "state" not in pkg:
        return {k: _np32(v) for k, v in pkg.items()}, {}
    state = pkg["state"]
    if isinstance(state, dict) and state.get("__quantized"):
        raise NotImplementedError("diffq-quantized demucs checkpoints")
    kwargs = dict(pkg.get("kwargs", {}))
    args = list(pkg.get("args", ()))
    if args and "sources" not in kwargs:
        kwargs["sources"] = args[0]
    meta = {"klass": getattr(pkg.get("klass"), "__name__", "HTDemucs"), "kwargs": kwargs,
            "sources": tuple(kwargs.get("sources", ())),
            "samplerate": kwargs.get("samplerate", 44100),
            "segment": float(kwargs.get("segment", 10.0))}
    return {k: _np32(v) for k, v in state.items()}, meta


def htdemucs_kwargs_from_meta(meta: dict) -> dict:
    """The reference constructor's kwargs cut to the keywords the port's
    ``HTDemucs`` (``klass`` "HTDemucs") or ``HDemucs`` (any other class, as
    the JAX package builds it) takes; lists become tuples, ``segment`` a
    float. Training-only options are dropped; sparse attention raises."""
    from ..models.htdemucs import HDemucs, HTDemucs

    klass = HTDemucs if meta.get("klass", "HTDemucs") == "HTDemucs" else HDemucs
    given = meta.get("kwargs", {})
    if given.get("t_sparse_self_attn") or given.get("t_sparse_cross_attn"):
        raise NotImplementedError("sparse attention in the cross-domain transformer")
    names = set(inspect.signature(klass.__init__).parameters) - {"self"}
    out = {k: tuple(v) if isinstance(v, list) else v for k, v in given.items() if k in names}
    if "segment" in out:
        out["segment"] = float(out["segment"])
    return out


def tasnet_state_from_checkpoint(state: Mapping[str, object]) -> tuple[dict[str, np.ndarray],
                                                                        dict]:
    """A demucs v2 Conv-TasNet state_dict -> (float32 state_dict as it is,
    config: N, L, B, H, P, X, R, audio_channels, n_sources, read from the
    shapes and names). BatchNorm ("BN") checkpoints raise."""
    sd = {k: _np32(v) for k, v in state.items()}
    if any("running_mean" in k for k in sd):
        raise NotImplementedError("BatchNorm ('BN') tasnet checkpoints")
    N, ac, L = sd["encoder.conv1d_U.weight"].shape
    B = sd["separator.network.1.weight"].shape[0]
    C = sd["separator.network.3.weight"].shape[0] // N
    blocks = [re.match(r"separator\.network\.2\.(\d+)\.(\d+)\.", k) for k in sd]
    R = 1 + max(int(m.group(1)) for m in blocks if m)
    X = 1 + max(int(m.group(2)) for m in blocks if m)
    P = sd["separator.network.2.0.0.net.3.net.0.weight"].shape[-1]
    H = sd["separator.network.2.0.0.net.0.weight"].shape[0]
    return sd, {"N": N, "L": L, "B": B, "H": H, "P": P, "X": X, "R": R,
                "audio_channels": ac, "n_sources": C}


def load_tasnet(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """A demucs v2 Conv-TasNet ``.th`` (a bare state_dict, as demucs v2
    released them, or a ``{klass, args, kwargs, state}`` package) ->
    ``tasnet_state_from_checkpoint``'s (state_dict, config)."""
    pkg = _load_pickled(path)
    if isinstance(pkg, dict) and "state" in pkg:
        pkg = pkg["state"]
    return tasnet_state_from_checkpoint(pkg)


# a bag of models: the keys and value forms demucs writes (the card's machine
# has no PyYAML): ``key: scalar``, ``key: [flow, list]`` over one or more
# lines, nested, trailing commas allowed, and ``key:`` then ``- item`` lines
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)(?:[eE][-+][0-9]+)?$")
_YAML_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")


def _yaml_scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if _YAML_INT.match(text):
        return int(text.replace("_", ""))
    if _YAML_FLOAT.match(text):
        return float(text.replace("_", ""))
    return {"true": True, "false": False, "null": None, "~": None, "": None}.get(
        text.lower(), text)


def _yaml_flow(text: str):
    """A flow sequence ``[a, [b, c], ...]`` -> nested lists of scalars."""
    stack, item, quote = [[]], "", None
    for ch in text:
        if quote:
            item += ch
            quote = None if ch == quote else quote
        elif ch in "'\"":
            item, quote = item + ch, ch
        elif ch == "[":
            stack.append([])
        elif ch in ",]":
            if item.strip():
                stack[-1].append(_yaml_scalar(item))
            item = ""
            if ch == "]":
                done = stack.pop()
                stack[-1].append(done)
        else:
            item += ch
    return stack[0][0]


def read_demucs_bag(path: str) -> dict:
    """A demucs bag-of-models ``.yaml`` -> {key: value} for its top-level
    keys (``models``, ``weights``, ``segment``), as ``yaml.safe_load`` reads
    the forms demucs writes."""
    out, key, pending = {}, None, ""
    with open(path) as f:
        lines = [ln.split(" #")[0].rstrip() for ln in f if not ln.lstrip().startswith("#")]
    for line in lines:
        if not line.strip():
            continue
        if pending:
            pending += " " + line.strip()
        elif line[0] not in " -\t" and ":" in line:
            key, _, rest = line.partition(":")
            key, rest = key.strip(), rest.strip()
            if rest.startswith("["):
                pending = rest
            else:
                out[key] = _yaml_scalar(rest) if rest else None
        elif line.lstrip().startswith("-") and key is not None:
            item = line.lstrip()[1:].strip()
            out[key] = out[key] or []
            out[key].append(_yaml_flow(item) if item.startswith("[") else _yaml_scalar(item))
        else:
            raise ValueError(f"{path}: cannot read line {line!r}")
        if pending and pending.count("[") == pending.count("]"):
            out[key], pending = _yaml_flow(pending), ""
    if pending:
        raise ValueError(f"{path}: unclosed list under {key!r}")
    return out


# ---------------------------------------------------------------------------
# BS-RoFormer and Mel-Band RoFormer (.ckpt, lucidrains/MSST layout)
# ---------------------------------------------------------------------------

# tensors the modules recompute: the rotary frequencies, the STFT window,
# the mel band layout's buffers
_ROFORMER_SKIP = re.compile(r"rotary_embed\.|multi_stft|stft_window|window_fn|freq_indices"
                            r"|freqs_per_band|num_freqs_per_band|num_bands_per_freq")


def _read_roformer_ckpt(path: str) -> dict:
    """The state dict of a UVR/MSST ``.ckpt``: bare, or under ``state_dict``
    (a Lightning checkpoint), with any ``model.`` prefix stripped.
    ``weights_only=False``, as the JAX package reads it: a Lightning
    checkpoint pickles its hyper-parameters; load only files you trust."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k[6:] if k.startswith("model.") else k: v for k, v in sd.items()}


def _roformer_shapes(sd: Mapping[str, object], what: str) -> dict:
    """The hyperparameters both RoFormers read from their tensors' shapes
    (``rvc_tpu/compat/torch_import.py``'s two inferers, line for line):
    the band widths, dim, depths, heads, dim_head, ff_mult, stems, mask
    depth, mlp expansion and whether the axial transformers end in a norm."""
    dims_in = []
    while f"band_split.to_features.{len(dims_in)}.1.weight" in sd:
        dims_in.append(int(sd[f"band_split.to_features.{len(dims_in)}.1.weight"].shape[1]))
    if not dims_in:
        raise ValueError(f"not a {what} state dict (no band_split keys)")
    dim = int(sd["band_split.to_features.0.1.weight"].shape[0])
    depth = 0
    while f"layers.{depth}.0.layers.0.0.to_qkv.weight" in sd:
        depth += 1
    if depth == 0:
        raise ValueError(f"no transformer layers found (layers.0.0.layers.0.0.to_qkv.weight "
                         f"missing) in the {what} state dict")
    t_depth = 0
    while f"layers.0.0.layers.{t_depth}.0.to_qkv.weight" in sd:
        t_depth += 1
    f_depth = 0
    while f"layers.0.1.layers.{f_depth}.0.to_qkv.weight" in sd:
        f_depth += 1
    heads = int(sd["layers.0.0.layers.0.0.to_gates.weight"].shape[0])
    num_stems = 0
    while f"mask_estimators.{num_stems}.to_freqs.0.0.0.weight" in sd:
        num_stems += 1
    est_depth = 0
    while f"mask_estimators.0.to_freqs.0.0.{2 * est_depth}.weight" in sd:
        est_depth += 1
    mlp_exp = 4
    if est_depth > 1:
        mlp_exp = int(sd["mask_estimators.0.to_freqs.0.0.0.weight"].shape[0]) // dim
    return dict(
        dims_in=dims_in, dim=dim, depth=depth, time_transformer_depth=t_depth,
        freq_transformer_depth=f_depth, heads=heads,
        dim_head=int(sd["layers.0.0.layers.0.0.to_qkv.weight"].shape[0]) // (3 * heads),
        ff_mult=int(sd["layers.0.0.layers.0.1.net.1.weight"].shape[0]) // dim,
        num_stems=num_stems, mask_estimator_depth=est_depth, mlp_expansion_factor=mlp_exp,
        transformer_norm_output="layers.0.0.norm.gamma" in sd)


def bs_roformer_config_from_state_dict(state_dict: Mapping[str, object]) -> BSRoformerConfig:
    """A ``BSRoformerConfig`` from the tensors' shapes. The channel count is
    the one of {1, 2} that gives an odd bin count (n_fft // 2 + 1 is odd for
    every even n_fft) with every band width divisible by 2 channels; a
    checkpoint holding ``freq_indices`` is a Mel-Band RoFormer and raises."""
    if any("freq_indices" in k for k in state_dict):
        raise ValueError(
            "this looks like a Mel-Band RoFormer checkpoint (freq_indices buffer present); "
            "overlapping mel bands are a different architecture: load it with "
            "load_mel_roformer")
    s = _roformer_shapes(state_dict, "BS-RoFormer")
    dims_in = s.pop("dims_in")
    total = sum(dims_in)  # 2 * channels * (n_fft // 2 + 1)
    candidates = [ch for ch in (1, 2)
                  if total % (2 * ch) == 0 and (total // (2 * ch)) % 2 == 1
                  and all(d % (2 * ch) == 0 for d in dims_in)]
    if len(candidates) != 1:
        raise ValueError(f"cannot infer the channel count from band widths {dims_in} "
                         f"(total {total}): no unique ch in {{1, 2}} gives an odd "
                         "n_fft // 2 + 1 bin count")
    ch = candidates[0]
    return BSRoformerConfig(stereo=ch == 2, n_fft=(total // (2 * ch) - 1) * 2,
                            freqs_per_bands=tuple(d // (2 * ch) for d in dims_in), **s)


def mel_roformer_config_from_state_dict(state_dict: Mapping[str, object]) -> MelRoformerConfig:
    """A ``MelRoformerConfig`` from the tensors' shapes and the
    ``freq_indices`` buffer where the checkpoint holds one (stereo when every
    entry's channel sibling ``v ^ 1`` is there and the slots split into an
    odd bin count over 2 channels). Without it the layout at 44.1 kHz is
    rebuilt from the mel filterbank, stereo tried first, n_fft 2048, 4096
    then 1024, and must give the checkpoint's band widths."""
    s = _roformer_shapes(state_dict, "Mel-Band RoFormer")
    widths = tuple(d // 2 for d in s.pop("dims_in"))  # (real, imag) pairs -> entries
    freq_indices = None
    for key in ("freq_indices", "model.freq_indices"):
        if key in state_dict:
            freq_indices = tuple(int(v) for v in np.asarray(state_dict[key]).reshape(-1))
            break
    if freq_indices is not None:
        FS = max(freq_indices) + 1
        idxset = set(freq_indices)
        stereo = (FS % 2 == 0 and (FS // 2) % 2 == 1
                  and all((v ^ 1) in idxset for v in freq_indices))
        n_fft = (FS // (2 if stereo else 1) - 1) * 2
    else:
        match = None
        for ch in (2, 1):
            if all(w % ch == 0 for w in widths):
                for n_fft in (2048, 4096, 1024):
                    idx, w = mel_band_indices(44100, n_fft, len(widths), ch)
                    if w == widths:
                        match = (idx, ch, n_fft)
                        break
            if match:
                break
        if match is None:
            raise ValueError(
                f"cannot rebuild the mel band layout for widths {widths[:8]}...: the "
                "checkpoint has no freq_indices buffer and no standard layout (44.1 kHz, "
                "n_fft 1024, 2048 or 4096) matches")
        freq_indices, ch, n_fft = match
        stereo = ch == 2
    return MelRoformerConfig(stereo=stereo, num_bands=len(widths), n_fft=n_fft,
                             freq_indices=freq_indices, band_widths=widths, **s)


def _roformer_state(sd: Mapping[str, object]) -> dict[str, np.ndarray]:
    return {k: _np32(v) for k, v in sd.items() if not _ROFORMER_SKIP.search(k)}


def load_bs_roformer(path: str) -> tuple[dict[str, np.ndarray], BSRoformerConfig]:
    """(float32 state_dict in lucidrains' names, BSRoformerConfig) from a
    UVR/MSST ``.ckpt``; ``BSRoformer``'s strict ``load_state_dict`` checks
    every name and shape."""
    sd = _read_roformer_ckpt(path)
    return _roformer_state(sd), bs_roformer_config_from_state_dict(sd)


def load_mel_roformer(path: str) -> tuple[dict[str, np.ndarray], MelRoformerConfig]:
    """(float32 state_dict in lucidrains' names, MelRoformerConfig) from a
    UVR/MSST ``.ckpt``, the band buffers left out."""
    sd = _read_roformer_ckpt(path)
    return _roformer_state(sd), mel_roformer_config_from_state_dict(sd)
