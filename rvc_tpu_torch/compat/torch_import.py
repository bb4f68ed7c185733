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
  * a UVR5 VR ``.pth`` (the separation route's ``CascadedASPPNet``).

Each returns ``{name: float32 numpy array}`` under the names the port's
modules use, which ``pipelines.convert.VoiceConverter.from_state_dicts``
takes. For inference weight norm is folded as ``compat.weights.
fold_weight_norm`` folds it (``g * v / (|v| + 1e-12)``, the norm over every
axis but 0); ``fold=False`` keeps the pairs, for a training warm start.

The safetensors format is read here (an 8-byte little-endian header
length, a JSON header, the raw buffers), so the ``safetensors`` package is
not needed. ``torch.load`` runs with ``weights_only=True``: both formats
hold only tensors, numbers, strings, lists and dicts, and a user's file
is then never unpickled into arbitrary objects.
"""
from __future__ import annotations

import json
import re
import struct
from typing import Mapping

import numpy as np
import torch

from ..config import SR_MAP
from ..models.hubert import HubertConfig
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
