"""JAX parameter trees -> the port's state_dicts.

The JAX package stores torch-layout weights under flax paths that mirror
the reference's state_dict names (``a/b_0/c`` for ``a.b.0.c``). Given such
a tree as nested dicts of numpy arrays (``jax.tree.map(np.asarray, p)``),
these functions fold weight norm into plain weights (the reference's
``remove_weight_norm``) and rename the keys to the reference's torch names:
the RVC synthesizer, HuBERT/ContentVec (HF ``HubertModel`` names) and
RMVPE (``E2E`` names). For inference a ``weight_g``/``weight_v`` pair
becomes one ``weight``; for training (``fold=False``) the pair is kept under
the names of the reference's ``G_*.pth`` / ``D_*.pth`` checkpoints, which
the port's layers take after ``models.layers.live_weight_norm_``.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np


# module names that end in _N without being a ModuleList index (attentions.FFN)
_NOT_INDEXED = ("conv_1", "conv_2")


def flax_path_to_torch_key(path: tuple[str, ...]) -> str:
    """One trailing ``_N`` per component becomes ``.N`` (ModuleList index),
    except in the FFN's ``conv_1``/``conv_2``, which the reference names so."""
    parts = []
    for p in path:
        m = re.match(r"^(.*)_(\d+)$", p)
        parts.append(f"{m.group(1)}.{m.group(2)}" if m and p not in _NOT_INDEXED else p)
    return ".".join(parts)


def flatten_tree(tree: Mapping, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _norm_except_dim0(v: np.ndarray) -> np.ndarray:
    axes = tuple(range(1, v.ndim))
    return np.sqrt(np.sum(v * v, axis=axes, keepdims=True))


def fold_weight_norm(tree: Mapping) -> dict:
    """Replace every {weight_v, weight_g} pair by ``g * v / |v|`` (norm over
    all axes but 0, as the JAX modules parameterize it)."""
    if not isinstance(tree, Mapping):
        return tree
    if "weight_v" in tree and "weight_g" in tree:
        v = np.asarray(tree["weight_v"], np.float32)
        g = np.asarray(tree["weight_g"], np.float32)
        w = g * v / (_norm_except_dim0(v) + 1e-12)
        rest = {k: fold_weight_norm(x) for k, x in tree.items()
                if k not in ("weight_v", "weight_g")}
        return {"weight": w, **rest}
    return {k: fold_weight_norm(x) for k, x in tree.items()}


def _state_dict(params: Mapping, rename, fold: bool = True) -> dict[str, np.ndarray]:
    tree = params.get("params", params)
    if fold:
        tree = fold_weight_norm(tree)
    return {rename(path): np.ascontiguousarray(arr, np.float32)
            for path, arr in flatten_tree(tree).items()}


def synthesizer_state_dict(params: Mapping, fold: bool = True) -> dict[str, np.ndarray]:
    """RVC synthesizer: the generic ``_N -> .N`` rule gives the reference
    names. Folded (inference), the posterior encoder is dropped; unfolded
    (training) it stays, with every ``weight_v``/``weight_g``."""
    sd = _state_dict(params, flax_path_to_torch_key, fold)
    return {k: v for k, v in sd.items() if not (fold and k.startswith("enc_q."))}


def discriminator_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """MultiPeriodDiscriminator, unfolded: ``discriminators.{i}.convs.{j}.
    weight_v`` and so on, the reference's ``D_*.pth`` names."""
    return _state_dict(params, flax_path_to_torch_key, fold=False)


_HUBERT_KEYS = [
    (r"^feature_extractor\.conv_layers_(\d+)_conv\.", r"feature_extractor.conv_layers.\1.conv."),
    (r"^feature_extractor\.conv_layers_(\d+)_layer_norm\.",
     r"feature_extractor.conv_layers.\1.layer_norm."),
    (r"^feature_projection_layer_norm\.", r"feature_projection.layer_norm."),
    (r"^feature_projection_projection\.", r"feature_projection.projection."),
    (r"^encoder_pos_conv_embed_conv\.", r"encoder.pos_conv_embed.conv."),
    (r"^encoder_layer_norm\.", r"encoder.layer_norm."),
    (r"^encoder_layers_(\d+)\.feed_forward_(intermediate|output)_dense\.",
     r"encoder.layers.\1.feed_forward.\2_dense."),
    (r"^encoder_layers_(\d+)\.", r"encoder.layers.\1."),
]

_RMVPE_KEYS = [
    (r"^unet\.encoder_bn\.", r"unet.encoder.bn."),
    (r"^unet\.(encoder|intermediate|decoder)_layers_(\d+)\.", r"unet.\1.layers.\2."),
    (r"\.conv2_(\d+)\.conv_(\d+)\.", r".conv2.\1.conv.\2."),
    (r"\.conv2_(\d+)\.shortcut\.", r".conv2.\1.shortcut."),
    (r"\.conv1_(\d+)\.", r".conv1.\1."),
    (r"\.conv_(\d+)\.conv_(\d+)\.", r".conv.\1.conv.\2."),
    (r"\.conv_(\d+)\.shortcut\.", r".conv.\1.shortcut."),
    (r"^fc_0_gru\.", r"fc.0.gru."),
    (r"^fc_1\.", r"fc.1."),
]


def _regex_rename(rules):
    def rename(path: tuple[str, ...]) -> str:
        key = ".".join(path)
        for pat, rep in rules:
            key = re.sub(pat, rep, key)
        return key
    return rename


def hubert_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """HuBERT/ContentVec -> HF ``HubertModel`` names (+ ``final_proj``)."""
    return _state_dict(params, _regex_rename(_HUBERT_KEYS))


def rmvpe_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """RMVPE (the JAX tree nests the E2E net under ``model``) -> reference
    ``E2E`` names."""
    tree = params.get("params", params)
    return _state_dict(tree.get("model", tree), _regex_rename(_RMVPE_KEYS))
