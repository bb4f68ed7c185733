"""JAX parameter trees -> the port's state_dicts.

The JAX package stores torch-layout weights under flax paths that mirror
the reference's state_dict names (``a/b_0/c`` for ``a.b.0.c``). Given such
a tree as nested dicts of numpy arrays (``jax.tree.map(np.asarray, p)``),
these functions fold weight norm into plain weights (the reference's
``remove_weight_norm``) and rename the keys to the reference's torch names:
the RVC synthesizer, HuBERT/ContentVec (HF ``HubertModel`` names),
RMVPE (``E2E`` names), CREPE (torchcrepe's names), the UVR5 VR nets (the
reference's names, each conv kernel's spatial axes swapped back), the
MDX-Net Conv-TDF nets, the Demucs family (HDemucs, HTDemucs, Demucs v2
and Conv-TasNet, the reference's names and shapes), the two RoFormers
(lucidrains' names) and Whisper (OpenAI's names). For inference a
``weight_g``/``weight_v`` pair becomes one ``weight``; for training
(``fold=False``) the pair is kept under the names of the reference's
``G_*.pth`` / ``D_*.pth`` checkpoints, which the port's layers take after
``models.layers.live_weight_norm_``.
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


def crepe_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """CREPE: the JAX tree's paths are torchcrepe's names (``conv1``,
    ``conv1_BN``, ``classifier``)."""
    return _state_dict(params, ".".join, fold=False)


# UVR5 VR nets: the JAX package's module paths -> the reference's names
# (the inverse of rvc_tpu/compat/torch_import.py's _VR_RENAMES)
_VR_KEYS = [
    (r"\.conv_(\d+)_weight$", r".conv.\1.weight"),  # a separable/dilated conv's flat leaf
    (r"\.conv_(\d+)\.", r".conv.\1."),
    (r"\.conv1_1\.", r".conv1.1."),
    (r"\.bottleneck_0\.", r".bottleneck.0."),
    (r"^stg(\d)_low_band_net_(\d)\.", r"stg\1_low_band_net.\2."),
    (r"\.lstm_dec2\.dense_(\d)\.", r".lstm_dec2.dense.\1."),
]


def vr_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """A JAX ``CascadedASPPNet`` or ``CascadedNet`` tree -> the reference's
    state_dict names, each 4-D kernel's spatial axes swapped back to
    (bins, frames) (the JAX nets run time-major). In the "new" family
    (a tree with ``lstm_dec2``) a decoder's conv is the reference's
    ``conv1``."""
    rename = _regex_rename(_VR_KEYS)
    sd = {}
    for path, arr in flatten_tree(params.get("params", params)).items():
        arr = np.asarray(arr, np.float32)
        sd[rename(path)] = np.ascontiguousarray(arr.swapaxes(2, 3) if arr.ndim == 4 else arr)
    if any(".lstm_dec2." in k for k in sd):
        sd = {re.sub(r"\.dec(\d)\.conv\.conv\.", r".dec\1.conv1.conv.", k): v
              for k, v in sd.items()}
    return sd


def _dotted(path: tuple[str, ...]) -> str:
    """``blocks_0_tfc1_0`` -> ``blocks.0.tfc1.0``: an underscore next to a
    digit is a ModuleList / Sequential index."""
    return ".".join(re.sub(r"(?<=\d)_", ".", re.sub(r"_(?=\d)", ".", p)) for p in path)


def convtdf_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """A JAX ``ConvTDFNetTrim`` or ``TFCTDFNet`` tree -> the port's names.
    The mixer's (8, 10) weight needs no bridge: ``models.mdx_net.apply_mixer``
    takes it as the JAX package's does."""
    return {_dotted(path): np.ascontiguousarray(arr, np.float32)
            for path, arr in flatten_tree(params.get("params", params)).items()}


def _demucs_key(path: tuple[str, ...]) -> str:
    """A JAX Demucs path -> the reference's name: ``_N`` read as ``.N``
    but in ``gamma_1``/``gamma_2`` (LayerScale) and an LSTM leaf
    (``lstm_weight_ih_l0_reverse`` -> ``lstm.weight_ih_l0_reverse``), the
    ``blstm`` level of the framed BLSTM dropped, ``freq_emb`` the
    ``ScaledEmbedding``'s ``embedding`` (``_DEMUCS_RENAMES`` undone)."""
    parts = []
    for p in path:
        if p == "blstm":
            continue
        if p.startswith("lstm_") and (p.startswith("lstm_weight") or p.startswith("lstm_bias")):
            parts.append("lstm." + p[len("lstm_"):])
        elif p in ("gamma_1", "gamma_2"):
            parts.append(p)
        elif p == "freq_emb":
            parts.append("freq_emb.embedding")
        else:
            parts.append(_dotted((p,)))
    return ".".join(parts)


def demucs_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """A JAX ``HDemucs``, ``HTDemucs`` or v2 ``Demucs`` tree (or a subtree:
    a ``DConv``, a layer, the transformer) -> the reference's state_dict
    names; every weight keeps its torch layout."""
    return _state_dict(params, _demucs_key, fold=False)


def tasnet_state_dict(params: Mapping, cfg: Mapping) -> dict[str, np.ndarray]:
    """A JAX ``ConvTasNet`` tree -> the reference's names and shapes (the
    inverse of ``rvc_tpu/compat/torch_import.py::tasnet_params_from_state_dict``):
    each 1x1 kernel given back its trailing axis, the depthwise (P, H) as
    (H, 1, P), the norms (1, C, 1), the PReLUs (1,). ``cfg``: R and X."""
    tree = params.get("params", params)

    def arr(a) -> np.ndarray:
        return np.ascontiguousarray(np.asarray(a, np.float32))

    def norm(prefix: str, node) -> dict:
        if not isinstance(node, Mapping):  # the "id" norm holds nothing
            return {}
        return {f"{prefix}.gamma": arr(node["gamma"]).reshape(1, -1, 1),
                f"{prefix}.beta": arr(node["beta"]).reshape(1, -1, 1)}

    sd = {"encoder.conv1d_U.weight": arr(tree["encoder_U"]["weight"]),
          **norm("separator.network.0", tree["layer_norm"]),
          "separator.network.1.weight": arr(tree["bottleneck"]["weight"])[..., None],
          "separator.network.3.weight": arr(tree["mask_conv"]["weight"])[..., None],
          "decoder.basis_signals.weight": arr(tree["basis_signals"]["weight"])}
    for r in range(cfg["R"]):
        for x in range(cfg["X"]):
            b = tree[f"block_{r}_{x}"]
            p = f"separator.network.2.{r}.{x}.net"
            sd.update({f"{p}.0.weight": arr(b["conv1x1"]["weight"])[..., None],
                       f"{p}.1.weight": arr(b["prelu1"]).reshape(1),
                       **norm(f"{p}.2", b.get("norm1")),
                       f"{p}.3.net.0.weight": arr(np.asarray(b["dw_weight"]).T[:, None, :]),
                       f"{p}.3.net.1.weight": arr(b["prelu2"]).reshape(1),
                       **norm(f"{p}.3.net.2", b.get("norm2")),
                       f"{p}.3.net.3.weight": arr(b["pointwise"]["weight"])[..., None]})
    return sd


def roformer_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """A JAX ``BSRoformer`` or ``MelBandRoformer`` tree -> lucidrains' names:
    every ``_N`` run of a component dotted (``layers_0_0`` ->
    ``layers.0.0``, ``to_freqs_5_0_2`` -> ``to_freqs.5.0.2``, ``to_out_0`` ->
    ``to_out.0``), names without digits (``final_norm``, ``to_qkv``) kept;
    every weight keeps its torch layout."""
    return {_dotted(path): np.ascontiguousarray(arr, np.float32)
            for path, arr in flatten_tree(params.get("params", params)).items()}


def whisper_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """A JAX ``Whisper`` tree -> OpenAI's names (``blocks_0`` ->
    ``blocks.0``, ``mlp_0`` -> ``mlp.0``, ``token_embedding_weight`` ->
    ``token_embedding.weight``), every weight in its torch layout. The
    encoder's sinusoidal positions, a buffer of OpenAI's that JAX computes,
    are not in the tree."""
    return {_dotted(path).replace("token_embedding_weight", "token_embedding.weight"):
            np.ascontiguousarray(arr, np.float32)
            for path, arr in flatten_tree(params.get("params", params)).items()}
