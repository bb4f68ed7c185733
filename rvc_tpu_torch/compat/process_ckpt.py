"""Checkpoint tools: inspect, re-tag, extract and merge RVC ``.pth`` files.

Counterpart of ``rvc_tpu/compat/process_ckpt.py`` (the reference's
lib/train/process_ckpt.py): ``show_info``, ``change_info``,
``extract_small_model`` (a training ``G_*.pth`` -> an fp16 inference
``.pth``) and ``merge`` (two models of one architecture blended by
``alpha1``, tolerant of differing speaker-embedding row counts). Files are
read with ``weights_only=True``: they hold only tensors, numbers, strings,
lists and dicts.
"""
from __future__ import annotations

import os
from collections import OrderedDict

import torch


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _weights(ckpt: dict) -> dict:
    return ckpt.get("model", ckpt.get("weight", ckpt))


def _save(obj, out_path: str) -> None:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.save(obj, out_path)


def show_info(path: str) -> str:
    """The model card string (reference :7-18)."""
    try:
        a = _load(path)
        return "模型信息:%s\n采样率:%s\n模型是否输入音高引导:%s\n版本:%s" % (
            a.get("info", "None"), a.get("sr", "None"), a.get("f0", "None"),
            a.get("version", "None"))
    except Exception as e:
        return f"error: {e}"


def change_info(path: str, info: str, out_path: str) -> str:
    """Re-tag the info field (reference :150-160)."""
    ckpt = _load(path)
    ckpt["info"] = info
    _save(ckpt, out_path)
    return "Success."


def extract_small_model(path: str, out_path: str, sr, if_f0: int, info: str,
                        version: str, config: list) -> str:
    """A training checkpoint (G with its optimizer) -> an fp16 inference
    ``.pth`` (reference :20-148)."""
    opt = OrderedDict(weight={})
    for key, val in _weights(_load(path)).items():
        if "enc_q" in key:
            continue
        opt["weight"][key] = val.half() if hasattr(val, "half") else val
    opt["config"] = list(config)
    opt["info"] = info
    opt["sr"] = sr
    opt["f0"] = int(if_f0)
    opt["version"] = version
    _save(opt, out_path)
    return "Success."


def merge(path1: str, path2: str, alpha1: float, sr, f0: int, info: str,
          out_path: str, version: str) -> str:
    """``alpha1`` of the first model plus ``1 - alpha1`` of the second
    (reference :162-217)."""
    def extract(ckpt):
        return {k: v for k, v in _weights(ckpt).items() if "enc_q" not in k}

    ckpt1 = _load(path1)
    cfg = ckpt1.get("config")
    w1, w2 = extract(ckpt1), extract(_load(path2))
    if sorted(w1) != sorted(w2):
        return "Fail to merge the models. The model architectures are not the same."
    opt = OrderedDict(weight={})
    for key in w1:
        a, b = w1[key].float(), w2[key].float()
        if key == "emb_g.weight" and a.shape != b.shape:
            n = min(a.shape[0], b.shape[0])
            blended = alpha1 * a[:n] + (1 - alpha1) * b[:n]
        else:
            blended = alpha1 * a + (1 - alpha1) * b
        opt["weight"][key] = blended.half()
    opt["config"] = cfg
    opt["sr"] = sr
    opt["f0"] = int(f0)
    opt["version"] = version
    opt["info"] = info
    _save(opt, out_path)
    return "Success."
