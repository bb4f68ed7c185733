"""Utility glue nodes (``rvc_tpu/graph/utility_nodes.py``): batch merging,
weighted repeat-interleave of image and latent batches, math, slice, zip
and sort. IMAGE and LATENT payloads are numpy arrays; a tensor from
ComfyUI comes in through ``.numpy()``."""
from __future__ import annotations

import numpy as np


def _as_np(x):
    return np.asarray(x if not hasattr(x, "numpy") else x.numpy())


class MergeImageBatchesNode:
    """Two image batches concatenated along the batch axis."""

    CATEGORY = "rvc_tpu/utils"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "merge"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"images1": ("IMAGE",), "images2": ("IMAGE",)}}

    def merge(self, images1, images2):
        return (np.concatenate([_as_np(images1), _as_np(images2)], axis=0),)


class MergeLatentBatchesNode:
    """A list of LATENT dicts concatenated along the batch axis: ``samples``
    and any ``noise_mask`` merged, ``batch_index`` rebuilt."""

    CATEGORY = "rvc_tpu/utils"
    RETURN_TYPES = ("LATENT",)
    INPUT_IS_LIST = True
    FUNCTION = "merge"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"latents": ("LATENT",)}}

    def merge(self, latents):
        samples = np.concatenate(
            [_as_np(lat["samples"]) for lat in latents], axis=0)
        merged = {"samples": samples,
                  "batch_index": list(range(len(samples)))}
        masks = [_as_np(lat["noise_mask"]) for lat in latents
                 if "noise_mask" in lat]
        if masks:
            merged["noise_mask"] = np.concatenate(masks, axis=0)
        return (merged,)


def _repeat(batch: np.ndarray, repeats, max_frames: int) -> np.ndarray:
    """Each item of ``batch`` repeated by its weight rounded (at least 1;
    the weights cycled over a longer batch), cut at ``max_frames`` if > 0."""
    reps = np.maximum(np.rint(np.atleast_1d(np.asarray(repeats))).astype(int), 1)
    if len(reps) < len(batch):
        reps = np.resize(reps, len(batch))
    out = np.repeat(batch, reps[: len(batch)], axis=0)
    if max_frames > 0:
        out = out[:max_frames]
    return out


class ImageRepeatInterleavedNode:
    """Each image repeated by its per-frame weight."""

    CATEGORY = "rvc_tpu/utils"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "repeat"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"images": ("IMAGE",), "repeats": ("FLOAT",)},
                "optional": {"max_frames": ("INT", {"default": 0})}}

    def repeat(self, images, repeats, max_frames: int = 0):
        return (_repeat(_as_np(images), repeats, max_frames),)


class LatentRepeatInterleavedNode:
    """Each latent repeated by its per-frame weight."""

    CATEGORY = "rvc_tpu/utils"
    RETURN_TYPES = ("LATENT",)
    FUNCTION = "repeat"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"latents": ("LATENT",), "repeats": ("FLOAT",)},
                "optional": {"max_frames": ("INT", {"default": 0})}}

    def repeat(self, latents, repeats, max_frames: int = 0):
        return ({"samples": _repeat(_as_np(latents["samples"]), repeats, max_frames)},)


class MathNode:
    CATEGORY = "rvc_tpu/utils"
    RETURN_TYPES = ("FLOAT",)
    FUNCTION = "calc"

    OPS = {
        "add": np.add, "subtract": np.subtract, "multiply": np.multiply,
        "divide": np.divide, "min": np.minimum, "max": np.maximum, "pow": np.power,
    }

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"a": ("FLOAT",), "b": ("FLOAT",),
                             "op": (list(cls.OPS), {"default": "add"})}}

    def calc(self, a, b, op="add"):
        result = self.OPS[op](np.asarray(a, np.float64), np.asarray(b, np.float64))
        return (result.tolist() if result.ndim else float(result),)


class SliceNode:
    CATEGORY = "rvc_tpu/utils"
    RETURN_TYPES = ("*",)
    FUNCTION = "slice"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"values": ("*",), "start": ("INT", {"default": 0}),
                             "end": ("INT", {"default": -1})}}

    def slice(self, values, start=0, end=-1):
        end = None if end == -1 else end
        return (values[start:end],)


class ZipNode:
    CATEGORY = "rvc_tpu/utils"
    RETURN_TYPES = ("*",)
    FUNCTION = "zip"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"a": ("*",), "b": ("*",)}}

    def zip(self, a, b):
        return (list(zip(a, b)),)


class SortNode:
    CATEGORY = "rvc_tpu/utils"
    RETURN_TYPES = ("*",)
    FUNCTION = "sort"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"values": ("*",)},
                "optional": {"reverse": ("BOOLEAN", {"default": False})}}

    def sort(self, values, reverse=False):
        return (sorted(values, reverse=reverse),)


class Any2ListNode:
    """Any iterable as a ComfyUI output list."""

    CATEGORY = "rvc_tpu/utility"
    RETURN_TYPES = ("*",)
    OUTPUT_IS_LIST = (True,)
    FUNCTION = "to"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"any": ("*",)}}

    def to(self, any):  # noqa: A002 - the input's name in saved workflows
        return (list(any),)


class List2AnyNode:
    """A ComfyUI input list as one value."""

    CATEGORY = "rvc_tpu/utility"
    RETURN_TYPES = ("*",)
    INPUT_IS_LIST = (True,)
    FUNCTION = "to"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {"any": ("*",)}}

    def to(self, any):  # noqa: A002
        return (any,)


UTILITY_NODE_CLASS_MAPPINGS = {
    "RVC_TPU_Any2List": Any2ListNode,
    "RVC_TPU_List2Any": List2AnyNode,
    "RVC_TPU_MergeImageBatches": MergeImageBatchesNode,
    "RVC_TPU_MergeLatentBatches": MergeLatentBatchesNode,
    "RVC_TPU_ImageRepeatInterleaved": ImageRepeatInterleavedNode,
    "RVC_TPU_LatentRepeatInterleaved": LatentRepeatInterleavedNode,
    "RVC_TPU_Math": MathNode,
    "RVC_TPU_Slice": SliceNode,
    "RVC_TPU_Zip": ZipNode,
    "RVC_TPU_Sort": SortNode,
}
