"""Host-side helpers: hashing, the nan-aware merge functions that
``io.audio`` uses to downmix channels, and an attribute-style dict
(``rvc_tpu/utils/__init__.py``)."""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable

import numpy as np


def get_hash(*args) -> str:
    """md5 of the args as JSON, an array by the md5 of its bytes and any
    other object by ``str``: the JAX package's digests for the same
    arguments, which the node layer's caches key on."""

    def default(o):
        if isinstance(o, np.ndarray):
            return hashlib.md5(o.tobytes()).hexdigest()
        return str(o)

    payload = json.dumps(args, default=default, sort_keys=True)
    return hashlib.md5(payload.encode()).hexdigest()


def file_hash(path: str, tail_bytes: int = 10000 * 1024) -> str:
    """md5 of the last ``tail_bytes`` of a file (the whole file if shorter)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if size > tail_bytes:
            f.seek(-tail_bytes, 2)
        return hashlib.md5(f.read()).hexdigest()


_MERGE_FUNCS: dict[str, Callable] = {
    "min": np.nanmin,
    "max": np.nanmax,
    "median": np.nanmedian,
    "mean": np.nanmean,
}


def get_merge_func(merge_type: str | None) -> Callable:
    """A nan-aware reducer by name; the median when the name is unknown."""
    return _MERGE_FUNCS.get(merge_type or "median", np.nanmedian)


class ObjectNamespace(dict):
    """A dict whose keys read, write and delete as attributes."""

    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    def __delattr__(self, k: str) -> None:
        del self[k]
