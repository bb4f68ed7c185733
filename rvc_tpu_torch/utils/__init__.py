"""Host-side helpers: the nan-aware merge functions that ``io.audio``
uses to downmix channels (``rvc_tpu/utils/__init__.py:38-47``)."""
from __future__ import annotations

from typing import Callable

import numpy as np

_MERGE_FUNCS: dict[str, Callable] = {
    "min": np.nanmin,
    "max": np.nanmax,
    "median": np.nanmedian,
    "mean": np.nanmean,
}


def get_merge_func(merge_type: str | None) -> Callable:
    """A nan-aware reducer by name; the median when the name is unknown."""
    return _MERGE_FUNCS.get(merge_type or "median", np.nanmedian)
