"""Kernel 1: a decoder stage's ResBlock1 chains, averaged.

Counterpart of ``rvc_tpu/ops/pallas_resblock.py::fused_resblock_group``
with S = 1. On a CUDA tensor the work runs in ``csrc/resblock_group.cu``:
one launch per residual unit (leaky_relu -> dilated conv -> leaky_relu ->
conv -> + residual), the last unit of each chain adding into the stage
output. On a CPU tensor the plain version below runs instead; it is the
same function written with ``F.conv1d``.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from . import _cuda

# (weight (O, I, k), bias (O,), k, dilation) for each conv of a chain
Conv = tuple[torch.Tensor, torch.Tensor, int, int]


def resblock_group_plain(x: torch.Tensor, chains: Sequence[Sequence[Conv]]) -> torch.Tensor:
    """x (B, T, C) -> mean over chains of the chain applied to x."""
    xc = x.transpose(1, 2)
    acc = None
    for chain in chains:
        h = xc
        for (wa, ba, ka, da), (wb, bb, kb, db) in zip(chain[0::2], chain[1::2]):
            t = F.conv1d(F.leaky_relu(h, 0.1), wa, ba, padding=(ka * da - da) // 2,
                         dilation=da)
            t = F.conv1d(F.leaky_relu(t, 0.1), wb, bb, padding=(kb * db - db) // 2,
                         dilation=db)
            h = h + t
        acc = h if acc is None else acc + h
    return (acc / len(chains)).transpose(1, 2)


def _check(x: torch.Tensor, chains) -> None:
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 (B, T, C) tensor")
    C = x.shape[2]
    if C % 16 or C > 256:
        raise ValueError(f"resblock kernel takes C a multiple of 16 up to 256, got {C}")
    if not chains or any(len(c) == 0 or len(c) % 2 for c in chains):
        raise ValueError("each chain needs an even, non-zero number of convs")
    for chain in chains:
        for w, b, k, d in chain:
            if (w.shape != (C, C, k) or b is None or b.shape != (C,) or k % 2 == 0
                    or any(t.device != x.device or t.dtype != torch.float32
                           for t in (w, b))):
                raise ValueError("conv weights must be float32 (C, C, k), odd k, "
                                 "with a (C,) bias, on the input's device")


def fused_resblock_group(x: torch.Tensor, chains: Sequence[Sequence[Conv]]) -> torch.Tensor:
    """x (B, T, C) float32; chains: per ResBlock1, its convs in order as
    (weight (O, I, k), bias, k, dilation). Returns (Σ_c chain_c(x)) / n."""
    if x.device.type == "cpu":
        return resblock_group_plain(x, chains)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, chains)
    lib = _cuda.library()
    B, T, C = x.shape
    out = torch.empty_like(x)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    stream = _cuda.stream_ptr(x)
    taps = [[(w.permute(2, 1, 0).contiguous(), b.contiguous(), k, d)
             for w, b, k, d in chain] for chain in chains]
    n = len(taps)
    for ci, chain in enumerate(taps):
        h = x
        units = list(zip(chain[0::2], chain[1::2]))
        for ui, ((wa, ba, ka, da), (wb, bb, kb, db)) in enumerate(units):
            last = ui == len(units) - 1
            dst = out if last else bufs[ui % 2]
            mode = 1 if (last and ci > 0) else 0
            n_div = n if (last and ci == n - 1) else 1
            err = lib.rvc_resblock_unit(
                h.data_ptr(), dst.data_ptr(), wa.data_ptr(), ba.data_ptr(),
                wb.data_ptr(), bb.data_ptr(), B, T, C, ka, da, kb, db, mode,
                n_div, stream)
            _cuda.check(err, "resblock_unit launch")
            fused_resblock_group.launches += 1
            h = dst
    return out


fused_resblock_group.launches = 0
