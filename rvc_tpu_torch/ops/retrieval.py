"""Kernel 3: nearest bank row (squared L2) and the retrieval blend.

Counterpart of ``rvc_tpu/ops/pallas_retrieval.py``: ``quantize_bank``,
``nearest_rows_q`` / ``blend_into_q`` (int8 bank with per-row scales) and
``nearest_rows`` / ``blend_into`` (float32 bank). On a CUDA tensor the
search runs ``csrc/nearest_rows.cu`` (one kernel, templated on the bank's
type); on a CPU tensor the plain version below, which is also the JAX
package's CPU path (``retrieval/index.py::_topk_blend`` at k = 1).
The kernel computes its dot products on the tensor cores from bf16 pieces
of the float32 operands (``csrc/mma.cuh``): every product is exact, and the
sums are ``mma.sync``'s, which truncates as it accumulates (``mma.cuh``);
the rows it picks are held to the plain version's.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cuda


def quantize_bank(bank: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8: (N, D) float -> ((N, D) int8, (N, 1) float32
    dequantization scales), value = round(127 x / max|row|)."""
    bank = np.asarray(bank, np.float32)
    amax = np.max(np.abs(bank), axis=-1, keepdims=True)
    scale = np.maximum(amax, 1e-12) / 127.0
    q = np.clip(np.round(bank / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def topk_blend(feats: torch.Tensor, bank: torch.Tensor, k: int = 1) -> torch.Tensor:
    """feats (..., D) vs bank (N, D): the 1/d²-weighted blend of the k
    nearest rows (reference faiss search + weights; k = 1 is the row itself)."""
    bank_sq = torch.sum(bank * bank, dim=-1)
    d2 = (torch.sum(feats * feats, dim=-1, keepdim=True)
          - 2.0 * torch.matmul(feats, bank.T) + bank_sq)
    neg, idx = torch.topk(-d2, k, dim=-1)
    w = 1.0 / torch.square(torch.clamp(-neg, min=1e-9))
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.sum(bank[idx] * w[..., None], dim=-2)


def _check(feats: torch.Tensor, bank: torch.Tensor, scales: torch.Tensor | None) -> None:
    NQ, D = feats.shape
    N = bank.shape[0]
    int8 = scales is not None
    if feats.dtype != torch.float32 or not feats.is_contiguous():
        raise ValueError("feats must be a contiguous float32 (T, D) tensor")
    if (bank.shape != (N, D) or not bank.is_contiguous() or bank.device != feats.device
            or bank.dtype != (torch.int8 if int8 else torch.float32)):
        raise ValueError("bank must be a contiguous (N, D) tensor on the feats' device, "
                         "int8 with scales or float32 without")
    if int8 and (scales.shape != (N, 1) or scales.dtype != torch.float32
                 or not scales.is_contiguous() or scales.device != feats.device):
        raise ValueError("scales must be a contiguous float32 (N, 1) tensor")
    if D % 32 or bank.data_ptr() % 16 or feats.data_ptr() % 16:
        raise ValueError(f"nearest-row kernel takes D a multiple of 32 and 16-byte "
                         f"aligned rows, got D={D}")


def _nearest(feats: torch.Tensor, bank: torch.Tensor, scales: torch.Tensor | None
             ) -> torch.Tensor:
    if feats.device.type == "cpu":
        bank_f = bank.float() * scales if scales is not None else bank.float()
        return topk_blend(feats.float(), bank_f, 1)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    _check(feats, bank, scales)
    NQ, D = feats.shape
    N = bank.shape[0]
    int8 = scales is not None
    lib = _cuda.library()
    out = torch.empty_like(feats)
    bsq = torch.empty(N, device=feats.device, dtype=torch.float32)
    keys = torch.empty(NQ, device=feats.device, dtype=torch.int64)
    # split the bank over enough blocks to fill the card a few times over
    sms = torch.cuda.get_device_properties(feats.device).multi_processor_count
    q_tiles = -(-NQ // 128)  # the kernel's tiles: 128 queries x 128 bank rows
    n_tiles = -(-N // 128)
    n_split = max(1, min(n_tiles, -(-4 * sms // q_tiles)))
    err = lib.rvc_nearest_rows(
        feats.data_ptr(), bank.data_ptr(), int(int8),
        scales.data_ptr() if int8 else None, bsq.data_ptr(), keys.data_ptr(),
        out.data_ptr(), NQ, N, D, n_split, _cuda.stream_ptr(feats))
    _cuda.check(err, "nearest_rows launch")
    return out


def nearest_rows_q(feats: torch.Tensor, bank_q: torch.Tensor, scales: torch.Tensor
                   ) -> torch.Tensor:
    """feats (T, D) float32, bank_q (N, D) int8, scales (N, 1) float32 ->
    the dequantized nearest rows (T, D)."""
    out = _nearest(feats, bank_q, scales)
    if feats.device.type == "cuda":
        nearest_rows_q.launches += 1
    return out


def nearest_rows(feats: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """feats (T, D), bank (N, D) float32 -> the nearest rows (T, D)."""
    out = _nearest(feats, bank, None)
    if feats.device.type == "cuda":
        nearest_rows.launches += 1
    return out


nearest_rows_q.launches = 0
nearest_rows.launches = 0


def blend_into_q(feats: torch.Tensor, bank_q: torch.Tensor, scales: torch.Tensor,
                 index_rate: float) -> torch.Tensor:
    """rate·nearest + (1 - rate)·feats over a (B, T, D) batch, int8 bank."""
    B, T, D = feats.shape
    nearest = nearest_rows_q(feats.reshape(B * T, D).contiguous(), bank_q, scales)
    return index_rate * nearest.reshape(B, T, D) + (1.0 - index_rate) * feats


def blend_into(feats: torch.Tensor, bank: torch.Tensor, index_rate: float) -> torch.Tensor:
    """float32-bank version of ``blend_into_q``."""
    B, T, D = feats.shape
    nearest = nearest_rows(feats.reshape(B * T, D).contiguous(), bank)
    return index_rate * nearest.reshape(B, T, D) + (1.0 - index_rate) * feats
