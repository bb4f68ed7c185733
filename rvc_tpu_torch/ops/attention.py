"""Kernel 2: self-attention with a banded relative-position bias.

Counterpart of ``rvc_tpu/ops/pallas_attention.py::banded_rel_attention``,
same signature. On a CUDA tensor it runs ``csrc/banded_attention.cu``
(``rvc_banded_attention``: QK^T and P.V on the tensor cores in 3xTF32, an
online softmax); on a CPU tensor the plain version below, which is the JAX
module's XLA path (``rvc_tpu/models/attention.py``) written in torch. The kernel has no
backward, as the Pallas kernel has none: ``banded_rel_attention`` raises
when gradients are wanted, and the text encoder trains through the plain
version, which is the JAX ``Trainer``'s own path (it never sets
``fuse_attention``, so its training attention is XLA, not Pallas).

In bfloat16 (q, k, v and the tables bf16) the kernel is
``rvc_banded_attention_bf16`` and rounds where the JAX package does: q
scaled by bf16(scale), each product summed in float32 and rounded, the band
added to the rounded scores and rounded again, the softmax full-row float32
with p rounded to bf16 before P.V; its launches count in
``banded_rel_attention.launches_bf16``. The plain version rounds at the same
places. Since p is rounded after normalisation, every row's max and sum
come first: the keys are split over blocks (about five blocks an SM), one
launch takes each split's max and sum, a second combines them in split
order and adds the split's P.V in float32 from the rounded p, and a third
adds the splits' sums in order and the band's value term. Q.K^T runs in
both of the first two, on ``mma.sync`` with K and V tiles copied one ahead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from ..models.layers import rounded


def band_to_dense(band: torch.Tensor, T_s: int, w: int) -> torch.Tensor:
    """(B, H, T, 2w+1) -> (B, H, T, T_s): band[..., t, m] lands at key
    column t + m - w (zeros elsewhere)."""
    B, H, T, W = band.shape
    padded = F.pad(band, (0, T_s))
    flat = padded.reshape(B, H, T * (W + T_s))[:, :, : T * (W + T_s - 1)]
    shifted = flat.reshape(B, H, T, W + T_s - 1)
    return shifted[..., w: w + T_s]


def dense_to_band(p: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, T, S) -> (B, H, T, 2w+1): out[t, m] = p[t, t + m - w]."""
    B, H, T, S = p.shape
    W = 2 * w + 1
    padded = F.pad(p, (w, w))
    flat = F.pad(padded.reshape(B, H, T * (S + 2 * w)), (0, T))
    shifted = flat.reshape(B, H, T, S + 2 * w + 1)
    return shifted[..., :W]


def banded_rel_attention_plain(q, k, v, emb_rel_k, emb_rel_v, lengths, *,
                               window: int, scale: float) -> torch.Tensor:
    B, H, T, D = q.shape
    qs = q * rounded(scale, q.dtype)
    scores = torch.matmul(qs, k.transpose(-1, -2))
    band = torch.matmul(qs, emb_rel_k.transpose(0, 1))  # (B, H, T, 2w+1)
    scores = scores + band_to_dense(band, T, window)
    t = torch.arange(T, device=q.device)
    valid = t[None, :] < lengths[:, None].to(t.dtype)  # (B, T)
    mask = valid[:, None, :, None] & valid[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e4))
    p = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.matmul(p, v)
    return out + torch.matmul(dense_to_band(p, window), emb_rel_v)


def _check(q, k, v, emb_rel_k, emb_rel_v, lengths, window: int) -> None:
    B, H, T, D = q.shape
    W = 2 * window + 1
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention kernel takes float32 or bfloat16, got {dt}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != (B, H, T, D) or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} (B, H, T, D) tensor")
    for name, t in (("emb_rel_k", emb_rel_k), ("emb_rel_v", emb_rel_v)):
        if t.shape != (W, D) or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} (2w+1, D) tensor")
    if D not in (32, 64, 96, 128) or not 0 <= window <= 16:
        raise ValueError(f"attention kernel takes D in 32/64/96/128 and window <= 16, "
                         f"got D={D}, window={window}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    if lengths.shape != (B,) or any(t.device != q.device
                                    for t in (k, v, emb_rel_k, emb_rel_v, lengths)):
        raise ValueError("lengths must be (B,), and every input on q's device")


def banded_rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         emb_rel_k: torch.Tensor, emb_rel_v: torch.Tensor,
                         lengths: torch.Tensor, *, window: int,
                         scale: float) -> torch.Tensor:
    """q, k, v: (B, H, T, D) float32 or bfloat16 self-attention; emb_rel_*:
    (2w+1, D) tables shared by the heads, in q's dtype; lengths: (B,) valid
    frames. -> (B, H, T, D). Raises when gradients are wanted (see the
    module's docstring)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, emb_rel_k,
                                                                  emb_rel_v)):
        raise RuntimeError("banded_rel_attention has no backward: a launch would cut "
                           "the gradient. Train through banded_rel_attention_plain")
    if q.device.type == "cpu":
        return banded_rel_attention_plain(q, k, v, emb_rel_k, emb_rel_v, lengths,
                                          window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, emb_rel_k, emb_rel_v, lengths, window)
    B, H, T, D = q.shape
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _cuda.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), emb_rel_k.data_ptr(),
            emb_rel_v.data_ptr(), lens.data_ptr(), out.data_ptr(), B, H, T, D, window)
    if q.dtype == torch.bfloat16:
        work = q.new_empty(lib.rvc_banded_attention_bf16_workspace(B, H, T, D),
                           dtype=torch.float32)
        err = lib.rvc_banded_attention_bf16(*args[:7], work.data_ptr(), *args[7:],
                                            rounded(scale, q.dtype), _cuda.stream_ptr(q))
        _cuda.check(err, "banded_attention_bf16 launch")
        banded_rel_attention.launches_bf16 += 1
        return out
    err = lib.rvc_banded_attention(*args, float(scale), _cuda.stream_ptr(q))
    _cuda.check(err, "banded_attention launch")
    banded_rel_attention.launches += 1
    return out


banded_rel_attention.launches = 0
banded_rel_attention.launches_bf16 = 0
