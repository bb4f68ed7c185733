"""Monotonic alignment search (VITS ``maximum_path``).

Counterpart of ``rvc_tpu/ops/monotonic_align.py`` (the reference's Cython
``monotonic_align``, used by the VITS text-to-speech synthesizer): a
forward pass over the decoder frames, each row one set of whole-row tensor
operations (the best of staying on a token or moving from the previous
one), then a backtrack from the last frame, again a row at a time. The
loops run over T_y in Python, as the JAX package's two scans do; nothing
loops over elements.
"""
from __future__ import annotations

import torch

_NEG = -1e9


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """neg_cent (B, T_y, T_x) alignment scores (y: decoder frames, x: text
    tokens); mask of the same shape, 1 inside each item's valid (t_y, t_x)
    rectangle. Returns the hard 0/1 monotonic path, of neg_cent's dtype."""
    B, T_y, T_x = neg_cent.shape
    value = torch.where(mask > 0, neg_cent, torch.full_like(neg_cent, _NEG))
    t_ys = mask[:, :, 0].sum(1).to(torch.long)
    t_xs = mask[:, 0, :].sum(1).to(torch.long)
    xs = torch.arange(T_x, device=neg_cent.device)[None, :]
    neg = torch.full((B, 1), _NEG, dtype=value.dtype, device=value.device)

    prev = torch.zeros(B, T_x, dtype=value.dtype, device=value.device)
    rows = []
    for y in range(T_y):
        stay = torch.where(xs == y, _NEG, prev)  # x == y cannot have stayed
        move = torch.cat([neg, prev[:, :-1]], dim=1)
        if y == 0:
            move = torch.where(xs == 0, 0.0, move)
        else:
            move = torch.where(xs == 0, _NEG, move)
        best = torch.maximum(stay, move)
        if y == 0:
            best = torch.where(xs == 0, 0.0, best)
        best = torch.where(xs > y, _NEG, best)  # only x <= y is reachable
        prev = value[:, y] + best
        rows.append(prev)
    v = torch.stack(rows, dim=1)

    index = t_xs - 1
    path = []
    for y in range(T_y - 1, -1, -1):
        active = y < t_ys
        path.append(((xs == index[:, None]) & active[:, None]).to(neg_cent.dtype))
        prev_row = v[:, max(y - 1, 0)]
        at_idx = prev_row.gather(1, (index % T_x)[:, None])[:, 0]
        at_prev = prev_row.gather(1, (index - 1).clamp(min=0)[:, None])[:, 0]
        step_down = (index > 0) & ((index == y) | (at_idx < at_prev)) & (y > 0)
        index = torch.where(step_down & active, index - 1, index)
    return torch.stack(path[::-1], dim=1) * mask
