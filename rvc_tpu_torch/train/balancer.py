"""Adaptive loss balancer (slope mode), a function over a small state.

Counterpart of ``rvc_tpu/train/balancer.py`` (the reference's LossBalancer,
slope mode), op for op, so that autograd differentiates the balanced total
as ``jax.value_and_grad`` does there: the weights depend on the losses and
their gradient is part of the step. Losses that are exactly 0 are skipped.
The weight and loss EMAs run at the JAX function's default decay of 0 (the
new values replace the old) and the Pareto re-weighting is on, as the
training step calls it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BalancerState(NamedTuple):
    ema_weights: torch.Tensor  # (K,)
    hist_losses: torch.Tensor  # (K,)
    initialized: torch.Tensor  # () bool


def init_state(n_losses: int, device=None) -> BalancerState:
    return BalancerState(torch.ones(n_losses, device=device),
                         torch.zeros(n_losses, device=device),
                         torch.zeros((), dtype=torch.bool, device=device))


def _pareto_weights(hist, active, weight: float = 0.8, eps: float = 1e-8):
    k = hist.shape[0]
    losses = torch.where(active, hist, torch.zeros_like(hist))
    total = torch.sum(losses)
    contrib = losses / torch.clamp(total, min=eps)
    order = torch.argsort(-contrib, stable=True)
    cum = torch.cumsum(contrib[order], 0)
    top_idx = torch.argmax((cum >= weight).to(torch.int32))
    ar = torch.arange(k, device=hist.device)
    boost_sorted = torch.where(ar <= top_idx, float(k), 1.0)
    boost = torch.zeros(k, device=hist.device).scatter(0, order, boost_sorted)
    normalized = losses * boost
    return normalized / (torch.sum(normalized) + eps)


def balance(state: BalancerState, losses: torch.Tensor, initial_weights: torch.Tensor,
            active: bool = True, eps: float = 1e-8):
    """Returns (balanced total, new state, weights used)."""
    losses = losses.float()
    act = (initial_weights != 0) & (losses != 0)
    weighted = losses * initial_weights
    init = state.initialized
    hist0 = torch.where(init, state.hist_losses, losses)
    ema = torch.where(act, hist0, weighted) + eps
    slope = torch.abs(weighted - torch.where(act, hist0, weighted)) / ema
    grads = torch.where(act, torch.clamp(slope, min=eps), torch.zeros_like(slope))

    inv_total_grad = 1.0 / (torch.sum(grads) + eps)
    n_active = torch.sum(act)
    total_initial = torch.sum(torch.where(act, initial_weights,
                                          torch.zeros_like(initial_weights))) - n_active
    w_ratio = grads * inv_total_grad
    smoothed = 0.5 * _pareto_weights(hist0, act) + 0.5 * w_ratio
    new_weights = 1.0 + total_initial * smoothed
    new_weights = torch.where(total_initial < 0, torch.ones_like(new_weights), new_weights)
    ema_w = torch.where(act, new_weights, state.ema_weights)
    zero = torch.zeros_like(losses)
    hist_new = torch.where(act, losses, torch.where(init, hist0, zero))
    balanced = torch.sum(torch.where(act, ema_w * losses, zero))
    passthrough = torch.sum(torch.where(act, initial_weights * losses, zero))
    total = balanced if active else passthrough
    new_state = BalancerState(torch.nan_to_num(ema_w.detach(), nan=eps),
                              torch.nan_to_num(hist_new.detach(), nan=eps),
                              torch.ones((), dtype=torch.bool, device=losses.device))
    return total, new_state, ema_w
