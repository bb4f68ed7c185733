"""The reference's torch Adam state -> the port's AdamW state, to resume
training from a reference training checkpoint.

Counterpart of ``rvc_tpu/compat/optimizer_import.py::torch_adam_to_optax``.
The reference's ``G_*.pth`` / ``D_*.pth`` hold ``{model, optimizer,
learning_rate, iteration}`` (lib/train/utils.py:119-134); the optimizer
dict is torch Adam's: per parameter ``{step, exp_avg, exp_avg_sq}`` keyed by
the parameter ids of ``param_groups``, in registration order, which is the
order of the model's state_dict keys. Each moment goes to the port's
parameter of the same name (the FFN convs renamed as the checkpoint loader
renames them) where the shapes match; the others keep their values. The
optimizer's ``count`` becomes the largest ``step``.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from .torch_import import _FFN_DOTTED


@torch.no_grad()
def torch_adam_to_adamw(torch_ckpt: Mapping[str, Any], module: torch.nn.Module, opt) -> int:
    """Fill ``opt``'s ``m``, ``v`` and ``count`` (an ``AdamW`` over
    ``module.parameters()``) in place from ``torch_ckpt``; returns the
    checkpoint's ``iteration`` (its largest step if absent)."""
    model_sd = torch_ckpt.get("model", {})
    opt_sd = torch_ckpt.get("optimizer", {})
    state = opt_sd.get("state", {})
    ordered_ids: list = []
    for g in opt_sd.get("param_groups", []):
        ordered_ids.extend(g.get("params", []))
    torch_keys = list(model_sd.keys())
    if len(torch_keys) != len(ordered_ids):
        raise ValueError(f"optimizer state has {len(ordered_ids)} params but model has "
                         f"{len(torch_keys)} tensors — cannot align")
    moments: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
    step = 0
    for key, pid in zip(torch_keys, ordered_ids):
        st = state.get(pid)
        if st is None:
            continue
        s = st.get("step", 0)
        step = max(step, int(s.item() if hasattr(s, "item") else s))
        moments[_FFN_DOTTED.sub(r"\1.conv_\2.", key)] = (st["exp_avg"], st["exp_avg_sq"])
    names = [n for n, _ in module.named_parameters()]
    if len(names) != len(opt.m):
        raise ValueError("the optimizer does not hold the module's parameters")
    for name, m, v in zip(names, opt.m, opt.v):
        got = moments.get(name)
        if got is not None and got[0].shape == m.shape:
            m.copy_(got[0])
            v.copy_(got[1])
    opt.count = step
    return int(torch_ckpt.get("iteration", step))
