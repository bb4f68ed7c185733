"""Training checkpoints, and warm starts from the reference's G/D files.

Counterpart of ``rvc_tpu/train/checkpoints.py``:

  1. *Training* state, ``state_{step}`` in the model directory: the
     generator's and discriminator's state_dicts, both optimizers' ``m``,
     ``v`` and ``count``, the step and both balancer states, written with
     ``torch.save`` (the JAX package writes an Orbax directory; the port's
     file is its own format) and read back with ``weights_only=True``.
     ``latest_checkpoint`` resumes the highest step, as the reference's
     ``latest_checkpoint_path`` does.
  2. *Warm start*: a reference pretrained ``G_*.pth`` / ``D_*.pth`` (its
     state_dict under ``"model"`` or ``"weight"``, or bare), overlaid on
     the initial weights wherever a name and shape match (the reference's
     shape-tolerant ``load_checkpoint``).

The trainer's modules hold the parameters and ``TrainState`` holds the
optimizers, whose tensors ``Trainer.step`` updates in place: a save copies
them to the host, and a restore writes into the live tensors, so that the
optimizers and modules keep referring to the same storage.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from ..compat.torch_import import synthesizer_state_from_checkpoint
from .balancer import BalancerState


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _opt_state(opt) -> dict:
    return {"count": int(opt.count), "m": [_host(t) for t in opt.m],
            "v": [_host(t) for t in opt.v]}


def save_train_state(ckpt_dir: str, trainer, state, step: int) -> str:
    """Write ``state_{step}`` under ``ckpt_dir``; returns its path."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"state_{step}"))
    torch.save({
        "step": int(state.step),
        "synth": {k: _host(v) for k, v in trainer.synth.state_dict().items()},
        "disc": {k: _host(v) for k, v in trainer.disc.state_dict().items()},
        "opt_g": _opt_state(state.opt_g), "opt_d": _opt_state(state.opt_d),
        "balancer_g": [_host(t) for t in state.balancer_g],
        "balancer_d": [_host(t) for t in state.balancer_d],
    }, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.match(r"state_(\d+)$", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(ckpt_dir, name), int(m.group(1))
    return best


@torch.no_grad()
def _restore_opt(opt, saved: dict) -> None:
    if len(saved["m"]) != len(opt.m):
        raise ValueError(f"the checkpoint holds {len(saved['m'])} moments, the optimizer "
                         f"{len(opt.m)}")
    for live, m, v, mm, vv in zip(opt.params, opt.m, opt.v, saved["m"], saved["v"]):
        if mm.shape != live.shape:
            raise ValueError(f"moment of shape {tuple(mm.shape)} for a parameter of "
                             f"{tuple(live.shape)}")
        m.copy_(mm)
        v.copy_(vv)
    opt.count = int(saved["count"])


def restore_train_state(path: str, trainer, state):
    """Load ``path`` into the trainer's live modules and ``state``'s live
    optimizer tensors; returns the state with the saved step and balancer
    states (on the trainer's device)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    trainer.synth.load_state_dict(ckpt["synth"], strict=True)
    trainer.disc.load_state_dict(ckpt["disc"], strict=True)
    _restore_opt(state.opt_g, ckpt["opt_g"])
    _restore_opt(state.opt_d, ckpt["opt_d"])
    dev = trainer.device
    return state._replace(
        step=int(ckpt["step"]),
        balancer_g=BalancerState(*(t.to(dev) for t in ckpt["balancer_g"])),
        balancer_d=BalancerState(*(t.to(dev) for t in ckpt["balancer_d"])))


def load_pretrained_g(path: str) -> dict[str, np.ndarray]:
    """A reference pretrained ``G_*.pth`` or ``D_*.pth`` -> {name: float32
    array} under the port's names (the FFN convs as ``conv_1``/``conv_2``),
    weight norm kept as ``weight_g``/``weight_v``."""
    cpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = cpt.get("model", cpt.get("weight", cpt))
    return synthesizer_state_from_checkpoint(sd, fold=False)


def merge_pretrained(init: dict, pretrained: dict, verbose: bool = False) -> dict:
    """``init`` ({name: array}) with every entry of ``pretrained`` whose name
    and shape match put in its place; the rest keep their initial values."""
    out = {}
    for k, v in init.items():
        s = pretrained.get(k)
        if s is not None and np.shape(s) == np.shape(v):
            out[k] = np.asarray(s, dtype=np.asarray(v).dtype)
        else:
            if verbose and s is not None:
                print(f"shape mismatch at {k}: {np.shape(s)} vs {np.shape(v)}")
            out[k] = v
    return out


@torch.no_grad()
def warm_start_(module: torch.nn.Module, path: str) -> torch.nn.Module:
    """Overlay a pretrained file on ``module``'s weights in place (the live
    tensors, which the optimizers hold)."""
    init = {k: v.cpu().numpy() for k, v in module.state_dict().items()}
    merged = merge_pretrained(init, load_pretrained_g(path))
    for k, v in module.state_dict().items():
        v.copy_(torch.from_numpy(np.asarray(merged[k])))
    return module
