"""Kernels 1, 4 and 5: ResBlock1 chains.

Kernel 1, ``fused_resblock_group``: a decoder stage's ResBlock1 chains,
averaged (inference). Counterpart of
``rvc_tpu/ops/pallas_resblock.py::fused_resblock_group`` with S = 1. On a
CUDA tensor the work runs in ``csrc/resblock_group.cu``: one launch per
residual unit (leaky_relu -> dilated conv -> leaky_relu -> conv ->
+ residual), the last unit of each chain adding into the stage output.

Kernels 4 and 5, ``fused_resblock1_train``: one chain, differentiable
(training). Counterpart of ``pallas_resblock.py::fused_resblock1_train``:
its forward is kernel 4 (``fused_resblock1``, the same unit kernel, each
unit's output kept for the backward) and its backward kernel 5
(``fused_resblock1_backward``, ``csrc/resblock_bwd.cu``: dx, and dW and db
of every conv, reduced on the card in a fixed order).

On a CPU tensor each wrapper runs its plain version below instead, the same
function written with ``F.conv1d`` (and autograd). A wrapper called on a
CUDA tensor launches its kernel or raises. The two forward-only wrappers
raise when gradients are wanted: their launches have no autograd node.
"""
from __future__ import annotations

import ctypes
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


def fused_resblock1_plain(x: torch.Tensor, convs: Sequence[Conv]) -> torch.Tensor:
    """x (B, T, C) -> one ResBlock1 chain applied to x (no averaging)."""
    return resblock_group_plain(x, [convs])


def wants_grad(x: torch.Tensor, chains) -> bool:
    """Whether autograd would differentiate these chains at x."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t is not None and t.requires_grad
                               for chain in chains for w, b, _, _ in chain for t in (w, b)))


def _refuse_grad(x: torch.Tensor, chains, name: str) -> None:
    if wants_grad(x, chains):
        raise RuntimeError(
            f"{name} has no backward: a launch would cut the gradient. Call it under "
            "torch.no_grad(), or use fused_resblock1_train for a differentiable chain")


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
    (weight (O, I, k), bias, k, dilation). Returns (Σ_c chain_c(x)) / n.
    Raises when gradients are wanted."""
    _refuse_grad(x, chains, "fused_resblock_group")
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


def _device_only(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")


def _packed(convs: Sequence[Conv]):
    """The chain's weights as the kernels take them: taps (2n, k, C, C)
    [conv][tap][in][out], the flipped transposed taps of the backward
    (WT[c][j][o][i] = W[c][k-1-j][i][o]), biases (2n, C), and the units'
    dilations as a C array."""
    w = torch.stack([cw for cw, _, _, _ in convs])  # (2n, O, I, k)
    taps = w.permute(0, 3, 2, 1).contiguous()
    taps_t = w.flip(3).permute(0, 3, 1, 2).contiguous()
    bias = torch.stack([cb for _, cb, _, _ in convs]).contiguous()
    dil = (ctypes.c_int * (len(convs) // 2))(*[d for _, _, _, d in convs[0::2]])
    return taps, taps_t, bias, dil


def _check_chain(x: torch.Tensor, convs: Sequence[Conv]) -> None:
    _check(x, [convs])
    k = convs[0][2]
    if any(ck != k for _, _, ck, _ in convs) or any(d != 1 for _, _, _, d in convs[1::2]):
        raise ValueError("a ResBlock1 chain has one kernel size, and dilation 1 "
                         "in the second conv of each unit")


def _resblock1_forward(x: torch.Tensor, convs: Sequence[Conv]):
    """Kernel 4 on the card: (y, hs) with hs (n-1, B, T, C) the outputs of
    units 0..n-2, i.e. the inputs of units 1..n-1."""
    _check_chain(x, convs)
    taps, _, bias, dil = _packed(convs)
    B, T, C = x.shape
    n = len(dil)
    hs = x.new_empty((max(n - 1, 1), B, T, C))
    out = torch.empty_like(x)
    err = _cuda.library().rvc_resblock1_fwd(
        x.data_ptr(), hs.data_ptr(), out.data_ptr(), taps.data_ptr(), bias.data_ptr(),
        B, T, C, convs[0][2], n, dil, _cuda.stream_ptr(x))
    _cuda.check(err, "resblock1_fwd launch")
    fused_resblock1.launches += 1
    return out, hs


def fused_resblock1(x: torch.Tensor, convs: Sequence[Conv]) -> torch.Tensor:
    """Kernel 4: one ResBlock1 chain over x (B, T, C) float32; convs as in
    ``fused_resblock_group``. Forward only: raises when gradients are wanted."""
    _refuse_grad(x, [convs], "fused_resblock1")
    if x.device.type == "cpu":
        return fused_resblock1_plain(x, convs)
    _device_only(x)
    return _resblock1_forward(x, convs)[0]


fused_resblock1.launches = 0


def fused_resblock1_backward_plain(x: torch.Tensor, hs: torch.Tensor, gy: torch.Tensor,
                                   convs: Sequence[Conv]):
    """Kernel 5's plain version: autograd of the plain chain at x (which
    recomputes the chain, so ``hs`` is not read)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        ps = [(w.detach().requires_grad_(), b.detach().requires_grad_(), k, d)
              for w, b, k, d in convs]
        g = torch.autograd.grad(fused_resblock1_plain(xg, ps),
                                [xg] + [t for w, b, _, _ in ps for t in (w, b)], gy)
    return g[0], torch.stack(g[1::2]), torch.stack(g[2::2])


def fused_resblock1_backward(x: torch.Tensor, hs: torch.Tensor, gy: torch.Tensor,
                             convs: Sequence[Conv]):
    """Kernel 5: the chain's VJP at x, given the unit inputs ``hs`` that
    kernel 4 kept. Returns (dx (B, T, C), dW (2n, C, C, k) in the convs'
    (O, I, k) layout, db (2n, C))."""
    if x.device.type == "cpu":
        return fused_resblock1_backward_plain(x, hs, gy, convs)
    _device_only(x)
    _check_chain(x, convs)
    B, T, C = x.shape
    k = convs[0][2]
    taps, taps_t, bias, dil = _packed(convs)
    gy = gy.contiguous()
    lib = _cuda.library()
    work = x.new_empty(lib.rvc_resblock1_bwd_workspace(B, T, C, k))
    dx = torch.empty_like(x)
    dw = x.new_empty(taps.shape)
    db = x.new_empty(bias.shape)
    err = lib.rvc_resblock1_bwd(
        x.data_ptr(), hs.data_ptr(), gy.data_ptr(), taps.data_ptr(), taps_t.data_ptr(),
        bias.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(), work.data_ptr(),
        work.numel(), B, T, C, k, len(dil), dil, _cuda.stream_ptr(x))
    _cuda.check(err, "resblock1_bwd launch")
    fused_resblock1_backward.launches += 1
    return dx, dw.permute(0, 3, 2, 1), db


fused_resblock1_backward.launches = 0


class _Resblock1Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, *params):
        n = len(spec)
        convs = [(w, b, k, d) for w, b, (k, d) in zip(params[:n], params[n:], spec)]
        y, hs = _resblock1_forward(x, convs)
        ctx.spec = spec
        ctx.save_for_backward(x, hs, *params)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, hs, *params = ctx.saved_tensors
        n = len(ctx.spec)
        convs = [(w, b, k, d) for w, b, (k, d) in zip(params[:n], params[n:], ctx.spec)]
        dx, dw, db = fused_resblock1_backward(x, hs, gy, convs)
        return (dx, None, *dw.unbind(0), *db.unbind(0))


def fused_resblock1_train(x: torch.Tensor, convs: Sequence[Conv]) -> torch.Tensor:
    """Differentiable chain: forward kernel 4, backward kernel 5 on the
    card; gradients reach x and every (weight, bias), and through them the
    weight-norm parameters. On the CPU the plain version, under autograd."""
    if x.device.type == "cpu":
        return fused_resblock1_plain(x, convs)
    _device_only(x)
    spec = tuple((k, d) for _, _, k, d in convs)
    return _Resblock1Train.apply(x.contiguous(), spec, *[w for w, _, _, _ in convs],
                                 *[b for _, b, _, _ in convs])
