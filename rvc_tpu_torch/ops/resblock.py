"""Kernels 1, 4 and 5: ResBlock1 chains.

Kernel 1, ``fused_resblock_group``: a decoder stage's ResBlock1 chains,
averaged (inference). Counterpart of
``rvc_tpu/ops/pallas_resblock.py::fused_resblock_group`` with S = 1. On a
CUDA tensor the work runs in ``csrc/resblock_group.cu``: one launch per
residual unit (leaky_relu -> dilated conv -> leaky_relu -> conv ->
+ residual), the last unit of each chain adding into the stage output. Its
convs run on the tensor cores in 3xTF32 (``csrc/mma.cuh``), which keeps
float32-level error, on weights split and packed for it
(``pack_tf32_weights``) once per set of weights (``packed``).

Kernels 4 and 5, ``fused_resblock1_train``: one chain, differentiable
(training). Counterpart of ``pallas_resblock.py::fused_resblock1_train``:
its forward is kernel 4 (``fused_resblock1``, ``csrc/resblock_chain.cu``:
each conv a launch on ``wgmma`` in 3xTF32, a block owning 128 rows and a
slice of the output channels so that the first stage's short rows still
fill the card, each unit's output kept for the backward) on weights split
and packed for it (``pack_tf32_wgmma_weights``, once per set of weights,
``packed``: once a step in training); its backward is kernel 5
(``fused_resblock1_backward``, ``csrc/resblock_bwd.cu``: dx, and dW and db
of every conv, reduced on the card in a fixed order), all its products on
the tensor cores in 3xTF32 on ``mma.sync`` (``csrc/tc_rowconv.cuh``), on
weights packed in its own layout (``pack_backward_weights``). Kernel 5
recomputes each unit's first conv with its sums in another order, so it may
take the other leaky-ReLU slope than kernel 4 at a pre-activation within
rounding of 0; ``check_chain_grads`` allows for that.

``fused_resblock1_train`` in bfloat16 is the JAX package's function at bf16
(rvc_tpu/ops/pallas_resblock.py:395-516): its forward is the bf16 unit
kernel's function (the Pallas chain kernel at bf16: bf16 activations and
weights, float32 sums and bias, each conv and residual output rounded once,
slope bf16(0.1)), one ``rvc_resblock_unit_bf16`` launch a unit, counted in
``fused_resblock1_train.launches_bf16``; its backward is the float32
backward at slope bf16(0.1) on x and the cotangent upcast, with the float32
weights and nothing rounded inside, dx cast to bf16: kernel 4 in float32 at
that slope recomputes the unit inputs, then kernel 5 at that slope. It
differentiates the float32 chain, not the rounded forward. Only x is saved.

In bfloat16, kernel 1 and kernel 8 (``fused_resblock1_v2``, one chain:
the counterpart of ``scripts/bench_resblock_v2.py::fused_resblock1_v2``)
run one bf16 unit kernel on ``wgmma`` (``rvc_resblock_unit_bf16``):
activations carry in bf16, each conv is one bf16 pass summed in float32,
the float32 bias is added and the sum rounded once to bf16, leaky ReLU
rounds its product, the residual add rounds, and a stage's chains add in
order in bf16 before one division (rvc_tpu/ops/pallas_resblock.py:591-656).
Its weights are packed as bf16 into the image its shared-memory operand
reads (``pack_bf16_weights``), once per set of weights. Kernel 1 counts
its float32 launches in ``fused_resblock_group.launches`` and its bf16 ones
in ``fused_resblock_group.launches_bf16``.

On a CPU tensor each wrapper runs its plain version below instead, the same
function written with ``F.conv1d`` (and autograd); in bf16 the plain
version convolves bf16-valued operands in float32 and rounds where the
kernel rounds. A wrapper called on a CUDA tensor launches its kernel or
raises. The forward-only wrappers raise when gradients are wanted: their
launches have no autograd node.

The forward-only wrappers (``fused_resblock_group``, ``fused_resblock1``,
``fused_resblock1_v2``) call custom ops of the ``rvc`` namespace
(``rvc::resblock_group``, ``rvc::resblock1``, ``rvc::resblock1_v2``), their
chains flattened to tensor and int lists (``_flat``): the CPU
implementation is the plain version, the CUDA implementation the launch
(checks, packing, launch counts), the fake implementation the output's
shape, so that ``torch.export`` keeps them in a traced graph
(``compat/export.py``). Training's ``fused_resblock1_train`` stays a
``torch.autograd.Function`` over kernels 4 and 5.
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from . import _cuda

# (weight (O, I, k), bias (O,), k, dilation) for each conv of a chain
Conv = tuple[torch.Tensor, torch.Tensor, int, int]
BF16_SLOPE = 0.10009765625  # bf16(0.1), the leaky ReLU's slope in bfloat16


def _lrelu_conv(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int, d: int,
                slope: float = 0.1) -> torch.Tensor:
    """conv(leaky_relu(h)) with same padding, (B, C, T), in float32 at
    ``slope``. In bf16: the product of the bf16 slope rounded, the conv of
    bf16 operands summed in float32 with the float32 bias, then rounded once
    to bf16."""
    pad = (k * d - d) // 2
    if h.dtype != torch.bfloat16:
        return F.conv1d(F.leaky_relu(h, slope), w, b, padding=pad, dilation=d)
    a = F.leaky_relu(h, BF16_SLOPE).float()
    return F.conv1d(a, w.to(h.dtype).float(), b.float(), padding=pad,
                    dilation=d).to(h.dtype)


def resblock_group_plain(x: torch.Tensor, chains: Sequence[Sequence[Conv]],
                         slope: float = 0.1) -> torch.Tensor:
    """x (B, T, C) -> mean over chains of the chain applied to x; in x's
    dtype (float32 at ``slope``, or bfloat16), rounding where kernel 1
    rounds."""
    xc = x.transpose(1, 2)
    acc = None
    for chain in chains:
        h = xc
        for (wa, ba, ka, da), (wb, bb, kb, db) in zip(chain[0::2], chain[1::2]):
            t = _lrelu_conv(h, wa, ba, ka, da, slope)
            h = h + _lrelu_conv(t, wb, bb, kb, db, slope)
        acc = h if acc is None else acc + h
    return (acc / len(chains)).transpose(1, 2)


def fused_resblock1_plain(x: torch.Tensor, convs: Sequence[Conv],
                          slope: float = 0.1) -> torch.Tensor:
    """x (B, T, C) -> one ResBlock1 chain applied to x (no averaging)."""
    return resblock_group_plain(x, [convs], slope)


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
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 or bfloat16 (B, T, C) tensor")
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


TC_CHANNELS = (16, 32, 64, 128, 256)  # the widths kernel 1 is built for
MAX_TAPS = 15  # kernels 5 and 7: their weight gradients give each tap a warp


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 stored mantissa bits), ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds (and ``mma.cuh``'s
    ``tf32_round``): half the weight of the low 13 bits added to the
    magnitude bits, then cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def pack_tf32_weights(w: torch.Tensor) -> torch.Tensor:
    """A conv's (O, I, k) float32 weights (O and I multiples of 8), or a
    stack of them (..., O, I, k), as the tensor-core kernels read them: for
    each k8 step (tap j, inputs 8s..8s+7), each n8 tile of outputs and each
    lane 4g + t of a warp, the float4 (w_big[o, i], w_big[o, i + 1], r[o, i],
    r[o, i + 1]) with o = 8n + g, i = 8s + 2t, w_big = tf32_round(w) and
    r = w - w_big (exact; the kernel rounds it to TF32). Flat per conv,
    (..., k I/8 O/8 32 4)."""
    *lead, O, I, k = w.shape
    n = len(lead)
    big = tf32_round(w)
    parts = []
    for v in (big, w - big):
        v = v.permute(*range(n), n + 2, n + 1, n).reshape(*lead, k, I // 8, 4, 2, O // 8, 8)
        # j, s, t, pair, n, g -> j, s, n, g, t, pair
        parts.append(v.permute(*range(n), n, n + 1, n + 4, n + 5, n + 2, n + 3))
    return torch.stack(parts, dim=-2).reshape(*lead, -1).contiguous()


def unpack_tf32_weights(packed: torch.Tensor, C: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``pack_tf32_weights``: (w_big, r), each (O, I, k)."""
    v = packed.reshape(k, C // 8, C // 8, 8, 4, 2, 2)  # j, s, n, g, t, part, pair
    out = []
    for part in range(2):
        u = v[..., part, :].permute(0, 1, 4, 5, 2, 3)  # j, s, t, pair, n, g
        out.append(u.reshape(k, C, C).permute(2, 1, 0).contiguous())
    return out[0], out[1]


TF32_SLICE_K = 32  # kernel 4's weight slice: 32 of K = (tap, input), 128 bytes a row


def pack_tf32_wgmma_weights(w: torch.Tensor) -> torch.Tensor:
    """A conv's (O, I, k) float32 weights (O and I multiples of 8), or a stack
    of them (..., O, I, k), as kernel 4's B operand lies in shared memory:
    K = (tap j, input i) flattened as j I + i, each 8 of K relabelled as
    ``mma.cuh`` relabels k (position t holds input 2t, position t + 4 input
    2t + 1), zero-padded to a multiple of 32; slice s is O rows, row o
    holding K 32 s .. 32 s + 31 in float32 (128 bytes) with the 128-byte
    swizzle (4-float chunk c of row o stored at chunk c ^ (o % 8)). Two
    images, w_big = tf32_round(w) and w_small = tf32_round(w - w_big):
    (..., 2, ceil(k I / 32), O, 8, 4) float32, each slice's rows of each
    image one bulk copy."""
    *lead, O, I, k = w.shape
    v = w.transpose(-1, -2).reshape(*lead, O, k, I // 8, 4, 2).transpose(-1, -2)
    v = F.pad(v.reshape(*lead, O, k * I), (0, -(k * I) % TF32_SLICE_K))
    big = tf32_round(v)
    parts = [u.reshape(*lead, O, -1, 8, 4).transpose(-4, -3)
             for u in (big, tf32_round(v - big))]
    return _swizzle(torch.stack(parts, dim=len(lead))).contiguous()


def pack_chain_weights(ws: Sequence[torch.Tensor]) -> torch.Tensor:
    """Kernel 4's packing of a whole chain's conv weights in one batch:
    (2n, 2, S, O, 8, 4), conv c's ``pack_tf32_wgmma_weights`` at [c]."""
    return pack_tf32_wgmma_weights(torch.stack(list(ws)))


def unpack_tf32_wgmma_weights(packed: torch.Tensor, I: int, k: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``pack_tf32_wgmma_weights``: (w_big, w_small), each (O, I, k)."""
    O = packed.shape[2]
    out = []
    for v in _swizzle(packed):
        v = v.transpose(0, 1).reshape(O, -1)[:, :k * I]
        v = v.reshape(O, k, I // 8, 2, 4).transpose(-1, -2).reshape(O, k, I)
        out.append(v.permute(0, 2, 1))
    return out[0], out[1]


SLICE_K = 64  # the bf16 unit kernel's weight slice: 64 of K = (tap, input)


def pack_bf16_weights(w: torch.Tensor) -> torch.Tensor:
    """A conv's (O, I, k) float32 weights (O and I multiples of 16) as the
    bf16 unit kernel's B operand lies in shared memory: K = (tap j, input i)
    flattened as j I + i and zero-padded to a multiple of 64; slice s is O
    rows, row o holding w[o, K 64 s .. 64 s + 63] in bf16 (128 bytes), with
    the 128-byte swizzle: 16-byte chunk c of row o stored at chunk c ^ (o % 8)
    (``csrc/hopper.cuh``). (ceil(k I / 64), O, 8, 8) bf16, each slice one
    bulk copy."""
    O, I, k = w.shape
    v = w.to(torch.bfloat16).permute(0, 2, 1).reshape(O, k * I)
    v = F.pad(v, (0, -(k * I) % SLICE_K)).reshape(O, -1, 8, 8).transpose(0, 1)
    return _swizzle(v).contiguous()


def unpack_bf16_weights(packed: torch.Tensor, I: int, k: int) -> torch.Tensor:
    """Inverse of ``pack_bf16_weights``: the (O, I, k) bf16 weights."""
    O = packed.shape[1]
    v = _swizzle(packed).transpose(0, 1).reshape(O, -1)[:, :k * I]
    return v.reshape(O, k, I).permute(0, 2, 1)


_SWIZZLE: dict = {}


def _swizzle(v: torch.Tensor) -> torch.Tensor:
    """(..., O, 8, X), O a multiple of 8 (every kernel's): chunk p of row o
    takes chunk p ^ (o % 8), the 128-byte swizzle and its own inverse; one
    gather over each group of 8 rows."""
    *lead, O, _, X = v.shape
    if O % 8:
        raise ValueError(f"the swizzle takes rows in groups of 8, got {O}")
    src = _SWIZZLE.get(v.device)
    if src is None:
        r, p = torch.arange(8)[:, None], torch.arange(8)[None, :]
        src = _SWIZZLE[v.device] = (8 * r + (p ^ r)).flatten().to(v.device)
    flat = v.reshape(*lead, O // 8, 64, X).index_select(-2, src)
    return flat.reshape(v.shape)


PACK_CACHE_SIZE = 256
_pack_cache: OrderedDict = OrderedDict()


def packed(w, pack: Callable) -> torch.Tensor:
    """``pack(w)``, computed once per set of weights; w a tensor or a tuple
    of tensors (packed together). The cache is keyed by the packing and by
    each tensor's device, storage pointer, shape, strides and dtype, and an
    entry is used only while their version counters are unchanged, so a
    change in place repacks. An entry holds the tensors' storage (detached,
    sharing their version counters but not their autograd graph), so their
    pointers cannot be reused by other weights while the entry lasts. The
    least recently used entries beyond ``PACK_CACHE_SIZE`` go. Inference
    tensors have no version counter, and tensors with autograd history (the
    weights weight norm folds anew every training step) are not seen again:
    both are packed at every call and not kept."""
    ws = w if isinstance(w, tuple) else (w,)
    if any(t.is_inference() or t.grad_fn is not None for t in ws):
        return pack(w)
    key = (pack,) + tuple((t.device, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                          for t in ws)
    versions = tuple(t._version for t in ws)
    hit = _pack_cache.get(key)
    if hit is not None and hit[1] == versions:
        _pack_cache.move_to_end(key)
        return hit[2]
    out = pack(w)
    _pack_cache[key] = (tuple(t.detach() for t in ws), versions, out)
    _pack_cache.move_to_end(key)
    while len(_pack_cache) > PACK_CACHE_SIZE:
        _pack_cache.popitem(last=False)
    return out


def _run_units(x: torch.Tensor, chains, entry: str, weights, counted,
               count: str = "launches") -> torch.Tensor:
    """The stage as one launch of ``entry`` per residual unit; ``weights``
    maps a conv's (O, I, k) weight to the layout the entry reads (once per
    set of weights, ``packed``), and each launch adds one to ``counted``'s
    attribute ``count``."""
    lib = _cuda.library()
    B, T, C = x.shape
    out = torch.empty_like(x)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    stream = _cuda.stream_ptr(x)
    launch = getattr(lib, entry)
    n = len(chains)
    for ci, chain in enumerate(chains):
        h = x
        units = list(zip(chain[0::2], chain[1::2]))
        for ui, ((wa, ba, ka, da), (wb, bb, kb, db)) in enumerate(units):
            last = ui == len(units) - 1
            dst = out if last else bufs[ui % 2]
            mode = 1 if (last and ci > 0) else 0
            n_div = n if (last and ci == n - 1) else 1
            pa, pb = packed(wa, weights), packed(wb, weights)
            ba, bb = ba.contiguous(), bb.contiguous()
            err = launch(h.data_ptr(), dst.data_ptr(), pa.data_ptr(), ba.data_ptr(),
                         pb.data_ptr(), bb.data_ptr(), B, T, C, ka, da, kb, db, mode,
                         n_div, stream)
            _cuda.check(err, f"{entry} launch")
            setattr(counted, count, getattr(counted, count) + 1)
            h = dst
    return out


def _check_tc(x: torch.Tensor, chains) -> None:
    _check(x, chains)
    if x.shape[2] not in TC_CHANNELS or x.data_ptr() % 16:
        raise ValueError(f"resblock kernel takes C in {TC_CHANNELS} and 16-byte aligned "
                         f"rows, got C={x.shape[2]}")


def _flat(chains) -> tuple:
    """A list of chains as the ops' flat arguments: (weights, biases, ks,
    dilations, chain_sizes)."""
    convs = [c for chain in chains for c in chain]
    if any(b is None for _, b, _, _ in convs):
        raise ValueError("conv weights must be float32 (C, C, k), odd k, with a (C,) bias, "
                         "on the input's device")
    return ([w for w, _, _, _ in convs], [b for _, b, _, _ in convs],
            [int(k) for _, _, k, _ in convs], [int(d) for _, _, _, d in convs],
            [len(chain) for chain in chains])


def _chains(weights, biases, ks, dilations, chain_sizes) -> list:
    """Inverse of ``_flat``."""
    convs = list(zip(weights, biases, ks, dilations))
    starts = [sum(chain_sizes[:i]) for i in range(len(chain_sizes))]
    return [convs[s:s + n] for s, n in zip(starts, chain_sizes)]


# The forward-only wrappers reach their kernels through custom ops of the
# namespace "rvc" (torch.library): the CPU implementation is the plain
# version, the CUDA implementation the launch (checks, packing, workspace
# and launch counts run there, on real tensors), and the fake implementation
# gives the output's shape, so that torch.export traces a graph that holds
# the op and launches the kernel when the exported program runs.
@torch.library.custom_op("rvc::resblock_group", mutates_args=(), device_types="cpu")
def _resblock_group_op(x: torch.Tensor, weights: list[torch.Tensor],
                       biases: list[torch.Tensor], ks: list[int], dilations: list[int],
                       chain_sizes: list[int]) -> torch.Tensor:
    return resblock_group_plain(x, _chains(weights, biases, ks, dilations,
                                           chain_sizes)).contiguous()


@_resblock_group_op.register_kernel("cuda")
def _resblock_group_cuda(x, weights, biases, ks, dilations, chain_sizes):
    chains = _chains(weights, biases, ks, dilations, chain_sizes)
    _check_tc(x, chains)
    if x.dtype == torch.bfloat16:
        return _run_units(x, chains, "rvc_resblock_unit_bf16", pack_bf16_weights,
                          fused_resblock_group, "launches_bf16")
    return _run_units(x, chains, "rvc_resblock_unit", pack_tf32_weights, fused_resblock_group)


@_resblock_group_op.register_fake
def _resblock_group_fake(x, weights, biases, ks, dilations, chain_sizes):
    return x.new_empty(x.shape)


def fused_resblock_group(x: torch.Tensor, chains: Sequence[Sequence[Conv]]) -> torch.Tensor:
    """x (B, T, C) float32 or bfloat16; chains: per ResBlock1, its convs in
    order as (weight (O, I, k), bias, k, dilation), float32. Returns
    (Σ_c chain_c(x)) / n in x's dtype, through ``rvc::resblock_group``.
    Raises when gradients are wanted."""
    _refuse_grad(x, chains, "fused_resblock_group")
    return torch.ops.rvc.resblock_group.default(x, *_flat(chains))


fused_resblock_group.launches = 0
fused_resblock_group.launches_bf16 = 0


@torch.library.custom_op("rvc::resblock1_v2", mutates_args=(), device_types="cpu")
def _resblock1_v2_op(x: torch.Tensor, weights: list[torch.Tensor], biases: list[torch.Tensor],
                     ks: list[int], dilations: list[int]) -> torch.Tensor:
    return fused_resblock1_plain(x, _chains(weights, biases, ks, dilations,
                                            [len(weights)])[0]).contiguous()


@_resblock1_v2_op.register_kernel("cuda")
def _resblock1_v2_cuda(x, weights, biases, ks, dilations):
    convs = _chains(weights, biases, ks, dilations, [len(weights)])[0]
    _check_chain(x, convs, torch.bfloat16)
    _check_tc(x, [convs])
    return _run_units(x, [convs], "rvc_resblock_unit_bf16", pack_bf16_weights,
                      fused_resblock1_v2)


@_resblock1_v2_op.register_fake
def _resblock1_v2_fake(x, weights, biases, ks, dilations):
    return x.new_empty(x.shape)


def fused_resblock1_v2(x: torch.Tensor, convs: Sequence[Conv]) -> torch.Tensor:
    """Kernel 8: one ResBlock1 chain over x (B, T, C) bfloat16 with the bf16
    carry (the bf16 unit kernel, a launch per unit), through
    ``rvc::resblock1_v2``; convs as in ``fused_resblock_group``. Its plain
    version is ``fused_resblock1_plain``. Forward only: raises when
    gradients are wanted."""
    _refuse_grad(x, [convs], "fused_resblock1_v2")
    if x.dtype != torch.bfloat16:
        raise ValueError("fused_resblock1_v2 takes bfloat16 activations")
    return torch.ops.rvc.resblock1_v2.default(x, *_flat([convs])[:4])


fused_resblock1_v2.launches = 0


def _device_only(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")


def _check_chain(x: torch.Tensor, convs: Sequence[Conv],
                 dtype: torch.dtype = torch.float32) -> None:
    _check(x, [convs])
    if x.dtype != dtype:
        raise ValueError(f"this chain kernel takes {dtype} activations, got {x.dtype}")
    k = convs[0][2]
    if any(ck != k for _, _, ck, _ in convs) or any(d != 1 for _, _, _, d in convs[1::2]):
        raise ValueError("a ResBlock1 chain has one kernel size, and dilation 1 "
                         "in the second conv of each unit")


def _resblock1_forward(x: torch.Tensor, convs: Sequence[Conv], slope: float = 0.1):
    """Kernel 4 on the card at the leaky ReLU's ``slope``: (y, hs) with hs
    (n-1, B, T, C) the outputs of units 0..n-2, i.e. the inputs of units
    1..n-1. The chain's weights are split and packed in one batch
    (``pack_chain_weights``) once per set of weights (``packed``); weights
    that carry autograd history, as in training, are new every step and
    packed at every call."""
    _check_chain(x, convs)
    B, T, C = x.shape
    n = len(convs) // 2
    hs = x.new_empty((max(n - 1, 1), B, T, C))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out, hs
    ws = packed(tuple(w for w, _, _, _ in convs), pack_chain_weights)
    bias = torch.stack([b for _, b, _, _ in convs]).contiguous()
    dil = (ctypes.c_int * n)(*[d for _, _, _, d in convs[0::2]])
    t = torch.empty_like(x)  # each unit's conv_a output
    err = _cuda.library().rvc_resblock1_fwd(
        x.data_ptr(), hs.data_ptr(), out.data_ptr(), t.data_ptr(),
        (ctypes.c_void_p * len(ws))(*[w.data_ptr() for w in ws]), bias.data_ptr(), B, T, C,
        convs[0][2], n, dil, slope, _cuda.stream_ptr(x))
    _cuda.check(err, "resblock1_fwd launch")
    fused_resblock1.launches += 1
    return out, hs


@torch.library.custom_op("rvc::resblock1", mutates_args=(), device_types="cpu")
def _resblock1_op(x: torch.Tensor, weights: list[torch.Tensor], biases: list[torch.Tensor],
                  ks: list[int], dilations: list[int]) -> torch.Tensor:
    return fused_resblock1_plain(x, _chains(weights, biases, ks, dilations,
                                            [len(weights)])[0]).contiguous()


@_resblock1_op.register_kernel("cuda")
def _resblock1_cuda(x, weights, biases, ks, dilations):
    return _resblock1_forward(x, _chains(weights, biases, ks, dilations, [len(weights)])[0])[0]


@_resblock1_op.register_fake
def _resblock1_fake(x, weights, biases, ks, dilations):
    return x.new_empty(x.shape)


def fused_resblock1(x: torch.Tensor, convs: Sequence[Conv]) -> torch.Tensor:
    """Kernel 4: one ResBlock1 chain over x (B, T, C) float32, through
    ``rvc::resblock1``; convs as in ``fused_resblock_group``. Forward only:
    raises when gradients are wanted."""
    _refuse_grad(x, [convs], "fused_resblock1")
    return torch.ops.rvc.resblock1.default(x, *_flat([convs])[:4])


fused_resblock1.launches = 0


def fused_resblock1_backward_plain(x: torch.Tensor, hs: torch.Tensor, gy: torch.Tensor,
                                   convs: Sequence[Conv], slope: float = 0.1):
    """Kernel 5's plain version: autograd of the plain float32 chain at x
    and ``slope`` (which recomputes the chain, so ``hs`` is not read)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        ps = [(w.detach().requires_grad_(), b.detach().requires_grad_(), k, d)
              for w, b, k, d in convs]
        g = torch.autograd.grad(fused_resblock1_plain(xg, ps, slope),
                                [xg] + [t for w, b, _, _ in ps for t in (w, b)], gy)
    return g[0], torch.stack(g[1::2]), torch.stack(g[2::2])


def pack_backward_weights(convs: Sequence[Conv]) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 5's weights, split and packed for its ``mma.sync`` B fragments
    (``pack_tf32_weights``): each unit's conv_a, and every conv's flipped
    transpose. Its layout is not kernel 4's (``pack_tf32_wgmma_weights``), so
    the backward packs its own, once a call."""
    w = torch.stack([cw for cw, _, _, _ in convs])  # (2n, O, I, k)
    return pack_tf32_weights(w[0::2]), pack_tf32_weights(w.transpose(1, 2).flip(3))


def fused_resblock1_backward(x: torch.Tensor, hs: torch.Tensor, gy: torch.Tensor,
                             convs: Sequence[Conv], packs=None, slope: float = 0.1):
    """Kernel 5: the chain's VJP at x (float32, leaky ReLU ``slope``),
    given the unit inputs ``hs`` that kernel 4 kept at that slope. Returns
    (dx (B, T, C), dW (2n, C, C, k) in the convs' (O, I, k) layout, db (2n,
    C)). On the card its convolutions run on the tensor cores in 3xTF32, on
    ``packs`` = ``pack_backward_weights(convs)`` (packed here when not
    given)."""
    if x.device.type == "cpu":
        return fused_resblock1_backward_plain(x, hs, gy, convs, slope)
    _device_only(x)
    _check_chain(x, convs)
    B, T, C = x.shape
    k = convs[0][2]
    if k > MAX_TAPS:
        raise ValueError(f"kernel 5 takes k up to {MAX_TAPS}, got {k}")
    packed_a, packed_t = pack_backward_weights(convs) if packs is None else packs
    bias = torch.stack([cb for _, cb, _, _ in convs]).contiguous()
    dil = (ctypes.c_int * (len(convs) // 2))(*[d for _, _, _, d in convs[0::2]])
    gy = gy.contiguous()
    lib = _cuda.library()
    work = x.new_empty(lib.rvc_resblock1_bwd_workspace(B, T, C, k))
    dx = torch.empty_like(x)
    dw = x.new_empty((len(convs), k, C, C))
    db = x.new_empty(bias.shape)
    err = lib.rvc_resblock1_bwd(
        x.data_ptr(), hs.data_ptr(), gy.data_ptr(), packed_a.data_ptr(), packed_t.data_ptr(),
        bias.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(), work.data_ptr(),
        work.numel(), B, T, C, k, len(dil), dil, slope, _cuda.stream_ptr(x))
    _cuda.check(err, "resblock1_bwd launch")
    fused_resblock1_backward.launches += 1
    return dx, dw.permute(0, 3, 2, 1), db


fused_resblock1_backward.launches = 0


def _preactivations(x: torch.Tensor, convs: Sequence[Conv], slope: float = 0.1
                    ) -> list[torch.Tensor]:
    """The inputs of the chain's leaky ReLUs in forward order, each (B, C, T):
    site 2u is unit u's input h, site 2u + 1 its first conv's output t
    (site c is the input of conv c)."""
    h = x.transpose(1, 2)
    sites = []
    for (wa, ba, ka, da), (wb, bb, kb, db) in zip(convs[0::2], convs[1::2]):
        t = F.conv1d(F.leaky_relu(h, slope), wa, ba, padding=(ka * da - da) // 2, dilation=da)
        sites += [h, t]
        h = h + F.conv1d(F.leaky_relu(t, slope), wb, bb, padding=(kb * db - db) // 2,
                         dilation=db)
    return sites


def _fixed_slope_vjp(acts, slopes, convs: Sequence[Conv], inject):
    """The chain's VJP with its leaky ReLUs' slopes fixed, for a cotangent
    injected at the sites only (none at the output): acts[c] (N, C, L) is
    conv c's input (its leaky ReLU applied), slopes[c] the slope at site c,
    inject[c] a cotangent added at site c after its slope, or None. Returns
    dx (N, C, L) and, per batch entry, dW (N, 2n, O, I, k) and db (N, 2n, C)."""
    dw, db = [None] * len(convs), [None] * len(convs)

    def through(g, c):  # conv c's weight and bias gradients, and its input's
        w, _, k, d = convs[c]
        pad = (k - 1) * d // 2
        a = F.pad(acts[c], (pad, pad))
        L = g.shape[-1]
        dw[c] = torch.stack([torch.einsum("nol,nil->noi", g, a[..., j * d:j * d + L])
                             for j in range(k)], dim=-1)
        db[c] = g.sum(-1)
        return F.conv_transpose1d(g, w, padding=pad, dilation=d)

    def site(g, c):
        return g if inject[c] is None else g + inject[c]

    gh = torch.zeros_like(acts[0])
    for u in reversed(range(len(convs) // 2)):
        gt = site(slopes[2 * u + 1] * through(gh, 2 * u + 1), 2 * u + 1)
        gh = site(gh + slopes[2 * u] * through(gt, 2 * u), 2 * u)
    return gh, torch.stack(dw, 1), torch.stack(db, 1)


MAX_NEAR_ZERO = 4096  # pre-activations near 0 that check_chain_grads will fit


def check_chain_grads(x: torch.Tensor, convs: Sequence[Conv], got, ref,
                      tol: float = 1e-4, slope: float = 0.1) -> tuple[str | None, dict]:
    """Kernel 5's gradients ``got`` = (dx (B, T, C), dW (2n, O, I, k), db
    (2n, C)) against ``ref`` (autograd of the plain chain), every element,
    for the chain at x (float32) with leaky ReLUs of ``slope`` (0.1, or
    bf16(0.1) for the bf16 training route's backward).

    A leaky ReLU's slope (1 or ``slope``) follows its input's sign, so where a
    pre-activation lies within float32 rounding of 0 the two versions may
    take different slopes, and their gradients then differ by that site's
    change of cotangent carried back through the chain. Such sites are found
    in a float64 run of the plain chain: |v64| <= 8 x (the largest
    |v32 - v64| at that site). The gradients are linear in the cotangent at
    each of them, and everywhere else both versions take the float64 slope;
    so got - ref = A u up to rounding, where column e of A is the gradients
    (dx, dW, db, in float64) that a unit cotangent at site e gives, with
    every such site's slope set to 0, and u_e is the difference of the two
    versions' cotangents there. u is fitted by least squares (each tensor
    scaled by its largest magnitude in ``ref``), and what is left must be
    within ``tol`` of that magnitude in every element of dx, and of dW and
    db of every conv. A column is computed in a window of 4 x reach + 1 rows
    around its site (reach: the sum of the convs' halos), wide enough that
    its gradients are exact. Returns (None or a message, counts)."""
    T = x.shape[1]
    c32 = [(w.detach(), b.detach(), k, d) for w, b, k, d in convs]
    c64 = [(w.double(), b.double(), k, d) for w, b, k, d in c32]
    with torch.no_grad():
        s32 = _preactivations(x.detach(), c32, slope)
        s64 = _preactivations(x.detach().double(), c64, slope)
        near = [v.abs() <= 8.0 * (a.double() - v).abs().max() for a, v in zip(s32, s64)]
        at = torch.cat([torch.cat([torch.full_like(i[:, :1], s), i], 1)
                        for s, m in enumerate(near) for i in [m.nonzero()]])
        n_e = at.shape[0]
        # dx, dW, db, each scaled by its (each conv's) largest magnitude in ref
        scales = [ref[0].abs().max().reshape(1, 1, 1),
                  ref[1].flatten(1).abs().amax(1).reshape(-1, 1, 1, 1),
                  ref[2].abs().amax(1).reshape(-1, 1)]
        scales = [v.double().clamp(min=1e-30) for v in scales]
        r = [(g - f).double() / v for g, f, v in zip(got, ref, scales)]
        counts = {"near_zero": n_e, "explained": int(sum((v.abs() > tol).sum() for v in r))}
        if n_e > MAX_NEAR_ZERO:
            return f"{n_e} pre-activations near 0, more than {MAX_NEAR_ZERO} to fit", counts
        if n_e:
            A = _site_columns(s64, near, c64, at, T, slope)
            for a, v in zip(A, scales):
                a.div_(v)
            b_of = at[:, 1]
            flat = [a.flatten(1) for a in A]
            G = (flat[0] @ flat[0].T) * (b_of[:, None] == b_of[None])
            rhs = (flat[0] * r[0][b_of].flatten(1)).sum(1)
            for a, v in zip(flat[1:], r[1:]):
                G += a @ a.T
                rhs += a @ v.flatten()
            u = torch.linalg.lstsq(G.cpu(), rhs.cpu()[:, None], driver="gelsd").solution
            u = u[:, 0].to(G.device)
            r[0] = r[0].index_add(0, b_of, -u[:, None, None] * A[0])
            r[1:] = [v - torch.tensordot(u, a, 1) for v, a in zip(r[1:], A[1:])]
        counts["worst"] = max(v.abs().max().item() for v in r)
    faults = []
    bad = r[0].abs() > tol
    if bad.any():
        b, t = divmod(int(r[0].abs().amax(-1).argmax()), T)
        faults.append(f"dx in {int(bad.sum())} elements (the worst at sample {b}, row {t})")
    for name, v in (("dW", r[1]), ("db", r[2])):
        for c, n_bad in enumerate((v.abs() > tol).flatten(1).sum(1).tolist()):
            if n_bad:
                faults.append(f"{name} of conv {c} in {n_bad} elements")
    if faults:
        return (f"beyond {tol} of the largest magnitude after fitting the slopes of {n_e} "
                f"pre-activations near 0: " + "; ".join(faults)), counts
    return None, counts


def _site_columns(s64, near, c64, at, T: int, slope: float):
    """For each site e = (site, sample, channel, row) in ``at``: the float64
    gradients (dx (T, C) of its sample, dW (2n, O, I, k), db (2n, C)) that a
    unit cotangent at e gives, every slope near 0 set to 0."""
    reach = sum((k - 1) * d // 2 for _, _, k, d in c64)
    L = 4 * reach + 1
    n_e = at.shape[0]
    e_i, b_i, ch_i, t_i = at.unbind(1)

    def window(v):  # (B, C, T) -> (n_e, C, L): rows t - 2 reach .. t + 2 reach, zeros outside
        return F.pad(v, (2 * reach, 2 * reach)).unfold(-1, L, 1)[b_i, :, t_i]
    acts = [window(F.leaky_relu(v, slope)) for v in s64]
    slopes = [window(v.new_full(v.shape, slope).masked_fill_(v > 0, 1.0).masked_fill_(m, 0.0))
              for v, m in zip(s64, near)]
    inject = []
    for s in range(len(s64)):
        mine = e_i == s
        if not mine.any():
            inject.append(None)
            continue
        g = torch.zeros_like(acts[0])
        g[mine.nonzero()[:, 0], ch_i[mine], 2 * reach] = 1.0
        inject.append(g)
    dx_w, dw, db = _fixed_slope_vjp(acts, slopes, c64, inject)
    C = dx_w.shape[1]
    dx = dx_w.new_zeros((n_e, T + 4 * reach, C))
    rows = t_i[:, None] + torch.arange(L, device=t_i.device)
    dx[torch.arange(n_e, device=t_i.device)[:, None], rows] = dx_w.transpose(1, 2)
    return dx[:, 2 * reach:2 * reach + T], dw, db


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


class _Resblock1TrainBf16(torch.autograd.Function):
    """The chain in bfloat16 (module docstring): the bf16 unit kernel
    forward (the plain bf16 chain on the CPU); the float32 backward at
    bf16(0.1) on x upcast, dx cast to bf16."""

    @staticmethod
    def forward(ctx, x, spec, *params):
        n = len(spec)
        convs = [(w, b, k, d) for w, b, (k, d) in zip(params[:n], params[n:], spec)]
        if x.device.type == "cpu":
            y = fused_resblock1_plain(x, convs)
        else:
            _check_chain(x, convs, torch.bfloat16)
            _check_tc(x, [convs])
            y = _run_units(x, [convs], "rvc_resblock_unit_bf16", pack_bf16_weights,
                           fused_resblock1_train, "launches_bf16")
        ctx.spec = spec
        ctx.save_for_backward(x, *params)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, *params = ctx.saved_tensors
        n = len(ctx.spec)
        convs = [(w, b, k, d) for w, b, (k, d) in zip(params[:n], params[n:], ctx.spec)]
        x32 = x.float()
        hs = None if x.device.type == "cpu" else _resblock1_forward(x32, convs, BF16_SLOPE)[1]
        dx, dw, db = fused_resblock1_backward(x32, hs, gy.float().contiguous(), convs,
                                              slope=BF16_SLOPE)
        return (dx.to(x.dtype), None, *dw.unbind(0), *db.unbind(0))


def fused_resblock1_train(x: torch.Tensor, convs: Sequence[Conv]) -> torch.Tensor:
    """Differentiable chain over x (B, T, C), float32 or bfloat16; gradients
    reach x and every (weight, bias), and through them the weight-norm
    parameters. float32: forward kernel 4, backward kernel 5 on the card,
    the plain version under autograd on the CPU. bfloat16: the route of the
    module docstring (the bf16 unit kernel, then kernel 4 at bf16(0.1) and
    kernel 5 at bf16(0.1)), its plain version on the CPU."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    spec = tuple((k, d) for _, _, k, d in convs)
    params = [w for w, _, _, _ in convs] + [b for _, b, _, _ in convs]
    if x.dtype == torch.bfloat16:
        return _Resblock1TrainBf16.apply(x.contiguous(), spec, *params)
    if x.device.type == "cpu":
        return fused_resblock1_plain(x, convs)
    return _Resblock1Train.apply(x.contiguous(), spec, *params)


fused_resblock1_train.launches_bf16 = 0
