"""Kernels 6 and 7: the gated WaveNet ("WN") stack, forward and backward.

Counterpart of ``rvc_tpu/ops/pallas_wavenet.py::fused_wn``, same signature
and weight layout (the split tanh/sigmoid halves of
``rvc_tpu/models/wavenet.py::WN._fused``). Per layer i:

    a, b  = conv_k(x)·W{a,b}_i + b{a,b}_i + g{a,b}_i   (g broadcast over T)
    acts  = tanh(a)·sigmoid(b)
    x     = (x + acts·Wres_i + bres_i)·mask
    skip += acts·Wskip_i + bskip_i

and the stack returns skip·mask; ``mask`` is ``t < lengths[b]``. The last
layer's res weights are zero (its C-wide output is all skip).

On a CUDA tensor ``fused_wn`` is a ``torch.autograd.Function``: its forward
is kernel 6 (``csrc/wavenet.cu``: two launches a layer on ``wgmma`` in
3xTF32, the in-conv with its a and b outputs interleaved by groups of 8
channels and the res/skip 1x1 with res and skip interleaved alike, on
weights split and packed at every call by ``pack_forward_weights``; each
layer's input and gate pre-activations kept) and its backward kernel 7
(``fused_wn_backward``: dx, dW{a,b}, db{a,b}, dG, dW{res,skip}, db{res,skip},
the weight gradients reduced on the card in a fixed order). On a CPU tensor
it runs ``fused_wn_plain``, the same function with ``F.conv1d`` under
autograd. The gradient through the weight-norm fold is left to autograd
outside, as in the JAX glue. The JAX wrapper chains launches of at most 8
layers and sums their skips; here a stack of any depth is one chain, so the
16-layer posterior encoder sums its skips in another order (float32
rounding only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .resblock import MAX_TAPS, pack_tf32_weights, pack_tf32_wgmma_weights


def fused_wn_plain(x, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths, *,
                   kernel_size: int) -> torch.Tensor:
    """x (B, T, C); w_a/w_b (L·k, C, C) [tap][in][out]; b_ab (2L, C) rows
    [a_0..a_{L-1}, b_0..b_{L-1}]; g_ab (B, 2L, C) in the same row plan;
    w_res/w_skip (L, C, C) [in][out]; b_rs2 (2L, C) rows [res..., skip...];
    lengths (B,). Returns skip·mask (B, T, C)."""
    B, T, C = x.shape
    L, k = w_res.shape[0], kernel_size
    keep = (torch.arange(T, device=x.device)[None, :] < lengths[:, None]).to(x.dtype)[:, None]
    h = x.transpose(1, 2)
    skip = None
    for i in range(L):
        wa = w_a[i * k:(i + 1) * k].permute(2, 1, 0)
        wb = w_b[i * k:(i + 1) * k].permute(2, 1, 0)
        a = F.conv1d(h, wa, b_ab[i], padding=(k - 1) // 2) + g_ab[:, i, :, None]
        b = F.conv1d(h, wb, b_ab[L + i], padding=(k - 1) // 2) + g_ab[:, L + i, :, None]
        acts = torch.tanh(a) * torch.sigmoid(b)
        res = torch.einsum("bct,cd->bdt", acts, w_res[i]) + b_rs2[i][:, None]
        sk = torch.einsum("bct,cd->bdt", acts, w_skip[i]) + b_rs2[L + i][:, None]
        h = (h + res) * keep
        skip = sk if skip is None else skip + sk
    return (skip * keep).transpose(1, 2)


def _check(x, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths, k: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 (B, T, C) tensor")
    B, T, C = x.shape
    L = w_res.shape[0]
    if C % 16 or C > 256 or k % 2 == 0 or L < 1:
        raise ValueError(f"WN kernel takes C a multiple of 16 up to 256 and odd k, "
                         f"got C={C}, k={k}")
    shapes = {"w_a": (w_a, (L * k, C, C)), "w_b": (w_b, (L * k, C, C)),
              "b_ab": (b_ab, (2 * L, C)), "g_ab": (g_ab, (B, 2 * L, C)),
              "w_res": (w_res, (L, C, C)), "w_skip": (w_skip, (L, C, C)),
              "b_rs2": (b_rs2, (2 * L, C))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be float32 {shape} on x's device")
    if lengths.shape != (B,) or lengths.device != x.device:
        raise ValueError("lengths must be (B,) on x's device")


def interleave(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """Two (L, C, ...) stacks of outputs as one (L, 2C, ...), interleaved by
    groups of 8: rows 16q..16q+7 are first's rows 8q..8q+7, the next 8
    second's."""
    L, C = first.shape[:2]
    pair = torch.stack([first.reshape(L, C // 8, 8, *first.shape[2:]),
                        second.reshape(L, C // 8, 8, *second.shape[2:])], dim=2)
    return pair.reshape(L, 2 * C, *first.shape[2:])


def forward_convs(w_a, w_b, w_res, w_skip, k: int):
    """Kernel 6's convs in (O, I, k) layout, per layer, their outputs
    interleaved by groups of 8 (``interleave``): the in-conv (L, 2C, C, k),
    a and b; the 1x1 (L, 2C, C, 1), res and skip, but for the last layer,
    whose res is zero and not computed: skip in rows 0..C-1, zeros after."""
    L, C = w_res.shape[0], w_res.shape[1]
    wab = interleave(*[w.reshape(L, k, C, C).permute(0, 3, 2, 1) for w in (w_a, w_b)])
    wrs = interleave(w_res.transpose(1, 2), w_skip.transpose(1, 2))
    last = torch.cat([w_skip[-1].t(), torch.zeros_like(w_skip[-1])])
    return wab, torch.cat([wrs[:-1], last[None]])[..., None]


def pack_forward_weights(w_a, w_b, w_res, w_skip, k: int):
    """Kernel 6's weights: its convs (``forward_convs``) split into TF32
    images for its ``wgmma`` B operand (``pack_tf32_wgmma_weights``)."""
    wab, wrs = forward_convs(w_a, w_b, w_res, w_skip, k)
    return pack_tf32_wgmma_weights(wab), pack_tf32_wgmma_weights(wrs)


def _forward(x, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths, k, packs=None):
    """Kernel 6: (skip·mask, xs (L-1, B, T, C) the inputs of layers 1..L-1,
    pre_a, pre_b (L, B, T, C) the gate pre-activations). Its products run on
    ``packs`` = ``pack_forward_weights(w_a, w_b, w_res, w_skip, k)``, packed
    here when not given: in training the weights change every step, so they
    are packed at every call and never cached."""
    _check(x, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths, k)
    if x.data_ptr() % 16:
        raise ValueError("kernel 6 takes x on a 16-byte boundary")
    B, T, C = x.shape
    L = w_res.shape[0]
    xs = x.new_empty((max(L - 1, 1), B, T, C))
    pre = x.new_empty((2, L, B, T, C))
    out = torch.empty_like(x)
    w_ab, w_rs = pack_forward_weights(w_a, w_b, w_res, w_skip, k) if packs is None else packs
    shapes = ((L, 2, -(-k * C // 32), 2 * C, 8, 4), (L, 2, -(-C // 32), 2 * C, 8, 4))
    if any(tuple(p.shape) != s_ or not p.is_contiguous() for p, s_ in zip((w_ab, w_rs), shapes)):
        raise ValueError(f"kernel 6's packed weights must be contiguous {shapes}")
    bias = [t.contiguous() for t in (b_ab, g_ab, b_rs2)]
    lens = lengths.to(torch.int32).contiguous()
    acts = torch.empty_like(x)
    err = _cuda.library().rvc_wn_fwd(
        x.data_ptr(), xs.data_ptr(), pre[0].data_ptr(), pre[1].data_ptr(), out.data_ptr(),
        acts.data_ptr(), w_ab.data_ptr(), w_rs.data_ptr(), *[t.data_ptr() for t in bias],
        lens.data_ptr(), B, T, C, k, L, _cuda.stream_ptr(x))
    _cuda.check(err, "wn_fwd launch")
    fused_wn.launches += 1
    return out, xs, pre


def fused_wn_backward_plain(x, xs, pre, gy, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2,
                            lengths, *, kernel_size: int):
    """Kernel 7's plain version: autograd of the plain stack at x (which
    recomputes the stack, so ``xs`` and ``pre`` are not read)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2)]
        y = fused_wn_plain(*leaves, lengths, kernel_size=kernel_size)
        grads = torch.autograd.grad(y, leaves, gy, allow_unused=True)
    # a one-layer stack never reads its (zero) res weights
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads))


def backward_convs(w_a, w_b, w_res, w_skip, k: int):
    """The convs of the stack's backward in (O, I, k) layout, per layer:
    dx from [d_a | d_b] with the flipped, transposed in-conv taps
    (L, C, 2C, k): wab[i][c][o][j] = W{a,b}[i][k-1-j][c][o]; and d_acts
    from [d_res | ds], (L, C, 2C, 1): [Wres_i, Wskip_i] side by side."""
    L, C = w_res.shape[0], w_res.shape[1]
    taps = [w.reshape(L, k, C, C).flip(1).permute(0, 2, 3, 1) for w in (w_a, w_b)]
    return torch.cat(taps, dim=2), torch.cat([w_res, w_skip], dim=2)[..., None]


def pack_backward_weights(w_a, w_b, w_res, w_skip, k: int):
    """Kernel 7's weights: the backward's convs (``backward_convs``) split and
    packed for its tensor-core B fragments (``pack_tf32_weights``)."""
    wab, wrs = backward_convs(w_a, w_b, w_res, w_skip, k)
    return pack_tf32_weights(wab), pack_tf32_weights(wrs)


def fused_wn_backward(x, xs, pre, gy, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths, *,
                      kernel_size: int, packs=None):
    """Kernel 7: the stack's VJP, given what kernel 6 kept (xs, pre) and the
    output cotangent gy (B, T, C). Returns (dx, dWa, dWb, dBab, dG, dWres,
    dWskip, dBrs) in the layouts of the forward's arguments. On the card its
    products run on the tensor cores in 3xTF32, on ``packs`` =
    ``pack_backward_weights(w_a, w_b, w_res, w_skip, kernel_size)`` (packed
    here when not given: the weights change every training step). The kernel
    does not read the biases and the conditioning (the kept pre-activations
    hold them); the plain version does."""
    if x.device.type == "cpu":
        return fused_wn_backward_plain(x, xs, pre, gy, w_a, w_b, b_ab, g_ab, w_res, w_skip,
                                       b_rs2, lengths, kernel_size=kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, T, C = x.shape
    L, k = w_res.shape[0], kernel_size
    if k > MAX_TAPS:
        raise ValueError(f"kernel 7 takes k up to {MAX_TAPS}, got {k}")
    wab_t, wrs_t = pack_backward_weights(w_a, w_b, w_res, w_skip, k) if packs is None else packs
    lens = lengths.to(torch.int32).contiguous()
    lib = _cuda.library()
    work = x.new_empty(lib.rvc_wn_bwd_workspace(B, T, C, k))
    dx = torch.empty_like(x)
    grads = [x.new_empty(s) for s in ((L * k, C, C), (L * k, C, C), (2 * L, C),
                                      (B, 2 * L, C), (L, C, C), (L, C, C), (2 * L, C))]
    err = lib.rvc_wn_bwd(
        x.data_ptr(), xs.data_ptr(), pre[0].data_ptr(), pre[1].data_ptr(),
        gy.contiguous().data_ptr(), wab_t.data_ptr(), wrs_t.data_ptr(), lens.data_ptr(),
        dx.data_ptr(),
        *[g.data_ptr() for g in grads], work.data_ptr(), work.numel(), B, T, C, k, L,
        _cuda.stream_ptr(x))
    _cuda.check(err, "wn_bwd launch")
    fused_wn_backward.launches += 1
    return (dx, *grads)


fused_wn_backward.launches = 0


class _FusedWN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths, k):
        out, xs, pre = _forward(x, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths, k)
        ctx.k = k
        ctx.save_for_backward(x, xs, pre, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths)
        return out

    @staticmethod
    def backward(ctx, gy):
        dx, dwa, dwb, dbab, dg, dwres, dwskip, dbrs = fused_wn_backward(
            *ctx.saved_tensors[:3], gy, *ctx.saved_tensors[3:], kernel_size=ctx.k)
        return dx, dwa, dwb, dbab, dg, dwres, dwskip, dbrs, None, None


def fused_wn(x, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths, *,
             kernel_size: int) -> torch.Tensor:
    """Differentiable WN stack (arguments as ``fused_wn_plain``): kernels 6
    and 7 on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return fused_wn_plain(x, w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2, lengths,
                              kernel_size=kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _FusedWN.apply(x.contiguous(), w_a, w_b, b_ab, g_ab, w_res, w_skip, b_rs2,
                          lengths, int(kernel_size))


fused_wn.launches = 0
