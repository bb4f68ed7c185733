"""Primitive layers of the port's networks, in PyTorch's layouts ((B, C, T),
(B, C, H, W)).

Counterparts of ``rvc_tpu/models/layers.py``. The JAX package keeps
activations channels-last; here activations are (B, C, T) as in the
reference's torch code. A layer built with ``weight_norm=True`` holds its
weight folded (``compat.weights.fold_weight_norm``), as inference loads it,
until ``live_weight_norm_`` turns it into the trainable form: parameters
``weight_v`` and ``weight_g`` under the reference's names, and the weight
``g * v / (|v| + 1e-12)`` (norm over every axis but 0) computed at each
call, as the JAX modules compute it. ``init_random_`` draws weights the
way the JAX package's ``fast_init`` does in either form.

Compute dtype: every layer computes in its ``dtype`` (float32 unless
``set_dtype_`` sets another), as the JAX layers' ``dtype`` field does.
Parameters stay float32 and are cast where they are used; a conv or linear
layer rounds its product to the compute dtype and then adds the bias in
that dtype (rvc_tpu/models/layers.py:197-206). A Python scalar that meets
a bfloat16 tensor is rounded to bfloat16 first (``rounded``), as JAX
rounds a weakly typed scalar; torch would keep it in float32. In float32
every layer runs exactly as before.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


def low_precision(dtype: torch.dtype) -> bool:
    """A floating dtype narrower than float32 (bfloat16)."""
    return dtype.is_floating_point and dtype.itemsize < 4


def rounded(v: float, dtype: torch.dtype) -> float:
    """The Python scalar ``v`` as a tensor of ``dtype`` holds it, for ops
    on tensors of a compute dtype below float32 (JAX rounds a weakly typed
    scalar to the array's dtype before the op)."""
    return float(torch.tensor(v, dtype=dtype)) if low_precision(dtype) else v


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, rounded(slope, x.dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """In a dtype below float32, 1 / (1 + exp(-x)) with each op rounded, as
    XLA expands ``jax.nn.sigmoid`` (``lax.logistic``) there."""
    return 1 / (1 + torch.exp(-x)) if low_precision(x.dtype) else torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU; in a dtype below float32 written as ``jax.nn.gelu``
    (approximate=False) writes it, 0.5 x erfc(-x sqrt(1/2)), each op rounded."""
    if not low_precision(x.dtype):
        return F.gelu(x)
    return 0.5 * x * torch.erfc(-x * rounded(0.5 ** 0.5, x.dtype))


def set_dtype_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Make ``module`` and everything in it compute in ``dtype``; the
    parameters stay float32."""
    for m in module.modules():
        m.dtype = dtype
    return module


class _Cast:
    """Mixin of the layers: ``dtype`` is the compute dtype (class default
    float32, set per instance by ``set_dtype_``)."""

    dtype = torch.float32

    def _affine(self, y: torch.Tensor, channels_last: bool = False) -> torch.Tensor:
        """The bias added to a product already rounded to the compute dtype;
        the channels on axis 1, or last."""
        if self.bias is None:
            return y
        b = self.bias.to(self.dtype)
        return y + (b if channels_last else b.view((-1,) + (1,) * (y.dim() - 2)))


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) -> (B, T) bool, True on the first ``lengths[b]`` steps."""
    t = torch.arange(max_length, device=lengths.device)
    return t[None, :] < lengths[:, None]


def norm_except_dim0(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())), keepdim=True))


class _WeightNorm(_Cast):
    """Mixin of the conv layers: ``folded_weight()`` is the weight the layer
    applies, whichever form it holds."""

    weight_norm: bool
    live: bool = False

    def folded_weight(self) -> torch.Tensor:
        if self.live:
            v = self.weight_v
            return self.weight_g * v / (norm_except_dim0(v) + 1e-12)
        return self.weight

    @torch.no_grad()
    def unfold_weight_norm_(self) -> None:
        """Replace ``weight`` by ``weight_v = weight`` and ``weight_g = |weight|``
        (the same folded weight up to the 1e-12), keeping the parameter order."""
        w = self._parameters["weight"]
        g = norm_except_dim0(w)
        params = {}
        for name, p in self._parameters.items():
            if name == "weight":
                params["weight_v"] = nn.Parameter(w.detach().clone())
                params["weight_g"] = nn.Parameter(g)
            else:
                params[name] = p
        self._parameters.clear()
        self._parameters.update(params)
        self.live = True


class Conv1d(_WeightNorm, nn.Conv1d):
    """``nn.Conv1d`` with symmetric integer padding, as the reference uses it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True, weight_norm: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, groups=groups,
                         bias=bias)
        self.weight_norm = weight_norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return self._conv_forward(x, self.folded_weight(), self.bias)
        dt = self.dtype
        x, w = x.to(dt), self.folded_weight().to(dt)
        if self.groups > 1:
            # the same sums over bf16 operands, taken in float32: ATen's CPU
            # bf16 grouped conv gives wrong sums at HuBERT's positional
            # conv (k 128, 16 groups; off by the output's own size)
            return self._affine(self._conv_forward(x.float(), w.float(), None).to(dt))
        return self._affine(self._conv_forward(x, w, None))


class ConvTranspose1d(_WeightNorm, nn.ConvTranspose1d):
    """``nn.ConvTranspose1d``; weight (in, out, k), its norm taken over dim 0
    (the input channels), as the JAX module does. The JAX package's subpixel
    rewrite is a TPU layout trick with the same output."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 weight_norm: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.weight_norm = weight_norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return F.conv_transpose1d(x, self.folded_weight(), self.bias, self.stride,
                                      self.padding, self.output_padding, self.groups,
                                      self.dilation)
        dt = self.dtype
        x, w = x.to(dt), self.folded_weight().to(dt)
        if x.device.type == "cpu":
            # the same sums over bf16 operands, taken in float32: ATen's CPU
            # bf16 transposed conv gives wrong input gradients at a few
            # shapes (8 or 4 outputs, stride 8 or 6: off by their own size)
            return self._affine(F.conv_transpose1d(
                x.float(), w.float(), None, self.stride, self.padding, self.output_padding,
                self.groups, self.dilation).to(dt))
        return self._affine(F.conv_transpose1d(
            x, w, None, self.stride, self.padding, self.output_padding, self.groups,
            self.dilation))


class Conv2d(_WeightNorm, nn.Conv2d):
    """``nn.Conv2d`` (the discriminator's, RMVPE's and the separation nets');
    weight (O, I / groups, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple[int, int],
                 stride: tuple[int, int] = (1, 1), padding: tuple[int, int] = (0, 0),
                 bias: bool = True, weight_norm: bool = False,
                 dilation: tuple[int, int] = (1, 1), groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, groups=groups, bias=bias)
        self.weight_norm = weight_norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return self._conv_forward(x, self.folded_weight(), self.bias)
        dt = self.dtype
        return self._affine(self._conv_forward(x.to(dt), self.folded_weight().to(dt), None))


class ConvTranspose2d(_Cast, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (RMVPE's decoder, MDX-Net's up path); weight
    (I, O, kh, kw)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        dt = self.dtype
        return self._affine(F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), None, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation))


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 with loaded running statistics (eps
    1e-5), any rank: ``x * scale + shift`` with ``scale = w / sqrt(var +
    eps)``, as the JAX package's ``BatchNorm`` folds it."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        scale = (self.weight * inv).to(x.dtype)
        shift = (self.bias - self.running_mean * self.weight * inv).to(x.dtype)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.view(shape) + shift.view(shape)


class Linear(_Cast, nn.Linear):
    """``nn.Linear``; weight (out, in)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        dt = self.dtype
        return self._affine(F.linear(x.to(dt), self.weight.to(dt)), channels_last=True)


class Embedding(_Cast, nn.Embedding):
    """``nn.Embedding``, its rows cast to the compute dtype."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.dtype)


class TorchLayerNorm(_Cast, nn.LayerNorm):
    """``nn.LayerNorm`` over the last axis (HuBERT's; names weight/bias),
    statistics in float32, output in the compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        return super().forward(x.float()).to(self.dtype)


def live_weight_norm_(module: nn.Module) -> nn.Module:
    """Turn every weight-normed layer of ``module`` into its trainable
    (weight_v, weight_g) form, in place."""
    for m in module.modules():
        if isinstance(m, _WeightNorm) and m.weight_norm and not m.live:
            m.unfold_weight_norm_()
    return module


def slice_segments(x: torch.Tensor, starts: torch.Tensor, segment_size: int) -> torch.Tensor:
    """Crops ``x[b, ..., s_b : s_b + segment_size]`` along the last axis of
    (B, T) or (B, C, T). A start past ``T - segment_size`` is clamped to it,
    as ``jax.lax.dynamic_slice`` clamps (rvc_tpu/models/layers.py:599)."""
    T = x.shape[-1]
    s = starts.to(torch.long).clamp(0, max(T - segment_size, 0))
    idx = s[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 2, idx[:, None, :].expand(x.shape[0], x.shape[1], segment_size))


def rand_slice_segments(x: torch.Tensor, lengths: torch.Tensor, segment_size: int,
                        u: torch.Tensor | None = None,
                        generator: torch.Generator | None = None):
    """Random crops of ``segment_size`` frames of x (B, C, T): the start is
    ``int(u * max(length - segment_size + 1, 1))`` with u ~ U[0, 1) per row,
    drawn from ``generator`` unless given (rvc_tpu/models/layers.py:578).
    Returns (slices, starts)."""
    if u is None:
        u = torch.rand(x.shape[0], generator=generator, device=x.device)
    max_start = torch.clamp(lengths - segment_size + 1, min=1).to(u.dtype)
    starts = (u * max_start).to(torch.int32)
    return slice_segments(x, starts, segment_size), starts


class LayerNorm(_Cast, nn.Module):
    """LayerNorm over the channel axis of (B, C, T), reference names
    ``gamma``/``beta``; statistics in float32, output in the compute dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.transpose(1, -1).float(), (x.shape[1],), self.gamma,
                         self.beta, self.eps)
        return y.transpose(1, -1).to(self.dtype)


_ONES = ("gamma", "weight_g", "running_var")  # as fast_init draws them
_ZEROS = ("beta", "running_mean", "bias")


@torch.no_grad()
def init_random_(module: nn.Module, seed: int = 0, scale: float = 0.02) -> nn.Module:
    """Random weights as the JAX package's ``utils/fastinit.fast_init`` draws
    them: N(0, scale²) for weights, ones for gains and running variances,
    zeros for biases and running means. A weight-normed layer draws ``v``
    with ``g = 1``; in the folded form it holds ``v / |v|``. Drawn with numpy
    from ``seed`` in state_dict order."""
    rng = np.random.default_rng(seed)
    wn = {name + ".weight" for name, m in module.named_modules()
          if getattr(m, "weight_norm", False) and not getattr(m, "live", False)}
    for key, t in module.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        if not t.is_floating_point():
            continue
        if leaf in _ONES:
            arr = np.ones(t.shape, np.float32)
        elif leaf in _ZEROS:
            arr = np.zeros(t.shape, np.float32)
        else:
            arr = (scale * rng.standard_normal(t.shape)).astype(np.float32)
            if key in wn:
                norm = np.sqrt(np.sum(arr * arr, axis=tuple(range(1, arr.ndim)),
                                      keepdims=True))
                arr = arr / (norm + 1e-12)
        t.copy_(torch.from_numpy(arr))
    return module


def load_numpy_state_dict(module: nn.Module, state: dict) -> nn.Module:
    """Strict load of a {name: numpy array} state_dict."""
    sd = {k: torch.tensor(np.asarray(v)) for k, v in state.items()}
    module.load_state_dict(sd, strict=True)
    return module
