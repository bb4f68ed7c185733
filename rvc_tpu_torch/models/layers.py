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

import weakref

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


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The first half of ``x`` along ``dim`` times the sigmoid of the second;
    below float32 through ``sigmoid``, each op rounded, as JAX writes it."""
    if not low_precision(x.dtype):
        return F.glu(x, dim)
    a, b = x.chunk(2, dim)
    return a * sigmoid(b)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.softmax``; in a dtype below float32 as ``jax.nn.softmax``
    computes there: exp(x - max) rounded, its sum taken in float32 and
    rounded, the quotient rounded."""
    if not low_precision(x.dtype):
        return torch.softmax(x, dim)
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True, dtype=torch.float32).to(x.dtype)


class GELU(nn.GELU):
    """``nn.GELU`` (exact) through ``gelu``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


class GLU(nn.GLU):
    """``nn.GLU`` through ``glu``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu(x, self.dim)


class LeakyReLU(nn.LeakyReLU):
    """``nn.LeakyReLU`` with its slope rounded to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.negative_slope)


class PReLU(nn.PReLU):
    """``nn.PReLU``; below float32 max(x, 0) + w min(x, 0) with the weight
    cast to the input's dtype, each op rounded (the JAX package's
    ``_prelu``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not low_precision(x.dtype):
            return super().forward(x)
        return x.clamp(min=0) + self.weight.to(x.dtype) * x.clamp(max=0)


# lstm's CUDA graphs: per module, (graph, input, output) by input shape
_LSTM_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def lstm(module: nn.LSTM, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``lstm_steps``. On the card, without autograd, the steps of a call
    are captured once per input shape as one CUDA graph, which each call of
    that shape replays: the same kernels on the same operands, without a
    launch from the host for each op of each step."""
    if not x.is_cuda or torch.is_grad_enabled():
        return lstm_steps(module, x, dtype)
    graphs = _LSTM_GRAPHS.setdefault(module, {})
    key = (tuple(x.shape), x.dtype, dtype, module.weight_ih_l0.data_ptr())
    if key not in graphs:
        static_x = x.clone()
        side, main = torch.cuda.Stream(x.device), torch.cuda.current_stream(x.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):  # a warm-up call before the capture
            lstm_steps(module, static_x, dtype)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_y = lstm_steps(module, static_x, dtype)
        graphs[key] = (graph, static_x, static_y)
    graph, static_x, static_y = graphs[key]
    static_x.copy_(x)
    graph.replay()
    return static_y.clone()


def lstm_steps(module: nn.LSTM, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A bidirectional ``nn.LSTM`` over x (T, B, I) -> (T, B, 2 H) in
    ``dtype``, step by step as the JAX package's scan computes it
    (rvc_tpu/models/demucs.py:29-73): weights and biases cast to ``dtype``,
    the input's gate products rounded and their bias added, at each step
    the input's gates + the product h W_hh (rounded) + the bias, the gates
    through ``sigmoid`` and tanh, c and h carried in ``dtype`` from zeros.
    Both directions go through each step together (one batched product):
    the same roundings as two scans."""
    T, B, _ = x.shape
    H = module.hidden_size
    h = x.to(dtype)
    for layer in range(module.num_layers):
        p = [{name: getattr(module, f"{name}_l{layer}{sfx}").to(dtype)
              for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
             for sfx in ("", "_reverse")]
        xg = torch.stack([F.linear(h, d["weight_ih"]) + d["bias_ih"] for d in p])  # (2, T, B, 4H)
        xg[1] = xg[1].flip(0)
        w_hh = torch.stack([d["weight_hh"].t() for d in p])  # (2, H, 4H)
        b_hh = torch.stack([d["bias_hh"] for d in p])[:, None]  # (2, 1, 4H)
        hs = x.new_zeros((2, B, H), dtype=dtype)
        cs = torch.zeros_like(hs)
        ys = []
        for t in range(T):
            g = xg[:, t] + torch.bmm(hs, w_hh) + b_hh
            s = sigmoid(g)
            i, f, o = s[..., :H], s[..., H: 2 * H], s[..., 3 * H:]
            cs = f * cs + i * torch.tanh(g[..., 2 * H: 3 * H])
            hs = o * torch.tanh(cs)
            ys.append(hs)
        y = torch.stack(ys, dim=1)  # (2, T, B, H)
        h = torch.cat([y[0], y[1].flip(0)], dim=-1)
    return h


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
        if self.groups > 1 or x.device.type == "cpu":
            # the same sums over bf16 operands, taken in float32: ATen's CPU
            # bf16 grouped conv gives wrong sums at HuBERT's positional
            # conv (k 128, 16 groups; off by the output's own size), and
            # its CPU bf16 conv1d at scattered shapes with k >= 4, HTDemucs's
            # 8 channels at k 8, stride 4 among them
            # (scripts/probe_torch_cpu_bf16_conv.py; conv2d and
            # conv_transpose2d showed no such fault there)
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


class _Float32Stats(_Cast):
    """Mixin of the norms: below float32 the statistics are taken in float32
    and the output is cast to the compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        return super().forward(x.float()).to(self.dtype)


class TorchLayerNorm(_Float32Stats, nn.LayerNorm):
    """``nn.LayerNorm`` over the last axis (HuBERT's; names weight/bias)."""


class GroupNorm(_Float32Stats, nn.GroupNorm):
    """``nn.GroupNorm`` (rvc_tpu/models/layers.py ``GroupNorm``)."""


class InstanceNorm2d(_Float32Stats, nn.InstanceNorm2d):
    """``nn.InstanceNorm2d`` (rvc_tpu/models/mdx_net.py ``InstanceNorm2d``)."""


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
