"""Primitive layers of the synthesizer, in PyTorch's (B, C, T) layout.

Counterparts of ``rvc_tpu/models/layers.py``. The JAX package keeps
activations channels-last and reparameterizes weight norm in the module;
here activations are (B, C, T) as in the reference's torch code, and
weight norm arrives folded (``compat.weights.fold_weight_norm``), so the
convolutions are plain ``nn.Conv1d`` / ``nn.ConvTranspose1d`` under the
reference's parameter names. ``weight_norm=True`` only records that the
reference trains the layer with weight norm, which ``init_random_`` uses to
draw weights the way the JAX package's ``fast_init`` does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) -> (B, T) bool, True on the first ``lengths[b]`` steps."""
    t = torch.arange(max_length, device=lengths.device)
    return t[None, :] < lengths[:, None]


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` with symmetric integer padding, as the reference uses it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True, weight_norm: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, groups=groups,
                         bias=bias)
        self.weight_norm = weight_norm


class ConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d``; weight (in, out, k). The JAX package's subpixel
    rewrite is a TPU layout trick with the same output."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 weight_norm: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.weight_norm = weight_norm


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis of (B, C, T), reference names
    ``gamma``/``beta``."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.transpose(1, -1), (x.shape[1],), self.gamma,
                         self.beta, self.eps)
        return y.transpose(1, -1)


_ONES = ("gamma", "weight_g", "running_var")
_ZEROS = ("beta", "running_mean", "bias")


@torch.no_grad()
def init_random_(module: nn.Module, seed: int = 0, scale: float = 0.02) -> nn.Module:
    """Random weights as the JAX package's ``utils/fastinit.fast_init`` draws
    them: N(0, scale²) for weights, ones for gains and running variances,
    zeros for biases and running means. A weight-normed layer draws ``v``
    with ``g = 1`` and holds the folded ``v / |v|``. Drawn with numpy from
    ``seed`` in state_dict order."""
    rng = np.random.default_rng(seed)
    wn = {name + ".weight" for name, m in module.named_modules()
          if getattr(m, "weight_norm", False)}
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
