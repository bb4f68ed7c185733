"""Gated dilated-conv WaveNet block (the VITS "WN").

Counterpart of ``rvc_tpu/models/wavenet.py::WN``; activations (B, C, T).
When gradients are wanted, or ``fuse`` is set (the JAX ``Trainer`` builds
its synthesizer with ``fuse_wn``, so its evaluation runs the fused stack
too; the port's ``Trainer`` sets ``fuse``), and under the JAX module's
conditions (dilation rate 1, a conditioning of length 1), the stack runs
as ``ops.wavenet.fused_wn``
(kernels 6 and 7 on the card, in groups of 8 layers): the conditioning
layer in the compute dtype, its output and the weights float32, the output
in x's dtype (rvc_tpu/models/wavenet.py:95-158); otherwise layer by layer,
as inference does (the JAX package leaves ``fuse_wn`` off at inference).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.wavenet import fused_wn
from .layers import Conv1d, sigmoid


class WN(nn.Module):
    fuse = False  # run the fused stack without gradients too (the trainer's)

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation_rate = dilation_rate
        self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        if gin_channels:
            self.cond_layer = Conv1d(gin_channels, 2 * hidden_channels * n_layers, 1,
                                     weight_norm=True)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            d = dilation_rate ** i
            self.in_layers.append(Conv1d(hidden_channels, 2 * hidden_channels, kernel_size,
                                         dilation=d, padding=(kernel_size * d - d) // 2,
                                         weight_norm=True))
            out = 2 * hidden_channels if i < n_layers - 1 else hidden_channels
            self.res_skip_layers.append(Conv1d(hidden_channels, out, 1, weight_norm=True))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None = None
                ) -> torch.Tensor:
        """x (B, H, T), masked; x_mask (B, 1, T) a prefix mask; g (B, gin, 1)
        or None."""
        train = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        if (train or self.fuse) and self.dilation_rate == 1 and (g is None or g.shape[-1] == 1):
            return self._fused(x, x_mask, g)
        H = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g) if g is not None else None
        for i, (in_layer, rs_layer) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            s = in_layer(x)
            if g_all is not None:
                s = s + g_all[:, i * 2 * H:(i + 1) * 2 * H]
            acts = torch.tanh(s[:, :H]) * sigmoid(s[:, H:])
            rs = rs_layer(acts)
            if i < self.n_layers - 1:
                x = (x + rs[:, :H]) * x_mask
                output = output + rs[:, H:]
            else:
                output = output + rs
        return output * x_mask

    def fused_args(self, x_mask: torch.Tensor, g: torch.Tensor | None) -> tuple:
        """``fused_wn``'s arguments after x: the stack's weights in the split
        layout of ``rvc_tpu/models/wavenet.py::WN._fused``, the conditioning
        per layer, and the lengths of the prefix mask."""
        C, L = self.hidden_channels, self.n_layers
        B = x_mask.shape[0]
        if g is not None:
            g_lc = self.cond_layer(g)[:, :, 0].float().reshape(B, L, 2 * C)
            g_ab = torch.cat([g_lc[:, :, :C], g_lc[:, :, C:]], dim=1)
        else:
            g_ab = x_mask.new_zeros((B, 2 * L, C), dtype=torch.float32)
        w_a, w_b, b_a, b_b, w_res, w_skip, b_res, b_skip = ([] for _ in range(8))
        for i, (in_layer, rs_layer) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            taps = in_layer.folded_weight().permute(2, 1, 0)  # (k, C, 2C)
            w_a.append(taps[:, :, :C])
            w_b.append(taps[:, :, C:])
            b_a.append(in_layer.bias[:C])
            b_b.append(in_layer.bias[C:])
            rw = rs_layer.folded_weight()[:, :, 0].t()  # (C, out)
            rb = rs_layer.bias
            if i == L - 1:
                w_res.append(rw.new_zeros((C, C)))
                w_skip.append(rw)
                b_res.append(rb.new_zeros((C,)))
                b_skip.append(rb)
            else:
                w_res.append(rw[:, :C])
                w_skip.append(rw[:, C:])
                b_res.append(rb[:C])
                b_skip.append(rb[C:])
        lengths = (x_mask[:, 0] > 0).sum(dim=1).to(torch.int32)
        return (torch.cat(w_a), torch.cat(w_b), torch.stack(b_a + b_b), g_ab,
                torch.stack(w_res), torch.stack(w_skip), torch.stack(b_res + b_skip), lengths)

    def _fused(self, x: torch.Tensor, x_mask: torch.Tensor, g: torch.Tensor | None
               ) -> torch.Tensor:
        out = fused_wn(x.transpose(1, 2).contiguous(), *self.fused_args(x_mask, g),
                       kernel_size=self.kernel_size)
        return out.transpose(1, 2).to(x.dtype)
