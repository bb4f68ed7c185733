"""Rational-rate resampling on the device, ``scipy.signal.resample_poly``'s
function.

Counterpart of ``rvc_tpu/ops/resample.py``: the same Kaiser-windowed FIR
(``_poly_filter_np``), the same centring and output length. The JAX
package writes it as one convolution over the zero-stuffed input
(``lhs_dilation``); here it is its polyphase form, which never forms the
stuffed signal (48 kHz to 44.1 kHz stuffs 147 zeros per sample: 60 s would
be 4.2e8 samples). Output ``y[a * up + b]`` sums the input under the
filter's phase ``p_b`` ending at input sample ``a * down + c_b``; the
``up`` phases, each shifted to its ``c_b`` within one window, are the
output channels of a single ``conv1d`` at stride ``down``, whose outputs
interleave into ``y``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as _ss


@functools.lru_cache(maxsize=None)
def _poly_filter_np(up: int, down: int, window=("kaiser", 5.0)) -> np.ndarray:
    """The FIR scipy.signal.resample_poly uses for (up, down)."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = _ss.firwin(2 * half_len + 1, 1.0 / max_rate, window=window) * up
    return h.astype(np.float64)


@functools.lru_cache(maxsize=32)
def polyphase_bank(up: int, down: int) -> tuple[np.ndarray, int]:
    """(W (up, 1, taps) float32, t0): output ``y[a * up + b]`` is
    ``sum_t x[a * down + t0 + t] * W[b, 0, t]`` (x zero outside its
    samples), for ``y = resample_poly(x, up, down)`` with up/down coprime.

    scipy's full-rate form is ``y[i] = z[(i + r) * down]`` with
    ``z = conv(zero_stuff(x, up), hp)``, hp the filter with scipy's
    centring zeros in front and ``r`` the samples it drops."""
    h = _poly_filter_np(up, down)
    half_len = (len(h) - 1) // 2
    n_pre_pad = down - (half_len % down)
    r = (half_len + n_pre_pad) // down
    hp = np.concatenate([np.zeros(n_pre_pad), h])
    J = -(-len(hp) // up)  # taps per phase
    phases = np.zeros((up, J))
    for p in range(up):
        g = hp[p::up]
        phases[p, :len(g)] = g
    m = (np.arange(up) + r) * down  # z index of each output channel at a = 0
    c, p = m // up, m % up          # y[a*up+b] = sum_j x[a*down + c_b - j] g_{p_b}[j]
    t0 = int(c.min()) - (J - 1)
    taps = int(c.max() - c.min()) + J
    W = np.zeros((up, 1, taps))
    for b in range(up):
        # x index a*down + t0 + t carries tap j = c_b - t0 - t
        t = c[b] - t0 - np.arange(J)
        W[b, 0, t] = phases[p[b]]
    return W.astype(np.float32), t0


def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """scipy.signal.resample_poly(x, up, down) along the last axis, in
    float32 (the sums are float32; scipy's are float64)."""
    if up == down:
        return x
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x
    W, t0 = polyphase_bank(up, down)
    *lead, n_in = x.shape
    n_out = -(-n_in * up // down)
    A = -(-n_out // up)  # conv positions
    xf = x.reshape(-1, 1, n_in).float()
    taps = W.shape[2]
    # the conv reads x[a*down + t0 + t] for a < A, t < taps: zeros outside
    left = max(0, -t0)
    start = max(0, t0)
    right = max(0, (A - 1) * down + t0 + taps - n_in)
    xp = F.pad(xf[..., start:], (left, right))
    w = torch.as_tensor(W, device=x.device)
    y = F.conv1d(xp, w, stride=down)[..., :A]  # (B, up, A)
    y = y.transpose(1, 2).reshape(y.shape[0], A * up)[:, :n_out]
    return y.reshape(*lead, n_out).to(x.dtype)


def resample(x: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Rational resample between integer sample rates, along the last axis."""
    if orig_sr == target_sr:
        return x
    g = math.gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g)
