"""Image resizing and Gaussian blur as OpenCV computes them, in torch.

The port's counterpart of the ``cv2.resize`` and ``cv2.GaussianBlur`` calls
of the JAX package's lip-sync pipeline (rvc_tpu/models/musetalk/vae.py:207,
rvc_tpu/pipelines/musetalk.py:99-192, :291). The card's machine has no
OpenCV, so these follow its algorithms step for step (imgproc/src/resize.cpp,
smooth.dispatch.cpp):

- ``resize``: a source position ``(d + 0.5) * scale - 0.5`` taken in double
  and rounded to float, the taps and weights from it. On uint8 the weights
  are 11-bit fixed point (``INTER_RESIZE_COEF_BITS``); the linear vertical
  pass drops 4 bits of each row sum and keeps the high half of each
  product, as OpenCV's vector path does, and Lanczos-4 rounds its 22-bit
  sum once. On float32 every product and sum is a float32 one; a linear
  resize keeps the position in double and rounds its two weights from it
  (OpenCV 5's float route for images of more than one row: within 2 ulp of
  it; no stage of the pipeline resizes float32 linearly). A linear resize
  to exactly half of each side is OpenCV's 2x2 area average.
  Nearest takes ``floor(d * src / dst)``.
- ``gaussian_blur`` with sigma 0 (``0.3·((k−1)·0.5−1)+0.8``) and
  ``BORDER_REFLECT_101``. On uint8 it is OpenCV's bit-exact fixed-point
  filter: the kernel in 8-bit fixed point with the rounding error carried
  from tap to tap, the row pass in 8 fractional bits, the column pass in
  16, rounded to uint8 once. On float32 the kernel is the float one.

Arrays are (H, W) or (H, W, C), numpy or torch; a numpy array comes back
as numpy, a tensor as a tensor on its own device. Sizes are OpenCV's
``(width, height)``. The integer paths are exact on any device.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

INTER_NEAREST = 0
INTER_LINEAR = 1
INTER_LANCZOS4 = 4

COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS


def _as_tensor(img) -> tuple[torch.Tensor, bool, bool]:
    """(H, W, C) tensor, whether the input was numpy, whether it had no channel axis."""
    was_numpy = isinstance(img, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(img)) if was_numpy else img
    flat = t.dim() == 2
    return (t[..., None] if flat else t), was_numpy, flat


def _back(t: torch.Tensor, was_numpy: bool, flat: bool):
    if flat:
        t = t[..., 0]
    return t.numpy() if was_numpy else t


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _positions(dst: int, src: int, double: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's source positions of ``dst`` samples: (floor, fraction), the
    position computed in double from ``scale = 1 / (dst / src)`` and
    rounded to float, the fraction a float32 difference; with ``double``
    the position and fraction stay in double and the fraction is rounded
    to float last."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    if double:
        s = np.floor(f).astype(np.int64)
        return s, f - s
    f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, _f32(f - s.astype(np.float32))


def _fixed(w: np.ndarray) -> np.ndarray:
    """``saturate_cast<short>(w * INTER_RESIZE_COEF_SCALE)``: float32 product,
    rounded half to even."""
    return np.rint(_f32(w) * np.float32(COEF_SCALE)).astype(np.int64)


@functools.lru_cache(maxsize=256)
def _linear_taps(dst: int, src: int, clamp_ends: bool, double: bool = False):
    """Linear taps (i0, i1) and float32 weights (w0, w1) for one axis; with
    ``clamp_ends`` (the horizontal axis) a position before the first sample
    or at or after the last takes that sample whole, as OpenCV's ``xmin`` /
    ``xmax`` handling does; the vertical axis only clamps its rows. With
    ``double``, the weights are 1 - f and f taken in double and rounded."""
    s, f = _positions(dst, src, double)
    if clamp_ends:
        lo, hi = s < 0, s >= src - 1
        f = np.where(lo | hi, 0, f).astype(f.dtype)
        s = np.where(lo, 0, np.where(hi, src - 1, s))
    i0 = np.clip(s, 0, src - 1)
    i1 = np.clip(s + 1, 0, src - 1)
    return i0, i1, _f32(f.dtype.type(1) - f), _f32(f)


def _lanczos4_coeffs(f: np.ndarray) -> np.ndarray:
    """OpenCV's ``interpolateLanczos4`` for each fraction: (n, 8) float32,
    each tap's value in double rounded to float, summed in float32 in tap
    order, then scaled by the float reciprocal of the sum."""
    s45 = 0.70710678118654752440084436210485
    cs = [(1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45), (0, -1), (-s45, s45)]
    x = np.asarray(f, np.float32)
    y0 = -(x.astype(np.float64) + 3) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    out = np.empty((len(x), 8), np.float32)
    total = np.zeros(len(x), np.float32)
    for i in range(8):
        y0_ = (x + np.float32(3 - i)).astype(np.float32)
        y = -y0_.astype(np.float64) * math.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            tap = ((cs[i][0] * s0 + cs[i][1] * c0) / (y * y)).astype(np.float32)
        out[:, i] = np.where(np.abs(y0_) >= np.float32(1e-6), tap, np.float32(1e30))
        total = (total + out[:, i]).astype(np.float32)
    return out * (np.float32(1) / total)[:, None]


@functools.lru_cache(maxsize=256)
def _lanczos_taps(dst: int, src: int):
    """Lanczos-4 taps (n, 8), clamped to the image, and float32 weights (n, 8)."""
    s, f = _positions(dst, src)
    idx = np.clip(s[:, None] + np.arange(-3, 5)[None, :], 0, src - 1)
    return idx, _lanczos4_coeffs(f)


def _take(t: torch.Tensor, idx: np.ndarray, dim: int) -> torch.Tensor:
    return torch.index_select(t, dim, torch.from_numpy(np.ascontiguousarray(idx)).to(t.device))


def _area_half(t: torch.Tensor) -> torch.Tensor:
    """OpenCV's fast 2x2 area average (a linear resize to half of each side)."""
    H, W = t.shape[0] // 2, t.shape[1] // 2
    s = t[: 2 * H, : 2 * W]
    if t.dtype == torch.uint8:
        s = s.to(torch.int32)
        q = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
        return ((q + 2) >> 2).to(torch.uint8)
    return (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]) * 0.25


def _resize_linear(t: torch.Tensor, w: int, h: int) -> torch.Tensor:
    H, W = t.shape[:2]
    if (W, H) == (2 * w, 2 * h):
        return _area_half(t)
    double = t.dtype == torch.float32
    x0, x1, ax0, ax1 = _linear_taps(w, W, clamp_ends=True, double=double)
    y0, y1, by0, by1 = _linear_taps(h, H, clamp_ends=False, double=double)
    dev = t.device
    if t.dtype == torch.uint8:
        s = t.to(torch.int32)
        a0 = torch.from_numpy(_fixed(ax0)).to(dev, torch.int32)[None, :, None]
        a1 = torch.from_numpy(_fixed(ax1)).to(dev, torch.int32)[None, :, None]
        rows = _take(s, x0, 1) * a0 + _take(s, x1, 1) * a1  # 11 fractional bits
        b0 = torch.from_numpy(_fixed(by0)).to(dev, torch.int32)[:, None, None]
        b1 = torch.from_numpy(_fixed(by1)).to(dev, torch.int32)[:, None, None]
        v = (((b0 * (_take(rows, y0, 0) >> 4)) >> 16)
             + ((b1 * (_take(rows, y1, 0) >> 4)) >> 16) + 2) >> 2
        return v.clamp(0, 255).to(torch.uint8)
    s = t.to(torch.float32)
    a0 = torch.from_numpy(ax0).to(dev)[None, :, None]
    a1 = torch.from_numpy(ax1).to(dev)[None, :, None]
    rows = _take(s, x0, 1) * a0 + _take(s, x1, 1) * a1
    b0 = torch.from_numpy(by0).to(dev)[:, None, None]
    b1 = torch.from_numpy(by1).to(dev)[:, None, None]
    return _take(rows, y0, 0) * b0 + _take(rows, y1, 0) * b1


def _resize_lanczos4(t: torch.Tensor, w: int, h: int) -> torch.Tensor:
    H, W = t.shape[:2]
    xi, xw = _lanczos_taps(w, W)
    yi, yw = _lanczos_taps(h, H)
    dev = t.device
    if t.dtype == torch.uint8:  # int32 sums, as OpenCV's
        s = t.to(torch.int32)
        a = torch.from_numpy(_fixed(xw)).to(dev, torch.int32)
        rows = sum(_take(s, xi[:, k], 1) * a[None, :, k, None] for k in range(8))
        b = torch.from_numpy(_fixed(yw)).to(dev, torch.int32)
        v = sum(_take(rows, yi[:, k], 0) * b[:, k, None, None] for k in range(8))
        return ((v + (1 << (2 * COEF_BITS - 1))) >> (2 * COEF_BITS)).clamp(0, 255).to(torch.uint8)
    s = t.to(torch.float32)
    a = torch.from_numpy(xw).to(dev)
    rows = _take(s, xi[:, 0], 1) * a[None, :, 0, None]
    for k in range(1, 8):
        rows = rows + _take(s, xi[:, k], 1) * a[None, :, k, None]
    b = torch.from_numpy(yw).to(dev)
    v = _take(rows, yi[:, 0], 0) * b[:, 0, None, None]
    for k in range(1, 8):
        v = v + _take(rows, yi[:, k], 0) * b[:, k, None, None]
    return v


def _resize_nearest(t: torch.Tensor, w: int, h: int) -> torch.Tensor:
    H, W = t.shape[:2]
    sx = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64), W - 1)
    sy = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64), H - 1)
    return _take(_take(t, sy, 0), sx, 1)


def resize(img, size: tuple[int, int], interpolation: int = INTER_LINEAR):
    """``cv2.resize(img, size, interpolation=...)`` for nearest, linear and
    Lanczos-4 on uint8 or float32 (H, W[, C]); ``size`` is (width, height)."""
    t, was_numpy, flat = _as_tensor(img)
    if t.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"resize takes uint8 or float32, not {t.dtype}")
    w, h = int(size[0]), int(size[1])
    if w <= 0 or h <= 0 or t.shape[0] == 0 or t.shape[1] == 0:
        raise ValueError(f"resize of a {tuple(t.shape[:2])} image to {size}")
    if (h, w) == tuple(t.shape[:2]):
        out = t.clone()
    elif interpolation == INTER_NEAREST:
        out = _resize_nearest(t, w, h)
    elif interpolation == INTER_LINEAR:
        out = _resize_linear(t, w, h)
    elif interpolation == INTER_LANCZOS4:
        out = _resize_lanczos4(t, w, h)
    else:
        raise ValueError(f"interpolation {interpolation} is not one of nearest, linear, lanczos4")
    return _back(out.to(t.dtype) if out.dtype != t.dtype else out, was_numpy, flat)


# ---------------------------------------------------------------------------
# Gaussian blur
# ---------------------------------------------------------------------------

_SMALL = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
          7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
          9: [4 / 256, 13 / 256, 30 / 256, 51 / 256, 60 / 256, 51 / 256, 30 / 256, 13 / 256,
              4 / 256]}


def gaussian_kernel(n: int) -> np.ndarray:
    """OpenCV's Gaussian kernel of odd size ``n`` at sigma 0, in double: the
    fixed tables up to 9 taps, else exp(-x² / (2σ²)) normalized, with
    σ = 0.15 n + 0.35."""
    if n % 2 != 1 or n < 1:
        raise ValueError(f"Gaussian kernel size {n} is not odd and positive")
    if n in _SMALL:
        return np.asarray(_SMALL[n], np.float64)
    sigma = n * 0.15 + 0.35
    scale2 = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    values = [math.exp(float(x * x) * scale2) for x in range(1 - n, 0, 2)]
    total = sum(values) * 2 + 1.0
    mul = 1.0 / total
    left = [v * mul for v in values]
    return np.asarray(left + [mul] + left[::-1], np.float64)


def fixed_gaussian_kernel(n: int) -> np.ndarray:
    """The kernel in 8-bit fixed point as OpenCV's bit-exact blur takes it:
    each outer tap rounded with the error carried to the next, the centre
    the remainder, so the taps sum to exactly 1 (256)."""
    k = gaussian_kernel(n)
    one = 256
    out = np.zeros(n, np.int64)
    err = 0.0
    for i in range(n // 2):
        adj = k[i] * one + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[n - 1 - i] = v
    out[n // 2] = one - 2 * int(out[: n // 2].sum())
    return out


def reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's ``borderInterpolate`` for BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba)."""
    if n == 1:
        return np.zeros_like(idx)
    p = idx.copy()
    while True:
        bad = (p < 0) | (p >= n)
        if not bad.any():
            return p
        p = np.where(p < 0, -p, np.where(p >= n, 2 * n - 2 - p, p))


def _blur_axis(t: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    """The taps ``k`` along ``dim`` over the reflected image, as one conv1d
    in ``k``'s dtype: float64 for the fixed-point path, where every product
    and partial sum is an integer below 2^53 and so exact in any order."""
    n = t.shape[dim]
    r = len(k) // 2
    padded = _take(t, reflect101(np.arange(-r, n + r), n), dim).to(k.dtype)
    moved = padded.movedim(dim, -1)
    out = torch.nn.functional.conv1d(moved.reshape(-1, 1, n + 2 * r), k.view(1, 1, -1))
    return out.reshape(moved.shape[:-1] + (n,)).movedim(-1, dim)


def gaussian_blur(img, ksize: tuple[int, int]):
    """``cv2.GaussianBlur(img, ksize, 0)`` on uint8 or float32 (H, W[, C]);
    ``ksize`` (width, height), each odd."""
    t, was_numpy, flat = _as_tensor(img)
    kx, ky = int(ksize[0]), int(ksize[1])
    if kx == 1 and ky == 1:
        return _back(t.clone(), was_numpy, flat)
    dev = t.device
    if t.dtype == torch.uint8:
        fx = torch.from_numpy(fixed_gaussian_kernel(kx)).to(dev)
        fy = torch.from_numpy(fixed_gaussian_kernel(ky)).to(dev)
        rows = _blur_axis(t, fx.to(torch.float64), 1)  # 8 fractional bits
        v = _blur_axis(rows, fy.to(torch.float64), 0).to(torch.int64)  # 16 fractional bits
        out = ((v + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)
    elif t.dtype == torch.float32:
        fx = torch.from_numpy(gaussian_kernel(kx).astype(np.float32)).to(dev)
        fy = torch.from_numpy(gaussian_kernel(ky).astype(np.float32)).to(dev)
        out = _blur_axis(_blur_axis(t, fx, 1), fy, 0)
    else:
        raise TypeError(f"gaussian_blur takes uint8 or float32, not {t.dtype}")
    return _back(out, was_numpy, flat)
