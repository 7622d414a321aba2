"""The host preprocessing functions of ``magicmirror/data/native/__init__.py``
in numpy, byte for byte as the JAX package's compiled library computes them
(``magicmirror/data/native/preprocess.cc`` built with ``g++ -O3
-march=native``, which contracts a multiply and an add into one fused
multiply-add where the expression allows).  The port builds no host C++
library: the float32 steps are taken in numpy in the same order, each fused
multiply-add rounded once (``_fma32``).

The JAX module's Pillow fallback for ``resize_bilinear`` (when its library
does not load) uses ``Image.resize``'s default filter, not this bilinear:
the port follows the library.  ``fill_holes`` is ``data/prepare.py``'s, as
in the JAX module's fallback.  The port's functions return new arrays;
the library writes ``binarize``, ``white_composite`` and ``fill_holes``
into the caller's array where that is already contiguous and of its dtype.
"""
from __future__ import annotations

import numpy as np

from .prepare import fill_holes  # noqa: F401  (the library's fill_holes is this one)


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product is exact in float64, the sum is rounded to odd in float64
    (TwoSum and one step to the odd neighbour), and rounding that to float32
    is then the rounding of the exact value."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(np.int64)
    fix = (err != 0) & ((bits & 1) == 0)
    s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _axis_taps(n_src: int, n_dst: int):
    """The C++ loop's taps along one axis -> (i0, i1 clamped, w, 1 - w)."""
    scale = np.float32(n_src) / np.float32(n_dst)
    f = _fma32(np.arange(n_dst, dtype=np.float32) + np.float32(0.5), scale, np.float32(-0.5))
    i0 = np.where(f >= 0, f, f - np.float32(1.0)).astype(np.int64)  # truncation
    w = f - i0.astype(np.float32)
    return (np.clip(i0, 0, n_src - 1), np.clip(i0 + 1, 0, n_src - 1), w,
            np.float32(1.0) - w)


def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 HWC (or HW) bilinear resize -> (dh, dw, C) uint8: half-pixel
    centres, edge taps clamped, the four taps blended in float32 and
    truncated after adding 0.5."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, _ = img.shape
    y0, y1, wy, vy = _axis_taps(h, dh)
    x0, x1, wx, vx = _axis_taps(w, dw)
    y0, y1, wy, vy = y0[:, None], y1[:, None], wy[:, None, None], vy[:, None, None]
    wx, vx = wx[:, None], vx[:, None]
    src = img.astype(np.float32)
    v00, v01, v10, v11 = src[y0, x0], src[y0, x1], src[y1, x0], src[y1, x1]
    # the compiled order: the v01 term, then v00, v10, v11 each fused on
    s = _fma32(v00 * vx, vy, (v01 * wx) * vy)
    s = _fma32(v10 * vx, wy, s)
    s = _fma32(v11 * wx, wy, s)
    return (s + np.float32(0.5)).astype(np.uint8)


def resize_nearest(mask: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 HW nearest resize (PIL NEAREST's convention, in float32)."""
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape

    def source(n_src, n_dst):
        pos = np.arange(n_dst, dtype=np.float32) * np.float32(n_src) / np.float32(n_dst)
        return np.minimum(pos.astype(np.int64), n_src - 1)

    return mask[source(h, dh)][:, source(w, dw)]


def binarize(mask: np.ndarray, threshold: int = 160) -> np.ndarray:
    """p > threshold -> 255, else 0 (uint8)."""
    mask = np.asarray(mask, np.uint8)
    return np.where(mask > threshold, 255, 0).astype(np.uint8)


def fg_ratio(mask: np.ndarray) -> float:
    """The share of nonzero pixels."""
    mask = np.asarray(mask, np.uint8)
    return np.count_nonzero(mask) / mask.size


def white_composite(rgba: np.ndarray) -> np.ndarray:
    """float32 HW4 -> rgb * mask + (1 - mask) in the rgb channels, the
    mask (channel 3) kept."""
    out = np.array(rgba, np.float32)
    m = out[..., 3:4]
    out[..., :3] = _fma32(out[..., :3], m, np.float32(1.0) - m)
    return out
