"""The datasets' image steps on uint8 arrays: the port of
``magicmirror/data/base.py`` without Pillow.

An image is an (H, W, 3) uint8 array, a mask an (H, W) uint8 array of 0 and
255.  Each step does what the JAX package's Pillow step does: ``flip`` is
``transpose(FLIP_LEFT_RIGHT)``, ``expand`` is ``ImageOps.expand`` (zeros),
``crop`` is ``Image.crop`` (zeros where the box leaves the image), the RGB
resize is ``Image.resize`` at its default filter (bicubic,
``eval/images.py::resize_bicubic``) and the mask's is ``resize(size,
NEAREST)`` (:func:`resize_nearest`).  ``cub_style_aug`` makes the same
``random`` draws in the same order.  A JPEG photo is decoded by Pillow,
imported only to decode it (``eval/images.py::read_image``); the masks by
the port's PNG codec.
"""
from __future__ import annotations

import random

import numpy as np

from ..eval.images import read_image

MASK_THRESHOLD = 160


def load_rgb(path: str) -> np.ndarray:
    """The photo at ``path`` -> (H, W, 3) uint8, as ``Image.open(path)
    .convert("RGB")`` gives it."""
    return read_image(path, "RGB")


def binarize(seg: np.ndarray, threshold: int = MASK_THRESHOLD) -> np.ndarray:
    """``seg.point(lambda p: 255 if p > threshold else 0)``."""
    return np.where(seg > threshold, 255, 0).astype(np.uint8)


def load_seg(path: str, threshold: int = MASK_THRESHOLD) -> np.ndarray:
    """Binary mask loader (reference datasets/bird.py:24-28: p > 160 -> 255):
    the file as grey ("L"), thresholded -> (H, W) uint8."""
    return binarize(read_image(path, "L"), threshold)


def filter_by_fg_ratio(paths, threshold: str):
    """Keep images whose filename-encoded foreground ratio ``*_0.XX.png`` is
    inside (lo, hi) (reference datasets/bird.py:43-51)."""
    lo, hi = [float(t) for t in threshold.replace(" ", "").split(",")]
    kept = []
    for name in paths:
        ratio = float(name[-8:-4])
        if lo < ratio < hi:
            kept.append(name)
    return kept


def expand(img: np.ndarray, left: int, top: int, right: int, bottom: int) -> np.ndarray:
    """``ImageOps.expand(img, (left, top, right, bottom))``: a border of zeros."""
    pad = ((top, bottom), (left, right)) + ((0, 0),) * (img.ndim - 2)
    return np.pad(img, pad)


def crop(img: np.ndarray, box) -> np.ndarray:
    """``Image.crop((left, upper, right, lower))``: the box's pixels, zeros
    where it leaves the image."""
    left, upper, right, lower = box
    h, w = img.shape[:2]
    out = np.zeros((max(lower - upper, 0), max(right - left, 0)) + img.shape[2:], img.dtype)
    y0, y1 = max(upper, 0), min(lower, h)
    x0, x1 = max(left, 0), min(right, w)
    if y0 < y1 and x0 < x1:
        out[y0 - upper:y1 - upper, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """``Image.resize(size, NEAREST)`` with ``size`` = (width, height):
    Pillow's affine nearest-neighbour transform, the source coordinate of
    each output pixel centre stepped by repeated addition in double and
    truncated."""
    width, height = size
    h, w = img.shape[:2]
    if (w, h) == (width, height):
        return img.copy()

    def source(n_in, n_out):
        scale = n_in / n_out
        coord, out = scale * 0.5, np.empty(n_out, np.int64)
        for i in range(n_out):
            out[i] = int(coord)  # coord >= 0: a cast truncates
            coord += scale
        return np.minimum(out, n_in - 1)

    return img[source(h, height)[:, None], source(w, width)[None, :]]


def pad_to_square(img: np.ndarray, seg: np.ndarray):
    """Center-pad both to a square canvas (reference datasets/bird.py:108-114)."""
    H, W = img.shape[:2]
    side = max(W, H)
    dw, dh = side - W, side - H
    padding = (dw // 2, dh // 2, dw - dw // 2, dh - dh // 2)
    return expand(img, *padding), expand(seg, *padding)


def cub_style_aug(img: np.ndarray, seg: np.ndarray):
    """hflip + pad-10 + 95-99% random crop (reference datasets/bird.py:83-99),
    drawing from ``random`` as the JAX package does."""
    if random.uniform(0, 1) < 0.5:
        img = img[:, ::-1]
        seg = seg[:, ::-1]
    img = expand(img, 10, 10, 10, 10)
    seg = expand(seg, 10, 10, 10, 10)
    H, W = img.shape[:2]
    w = random.randint(int(0.95 * W), int(0.99 * W))
    h = random.randint(int(0.95 * H), int(0.99 * H))
    left = random.randint(0, W - w)
    upper = random.randint(0, H - h)
    right = random.randint(w - left, W)
    lower = random.randint(h - upper, H)
    box = (left, upper, right, lower)
    return crop(img, box), crop(seg, box)


def to_rgba_array(img: np.ndarray, seg: np.ndarray, bg: bool) -> np.ndarray:
    """-> (H, W, 4) float32; white-composite unless bg mode
    (reference datasets/bird.py:125-132)."""
    rgb = np.asarray(img, np.float32) / 255.0
    mask = np.asarray(seg, np.float32) / 255.0
    if mask.ndim == 3:
        mask = mask.max(axis=-1)
    mask = mask[..., None]
    if not bg:
        rgb = rgb * mask + (1.0 - mask)
    return np.concatenate([rgb, mask], axis=-1)


class ImageDataset:
    """Map-style dataset protocol: __len__ + __getitem__ returning
    {'images': (H, W, 4) float32, 'path': str, 'label': int, ...}."""

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError
