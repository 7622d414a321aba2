"""Image artifacts: grids, parallel writes of eval images, and a reader;
the port of ``magicmirror/eval/images.py``.

PNG (8-bit grey or RGB) is written and read by this module itself, with
``zlib``, ``struct`` and numpy: the writer emits one IDAT with filter 0 on
every row, the reader takes the five row filters of the PNG standard (what
other writers emit).  A ``.jpg`` / ``.jpeg`` name is written as the JAX
package writes it, JPEG at quality 100 through Pillow, imported inside the
JPEG functions; where Pillow is missing they raise and name the file.
"""
from __future__ import annotations

import math
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3}  # colour type -> channels: grey, RGB
JPEG_SUFFIXES = (".jpg", ".jpeg")


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """(B, H, W, C) -> one grid image (H', W', C), ``nrow`` images a row."""
    b, h, w, c = images.shape
    ncol = min(nrow, b)
    nrows = math.ceil(b / ncol)
    grid = np.full(((h + padding) * nrows + padding, (w + padding) * ncol + padding, c),
                   pad_value, dtype=images.dtype)
    for i in range(b):
        r, col = divmod(i, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> the bytes of a PNG file."""
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (arr.ndim == 3
                                                         and arr.shape[2] != 3):
        raise ValueError(f"PNG: expected (H, W) or (H, W, 3) uint8, got {arr.dtype} "
                         f"{arr.shape}")
    h, w = arr.shape[:2]
    colour = 0 if arr.ndim == 2 else 2
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0 a row
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _png_chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters -> (h, w * bpp) uint8."""
    stride = w * bpp
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along each channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) % 256
        elif kind == 2:  # Up
            cur = (line + prev) % 256
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                pred = (left + up) // 2 if kind == 3 else _paeth(left, up, up_left)
                left = (line[x:x + bpp] + pred) % 256
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"PNG: unknown row filter {kind}")
        out[y] = prev = cur
    return out.astype(np.uint8)


def decode_png(blob: bytes) -> np.ndarray:
    """The bytes of an 8-bit grey or RGB PNG (not interlaced) -> (H, W) or
    (H, W, 3) uint8."""
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError("PNG: bad signature")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        length, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace:
        raise ValueError(f"PNG: only 8-bit grey or RGB without interlace, got depth "
                         f"{depth}, colour type {colour}, interlace {interlace}")
    bpp = _PNG_CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp)
    return pixels.reshape(h, w) if bpp == 1 else pixels.reshape(h, w, bpp)


def _save_jpeg(arr: np.ndarray, path: str, quality: int) -> None:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{path}: writing JPEG needs Pillow, which is not installed; "
                           "name the file .png") from e
    Image.fromarray(arr).save(path, "JPEG", quality=quality)


def _read_jpeg(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{path}: reading JPEG needs Pillow, which is not installed") from e
    with Image.open(path) as im:
        return np.asarray(im)


def _to_grey(arr: np.ndarray) -> np.ndarray:
    """RGB -> grey as Pillow's ``convert("L")``: ITU-R 601-2 luma, rounded."""
    r, g, b = (arr[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def read_image(path: str, mode: str | None = None) -> np.ndarray:
    """A PNG or JPEG file -> uint8 array; ``mode`` "RGB" gives (H, W, 3),
    "L" (H, W), as Pillow's ``convert`` does."""
    if path.lower().endswith(JPEG_SUFFIXES):
        arr = _read_jpeg(path)
    else:
        with open(path, "rb") as fp:
            arr = decode_png(fp.read())
    if mode == "RGB" and arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    elif mode == "L" and arr.ndim == 3:
        arr = _to_grey(arr)
    return arr


# Pillow's fixed point for 8-bit resampling (libImaging/Resample.c): weights
# in units of 2^-22, a sum rounded by adding half a unit
_RESAMPLE_BITS = 32 - 8 - 2


def _bicubic(x: float) -> float:
    """Pillow's bicubic kernel (a = -0.5)."""
    a, x = -0.5, abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


def _resample_weights(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    bicubic filter over the whole axis -> (first source index (out,), integer
    weights (out, k)): the kernel is widened by the scale when it shrinks,
    its taps are normalised to sum 1 in double, then rounded half away from
    zero to units of 2^-22."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # int() truncates, as C's cast
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - center + 0.5) / filterscale) for x in range(xmax)]
        total = 0.0
        for v in w:
            total += v
        first[xx] = xmin
        for x, v in enumerate(w):
            v = v / total if total != 0.0 else v
            weights[xx, x] = int(v * (1 << _RESAMPLE_BITS) + (0.5 if v >= 0 else -0.5))
    return first, weights


def _resample_axis(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along ``axis`` of a uint8 array."""
    first, weights = _resample_weights(arr.shape[axis], out_size)
    src = np.moveaxis(arr, axis, 0).astype(np.int64)
    n = src.shape[0]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_RESAMPLE_BITS - 1), np.int64)
    for k in range(weights.shape[1]):
        index = np.minimum(first + k, n - 1)  # taps past the edge carry weight 0
        w = weights[:, k].reshape((-1,) + (1,) * (src.ndim - 1))
        acc += src[index] * w
    out = np.clip(acc >> _RESAMPLE_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(arr: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 resized to ``size`` = (width, height) as
    Pillow's ``Image.resize(size)`` does for an "L" or "RGB" image at its
    default filter (bicubic): the horizontal pass first, each pass rounded to
    uint8, and the same array back when the size is already right."""
    width, height = size
    out = arr
    if out.shape[1] != width:
        out = _resample_axis(out, width, axis=1)
    if out.shape[0] != height:
        out = _resample_axis(out, height, axis=0)
    return out


def save_array_image(img, path: str, quality: int = 100) -> None:
    """(H, W, C) or (H, W) float in [0, 1] -> a file: PNG, or JPEG at
    ``quality`` for a .jpg / .jpeg name (JPEG quantisation is part of the
    metric, as in the reference)."""
    arr = to_uint8(np.asarray(img))
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if path.lower().endswith(JPEG_SUFFIXES):
        _save_jpeg(arr, path, quality)
        return
    with open(path, "wb") as fp:
        fp.write(encode_png(arr))


def save_image_grid(images, path: str, nrow: int = 8, normalize: bool = False) -> None:
    """A batch (B, H, W, C) as one grid image file; ``normalize`` maps the
    batch's range onto [0, 1] first."""
    images = np.asarray(images)
    if normalize:
        lo, hi = images.min(), images.max()
        images = (images - lo) / max(hi - lo, 1e-5)
    grid = make_grid(images, nrow=nrow)
    if grid.shape[-1] == 1:
        grid = np.repeat(grid, 3, axis=-1)
    save_array_image(grid, path)


def save_images_parallel(images_and_paths, workers: int = 4) -> None:
    """Write many (array, path) pairs on ``workers`` threads (zlib releases
    the interpreter lock)."""
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for future in [ex.submit(save_array_image, img, path)
                       for img, path in images_and_paths]:
            future.result()
