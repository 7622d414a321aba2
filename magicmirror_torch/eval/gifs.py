"""Camera-sweep GIFs, the port of ``magicmirror/eval/gifs.py``: the same
sweeps with the same frame values (azimuth every 10 degrees over the scope,
elevation every 10 over its range, every integer distance of its range), each
frame the batch re-rendered and laid out as one grid.

The GIF writer is the port's own: a fixed 3-3-2 palette (8 red, 8 green and
4 blue levels, no dithering) and LZW coding from the standard library,
100 ms a frame, looping.  imageio, which the JAX package writes through,
gives each frame its own adaptive palette instead; the frames are
artifacts, not metrics.
"""
from __future__ import annotations

import shutil
import struct

import numpy as np
import torch

from ..render.renderer import deep_copy
from .images import make_grid, to_uint8

# the 3-3-2 palette: index = r3 << 5 | g3 << 2 | b2, each level spread over 0..255
_LEVELS = [np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.uint8) for n in (8, 8, 4)]
PALETTE = np.stack(np.meshgrid(*_LEVELS, indexing="ij"), axis=-1).reshape(256, 3)


def palette_indices(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) indices into :data:`PALETTE`."""
    r, g, b = (frame[..., i] for i in range(3))
    return ((r >> 5) << 5 | (g >> 5) << 2 | (b >> 6)).astype(np.uint8)


def lzw_encode(indices: bytes, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a string of palette indices."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out, acc, nbits = bytearray(), 0, 0
    size, next_code, table = min_code_size + 1, end + 1, {}

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear)
    prefix = indices[0]
    for c in indices[1:]:
        key = prefix << 8 | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << size) and size < 12:
                size += 1
        else:  # the table is full: start again
            emit(clear)
            size, next_code, table = min_code_size + 1, end + 1, {}
        prefix = c
    emit(prefix)
    emit(end)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def write_gif(path: str, frames, delay_ms: int = 100) -> None:
    """(H, W, 3) uint8 frames -> a looping GIF at ``path``."""
    h, w = frames[0].shape[:2]
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), PALETTE.tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for frame in frames:
        data = lzw_encode(palette_indices(frame).tobytes())
        parts += [struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0, delay_ms // 10, 0, 0),
                  struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0), b"\x08"]
        parts += [bytes([len(data[i:i + 255])]) + data[i:i + 255]
                  for i in range(0, len(data), 255)]
        parts.append(b"\x00")
    parts.append(b"\x3b")
    with open(path, "wb") as fp:
        fp.write(b"".join(parts))


def _frames(render_fn, att, key, values, batch_size):
    frames = []
    for v in values:
        att2 = dict(att)
        att2[key] = torch.full((batch_size,), float(v), device=att["azimuths"].device)
        rgba, _ = render_fn(**att2)
        frames.append(to_uint8(make_grid(rgba[..., :3].cpu().numpy())))
    return frames


def sweep_gif(render_fn, att, path: str, key: str, values, copy_to: str | None = None):
    """Render ``att`` while sweeping one camera attribute; write a GIF (and
    a copy at ``copy_to``)."""
    att = deep_copy(att, detach=True)
    frames = _frames(render_fn, att, key, values, att["azimuths"].shape[0])
    write_gif(path, frames)
    if copy_to:
        shutil.copyfile(path, copy_to)


def azimuth_sweep(render_fn, att, path, azi_scope=360, step=10, copy_to=None):
    values = [-a for a in range(-int(azi_scope / 2), int(azi_scope / 2), step)]
    sweep_gif(render_fn, att, path, "azimuths", values, copy_to)


def elevation_sweep(render_fn, att, path, elev_range="0~30", step=10, copy_to=None):
    lo, hi = [int(float(v)) for v in elev_range.split("~")]
    values = [-e for e in range(lo, hi, step)]
    sweep_gif(render_fn, att, path, "elevations", values, copy_to)


def distance_sweep(render_fn, att, path, dist_range="2~7", copy_to=None):
    lo, hi = [int(float(v)) for v in dist_range.split("~")]
    values = [-d for d in range(lo, hi + 1)]
    sweep_gif(render_fn, att, path, "distances", values, copy_to)
