"""Synthetic render inputs made from a seed with numpy, so that both
packages (and the CPU and the card) can be fed the same arrays."""
from __future__ import annotations

import numpy as np
import torch


def bench_attributes(vertices_init: np.ndarray, batch: int, image_size: int,
                     seed: int = 0, height: int | None = None) -> dict:
    """The attribute distribution that ``bench.py`` renders: azimuth
    U(-180, 180), elevation U(0, 30), distance U(2, 4), bias U(-0.2, 0.2),
    vertex jitter U(-0.05, 0.05), random textures (B, 2H, S, 3) with H the
    render height (S unless ``height`` is given), ambient light 3 with
    U(-0.1, 0.1) bands.  Returns float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    V = vertices_init.shape[0]
    f32 = np.float32
    return {
        "azimuths": rng.uniform(-180, 180, batch).astype(f32),
        "elevations": rng.uniform(0, 30, batch).astype(f32),
        "distances": rng.uniform(2, 4, batch).astype(f32),
        "biases": rng.uniform(-0.2, 0.2, (batch, 2)).astype(f32),
        "vertices": (vertices_init[None]
                     + rng.uniform(-0.05, 0.05, (batch, V, 3))).astype(f32),
        "textures": rng.rand(batch, 2 * (height or image_size), image_size, 3).astype(f32),
        "lights": np.concatenate([np.full((batch, 1), 3.0),
                                  rng.uniform(-0.1, 0.1, (batch, 8))], 1).astype(f32),
        "delta_vertices": np.zeros((batch, V, 3), f32),
    }


def to_torch(att: dict, device) -> dict:
    """numpy attribute dict -> tensors on ``device`` (``bg`` None unless
    the dict has one)."""
    out = {k: torch.as_tensor(v, device=device) for k, v in att.items()}
    out.setdefault("bg", None)
    return out


def smooth_random(shape, seed: int = 0, cells: int = 4) -> np.ndarray:
    """Low-frequency random images (B, H, W, C) in [0, 1]: a cells x cells
    grid of random values, bilinearly upsampled; photo-like, unlike
    per-pixel noise."""
    B, H, W, C = shape
    grid = np.random.RandomState(seed).rand(B, C, cells, cells).astype(np.float32)
    up = torch.nn.functional.interpolate(torch.as_tensor(grid), size=(H, W),
                                         mode="bilinear", align_corners=True)
    return up.permute(0, 2, 3, 1).contiguous().numpy()
