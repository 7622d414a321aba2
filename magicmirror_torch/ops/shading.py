"""Spherical-harmonic lighting, the port of ``magicmirror/ops/shading.py``."""
from __future__ import annotations

import torch

_C0 = 0.282094791773878  # 1 / (2 sqrt(pi))
_C1 = 0.488602511902920  # sqrt(3) / (2 sqrt(pi))
_C2n2 = 1.092548430592079  # sqrt(15) / (2 sqrt(pi))
_C20 = 0.315391565252520  # sqrt(5) / (4 sqrt(pi))
_C22 = 0.546274215296040  # sqrt(15) / (4 sqrt(pi))


def spherical_harmonic_bases(normals):
    """9 SH basis values at unit ``normals`` (..., 3) -> (..., 9), in the
    order [1, y, z, x, xy, yz, 3z^2-1, xz, x^2-y^2]."""
    x = normals[..., 0]
    y = normals[..., 1]
    z = normals[..., 2]
    return torch.stack([
        _C0 * torch.ones_like(x),
        _C1 * y,
        _C1 * z,
        _C1 * x,
        _C2n2 * x * y,
        _C2n2 * y * z,
        _C20 * (3.0 * z * z - 1.0),
        _C2n2 * x * z,
        _C22 * (x * x - y * y),
    ], dim=-1)


def spherical_harmonic_lighting(imnormal, lights):
    """imnormal (B, H, W, 3), lights (B, 9) -> irradiance (B, H, W)."""
    return torch.einsum("bhwk,bk->bhw", spherical_harmonic_bases(imnormal), lights)
