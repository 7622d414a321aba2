"""Rendering ops: rasterizer, texture sampling, SH shading."""

import torch


def clip01(x):
    """Clip to [0, 1] as a minimum of a maximum: the values of
    ``x.clamp(0, 1)``, with the gradient of ``jnp.clip``, 1/2 where x is
    exactly 0 or 1 (``torch.clamp`` passes 1 there)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))
