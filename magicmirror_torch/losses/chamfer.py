"""Bidirectional chamfer distance, the port of
``magicmirror/losses/chamfer.py``: brute force over a dense (B, N, M) matrix
of squared distances."""
from __future__ import annotations

import torch


def pairwise_sqdist(x, y):
    """(B, N, 3) x (B, M, 3) -> (B, N, M) squared distances through the
    expansion |x|^2 + |y|^2 - 2 x.y, floored at 0."""
    x2 = (x * x).sum(dim=-1)[:, :, None]
    y2 = (y * y).sum(dim=-1)[:, None, :]
    xy = torch.einsum("bnd,bmd->bnm", x, y)
    d = x2 + y2 - 2.0 * xy
    return torch.maximum(d, d.new_zeros(()))  # a tie at 0 splits the gradient, as in JAX


def chamfer_distance(x, y):
    """Mean bidirectional chamfer (point and batch reduction 'mean');
    returns (loss, None)."""
    d = pairwise_sqdist(x, y)
    cham_x = d.amin(dim=2).mean(dim=1)
    cham_y = d.amin(dim=1).mean(dim=1)
    return (cham_x + cham_y).mean(), None
