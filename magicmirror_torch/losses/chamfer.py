"""Bidirectional chamfer distance, the port of
``magicmirror/losses/chamfer.py``: brute force over a dense (B, N, M) matrix
of squared distances, walked image by image where the whole matrix would be
large (a dense body template: (32, 6890, 6890) f32 is 6.1 GB, held several
times over by autograd)."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

# elements of the (B, N, M) matrix beyond which the batch is walked image by
# image, each image's matrix rebuilt in the backward pass (512 MB of f32)
_DENSE_ELEMS = 1 << 27


def pairwise_sqdist(x, y):
    """(B, N, 3) x (B, M, 3) -> (B, N, M) squared distances through the
    expansion |x|^2 + |y|^2 - 2 x.y, floored at 0."""
    x2 = (x * x).sum(dim=-1)[:, :, None]
    y2 = (y * y).sum(dim=-1)[:, None, :]
    xy = torch.einsum("bnd,bmd->bnm", x, y)
    d = x2 + y2 - 2.0 * xy
    return torch.maximum(d, d.new_zeros(()))  # a tie at 0 splits the gradient, as in JAX


def _chamfer_per_image(x, y):
    """(B, N, 3), (B, M, 3) -> (B,): both directions' mean nearest distance."""
    d = pairwise_sqdist(x, y)
    return d.amin(dim=2).mean(dim=1) + d.amin(dim=1).mean(dim=1)


def chamfer_distance(x, y):
    """Mean bidirectional chamfer (point and batch reduction 'mean');
    returns (loss, None).  The same arithmetic per image whether the batch is
    taken at once or, beyond ``_DENSE_ELEMS``, one image at a time."""
    if x.shape[0] * x.shape[1] * y.shape[1] <= _DENSE_ELEMS:
        return _chamfer_per_image(x, y).mean(), None
    per_image = [checkpoint(_chamfer_per_image, x[i:i + 1], y[i:i + 1], use_reentrant=False)
                 for i in range(x.shape[0])]
    return torch.cat(per_image).mean(), None
