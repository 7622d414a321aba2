"""Seamless (Poisson) compositing for generated Market images, the host
tool behind ``generate_market --poisson``: a copy of
``magicmirror/eval/poisson.py`` (numpy and scipy.sparse; copied, not
imported, since importing the JAX package runs its ``__init__``).

Derivation (Pérez et al. 2003, "Poisson Image Editing", eq. 7): inside the
blend region Ω solve the discrete Poisson equation

    4 f_p − Σ_{q∈N(p)∩Ω} f_q  =  Σ_{q∈N(p)∖Ω} t_q  +  (4 g_p − Σ_{q∈N(p)} g_q)

i.e. the composite ``f`` matches the *gradients* of the source ``g`` while
taking Dirichlet boundary values from the target ``t``.  Unknowns are only
the |Ω| masked pixels; the system is assembled vectorized in COO form and
solved by one sparse LU factorisation for the three channels.  Pixels
outside Ω pass the target through untouched.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.linalg

# 4-neighborhood as (dy, dx) grid shifts
_SHIFTS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def poisson_edit(source, target, mask, offset=(0, 0)):
    """Blend ``source`` into ``target`` where ``mask`` > 0, matching source
    gradients with target boundary conditions.

    source/target: (H, W, 3) uint8/float; mask: (H, W), nonzero = blend
    region; offset: (dx, dy) integer shift applied to the source before
    blending.  Returns uint8 (H, W, 3).
    """
    target = np.asarray(target, np.float64)
    H, W = target.shape[:2]

    # integer-shift the source onto the target canvas
    src = np.zeros_like(target)
    oy, ox = int(offset[1]), int(offset[0])
    sy0, sy1 = max(0, -oy), min(source.shape[0], H - oy)
    sx0, sx1 = max(0, -ox), min(source.shape[1], W - ox)
    if sy1 > sy0 and sx1 > sx0:
        src[sy0 + oy:sy1 + oy, sx0 + ox:sx1 + ox] = source[sy0:sy1, sx0:sx1]

    # Ω: masked pixels, excluding the image border ring (border pixels have
    # no full 4-neighborhood; they keep the target unchanged)
    omega = np.asarray(mask)[:H, :W] > 0
    omega[0, :] = omega[-1, :] = False
    omega[:, 0] = omega[:, -1] = False
    n = int(omega.sum())
    if n == 0:
        return np.rint(np.clip(target, 0, 255)).astype(np.uint8)

    ids = np.full((H, W), -1, np.int64)
    ids[omega] = np.arange(n)

    # A: 4 on the diagonal; −1 for each masked neighbor.  b accumulates the
    # source Laplacian plus target Dirichlet terms for unmasked neighbors.
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, 4.0)]
    b = 4.0 * src[omega]                                   # (n, C)
    for dy, dx in _SHIFTS:
        nb_ids = np.roll(ids, (-dy, -dx), axis=(0, 1))[omega]   # id of p+(dy,dx)
        nb_src = np.roll(src, (-dy, -dx), axis=(0, 1))[omega]
        nb_tgt = np.roll(target, (-dy, -dx), axis=(0, 1))[omega]
        b -= nb_src                                        # source Laplacian
        inside = nb_ids >= 0
        rows.append(np.arange(n)[inside])
        cols.append(nb_ids[inside])
        vals.append(np.full(int(inside.sum()), -1.0))
        b[~inside] += nb_tgt[~inside]                      # Dirichlet boundary
    A = scipy.sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n)).tocsc()

    out = target.copy()
    solve = scipy.sparse.linalg.factorized(A)
    for c in range(target.shape[2]):
        out[:, :, c][omega] = solve(b[:, c])
    return np.rint(np.clip(out, 0, 255)).astype(np.uint8)
