"""The O(F) per-face row precompute that the rasterizer kernel consumes.

The port of ``_raw_line_coeffs``, ``_affine_interp`` and ``_face_rows`` of
``magicmirror/ops/pallas/rasterize_v4.py``.  Every per-(pixel, face)
quantity the forward needs is an affine function of the pixel centre, so a
face is 26 f32: three signed edge-line distances, the z plane, the bbox, the
face id, the u and v planes and the face normal.  Plain torch, as XLA did it.
``coeffs13`` is the differentiable half that the backward pass chains through.
``face_cull`` is the table the kernels' tiles cull by: the bbox alone, 16
bytes a face.  The 'exact' soft mode measures the distance to the edge
segments, which are not affine in the pixel: ``face_verts`` is the second
table it reads, the six vertex coordinates of each face (rows _AX.._CY of
``_pack_faces``, ``magicmirror/ops/pallas/rasterize_tpu.py:34-67``).
"""
from __future__ import annotations

import torch

# column layout of a face row (rasterize_v4.py:45-49)
(A0X, A0Y, A0C, A1X, A1Y, A1C, A2X, A2Y, A2C,
 ZX, ZY, ZC, BXMIN, BXMAX, BYMIN, BYMAX, FID) = range(17)
(UX, UY, UC, VX, VY, VC, NXR, NYR, NZR) = range(17, 26)
R_FUSED = 26
R_VERTS = 6
R_CULL = 4
# the JAX renderer hands templates of at least this many faces to its dense
# kernels (rasterize_v6.DENSE_THRESHOLD); here only the launch counters differ
DENSE_THRESHOLD = 2048

DEN_EPS = 1e-10
SOFT_MARGIN = 0.035   # p < 2e-4 at sigmainv = 7000 beyond this distance
BIG_D = 3.0e4         # "infinitely far" line distance of a dead face
DEAD_Z = -1.0e30      # z of a degenerate front face: never covers a pixel
Z_FLOOR = -1.0e29     # a pixel is covered iff its best z is above this


def _raw_line_coeffs(fvi):
    """Affine coefficients of the three signed edge-line distances (positive
    outside) and the bbox, per face.  fvi (..., F, 3, 2)."""
    ax, ay = fvi[..., 0, 0], fvi[..., 0, 1]
    bx, by = fvi[..., 1, 0], fvi[..., 1, 1]
    cx, cy = fvi[..., 2, 0], fvi[..., 2, 1]
    den = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    sgn = torch.where(den >= 0.0, 1.0, -1.0)
    c0x, c0y = -(cy - by), (cx - bx)
    c0c = (cy - by) * bx - (cx - bx) * by
    c1x, c1y = -(ay - cy), (ax - cx)
    c1c = (ay - cy) * cx - (ax - cx) * cy
    c2x, c2y = -c0x - c1x, -c0y - c1y
    c2c = den - c0c - c1c

    def rl(ux, uy, vx, vy):
        dx, dy = vx - ux, vy - uy
        return torch.rsqrt(dx * dx + dy * dy + 1e-12)

    s0 = -sgn * rl(bx, by, cx, cy)
    s1 = -sgn * rl(cx, cy, ax, ay)
    s2 = -sgn * rl(ax, ay, bx, by)
    xs, ys = fvi[..., 0], fvi[..., 1]
    coeffs = dict(
        a0x=s0 * c0x, a0y=s0 * c0y, a0c=s0 * c0c,
        a1x=s1 * c1x, a1y=s1 * c1y, a1c=s1 * c1c,
        a2x=s2 * c2x, a2y=s2 * c2y, a2c=s2 * c2c,
        xmin=xs.amin(-1), xmax=xs.amax(-1), ymin=ys.amin(-1), ymax=ys.amax(-1),
    )
    aux = dict(den=den, c0x=c0x, c0y=c0y, c0c=c0c, c1x=c1x, c1y=c1y, c1c=c1c)
    return coeffs, aux


COEFF13_KEYS = ("a0x", "a0y", "a0c", "a1x", "a1y", "a1c",
                "a2x", "a2y", "a2c", "xmin", "xmax", "ymin", "ymax")


def coeffs13(fvi):
    """(..., F, 3, 2) -> (..., F, 13): the nine edge-line and four bbox
    coefficients, unmasked and differentiable.  The soft-silhouette backward
    produces one moment per coefficient and chains to the vertices through
    this function's autograd (``_coeffs13``, rasterize_v4.py:109)."""
    c, _ = _raw_line_coeffs(fvi)
    return torch.stack([c[k] for k in COEFF13_KEYS], dim=-1)


def _affine_interp(aux, v0, v1, v2):
    """Affine coefficients of w0*v0 + w1*v1 + w2*v2 over the face plane."""
    den = aux["den"]
    inv = 1.0 / torch.where(den.abs() > DEN_EPS, den, 1.0)
    d0, d1 = v0 - v2, v1 - v2
    gx = (aux["c0x"] * d0 + aux["c1x"] * d1) * inv
    gy = (aux["c0y"] * d0 + aux["c1y"] * d1) * inv
    gc = v2 + (aux["c0c"] * d0 + aux["c1c"] * d1) * inv
    return gx, gy, gc


def face_rows(fvi, fz, fnz, face_uvs, face_normals):
    """Pack the per-face rows -> (B, F + 1, 26) f32.

    fvi (B, F, 3, 2) NDC xy; fz (B, F, 3) camera z; fnz (B, F) normal z;
    face_uvs (F, 3, 2) shared; face_normals (B, F, 3).  Back faces are dead
    rows; degenerate front faces keep their line distances (they still emit
    soft mass) but can never win the z-test.  Row F is the dead sentinel.
    """
    B, F = fvi.shape[0], fvi.shape[1]
    c, aux = _raw_line_coeffs(fvi)
    front = fnz > 0.0
    zok = front & (aux["den"].abs() > DEN_EPS)
    zero = torch.zeros_like(fnz)

    def mk(x, dead=0.0):
        return torch.where(front, x, dead)

    zx, zy, zc = _affine_interp(aux, fz[..., 0], fz[..., 1], fz[..., 2])
    uvs = face_uvs.to(fvi.dtype)
    ux, uy, uc = _affine_interp(aux, uvs[:, 0, 0], uvs[:, 1, 0], uvs[:, 2, 0])
    vx, vy, vc = _affine_interp(aux, uvs[:, 0, 1], uvs[:, 1, 1], uvs[:, 2, 1])
    fid = torch.arange(F, dtype=fvi.dtype, device=fvi.device).expand(B, F)
    cols = [mk(c["a0x"]), mk(c["a0y"]), mk(c["a0c"], BIG_D),
            mk(c["a1x"]), mk(c["a1y"]), mk(c["a1c"]),
            mk(c["a2x"]), mk(c["a2y"]), mk(c["a2c"]),
            torch.where(zok, zx, 0.0), torch.where(zok, zy, 0.0),
            torch.where(zok, zc, DEAD_Z),
            mk(c["xmin"]), mk(c["xmax"]), mk(c["ymin"]), mk(c["ymax"]),
            fid,
            torch.where(zok, ux, zero), torch.where(zok, uy, zero),
            torch.where(zok, uc, zero), torch.where(zok, vx, zero),
            torch.where(zok, vy, zero), torch.where(zok, vc, zero),
            face_normals[..., 0], face_normals[..., 1], face_normals[..., 2]]
    packed = torch.stack(cols, dim=-1)  # (B, F, 26)
    dead = torch.zeros((B, 1, R_FUSED), dtype=packed.dtype, device=packed.device)
    dead[..., A0C] = BIG_D
    dead[..., ZC] = DEAD_Z
    dead[..., FID] = -1.0
    return torch.cat([packed, dead], dim=1)


def face_verts(fvi):
    """(B, F, 3, 2) -> (B, F + 1, 6) f32: ax, ay, bx, by, cx, cy per face, the
    table of the 'exact' soft mode beside :func:`face_rows`; row F is the
    sentinel's (never read past the culling: its row is dead)."""
    B, F = fvi.shape[0], fvi.shape[1]
    return torch.cat([fvi.reshape(B, F, R_VERTS),
                      fvi.new_zeros((B, 1, R_VERTS))], dim=1)


def face_cull(rows):
    """(B, F + 1, 26) face rows -> (B, F + 1, 4) f32: xmin, xmax, ymin, ymax
    of each front face; a face that faces away and the sentinel get BIG_D in
    all four, a box that meets no tile (its xmin lies right of every tile).
    A tile of the rasterizer kernels tests every face of the mesh against its
    bounds; this table is what it reads.  Two launches, no host constant."""
    box = torch.where(rows[..., NZR:NZR + 1] > 0.0, rows[..., BXMIN:BYMAX + 1], BIG_D)
    return box.contiguous()  # already so: no copy
