"""DIB-R soft rasterization ('line' soft mode): the plain PyTorch path and
the wrapper of the CUDA forward kernel.

``rasterize_fused_plain`` is the port of the JAX package's golden XLA path
(``magicmirror/ops/rasterize.py``: ``_face_pixel_terms`` in 'line' mode, the
face-chunked phase 1 and ``_interpolate_selected``) over ALL faces, with no
culling.  It is the CPU path and the kernel's oracle.

``rasterize_fused`` is the wrapper: CPU tensors take the plain path; CUDA
tensors pack the per-face rows (``face_rows.py``) and launch
``csrc/raster_fwd.cu``, or raise.

Per pixel: the winner is the front-facing, non-degenerate covering face with
the largest camera z (lowest id on ties); soft = 1 - prod(1 - p) with
p = (1 - 1e-7) * exp(-sigmainv * d^2), d the 'line' distance floored by the
bbox distance; uv and normal are the winner's, interpolated.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..kernels import build
from .face_rows import R_FUSED, face_rows

_DEN_EPS = 1e-10
_P_CLAMP = 1.0 - 1e-7
# elements of one (B, P, chunk) temporary of the plain phase 1 (64 MB f32)
_CHUNK_ELEMS = 1 << 24


def pixel_grid(height: int, width: int, device=None):
    """NDC pixel-centre coordinates (P,), row 0 at the image top (y = +1)."""
    ys = 1.0 - (2.0 * torch.arange(height, dtype=torch.float32, device=device) + 1.0) / height
    xs = (2.0 * torch.arange(width, dtype=torch.float32, device=device) + 1.0) / width - 1.0
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def _cross2(ux, uy, vx, vy):
    return ux * vy - uy * vx


def _face_pixel_terms(px, py, fvi, fz, fnz, sigmainv):
    """Per (pixel, face) terms of one face chunk, 'line' soft mode.

    px, py (P,); fvi (B, C, 3, 2); fz (B, C, 3); fnz (B, C).
    Returns z_sel (B, P, C), -inf where the face does not cover the pixel,
    and log(1 - p) (B, P, C).
    """
    ax, ay = fvi[:, None, :, 0, 0], fvi[:, None, :, 0, 1]  # (B, 1, C)
    bx, by = fvi[:, None, :, 1, 0], fvi[:, None, :, 1, 1]
    cx, cy = fvi[:, None, :, 2, 0], fvi[:, None, :, 2, 1]
    p_x = px[None, :, None]
    p_y = py[None, :, None]

    den = _cross2(bx - ax, by - ay, cx - ax, cy - ay)
    safe_den = torch.where(den.abs() > _DEN_EPS, den, 1.0)
    cross0 = _cross2(cx - bx, cy - by, p_x - bx, p_y - by)
    cross1 = _cross2(ax - cx, ay - cy, p_x - cx, p_y - cy)
    w0 = cross0 / safe_den
    w1 = cross1 / safe_den
    w2 = 1.0 - w0 - w1

    front = fnz[:, None, :] > 0.0
    nondegenerate = den.abs() > _DEN_EPS
    inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0) & nondegenerate & front
    z = w0 * fz[:, None, :, 0] + w1 * fz[:, None, :, 1] + w2 * fz[:, None, :, 2]
    z_sel = torch.where(inside, z, -torch.inf)

    def rlen(ux, uy, vx, vy):
        dx = vx - ux
        dy = vy - uy
        return torch.rsqrt(dx * dx + dy * dy + 1e-12)

    cross2_ = den - cross0 - cross1
    sgn = torch.where(den >= 0, 1.0, -1.0)
    d_line = torch.maximum(
        torch.maximum(-sgn * cross0 * rlen(bx, by, cx, cy),
                      -sgn * cross1 * rlen(cx, cy, ax, ay)),
        -sgn * cross2_ * rlen(ax, ay, bx, by))
    # the line distance leaks along edge-line extensions: floor it with the
    # axis-aligned bbox distance, a lower bound on the true distance
    xs = fvi[..., 0]
    ys = fvi[..., 1]
    dbx = torch.maximum(xs.amin(-1)[:, None] - p_x, p_x - xs.amax(-1)[:, None])
    dby = torch.maximum(ys.amin(-1)[:, None] - p_y, p_y - ys.amax(-1)[:, None])
    d_line = torch.maximum(d_line, torch.maximum(dbx, dby))
    d2 = torch.clamp(d_line, min=0.0) ** 2
    d2 = torch.where(inside, 0.0, d2)
    p_soft = torch.where(front, _P_CLAMP * torch.exp(-d2 * sigmainv), 0.0)
    return z_sel, torch.log1p(-p_soft)


def rasterize_phase1(px, py, fvi, fz, fnz, sigmainv):
    """Walk the faces in chunks -> (best_idx (B, P) int64, sumlog (B, P)).

    Ties in z go to the lowest face id: argmax takes the first maximum in a
    chunk and a later chunk must be strictly nearer.
    """
    B, F = fvi.shape[0], fvi.shape[1]
    P = px.shape[0]
    chunk = max(1, min(256, _CHUNK_ELEMS // (B * P)))
    best_z = torch.full((B, P), -torch.inf, dtype=torch.float32, device=fvi.device)
    best_idx = torch.full((B, P), -1, dtype=torch.int64, device=fvi.device)
    sumlog = torch.zeros((B, P), dtype=torch.float32, device=fvi.device)
    for base in range(0, F, chunk):
        sl = slice(base, base + chunk)
        z_sel, log1mp = _face_pixel_terms(px, py, fvi[:, sl], fz[:, sl], fnz[:, sl],
                                          sigmainv)
        chunk_best = torch.argmax(z_sel, dim=2)
        chunk_z = torch.gather(z_sel, 2, chunk_best[..., None])[..., 0]
        take = chunk_z > best_z
        best_z = torch.where(take, chunk_z, best_z)
        best_idx = torch.where(take, chunk_best + base, best_idx)
        sumlog = sumlog + log1mp.sum(dim=2)
    return best_idx, sumlog


def interpolate_selected(px, py, best_idx, fvi, face_features):
    """Gather the winning face per pixel, recompute its barycentric weights
    and interpolate its features.

    best_idx (B, P); fvi (B, F, 3, 2); face_features (B, F, 3, C).
    Returns (features (B, P, C), hard (B, P)).
    """
    B, F, _, C = face_features.shape
    packed = torch.cat([fvi.reshape(B, F, 6), face_features.reshape(B, F, 3 * C)], dim=2)
    safe = best_idx.clamp(min=0)
    g = torch.gather(packed, 1, safe[..., None].expand(-1, -1, packed.shape[2]))
    fv = g[..., :6].reshape(B, -1, 3, 2)
    feats = g[..., 6:].reshape(B, -1, 3, C)

    ax, ay = fv[..., 0, 0], fv[..., 0, 1]
    bx, by = fv[..., 1, 0], fv[..., 1, 1]
    cx, cy = fv[..., 2, 0], fv[..., 2, 1]
    den = _cross2(bx - ax, by - ay, cx - ax, cy - ay)
    den = torch.where(den.abs() > _DEN_EPS, den, 1.0)
    w0 = _cross2(cx - bx, cy - by, px - bx, py - by) / den
    w1 = _cross2(ax - cx, ay - cy, px - cx, py - cy) / den
    w2 = 1.0 - w0 - w1
    w = torch.stack([w0, w1, w2], dim=-1).clamp(0.0, 1.0)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-12)

    hard = (best_idx >= 0).to(torch.float32)
    out = (w[..., None] * feats).sum(dim=2) * hard[..., None]
    return out, hard


def rasterize_fused_plain(fvi, fz, fnz, face_uvs, face_normals, sigmainv=7000.0,
                          height=256, width=256):
    """Plain version of the forward kernel (any device).

    fvi (B, F, 3, 2); fz (B, F, 3); fnz (B, F); face_uvs (F, 3, 2) shared;
    face_normals (B, F, 3).  Returns idx (B, H, W) int32 (-1 = background),
    soft (B, H, W), uv (B, H, W, 2), normal (B, H, W, 3), hard (B, H, W).
    """
    B, F = fvi.shape[0], fvi.shape[1]
    px, py = pixel_grid(height, width, fvi.device)
    best_idx, sumlog = rasterize_phase1(px, py, fvi, fz, fnz, sigmainv)
    feats = torch.cat([face_uvs.to(fvi.dtype)[None].expand(B, F, 3, 2),
                       face_normals[:, :, None, :].expand(B, F, 3, 3)], dim=-1)
    out, hard = interpolate_selected(px, py, best_idx, fvi, feats)
    soft = 1.0 - torch.exp(sumlog)
    return (best_idx.to(torch.int32).reshape(B, height, width),
            soft.reshape(B, height, width),
            out[..., :2].reshape(B, height, width, 2),
            out[..., 2:].reshape(B, height, width, 3),
            hard.reshape(B, height, width))


def raster_fwd(rows, sigmainv: float, height: int, width: int):
    """Launch ``csrc/raster_fwd.cu`` on face rows (B, F + 1, 26) from
    :func:`face_rows.face_rows`; same outputs as :func:`rasterize_fused_plain`."""
    B, F1 = rows.shape[0], rows.shape[1]
    build.check(rows, "rows", torch.float32, (B, F1, R_FUSED))
    dev = rows.device
    idx = torch.empty((B, height, width), dtype=torch.int32, device=dev)
    soft = torch.empty((B, height, width), dtype=torch.float32, device=dev)
    uv = torch.empty((B, height, width, 2), dtype=torch.float32, device=dev)
    normal = torch.empty((B, height, width, 3), dtype=torch.float32, device=dev)
    hard = torch.empty((B, height, width), dtype=torch.float32, device=dev)
    build.launch("raster_fwd", rows.data_ptr(), B, F1, height, width, float(sigmainv),
                 idx.data_ptr(), soft.data_ptr(), uv.data_ptr(), normal.data_ptr(),
                 hard.data_ptr())
    kernels.LAUNCHES["raster_fwd"] += 1
    return idx, soft, uv, normal, hard


def rasterize_fused(fvi, fz, fnz, face_uvs, face_normals, sigmainv=7000.0,
                    height=256, width=256):
    """Forward rasterization: the plain path for CPU tensors, the CUDA
    kernel for CUDA tensors.  Same contract as :func:`rasterize_fused_plain`."""
    if not fvi.is_cuda:
        return rasterize_fused_plain(fvi, fz, fnz, face_uvs, face_normals,
                                     sigmainv, height, width)
    rows = face_rows(fvi, fz, fnz, face_uvs, face_normals).contiguous()
    return raster_fwd(rows, sigmainv, height, width)
