"""DIB-R soft rasterization in the 'line' and the 'exact' soft mode: the
plain PyTorch path and the wrappers of the CUDA kernels.

``rasterize_fused_plain`` is the port of the JAX package's golden XLA path
(``magicmirror/ops/rasterize.py``: ``_face_pixel_terms``, the face-chunked
phase 1 and ``_interpolate_selected``) over ALL faces, with no culling.  It
is the CPU path and the kernels' oracle.

``rasterize_fused`` (``RasterizeFused``) is the differentiable wrapper: CPU
tensors take the plain paths; CUDA tensors pack the per-face rows
(``face_rows.py``) and launch ``csrc/raster_fwd.cu`` in the forward, or
raise.  ``rasterize_plain`` (``RasterizePlain``) is phase 1 alone (idx and
sumlog), through the forward kernel's plain mode.  ``dibr_rasterization`` is
the two-phase form: phase 1 through the kernel, then
``interpolate_selected`` under autograd.

The backward of the soft silhouette: in 'line' mode ``csrc/raster_bwd.cu``
on the card and ``soft_backward_plain`` on the CPU (13 moments per face that
chain to the vertices through ``coeffs13``); in 'exact' mode, as in the JAX
package (``rasterize_tpu.py::_phase1_bwd``, ``_fused_bwd``), autograd of the
plain phase 1, one face chunk at a time (``soft_backward_autograd``), on
either device: there is no backward kernel for that mode.

Per pixel: the winner is the front-facing, non-degenerate covering face with
the largest camera z (lowest id on ties); soft = 1 - prod(1 - p) with
p = (1 - 1e-7) * exp(-sigmainv * d^2); in 'line' mode d is the largest signed
distance to the three edge lines floored by the bbox distance, in 'exact'
mode the distance to the nearest edge segment (kaolin's rule), 0 inside; uv
and normal are the winner's, interpolated.
"""
from __future__ import annotations

import torch

from .. import kernels
from . import clip01
from ..kernels import build
from .face_rows import (DENSE_THRESHOLD, R_CULL, R_FUSED, R_VERTS, SOFT_MARGIN, coeffs13,
                        face_cull, face_rows, face_verts)

_DEN_EPS = 1e-10
_P_CLAMP = 1.0 - 1e-7
# elements of one (B, P, chunk) temporary of the plain phase 1 (64 MB f32)
_CHUNK_ELEMS = 1 << 24
SOFT_MODES = ("line", "exact")


def _check_soft_mode(soft_mode: str) -> bool:
    """-> whether the mode is 'exact'; raises on an unknown mode."""
    if soft_mode not in SOFT_MODES:
        raise ValueError(f"soft_mode must be one of {SOFT_MODES}, got {soft_mode!r}")
    return soft_mode == "exact"


def pixel_grid(height: int, width: int, device=None):
    """NDC pixel-centre coordinates (P,), row 0 at the image top (y = +1)."""
    ys = 1.0 - (2.0 * torch.arange(height, dtype=torch.float32, device=device) + 1.0) / height
    xs = (2.0 * torch.arange(width, dtype=torch.float32, device=device) + 1.0) / width - 1.0
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def _cross2(ux, uy, vx, vy):
    return ux * vy - uy * vx


def _segment_dist2(p_x, p_y, ax, ay, bx, by):
    """Squared distance from the pixels to the segments a -> b."""
    abx, aby = bx - ax, by - ay
    apx, apy = p_x - ax, p_y - ay
    t = clip01((apx * abx + apy * aby) / (abx * abx + aby * aby + 1e-12))
    dx, dy = apx - t * abx, apy - t * aby
    return dx * dx + dy * dy


def _face_pixel_terms(px, py, fvi, fz, fnz, sigmainv, soft_mode="line"):
    """Per (pixel, face) terms of one face chunk.

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

    if soft_mode == "exact":
        d2 = torch.minimum(torch.minimum(_segment_dist2(p_x, p_y, ax, ay, bx, by),
                                         _segment_dist2(p_x, p_y, bx, by, cx, cy)),
                           _segment_dist2(p_x, p_y, cx, cy, ax, ay))
    else:
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


def _chunk_faces(B: int, P: int) -> int:
    """Faces per chunk of the plain paths: at most 256, and no (B, P, chunk)
    temporary beyond ``_CHUNK_ELEMS`` elements."""
    return max(1, min(256, _CHUNK_ELEMS // (B * P)))


def _tile_overlaps(fvi, height: int, width: int):
    """The kernels' culling rule per pixel column and per pixel row: in_x
    (B, W, F) and in_y (B, H, F), whether a face's bbox, widened by the soft
    margin, meets the 16-pixel tile that the column or row lies in
    (``csrc/raster_common.cuh``: ``tile_bounds``, ``face_live``)."""
    xs, ys = fvi[..., 0], fvi[..., 1]

    def meets(lo, hi, n, flip):
        first = torch.arange(n, device=fvi.device) // 16 * 16
        a = -1.0 + 2.0 * first / n
        b = -1.0 + 2.0 * (first + 16).clamp(max=n) / n
        t_lo, t_hi = (-b, -a) if flip else (a, b)  # rows run from y = +1 down
        return ((hi[:, None, :] >= (t_lo - SOFT_MARGIN)[None, :, None])
                & (lo[:, None, :] <= (t_hi + SOFT_MARGIN)[None, :, None]))

    return (meets(xs.amin(-1), xs.amax(-1), width, False),
            meets(ys.amin(-1), ys.amax(-1), height, True))


def rasterize_phase1(px, py, fvi, fz, fnz, sigmainv, soft_mode="line", tile_cull=None):
    """Walk the faces in chunks -> (best_idx (B, P) int64, sumlog (B, P)).

    Ties in z go to the lowest face id: argmax takes the first maximum in a
    chunk and a later chunk must be strictly nearer.  With ``tile_cull`` =
    (height, width) the sum leaves out the (pixel, face) terms that the
    kernels' tiles cull (:func:`_tile_overlaps`): the oracle for what the
    0.035 margin cuts from sumlog; the winner is the same either way.
    """
    B, F = fvi.shape[0], fvi.shape[1]
    P = px.shape[0]
    chunk = _chunk_faces(B, P)
    in_x, in_y = _tile_overlaps(fvi, *tile_cull) if tile_cull else (None, None)
    best_z = torch.full((B, P), -torch.inf, dtype=torch.float32, device=fvi.device)
    best_idx = torch.full((B, P), -1, dtype=torch.int64, device=fvi.device)
    sumlog = torch.zeros((B, P), dtype=torch.float32, device=fvi.device)
    for base in range(0, F, chunk):
        sl = slice(base, base + chunk)
        z_sel, log1mp = _face_pixel_terms(px, py, fvi[:, sl], fz[:, sl], fnz[:, sl],
                                          sigmainv, soft_mode)
        chunk_best = torch.argmax(z_sel, dim=2)
        chunk_z = torch.gather(z_sel, 2, chunk_best[..., None])[..., 0]
        take = chunk_z > best_z
        best_z = torch.where(take, chunk_z, best_z)
        best_idx = torch.where(take, chunk_best + base, best_idx)
        if tile_cull:
            keep = in_y[:, :, None, sl] & in_x[:, None, :, sl]  # (B, H, W, C)
            log1mp = torch.where(keep.reshape(B, P, -1), log1mp, 0.0)
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
    w = clip01(torch.stack([w0, w1, w2], dim=-1))
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-12)

    hard = (best_idx >= 0).to(torch.float32)
    out = (w[..., None] * feats).sum(dim=2) * hard[..., None]
    return out, hard


def rasterize_fused_plain(fvi, fz, fnz, face_uvs, face_normals, sigmainv=7000.0,
                          height=256, width=256, soft_mode="line", tile_cull=False):
    """Plain version of the forward kernel (any device), in either soft mode.

    fvi (B, F, 3, 2); fz (B, F, 3); fnz (B, F); face_uvs (F, 3, 2) shared;
    face_normals (B, F, 3).  Returns idx (B, H, W) int32 (-1 = background),
    soft (B, H, W), uv (B, H, W, 2), normal (B, H, W, 3), hard (B, H, W).
    ``tile_cull``: sum soft over the faces the kernels' tiles keep, not all.
    """
    B, F = fvi.shape[0], fvi.shape[1]
    px, py = pixel_grid(height, width, fvi.device)
    best_idx, sumlog = rasterize_phase1(px, py, fvi, fz, fnz, sigmainv, soft_mode,
                                        (height, width) if tile_cull else None)
    feats = torch.cat([face_uvs.to(fvi.dtype)[None].expand(B, F, 3, 2),
                       face_normals[:, :, None, :].expand(B, F, 3, 3)], dim=-1)
    out, hard = interpolate_selected(px, py, best_idx, fvi, feats)
    soft = 1.0 - torch.exp(sumlog)
    return (best_idx.to(torch.int32).reshape(B, height, width),
            soft.reshape(B, height, width),
            out[..., :2].reshape(B, height, width, 2),
            out[..., 2:].reshape(B, height, width, 3),
            hard.reshape(B, height, width))


def _counter(base: str, num_faces: int) -> str:
    """The launch counter of a 'line' kernel: templates of at least
    ``DENSE_THRESHOLD`` faces count under the dense name (the JAX package's
    ``rasterize_v6`` kernels), the rest under the base name."""
    return f"{base}_dense" if num_faces >= DENSE_THRESHOLD else base


def _tables(rows, cull, verts):
    """Check the kernels' face tables -> (cull, pointer of the vertex table
    or None, whether the mode is 'exact').  The cull table is derived from
    the rows unless the caller kept it from an earlier launch."""
    B, F1 = rows.shape[0], rows.shape[1]
    build.check(rows, "rows", torch.float32, (B, F1, R_FUSED))
    if cull is None:
        cull = face_cull(rows)
    build.check(cull, "cull", torch.float32, (B, F1, R_CULL))
    if verts is None:
        return cull, None, 0
    build.check(verts, "verts", torch.float32, (B, F1, R_VERTS))
    return cull, verts.data_ptr(), 1


def raster_fwd(rows, sigmainv: float, height: int, width: int, verts=None, cull=None):
    """Launch the fused mode of ``csrc/raster_fwd.cu`` on face rows
    (B, F + 1, 26) from :func:`face_rows.face_rows`; same outputs as
    :func:`rasterize_fused_plain`.  With ``verts`` (B, F + 1, 6) from
    :func:`face_rows.face_verts` the soft mode is 'exact', else 'line';
    ``cull`` is :func:`face_rows.face_cull` of the rows."""
    B, F1 = rows.shape[0], rows.shape[1]
    cull, verts_ptr, exact = _tables(rows, cull, verts)
    dev = rows.device
    idx = torch.empty((B, height, width), dtype=torch.int32, device=dev)
    soft = torch.empty((B, height, width), dtype=torch.float32, device=dev)
    uv = torch.empty((B, height, width, 2), dtype=torch.float32, device=dev)
    normal = torch.empty((B, height, width, 3), dtype=torch.float32, device=dev)
    hard = torch.empty((B, height, width), dtype=torch.float32, device=dev)
    build.launch("raster_fwd", rows.data_ptr(), cull.data_ptr(), verts_ptr, exact, B, F1,
                 height, width, float(sigmainv), idx.data_ptr(), soft.data_ptr(),
                 uv.data_ptr(), normal.data_ptr(), hard.data_ptr())
    kernels.LAUNCHES["raster_exact_fused" if exact else _counter("raster_fwd", F1 - 1)] += 1
    return idx, soft, uv, normal, hard


def raster_fwd_plain(rows, sigmainv: float, height: int, width: int, verts=None, cull=None):
    """Launch the plain mode of ``csrc/raster_fwd.cu`` on face rows
    (B, F + 1, 26): idx (B, P) int32 and sumlog (B, P) only, the outputs of
    :func:`rasterize_phase1`; 'exact' with ``verts``, else 'line'.  In 'line'
    mode it counts as a launch of ``raster_fwd``: one kernel source, two
    instantiations."""
    B, F1 = rows.shape[0], rows.shape[1]
    cull, verts_ptr, exact = _tables(rows, cull, verts)
    idx = torch.empty((B, height * width), dtype=torch.int32, device=rows.device)
    sumlog = torch.empty((B, height * width), dtype=torch.float32, device=rows.device)
    build.launch("raster_fwd_plain", rows.data_ptr(), cull.data_ptr(), verts_ptr, exact, B, F1,
                 height, width, float(sigmainv), idx.data_ptr(), sumlog.data_ptr())
    kernels.LAUNCHES["raster_exact" if exact else _counter("raster_fwd", F1 - 1)] += 1
    return idx, sumlog


def soft_backward_plain(fvi, fnz, g_sumlog, sigmainv: float, height: int, width: int):
    """Plain version of the 'line' backward kernel (any device): the 13 per-face
    moments of the soft-silhouette gradient, over ALL faces with no culling.

    fvi (B, F, 3, 2); fnz (B, F); g_sumlog (B, P) the cotangent of sumlog.
    Returns G (B, F, 13), the cotangent of ``face_rows.coeffs13(fvi)``: per
    (pixel, face) pair the weight gl = g * 2 sigma d p / (1 - p) goes to the
    one term that is active in d = max(d0, d1, d2, dbx, dby, 0), ties as
    ``_bwd_stream_kernel`` resolves them (rasterize_v4.py:653-666)."""
    B, F = fvi.shape[0], fvi.shape[1]
    px, py = pixel_grid(height, width, fvi.device)
    P = px.shape[0]
    coef = coeffs13(fvi.detach())
    front = fnz > 0.0
    g = g_sumlog.reshape(B, P, 1)
    p_x, p_y = px[None, :, None], py[None, :, None]
    chunk = _chunk_faces(B, P)
    out = []
    for base in range(0, F, chunk):
        c = coef[:, None, base:base + chunk]  # (B, 1, C, 13)
        d0 = c[..., 0] * p_x + c[..., 1] * p_y + c[..., 2]
        d1 = c[..., 3] * p_x + c[..., 4] * p_y + c[..., 5]
        d2 = c[..., 6] * p_x + c[..., 7] * p_y + c[..., 8]
        xmin, xmax, ymin, ymax = c[..., 9], c[..., 10], c[..., 11], c[..., 12]
        dl = torch.maximum(torch.maximum(d0, d1), d2)
        dbx = torch.maximum(xmin - p_x, p_x - xmax)
        dby = torch.maximum(ymin - p_y, p_y - ymax)
        dpos = torch.maximum(dl, torch.maximum(dbx, dby)).clamp(min=0.0)
        p_soft = _P_CLAMP * torch.exp(dpos * dpos * (-sigmainv))
        gl = g * (2.0 * sigmainv) * dpos * (p_soft / (1.0 - p_soft))
        gl = torch.where(front[:, None, base:base + chunk], gl, 0.0)

        mline = (dl >= dbx) & (dl >= dby)
        m0 = (d0 >= d1) & (d0 >= d2)
        m1 = ~m0 & (d1 >= d2)
        m2 = ~m0 & ~m1
        mbx = ~mline & (dbx >= dby)
        mby = ~mline & ~mbx
        x_lo = (xmin - p_x) >= (p_x - xmax)
        y_lo = (ymin - p_y) >= (p_y - ymax)
        cols = []
        for m in (m0, m1, m2):
            w = torch.where(mline & m, gl, 0.0)
            cols += [(w * p_x).sum(1), (w * p_y).sum(1), w.sum(1)]
        cols += [torch.where(mbx & x_lo, gl, 0.0).sum(1),
                 torch.where(mbx & ~x_lo, -gl, 0.0).sum(1),
                 torch.where(mby & y_lo, gl, 0.0).sum(1),
                 torch.where(mby & ~y_lo, -gl, 0.0).sum(1)]
        out.append(torch.stack(cols, dim=-1))  # (B, C, 13)
    return torch.cat(out, dim=1)


def soft_backward_autograd(fvi, fz, fnz, g_sumlog, sigmainv: float, height: int, width: int,
                           soft_mode: str = "exact"):
    """d_fvi (B, F, 3, 2) of sum(sumlog * g_sumlog) by autograd of the plain
    phase 1 over ALL faces, one face chunk at a time (any device, either soft
    mode).  sumlog is a sum over faces, so a chunk's vertices take their
    whole gradient from that chunk's terms: each chunk is computed and
    differentiated on its own, and only one chunk's graph is alive at a time
    (what ``jax.checkpoint`` on the scan body buys the JAX package,
    ``magicmirror/ops/rasterize.py:158``)."""
    B, F = fvi.shape[0], fvi.shape[1]
    px, py = pixel_grid(height, width, fvi.device)
    g = g_sumlog.reshape(B, -1, 1)
    # autograd keeps some 40 (B, P, chunk) temporaries of a chunk alive: 2.7 GB
    # at the most, and one kernel launch per temporary whatever the chunk holds
    chunk = _chunk_faces(B, px.shape[0])
    out = torch.empty_like(fvi)
    with torch.enable_grad():
        for base in range(0, F, chunk):
            sl = slice(base, base + chunk)
            leaf = fvi[:, sl].detach().requires_grad_(True)
            _, log1mp = _face_pixel_terms(px, py, leaf, fz[:, sl], fnz[:, sl], sigmainv,
                                          soft_mode)
            (out[:, sl],) = torch.autograd.grad((log1mp * g).sum(), leaf)
    return out


def raster_bwd(rows, g_sumlog, sigmainv: float, height: int, width: int, cull=None):
    """Launch ``csrc/raster_bwd.cu`` ('line' mode) on the forward's face rows
    (B, F + 1, 26), their cull table and g_sumlog (B, H * W); same output as
    :func:`soft_backward_plain`."""
    B, F1 = rows.shape[0], rows.shape[1]
    cull, _, _ = _tables(rows, cull, None)
    build.check(g_sumlog, "g_sumlog", torch.float32, (B, height * width))
    G = torch.zeros((B, F1 - 1, 13), dtype=torch.float32, device=rows.device)
    build.launch("raster_bwd", rows.data_ptr(), cull.data_ptr(), g_sumlog.data_ptr(), B, F1,
                 height, width, float(sigmainv), G.data_ptr())
    kernels.LAUNCHES[_counter("raster_bwd", F1 - 1)] += 1
    return G


def _soft_term(fvi_, saved, g_sumlog):
    """The scalar whose gradient with respect to ``fvi_`` is the soft
    silhouette's: in 'line' mode the moments (the backward kernel on the
    card, :func:`soft_backward_plain` on the CPU) against ``coeffs13``; in
    'exact' mode the chunked autograd's d_fvi against ``fvi_`` itself."""
    fvi, fz, fnz, tables, (sigmainv, height, width, soft_mode) = saved
    if soft_mode == "exact":
        d_fvi = soft_backward_autograd(fvi, fz, fnz, g_sumlog, sigmainv, height, width)
        return (fvi_ * d_fvi).sum()
    if fvi.is_cuda:
        rows, cull = tables
        G = raster_bwd(rows, g_sumlog, sigmainv, height, width, cull)
    else:
        G = soft_backward_plain(fvi, fnz, g_sumlog, sigmainv, height, width)
    return (coeffs13(fvi_) * G).sum()


class RasterizeFused(torch.autograd.Function):
    """Differentiable rasterization: the plain path for CPU tensors, the CUDA
    kernels for CUDA tensors (or an error; there is no fallback).

    forward(fvi, fz, fnz, face_uvs, face_normals, sigmainv, height, width,
    soft_mode) has the contract of :func:`rasterize_fused_plain`.  backward,
    as ``_fused_bwd`` (rasterize_v4.py:885-918, rasterize_tpu.py:817-845):
    the uv and normal cotangents go through autograd of
    :func:`interpolate_selected` at the saved winner; the soft cotangent
    becomes g_sumlog = g_soft * (soft - 1), which reaches fvi through
    :func:`_soft_term`.  fz and fnz get no gradient, and the cotangents of
    idx and hard are dropped."""

    @staticmethod
    def forward(ctx, fvi, fz, fnz, face_uvs, face_normals, sigmainv, height, width,
                soft_mode="line"):
        exact = _check_soft_mode(soft_mode)
        tables = None
        if fvi.is_cuda:
            rows = face_rows(fvi, fz, fnz, face_uvs, face_normals).contiguous()
            tables = (rows, face_cull(rows))
            out = raster_fwd(rows, sigmainv, height, width,
                             face_verts(fvi).contiguous() if exact else None, tables[1])
        else:
            out = rasterize_fused_plain(fvi, fz, fnz, face_uvs, face_normals,
                                        sigmainv, height, width, soft_mode)
        idx, soft = out[0], out[1]
        ctx.save_for_backward(fvi, fz, fnz, face_uvs, face_normals, idx, soft)
        ctx.tables = None if exact else tables
        ctx.geometry = (float(sigmainv), int(height), int(width), soft_mode)
        ctx.mark_non_differentiable(idx, out[4])
        return out

    @staticmethod
    def backward(ctx, _g_idx, g_soft, g_uv, g_normal, _g_hard):
        fvi, fz, fnz, face_uvs, face_normals, idx, soft = ctx.saved_tensors
        _, height, width, _ = ctx.geometry
        B, F = fvi.shape[0], fvi.shape[1]
        P = height * width

        g_sumlog = (g_soft * (soft - 1.0)).reshape(B, P).contiguous()
        px, py = pixel_grid(height, width, fvi.device)
        g_feats = torch.cat([g_uv.reshape(B, P, 2), g_normal.reshape(B, P, 3)], dim=-1)
        with torch.enable_grad():
            fvi_, uvs_, normals_ = (x.detach().to(fvi.dtype).requires_grad_(True)
                                    for x in (fvi, face_uvs, face_normals))
            feats = torch.cat([uvs_[None].expand(B, F, 3, 2),
                               normals_[:, :, None, :].expand(B, F, 3, 3)], dim=-1)
            out, _ = interpolate_selected(px, py, idx.reshape(B, P).long(), fvi_, feats)
            total = (out * g_feats).sum() + _soft_term(
                fvi_, (fvi, fz, fnz, ctx.tables, ctx.geometry), g_sumlog)
            g_fvi, g_uvs, g_normals = torch.autograd.grad(total, (fvi_, uvs_, normals_))
        return g_fvi, None, None, g_uvs, g_normals, None, None, None, None


class RasterizePlain(torch.autograd.Function):
    """Phase 1 alone, differentiable: (idx (B, P) int32, sumlog (B, P)), the
    function of ``rasterize_plain_v4`` and, with ``soft_mode``, of
    ``rasterize_phase1_pallas``.  forward(fvi, fz, fnz, sigmainv, height,
    width, soft_mode): :func:`rasterize_phase1` for CPU tensors, the forward
    kernel's plain mode for CUDA tensors.  backward: the cotangent of sumlog
    through :func:`_soft_term`, to fvi alone."""

    @staticmethod
    def forward(ctx, fvi, fz, fnz, sigmainv, height, width, soft_mode="line"):
        exact = _check_soft_mode(soft_mode)
        tables = None
        if fvi.is_cuda:
            zeros = fvi.new_zeros(())
            normals = torch.stack([zeros.expand_as(fnz), zeros.expand_as(fnz), fnz], dim=-1)
            rows = face_rows(fvi, fz, fnz, fvi.new_zeros((fvi.shape[1], 3, 2)),
                             normals).contiguous()
            tables = (rows, face_cull(rows))
            idx, sumlog = raster_fwd_plain(rows, sigmainv, height, width,
                                           face_verts(fvi).contiguous() if exact else None,
                                           tables[1])
        else:
            px, py = pixel_grid(height, width, fvi.device)
            idx, sumlog = rasterize_phase1(px, py, fvi, fz, fnz, sigmainv, soft_mode)
            idx = idx.to(torch.int32)
        ctx.save_for_backward(fvi, fz, fnz)
        ctx.tables = None if exact else tables
        ctx.geometry = (float(sigmainv), int(height), int(width), soft_mode)
        ctx.mark_non_differentiable(idx)
        return idx, sumlog

    @staticmethod
    def backward(ctx, _g_idx, g_sumlog):
        fvi, fz, fnz = ctx.saved_tensors
        with torch.enable_grad():
            fvi_ = fvi.detach().requires_grad_(True)
            total = _soft_term(fvi_, (fvi, fz, fnz, ctx.tables, ctx.geometry),
                               g_sumlog.contiguous())
            (g_fvi,) = torch.autograd.grad(total, fvi_)
        return g_fvi, None, None, None, None, None, None


def rasterize_plain(fvi, fz, fnz, sigmainv=7000.0, height=256, width=256, soft_mode="line"):
    """Phase-1 rasterization with a gradient to fvi: see
    :class:`RasterizePlain`.  Returns (idx (B, P) int32 with -1 = background,
    sumlog (B, P), dropped (B,) int32, always 0: nothing has a capacity)."""
    idx, sumlog = RasterizePlain.apply(fvi, fz, fnz, sigmainv, height, width, soft_mode)
    return idx, sumlog, torch.zeros(fvi.shape[0], dtype=torch.int32, device=fvi.device)


def rasterize_fused(fvi, fz, fnz, face_uvs, face_normals, sigmainv=7000.0,
                    height=256, width=256, soft_mode="line"):
    """Rasterization with gradients to fvi, face_uvs and face_normals: see
    :class:`RasterizeFused`.  Same contract as :func:`rasterize_fused_plain`."""
    return RasterizeFused.apply(fvi, fz, fnz, face_uvs, face_normals, sigmainv,
                                height, width, soft_mode)


def dibr_rasterization(fvi, fz, fnz, face_uvs, face_normals, sigmainv=7000.0,
                       height=256, width=256, soft_mode="exact"):
    """The two-phase form, as the JAX package's ``dibr_rasterization`` with
    ``backend='pallas'`` runs it: phase 1 (:func:`rasterize_plain`: the
    kernel's plain mode on the card) and then :func:`interpolate_selected`
    at the winner, under autograd.  Same contract as
    :func:`rasterize_fused_plain`; against :func:`rasterize_fused` the
    forward keeps the interpolation's graph instead of recomputing it in the
    backward, and uv is the clipped barycentric interpolation, not the uv
    plane."""
    B, F = fvi.shape[0], fvi.shape[1]
    idx, sumlog, _ = rasterize_plain(fvi, fz, fnz, sigmainv, height, width, soft_mode)
    px, py = pixel_grid(height, width, fvi.device)
    feats = torch.cat([face_uvs.to(fvi.dtype)[None].expand(B, F, 3, 2),
                       face_normals[:, :, None, :].expand(B, F, 3, 3)], dim=-1)
    out, hard = interpolate_selected(px, py, idx.long(), fvi, feats)
    return (idx.reshape(B, height, width), (1.0 - torch.exp(sumlog)).reshape(B, height, width),
            out[..., :2].reshape(B, height, width, 2),
            out[..., 2:].reshape(B, height, width, 3), hard.reshape(B, height, width))
