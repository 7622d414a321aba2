"""How the port is held to its references: the statistics and the
tolerances, shared by the port's tests and chip_smoke.py.

Rasterizer (``raster_fwd`` vs ``rasterize_fused_plain``):
  * idx may differ on at most 0.01% of pixels, and only where both cover the
    pixel: the kernel evaluates the edge and z planes in affine form, the
    plain path through barycentrics, so a pixel on an edge shared by two
    faces may go to either;
  * normal within 1e-5 where idx agrees;
  * uv within 1e-5 where idx agrees, except on at most 0.01% of pixels,
    which stay within 1e-3: the plain path clips the barycentrics into the
    triangle and renormalises, the kernel evaluates the uv plane, and the
    two differ where a pixel sits on the edge of a sliver face;
  * hard equal;
  * soft within 3e-4: the kernel culls faces beyond the 0.035 soft margin,
    the plain path sums over all faces;
  * on the dense template (smpl_uv.obj, 13,776 faces) at the Market shape
    (128x64) the same bounds hold, and no pixel may change coverage.  At
    256^2 (``dense_uncut=True``), where a tile spans an eighth of the NDC
    range and the cull follows the 0.035 margin most closely, the
    comparison with the plain sum over ALL faces is wider in two places: a
    pixel may be covered in one and background in the other on at most 2e-6
    of the pixels (the body's silhouette is made of edges shorter than a
    pixel there, and a pixel centre within float rounding of such an edge
    falls inside by the affine edge planes and outside by the barycentrics,
    or the other way round; seen: 1 of 2,097,152 pixels at b32 with the
    camera at distance 2), and soft within 2e-3 (seen 1.0e-3 with the
    camera at 6.5, 1.9e-4 at 2).  That this is the margin truncating a sum
    of many small terms, and no fault of the kernel, is shown beside it:
    against the plain sum over the faces the tiles keep
    (``rasterize_fused_plain(tile_cull=True)``) soft is held to 3e-4 there
    too.  The margin is the JAX package's own (``_SOFT_MARGIN``), whose
    kernels truncate the same sum.
The plain mode returns sumlog itself.  On a covered pixel it is a sum of
large terms (-15.9 for each face that covers it), and a term with p near 1
is ill conditioned: log(1 - p) moves by p / (1 - p) times the relative
change of p, and the kernel's edge distances (affine rows) and the plain
path's (cross products) differ by ~1e-7, as do two exp implementations by
their last bit.  Where a face's edge passes within ~1e-3 of the pixel
centre, 1 - p is ~1e-5 and the term is not determined in float32 at all.
So sumlog is held to the soft bound (3e-4) on the covered pixels where
every face's term is well conditioned: p <= 0.5, or the face covers the
pixel (d = 0 exactly, p = 1 - 1e-7 on either side).  tests/
sumlog_conditioning.py measures the largest difference by threshold on the
card, for the kernel of any checkout (at b32 / 128^2 it falls about fourfold
from p <= 0.9 to p <= 0.5).  The other covered pixels are held to a float64
witness, the same sum taken in float64 with float32's value of 1 - 1e-7
(1 - 2^-23): on those pixels the kernel's largest and its mean distance
from it may be at most twice the plain float32 path's, plus 3e-4 (b32 /
128^2: the largest is ~0.53 for either).
The 'exact' soft mode (segment distances) is held to the same bounds
against the plain 'exact' path, and the unmasked texture mode to the
texture bounds with every pixel counted as inside the mask.
Texture (``texture_fwd`` vs ``texture_render_plain``): 1e-5, and exactly 0
outside the mask.

Rasterizer backward (``raster_bwd`` vs ``soft_backward_plain``), each
relative to the largest absolute value of the plain result: the 13 moments
G and their chain to d_fvi within RASTER_BWD_TOL.  The kernel culls
(tile, face) pairs beyond the 0.035 soft margin, whose terms the plain
version keeps (each below 2e-4 of soft mass), and sums with atomics in an
order that changes from run to run.
Texture backward (``texture_bwd`` vs ``texture_backward_plain``): d_texcoord
and d_textures within TEXTURE_BWD_TOL of the largest absolute value of the
plain result (atomic sums in another order; the tap differences that
d_texcoord multiplies by the texture's size cancel in float32), d_texcoord
exactly 0 outside the mask.

The serving slice (two runs of encoder + five renders, e.g. JAX vs the port
or the card vs the CPU): attributes within 1e-3 (azimuth and elevation 1e-2
degrees), except the textures, which are within 1e-3 on at least 99.5% of
texels: a texture is the photo resampled (bicubic) at a predicted flow, so
at the photo's silhouette, where it steps from object to background, a
1e-5 change of the flow moves a texel by up to ~1e-3 per unit step; alpha
and rgb within 1e-3 on at least 99.5% of each image's pixels, and on all
but 64 of them: a z-test winner may flip at a silhouette pixel, and a face
seen edge-on at the silhouette (normal z ~1e-6) may face the camera in one
run and away in the other, which switches its soft term, and its winner,
on or off near it (15 of 65,536 pixels, alpha 0.10, in one b4/128^2
render, card vs CPU).  The worst value anywhere is capped too: textures
and rgb 1e-2, alpha 0.15, above the worst seen card vs CPU (5.6e-3, 7.9e-3,
0.10).  Float32 on both sides, through a 56M-parameter encoder whose
convolutions sum in another order.  Between the card and the CPU
(``check_slice(stats, rgb_flip_pixels=4)``) up to four pixels of an image
may pass the rgb cap: the two devices place the vertices ~2e-6 apart, so a
pixel centre within that of a silhouette edge is covered on one device and
background (white) on the other while alpha is ~1 on both, and rgb is the
texture times a light coefficient of up to ~3, which carries a texel's
4e-3 to 1.3e-2 (seen in one b4/128^2 'exact' serve: one such pixel 0.18
off in ``Xir2``, one 0.013 off in ``Xer270``; chip_smoke.py prints the
pixels whose winner differs beside each view).
"""
from __future__ import annotations

import numpy as np
import torch

RASTER_TOL = {"idx_frac": 1e-4, "normal": 1e-5, "uv": 1e-5, "uv_frac": 1e-4,
              "uv_max": 1e-3, "soft": 3e-4, "uncut_coverage_frac": 2e-6, "uncut_soft": 2e-3}
TEXTURE_TOL = 1e-5
RASTER_BWD_TOL = 1e-3
TEXTURE_BWD_TOL = 1e-5


def _require(ok: bool, what) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def raster_stats(kernel_out, plain_out) -> dict:
    """Compare (idx, soft, uv, normal, hard) of the kernel and the plain path."""
    idx, soft, uv, normal, hard = kernel_out
    idx_p, soft_p, uv_p, normal_p, hard_p = plain_out
    differ = idx != idx_p
    same = ~differ
    uv_err = (uv - uv_p).abs().amax(-1)[same]
    return {
        "pixels": idx.numel(),
        "covered": int((idx_p >= 0).sum()),
        "idx_mismatch": int(differ.sum()),
        "idx_mismatch_uncovered": int((differ & ((idx < 0) | (idx_p < 0))).sum()),
        "normal_max": float((normal - normal_p).abs().amax(-1)[same].max()),
        "uv_max": float(uv_err.max()),
        "uv_over_tol": int((uv_err > RASTER_TOL["uv"]).sum()),
        "hard_mismatch": int((hard != hard_p).sum()),
        "soft_max": float((soft - soft_p).abs().max()),
    }


def check_raster(stats: dict, dense_uncut: bool = False) -> None:
    """``dense_uncut``: the dense template at 256^2 against the sum over all
    faces (see the module's text)."""
    tol = RASTER_TOL
    n = stats["pixels"]
    coverage_flips = tol["uncut_coverage_frac"] * n if dense_uncut else 0
    _require(stats["idx_mismatch"] <= tol["idx_frac"] * n, stats)
    _require(stats["idx_mismatch_uncovered"] <= coverage_flips, stats)
    _require(stats["normal_max"] <= tol["normal"], stats)
    _require(stats["uv_over_tol"] <= tol["uv_frac"] * n, stats)
    _require(stats["uv_max"] <= tol["uv_max"], stats)
    _require(stats["hard_mismatch"] <= coverage_flips, stats)
    _require(stats["soft_max"] <= tol["uncut_soft" if dense_uncut else "soft"], stats)


def sumlog_stats(sumlog, sumlog_plain, idx_plain, raster_inputs, sigmainv: float) -> dict:
    """Compare the plain mode's sumlog (B, P) with the plain path's on the
    covered pixels where it is well conditioned, and both with the float64
    witness on the other covered pixels (see the module's text);
    ``raster_inputs`` = (px, py, fvi, fz, fnz) of ``rasterize_phase1``."""
    from .ops.rasterize import _P_CLAMP, _chunk_faces, _face_pixel_terms

    px, py, fvi, fz, fnz = (x.double() for x in raster_inputs)
    cover_term = float(np.log1p(-_P_CLAMP))  # in float64, as the terms are taken
    to_f32_clamp = float(np.float32(_P_CLAMP)) / _P_CLAMP
    good = torch.ones(sumlog.shape, dtype=torch.bool, device=sumlog.device)
    witness = torch.zeros(sumlog.shape, dtype=torch.float64, device=sumlog.device)
    chunk = _chunk_faces(*sumlog.shape)
    for base in range(0, fvi.shape[1], chunk):
        sl = slice(base, base + chunk)
        _, log1mp = _face_pixel_terms(px, py, fvi[:, sl], fz[:, sl], fnz[:, sl], sigmainv)
        good &= (((log1mp - cover_term).abs() < 1e-6) | (log1mp >= np.log(0.5))).all(-1)
        witness += torch.log1p(torch.expm1(log1mp) * to_f32_clamp).sum(-1)
    covered = idx_plain >= 0
    held, rest = covered & good, covered & ~good
    err = (sumlog.double() - sumlog_plain.double()).abs()
    err64 = (sumlog.double() - witness).abs()
    plain_err64 = (sumlog_plain.double() - witness).abs()

    def most(x, where):
        return float(x[where].max()) if where.any() else 0.0

    return {"covered": int(covered.sum()), "held": int(held.sum()),
            "sumlog_min_held": float(sumlog_plain[held].min()) if held.any() else 0.0,
            "sumlog_max_abs_held": most(err, held),
            "sumlog_max_abs_covered": most(err, covered),
            "sumlog_max_abs64_rest": most(err64, rest),
            "plain_max_abs64_rest": most(plain_err64, rest),
            "sumlog_mean_abs64_rest": float(err64[rest].mean()) if rest.any() else 0.0,
            "plain_mean_abs64_rest": float(plain_err64[rest].mean()) if rest.any() else 0.0}


def check_sumlog(stats: dict) -> None:
    _require(stats["held"] >= 0.05 * stats["covered"] > 0, stats)
    _require(stats["sumlog_max_abs_held"] <= RASTER_TOL["soft"], stats)
    for what in ("max", "mean"):
        _require(stats[f"sumlog_{what}_abs64_rest"]
                 <= 2.0 * stats[f"plain_{what}_abs64_rest"] + RASTER_TOL["soft"], stats)


def texture_stats(kernel_out, plain_out, texmask) -> dict:
    outside = texmask <= 0.5
    return {"max_abs": float((kernel_out - plain_out).abs().max()),
            "nonzero_outside_mask": int((kernel_out[outside] != 0).sum())}


def check_texture(stats: dict) -> None:
    _require(stats["max_abs"] <= TEXTURE_TOL, stats)
    _require(stats["nonzero_outside_mask"] == 0, stats)


# the stress cases of the texture backward, each with the dtype of the plain
# version it is held to (texture_bwd_stress)
TEXTURE_BWD_STRESS = {"one_texel": torch.float64, "clip_edges": torch.float32,
                      "band_borders": torch.float32}


def _texel_coords(rs, n: int, shape) -> np.ndarray:
    """Texture coordinates in (0, 1) whose texel position u * n - 0.5 lies
    0.1 or more from a whole number: every way of rounding it (float32 with
    or without fused multiply-adds, float64) picks the same taps."""
    j = rs.randint(0, n - 1, shape)
    return (j + 0.5 + rs.uniform(0.1, 0.9, shape)) / n


def texture_bwd_stress(case: str, batch: int, size: int, rows: int, seed: int = 0):
    """Inputs where the texture backward kernel works hardest, numpy float32:
    (g (B, S, S, 3), uv (B, S, S, 2), textures (B, 2S, S, 3), mask (B, S, S)
    or None for the unmasked mode).  ``one_texel``: unmasked, every pixel at
    uv = (0, 0), the unmasked background, with a cotangent on every pixel,
    so all of an image's pixels add into the texel (2S - 1, 0).
    ``clip_edges``: masked, u and v each exactly 0, exactly 1 or inside, the
    nine pairs at random pixels (taps outside the texture, the clip's
    gradient of 1/2).  ``band_borders``: masked, the two tap rows of every
    pixel straddle a border between two bands of ``rows`` texture rows (the
    rows of the texture that one block of the kernel zeroes).  Hold the
    kernel to ``texture_backward_plain`` in the case's dtype of
    TEXTURE_BWD_STRESS: float64 for ``one_texel``, whose float32 sum of
    16,384 terms in one texel is itself ~1e-5 off (its taps are exact in
    both), float32 for the others, whose weights float32 rounds as the
    kernel does (against float64 that rounding alone is ~1e-5 of d_uv)."""
    if case not in TEXTURE_BWD_STRESS:
        raise ValueError(f"case must be one of {TEXTURE_BWD_STRESS}, got {case!r}")
    rs = np.random.RandomState(seed)
    Ht, Wt = 2 * size, size
    tex = rs.rand(batch, Ht, Wt, 3)
    g = rs.randn(batch, size, size, 3)
    mask = (rs.rand(batch, size, size) > 0.3).astype(np.float64)
    shape = (batch, size, size)
    u, v = _texel_coords(rs, Wt, shape), _texel_coords(rs, Ht, shape)
    if case == "one_texel":
        u, v, mask = np.zeros(shape), np.zeros(shape), None
    elif case == "clip_edges":
        pick = rs.randint(0, 3, (2,) + shape)  # 0, 1 or inside
        u = np.where(pick[0] == 2, u, pick[0])
        v = np.where(pick[1] == 2, v, pick[1])
    else:
        borders = np.arange(rows, Ht, rows)
        if borders.size == 0:
            raise ValueError(f"band_borders: no border between bands of {rows} of {Ht} rows")
        # y = (1 - v) * Ht - 0.5 in [border - 0.9, border - 0.1]: taps border - 1, border
        y = borders[rs.randint(0, borders.size, shape)] - rs.uniform(0.1, 0.9, shape)
        v = 1.0 - (y + 0.5) / Ht
    out = [g, np.stack([u, v], axis=-1), tex, mask]
    return tuple(None if a is None else a.astype(np.float32) for a in out)


def _rel_err(ours, ref) -> float:
    return float((ours - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def raster_bwd_stats(G, G_plain, d_fvi, d_fvi_plain) -> dict:
    """Compare the backward kernel's moments (B, F, 13), and their chain to
    the vertices (B, F, 3, 2), with the plain version's."""
    return {"G_absmax": float(G_plain.abs().max()), "G_rel": _rel_err(G, G_plain),
            "d_fvi_absmax": float(d_fvi_plain.abs().max()),
            "d_fvi_rel": _rel_err(d_fvi, d_fvi_plain),
            "finite": bool(torch.isfinite(G).all() and torch.isfinite(d_fvi).all())}


def check_raster_bwd(stats: dict) -> None:
    _require(stats["finite"], stats)
    _require(stats["G_absmax"] > 0.0, stats)
    _require(stats["G_rel"] <= RASTER_BWD_TOL, stats)
    _require(stats["d_fvi_rel"] <= RASTER_BWD_TOL, stats)


def texture_bwd_stats(kernel_out, plain_out, texmask) -> dict:
    """Compare (d_texcoord, d_textures) of the backward kernel and the plain
    version."""
    (d_uv, d_tex), (d_uv_p, d_tex_p) = kernel_out, plain_out
    return {"d_uv_absmax": float(d_uv_p.abs().max()), "d_uv_rel": _rel_err(d_uv, d_uv_p),
            "d_tex_absmax": float(d_tex_p.abs().max()), "d_tex_rel": _rel_err(d_tex, d_tex_p),
            "nonzero_outside_mask": int((d_uv[texmask <= 0.5] != 0).sum())}


def check_texture_bwd(stats: dict) -> None:
    _require(stats["d_tex_absmax"] > 0.0, stats)
    _require(stats["d_uv_rel"] <= TEXTURE_BWD_TOL, stats)
    _require(stats["d_tex_rel"] <= TEXTURE_BWD_TOL, stats)
    _require(stats["nonzero_outside_mask"] == 0, stats)


SLICE_TOL = {
    "attr": 1e-3, "angle_deg": 1e-2, "alpha": 1e-3, "rgb": 1e-3,
    "frac": 0.995,  # least share of texels, and of each image's pixels, within tolerance
    "over_pixels": 64,  # most pixels of one image beyond "alpha" or "rgb"
    # the worst value anywhere (seen card vs CPU: textures 5.6e-3, alpha 0.10, rgb 7.9e-3)
    "textures_max": 1e-2, "alpha_max": 0.15, "rgb_max": 1e-2,
}
TRAIN_RGB_FRAC = 0.98  # least share of an image's pixels within "rgb" after a train step
SLICE_ATTRS = ("azimuths", "elevations", "distances", "biases", "vertices",
               "delta_vertices", "textures", "lights")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def render_stats(ref_renders, renders) -> dict:
    """Compare two sequences of (B, H, W, 4) renders.  Pixel shares and
    counts are per image, the worst image of any render."""
    stats = {}
    for channel, sl in (("alpha", slice(3, 4)), ("rgb", slice(0, 3))):
        within, over, worst, over_cap = [], [], [], []
        for a, b in zip(ref_renders, renders):
            d = np.abs(_np(b)[..., sl] - _np(a)[..., sl]).max(-1)  # (B, H, W)
            beyond = (d > SLICE_TOL[channel]).reshape(d.shape[0], -1)
            within.append(float(1.0 - beyond.mean(1).max()))
            over.append(int(beyond.sum(1).max()))
            worst.append(float(d.max()))
            over_cap.append(int((d > SLICE_TOL[f"{channel}_max"]).reshape(d.shape[0], -1)
                                .sum(1).max()))
        stats[f"{channel}_within_frac"] = min(within)
        stats[f"{channel}_over_pixels"] = max(over)
        stats[f"{channel}_max"] = max(worst)
        stats[f"{channel}_over_cap_pixels"] = max(over_cap)
    return stats


def check_renders(stats: dict, rgb_flip_pixels: int = 0) -> None:
    """``rgb_flip_pixels``: the pixels of one image that may pass the cap on
    the worst rgb value (0 unless the two runs are on different devices)."""
    tol = SLICE_TOL
    for channel in ("alpha", "rgb"):
        _require(stats[f"{channel}_within_frac"] >= tol["frac"], stats)
        _require(stats[f"{channel}_over_pixels"] <= tol["over_pixels"], stats)
    _require(stats["alpha_max"] <= tol["alpha_max"], stats)
    _require(stats["rgb_over_cap_pixels"] <= rgb_flip_pixels, stats)


def check_train_renders(stats: dict) -> None:
    """The renders of one train step on two devices.  Alpha as in
    :func:`check_renders`.  The rgb rule is wider: in train mode the texture
    encoder normalises with the statistics of the step's own small batch,
    which amplifies a float32 difference in the predicted flow, and the
    texture is the photo resampled at that flow (seen card vs CPU at
    b4/128^2: 182 of 16,384 pixels of one image beyond 1e-3, the worst
    6.7e-3; alpha 2.2e-4 everywhere)."""
    tol = SLICE_TOL
    _require(stats["alpha_within_frac"] >= tol["frac"], stats)
    _require(stats["alpha_over_pixels"] <= tol["over_pixels"], stats)
    _require(stats["alpha_max"] <= tol["alpha_max"], stats)
    _require(stats["rgb_within_frac"] >= TRAIN_RGB_FRAC, stats)
    _require(stats["rgb_max"] <= tol["rgb_max"], stats)


def slice_stats(ref_renders, renders, ref_att, att) -> dict:
    """Compare two runs of the slice: the attribute dicts and the renders
    (:func:`render_stats`)."""
    stats = {}
    for key in SLICE_ATTRS:
        d = _np(att[key]) - _np(ref_att[key])
        if key == "azimuths":
            d = (d + 180.0) % 360.0 - 180.0
        stats[f"{key}_max"] = float(np.abs(d).max())
        if key == "textures":
            stats["textures_within_frac"] = float((np.abs(d) <= SLICE_TOL["attr"]).mean())
    stats.update(render_stats(ref_renders, renders))
    return stats


def check_slice(stats: dict, rgb_flip_pixels: int = 0) -> None:
    tol = SLICE_TOL
    for key in SLICE_ATTRS:
        if key == "textures":
            _require(stats["textures_within_frac"] >= tol["frac"], stats)
            _require(stats["textures_max"] <= tol["textures_max"], stats)
            continue
        limit = tol["angle_deg"] if key in ("azimuths", "elevations") else tol["attr"]
        _require(stats[f"{key}_max"] <= limit, (key, stats))
    check_renders(stats, rgb_flip_pixels)
