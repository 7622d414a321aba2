"""Every kernel of the port on the device alone, warm and cold, beside its
bound: one JSON line a kernel and shape.

    python3 -m magicmirror_torch.benchmarks.kernel_times [--tree DIR]

``--tree`` is the root of the checkout whose ``magicmirror_torch`` is timed
(default: this one); its kernels are built into that checkout's own
``build/``.  Of that checkout only long-standing interfaces are used: the
wrappers of ``ops/rasterize.py`` and ``ops/sampling.py``, ``face_rows``,
``face_cull``, ``face_verts``, ``DiffRender`` and ``bench_attributes``; the
timing loops and the bounds are this file's and ``timing.py``'s.  So a checkout of another commit (``git
archive`` into an ignored directory) and this one can be timed on one card
in one call, in the order a, b, b, a.

The kernels, b32 (the ids of PERF.md's kernel table): on ``sphere.obj`` under
bench.py's attributes at 128^2 and 256^2, K1 (``raster_fwd``, 'line', fused),
K7a (its plain mode), K2 (``raster_bwd``, the cotangent of a random soft
cotangent), K9a and K8 ('exact', fused and plain), K3 and K4 (the masked
sampler, forward and backward), K9b forward and backward (unmasked; the
cotangent zero where nothing is covered, as the 'exact' render hands it
back); on ``smpl_uv.obj`` at the Market shape 128x64 (ratio 2, ellipsoid 2),
K5 and K6, the cameras at U(2, 6) (the recipe's range) and at 6.5 (the far
tail).  Each line holds ``warm_ms`` and ``cold_ms`` (``timing.device_ms``:
CUDA-graph replays of 100 launches, the inputs kept in the L2 or copies of
them past it), ``burst_ms`` (100 launches from Python), the bound for these
inputs (``raster_work``, ``texture_parts.texture_bytes``) and, where one
PyTorch call computes the same function, its warm and cold times (K3:
``F.grid_sample`` times the mask; K9b forward: ``F.grid_sample``).  A
wrapper's time includes what the wrapper launches besides its kernel: the
backward's zeroed output (``torch.zeros``), 2 MB at 128^2 on the sphere, 23
MB on the dense template.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import types
from pathlib import Path

import torch

from ..ops.face_rows import SOFT_MARGIN
from . import texture_parts
from .timing import bound_ms, burst_ms, card, clone_inputs, cold_copies, device_ms

ROOT = Path(__file__).resolve().parents[2]
SIGMAINV = 7000.0
BATCH = 32
SIZES = (128, 256)  # the sphere's square renders
# float operations per unit of data-dependent work, counted from the kernels'
# sources: per (pixel, surviving face) pair for the rasterizer, per covered
# pixel for the texture sampler
FLOPS_PER_UNIT = {"raster_fwd": 34, "raster_bwd": 46, "texture_fwd": 42, "texture_bwd": 78,
                  # 'exact': the winner test (23) and three segment distances (20 each)
                  "raster_exact": 90}


def live_pairs(rows, height, width, g=None, per_tile=False):
    """The (pixel, face) pairs the rasterizer kernels visit for these face
    rows: per 16x16 tile the faces that survive the kernels' culling rule
    (front-facing, bbox +- the soft margin meets the tile), times 256 pixels.
    With ``g`` (B, H, W), only the tiles where g is not all zero count: the
    backward kernel leaves the others at once.  ``per_tile``: the faces live
    per tile, (B, TY, TX), instead of the total."""
    dev = rows.device
    nz, xmin, xmax = rows[..., 25], rows[..., 12], rows[..., 13]
    ymin, ymax = rows[..., 14], rows[..., 15]
    c0 = torch.arange(0, width, 16, device=dev, dtype=torch.float32)
    r0 = torch.arange(0, height, 16, device=dev, dtype=torch.float32)
    x_lo = -1.0 + 2.0 * c0 / width - SOFT_MARGIN
    x_hi = -1.0 + 2.0 * (c0 + 16).clamp(max=width) / width + SOFT_MARGIN
    y_hi = 1.0 - 2.0 * r0 / height + SOFT_MARGIN
    y_lo = 1.0 - 2.0 * (r0 + 16).clamp(max=height) / height - SOFT_MARGIN
    in_x = (xmax[:, None, :] >= x_lo[None, :, None]) & (xmin[:, None, :] <= x_hi[None, :, None])
    in_y = (ymax[:, None, :] >= y_lo[None, :, None]) & (ymin[:, None, :] <= y_hi[None, :, None])
    front = (nz > 0)[:, None, :]
    # faces live per tile, (B, TY, TX): the product of the two overlaps
    counts = torch.einsum("byf,bxf->byx", (in_y & front).float(), in_x.float())
    if g is not None:  # padded to whole tiles
        B, TY, TX = counts.shape
        padded = torch.zeros((B, TY * 16, TX * 16), device=dev)
        padded[:, :height, :width] = g.abs()
        counts = counts * (padded.reshape(B, TY, 16, TX, 16).amax(dim=(2, 4)) > 0)
    if per_tile:
        return counts
    return int(counts.sum().item()) * 256


def raster_work(rows, height, width, g=None):
    """(bytes a rasterizer launch must move, its (pixel, face) pairs): the
    face tables read once; 32 B a pixel written by the fused forward, or g read and
    13 moments a face written by the backward (``g`` given)."""
    B, F1 = rows.shape[0], rows.shape[1]
    P = B * height * width
    tables = (rows.numel() + B * F1 * 4) * 4  # the rows and their cull table
    if g is None:
        return tables + P * 32, live_pairs(rows, height, width)
    return (tables + P * 4 + B * (F1 - 1) * 13 * 4,
            live_pairs(rows, height, width, g.reshape(B, height, width)))


def work_bound(kind: str, nbytes: int, units: int) -> tuple[float, str]:
    """:func:`timing.bound_ms` of ``units`` of work at ``FLOPS_PER_UNIT[kind]``."""
    return bound_ms(nbytes, units * FLOPS_PER_UNIT[kind])


def load_port(tree=None) -> types.SimpleNamespace:
    """The port's modules from the checkout at ``tree`` (default: this one).
    Another checkout's package replaces this one's in ``sys.modules``; what
    this file imported before stays bound."""
    root = Path(tree).resolve() if tree else ROOT
    if root != ROOT:
        for name in [n for n in sys.modules
                     if n == "magicmirror_torch" or n.startswith("magicmirror_torch.")]:
            del sys.modules[name]
        sys.path.insert(0, str(root))
    mod = {name: importlib.import_module(f"magicmirror_torch.{name}")
           for name in ("kernels", "ops.face_rows", "ops.rasterize", "ops.sampling",
                        "render.renderer", "render.synthetic")}
    return types.SimpleNamespace(root=root, kernels=mod["kernels"], rows=mod["ops.face_rows"],
                                 raster=mod["ops.rasterize"], sampling=mod["ops.sampling"],
                                 DiffRender=mod["render.renderer"].DiffRender,
                                 synthetic=mod["render.synthetic"])


def _nbytes(inputs) -> int:
    return sum(x.numel() * x.element_size() for x in inputs if torch.is_tensor(x))


def sphere_case(port, size: int, seed: int = 7) -> dict:
    """The inputs of the sphere's kernels at b32 / ``size``^2: bench.py's
    attributes projected, the face tables, the forward's outputs, a random
    soft cotangent carried to sumlog, and texture cotangents."""
    dev = torch.device("cuda")
    dr = port.DiffRender(str(port.root / "template" / "sphere.obj"), size, device=dev)
    att = port.synthetic.to_torch(port.synthetic.bench_attributes(
        dr.vertices_init.cpu().numpy(), BATCH, size, seed), dev)
    fvc, fvi, fn = dr.project(att)
    args = (fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn)
    rows = port.rows.face_rows(*args).contiguous()
    cull = port.rows.face_cull(rows)
    verts = port.rows.face_verts(fvi).contiguous()
    _, soft, uv, _, hard = port.raster.raster_fwd(rows, SIGMAINV, size, size, cull=cull)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g_soft = torch.randn(soft.shape, device=dev, generator=gen)
    g_tex = torch.randn((BATCH, size, size, 3), device=dev, generator=gen)
    return {"args": args, "rows": rows, "cull": cull, "verts": verts, "uv": uv, "hard": hard,
            "soft": soft, "textures": att["textures"].contiguous(),
            "g_sumlog": (g_soft * (soft - 1.0)).reshape(BATCH, -1).contiguous(),
            "g_tex": g_tex, "g_covered": (g_tex * hard[..., None]).contiguous()}


def dense_case(port, height: int, width: int, distances, seed: int) -> dict:
    """The dense template (``smpl_uv.obj``, 13,776 faces) at b32 and the
    Market shape, bench.py's attributes with the distance U(2, 4) mapped
    onto ``distances``: the face tables and a random soft cotangent."""
    dev = torch.device("cuda")
    dr = port.DiffRender(str(port.root / "template" / "smpl_uv.obj"), width,
                         ratio=height / width, init_ellipsoid=2.0, device=dev)
    att = port.synthetic.bench_attributes(dr.vertices_init.cpu().numpy(), BATCH, width, seed,
                                          height=height)
    lo, hi = distances
    att["distances"] = (lo + (hi - lo) * (att["distances"] - 2.0) / 2.0).astype("float32")
    fvc, fvi, fn = dr.project(port.synthetic.to_torch(att, dev))
    rows = port.rows.face_rows(fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn).contiguous()
    cull = port.rows.face_cull(rows)
    soft = port.raster.raster_fwd(rows, SIGMAINV, height, width, cull=cull)[1]
    g_soft = torch.randn(soft.shape, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(seed + 1))
    return {"rows": rows, "cull": cull,
            "g_sumlog": (g_soft * (soft - 1.0)).reshape(BATCH, -1).contiguous()}


def time_kernel(port, kid, name, shape, fn, inputs, bound, library=None) -> dict:
    """One line: ``fn(*inputs)`` warm and cold on the device alone and as a
    burst, with ``bound`` = (ms, by) and ``library`` = (what, function of the
    same inputs) or None."""
    counters = port.kernels.LAUNCHES
    sets = clone_inputs(inputs, cold_copies(_nbytes(inputs)))
    rec = {"id": kid, "name": name, "shape": shape,
           **device_ms(fn, inputs, _nbytes(inputs), counters, sets),
           "burst_ms": burst_ms(lambda: fn(*inputs)), "bound_ms": bound[0],
           "bound_by": bound[1], "library": None}
    if library is not None:
        what, lib = library
        t = device_ms(lib, inputs, _nbytes(inputs), counters, sets)
        rec.update(library=what, library_warm_ms=t["warm_ms"], library_cold_ms=t["cold_ms"])
    return rec


def sphere_kernels(port, size: int) -> list:
    """K1, K7a, K2, K9a, K8, K3, K4 and K9b forward and backward at b32 /
    ``size``^2 on the sphere."""
    c, R, S = sphere_case(port, size), port.raster, port.sampling
    shape = f"b{BATCH}/{size}^2"
    P = BATCH * size * size
    fwd_bytes, pairs = raster_work(c["rows"], size, size)
    bwd_bytes, pairs_bwd = raster_work(c["rows"], size, size, c["g_sumlog"])
    verts_bytes = c["verts"].numel() * 4
    uv, hard, tex = c["uv"], c["hard"], c["textures"]
    covered = int((hard > 0.5).sum().item())
    tb = texture_parts.texture_bytes
    tables = (c["rows"], c["cull"])
    return [
        time_kernel(port, "K1", "raster_fwd", shape,
                    lambda r, k: R.raster_fwd(r, SIGMAINV, size, size, cull=k), tables,
                    work_bound("raster_fwd", fwd_bytes, pairs)),
        time_kernel(port, "K7a", "raster_fwd_plain_mode", shape,
                    lambda r, k: R.raster_fwd_plain(r, SIGMAINV, size, size, cull=k), tables,
                    work_bound("raster_fwd", fwd_bytes - P * 24, pairs)),
        time_kernel(port, "K2", "raster_bwd", shape,
                    lambda r, k, g: R.raster_bwd(r, g, SIGMAINV, size, size, k),
                    (*tables, c["g_sumlog"]), work_bound("raster_bwd", bwd_bytes, pairs_bwd)),
        time_kernel(port, "K9a", "raster_exact_fused", shape,
                    lambda r, k, v: R.raster_fwd(r, SIGMAINV, size, size, v, k),
                    (*tables, c["verts"]),
                    work_bound("raster_exact", fwd_bytes + verts_bytes, pairs)),
        time_kernel(port, "K8", "raster_exact", shape,
                    lambda r, k, v: R.raster_fwd_plain(r, SIGMAINV, size, size, v, k),
                    (*tables, c["verts"]),
                    work_bound("raster_exact", fwd_bytes - P * 24 + verts_bytes, pairs)),
        time_kernel(port, "K3", "texture_fwd", shape, S.texture_fwd, (uv, tex, hard),
                    work_bound("texture_fwd", tb(uv, hard, tex), covered),
                    ("F.grid_sample * mask",
                     lambda u, x, h: texture_parts.grid_sample_masked(u, h, x))),
        time_kernel(port, "K4", "texture_bwd", shape, S.texture_bwd,
                    (c["g_tex"], uv, tex, hard),
                    work_bound("texture_bwd", tb(uv, hard, tex, backward=True), covered)),
        time_kernel(port, "K9b", "texture_unmasked_fwd", shape, S.texture_fwd, (uv, tex),
                    work_bound("texture_fwd", tb(uv, None, tex), P),
                    ("F.grid_sample",
                     lambda u, x: texture_parts.grid_sample_masked(u, None, x))),
        time_kernel(port, "K9b", "texture_unmasked_bwd", shape, S.texture_bwd,
                    (c["g_covered"], uv, tex),
                    work_bound("texture_bwd", tb(uv, None, tex, backward=True), P)),
    ]


# the dense cases: the recipe's distance range and the far tail, with the
# seeds chip_smoke.py's dense phase draws them from
DENSE_CASES = (((2.0, 6.0), 188), ((6.5, 6.5), 193))


def dense_kernels(port, height: int = 128, width: int = 64) -> list:
    """K5 and K6 on the dense template at b32 and the Market shape."""
    out = []
    for distances, seed in DENSE_CASES:
        c, R = dense_case(port, height, width, distances, seed), port.raster
        shape = f"b{BATCH}/{height}x{width}/smpl_uv/dist{distances[0]:g}-{distances[1]:g}"
        fwd_bytes, pairs = raster_work(c["rows"], height, width)
        bwd_bytes, pairs_bwd = raster_work(c["rows"], height, width, c["g_sumlog"])
        tables = (c["rows"], c["cull"])
        out += [time_kernel(port, "K5", "raster_fwd_dense", shape,
                            lambda r, k: R.raster_fwd(r, SIGMAINV, height, width, cull=k),
                            tables, work_bound("raster_fwd", fwd_bytes, pairs)),
                time_kernel(port, "K6", "raster_bwd_dense", shape,
                            lambda r, k, g: R.raster_bwd(r, g, SIGMAINV, height, width, k),
                            (*tables, c["g_sumlog"]),
                            work_bound("raster_bwd", bwd_bytes, pairs_bwd))]
    return out


def measure(port) -> list:
    """Every line of this file's table for ``port`` (:func:`load_port`)."""
    out = []
    for size in SIZES:
        out += sphere_kernels(port, size)
    return out + dense_kernels(port)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=None, help="the checkout to time (default: this)")
    a = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_times needs a CUDA device; torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    port = load_port(a.tree)
    tree = os.fspath(port.root)
    print(json.dumps({"tree": tree, "card": card()}), flush=True)
    for rec in measure(port):
        print(json.dumps({"tree": tree, **rec}), flush=True)


if __name__ == "__main__":
    main()
