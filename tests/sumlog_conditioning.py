"""How far the rasterizer's plain mode (``raster_fwd_plain``) puts sumlog
from the plain path (``rasterize_phase1``) on covered pixels, by how well
conditioned the pixel's terms are (not a test: run it by hand on the card).

    python3 tests/sumlog_conditioning.py [--tree DIR]

``--tree`` is the checkout whose kernel is measured (its ``build/`` holds the
build), as ``magicmirror_torch.benchmarks.kernel_times`` takes it.  Inputs:
``sphere.obj`` under bench.py's attributes with every camera at one
distance, the shapes of chip_smoke.py's and tests/test_torch_kernels.py's
sumlog checks.  For each threshold t, the covered pixels where every face's
term has p <= t or covers the pixel (d = 0: p = 1 - 1e-7 exactly), their
number and the largest |sumlog - sumlog_plain| among them; one JSON line a
shape.  ``parity.sumlog_stats`` holds the pixels of t = 0.5 to the plain
path, and the other covered pixels to a float64 witness.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from magicmirror_torch.benchmarks import kernel_times  # noqa: E402

THRESHOLDS = (0.99, 0.9, 0.5, 0.3)
CASES = ((128, 32, 3.0, 32), (128, 2, 3.0, 5), (64, 2, 6.0, 5))  # size, batch, distance, seed


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=None)
    port = kernel_times.load_port(parser.parse_args().tree)
    from magicmirror_torch.ops.rasterize import (_chunk_faces, _face_pixel_terms, pixel_grid,
                                                 rasterize_phase1)
    dev = torch.device("cuda")
    cover = float(np.log1p(-(1.0 - 1e-7)))  # a covering face's term, in float64
    for size, batch, distance, seed in CASES:
        dr = port.DiffRender(str(port.root / "template" / "sphere.obj"), size, device=dev)
        att = port.synthetic.bench_attributes(dr.vertices_init.cpu().numpy(), batch, size, seed)
        att["distances"][:] = distance
        fvc, fvi, fn = dr.project(port.synthetic.to_torch(att, dev))
        args = (fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn)
        _, sumlog = port.raster.raster_fwd_plain(port.rows.face_rows(*args).contiguous(),
                                                 7000.0, size, size)
        px, py = pixel_grid(size, size, dev)
        idx_p, sumlog_p = rasterize_phase1(px, py, fvi, args[1], args[2], 7000.0)
        x = [t.double() for t in (px, py, fvi, args[1], args[2])]
        least = torch.zeros(sumlog.shape, dtype=torch.float64, device=dev)  # min log(1 - p)
        chunk = _chunk_faces(*sumlog.shape)
        for base in range(0, fvi.shape[1], chunk):
            sl = slice(base, base + chunk)
            _, log1mp = _face_pixel_terms(x[0], x[1], x[2][:, sl], x[3][:, sl], x[4][:, sl],
                                          7000.0)
            log1mp = torch.where((log1mp - cover).abs() < 1e-6, 0.0, log1mp)
            least = torch.minimum(least, log1mp.min(-1).values)
        err = (sumlog.double() - sumlog_p.double()).abs()
        covered = idx_p >= 0
        line = {"tree": os.fspath(port.root), "card": kernel_times.card(),
                "shape": f"b{batch}/{size}^2", "distance": distance,
                "covered": int(covered.sum())}
        for t in THRESHOLDS:
            held = covered & (least >= np.log(1.0 - t))
            line[f"p_le_{t}"] = {"held": int(held.sum()),
                                 "max_abs": float(err[held].max()) if held.any() else 0.0}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
