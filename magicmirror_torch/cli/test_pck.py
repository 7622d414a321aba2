"""Keypoint-transfer PCK (the reference's PCK/ harness), the port of
``magicmirror/cli/test_pck.py``, on the card: consecutive test photos are
paired, the source's keypoints moved to the target through the predicted
cameras and the pair's mean shape (``eval/pck.py::transfer_via_camera``),
and PCK at 0.1 and 0.15 written to ``result.txt``.

    python -m magicmirror_torch.cli.test_pck --name <model> \
        --cub_root ./data/CUB_200_2011 [--max_pairs 500]

The keypoints are CUB_200_2011's ``parts/part_locs.txt`` (``<image id> <part
id> <x> <y> <visible>``, 15 parts an image) with ``images.txt``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..configs.flags import build_parser
from ..data import CUBDataset
from ..eval.pck import pck_aggregate, pck_errors, transfer_via_camera
from ..eval.reports import ResultLog
from .test import KEEP, clock, eval_options, load_reconstructor, report_seconds

CAMERA = ("azimuths", "elevations", "distances", "biases")


def load_cub_keypoints(cub_root):
    """-> {image stem: (15, 3) x, y, visible}."""
    kp = np.loadtxt(os.path.join(cub_root, "parts", "part_locs.txt"))
    kp = kp[:, 2:5].reshape(-1, 15, 3)
    paths = np.loadtxt(os.path.join(cub_root, "images.txt"), dtype=str)[:, 1]
    return {os.path.basename(p).replace(".jpg", ""): k for p, k in zip(paths, kp)}


def normalize_keypoints(k, vis):
    """Annotation pixels -> [-1, 1] over the bounding box of the keypoints
    visible in both photos, y flipped into the model's frame (+y up)."""
    xy = k[:, :2].copy()
    span = xy[vis].max(0) - xy[vis].min(0) + 1e-6
    center = (xy[vis].max(0) + xy[vis].min(0)) / 2
    out = (xy - center) / (span / 2 + 1e-6)
    out[:, 1] = -out[:, 1]
    return out


def main(argv=None, device="cuda"):
    """-> {"pck": {alpha: value}, "pairs", "seconds"}."""
    device = resolve_device(device)
    parser = build_parser()
    parser.add_argument("--cub_root", default="./data/CUB_200_2011")
    parser.add_argument("--max_pairs", type=int, default=500)
    opt = eval_options(argv, parser, keep=KEEP + ("cub_root", "max_pairs"))
    kps = load_cub_keypoints(opt.cub_root)
    dataset = CUBDataset(opt.dataroot, opt.imageSize, train=False, aug=False)
    rec = load_reconstructor(opt, device)
    cam_proj = rec.diff_render.cam_proj.cpu()

    all_errs, all_vis, seconds = [], [], {}
    n = min(len(dataset) // 2, opt.max_pairs) * 2
    t0 = clock(device)
    for i in range(0, n, 2):
        a, b = dataset[i], dataset[i + 1]
        stem_a, stem_b = (os.path.splitext(os.path.basename(x["path"]))[0] for x in (a, b))
        if stem_a not in kps or stem_b not in kps:
            continue
        ka, kb = kps[stem_a], kps[stem_b]
        vis = (ka[:, 2] > 0) & (kb[:, 2] > 0)
        if vis.sum() == 0:
            continue
        att = rec.encode(torch.as_tensor(np.stack([a["images"], b["images"]]), device=device))
        verts = att["vertices"].mean(0).cpu().numpy()  # the pair's mean shape
        cam_a, cam_b = (tuple(att[k][j:j + 1].cpu().numpy() for k in CAMERA) for j in (0, 1))
        pred = transfer_via_camera(normalize_keypoints(ka, vis), verts, cam_a, cam_b, cam_proj,
                                   mask_tgt=b["images"][..., 3])
        all_errs.append(pck_errors(pred, normalize_keypoints(kb, vis)))
        all_vis.append(vis.astype(np.float64))
    seconds["encode_transfer"] = clock(device) - t0

    result = ResultLog(os.path.join(opt.outf, "result.txt"))
    scores = (pck_aggregate(np.stack(all_errs), np.stack(all_vis)) if all_errs
              else {0.1: float("nan"), 0.15: float("nan")})
    for alpha, v in scores.items():
        print(f"PCK@{alpha}: {v:.4f} over {len(all_errs)} pairs")
        result.write(f"PCK@{alpha}: {v:.4f}")
    report_seconds("test_pck", seconds, 2 * len(all_errs))
    return {"pck": scores, "pairs": len(all_errs), "seconds": seconds}


if __name__ == "__main__":
    main()
