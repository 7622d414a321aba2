"""Camera-prediction check (reference show_camera.py), the port of
``magicmirror/cli/show_camera.py``, on the card: the test split's predicted
cameras into ``camera_hist.png(.npz)``.

    python -m magicmirror_torch.cli.show_camera --name <model> [--dataroot DIR]

Each batch is encoded and rendered once: the camera is the encoder's, so this
gives the file the JAX CLI writes from its whole eval step.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import DataLoader
from ..eval.reports import save_histograms
from ..serve import _no_tf32
from .test import (camera_stats, clock, eval_options, images, load_reconstructor,
                   pick_dataset, report_seconds)


def main(argv=None, device="cuda"):
    """-> {"path": the histogram's path, "images", "seconds"}."""
    device = resolve_device(device)
    opt = eval_options(argv)
    loader = DataLoader(pick_dataset(opt), opt.batchSize, shuffle=False,
                        num_workers=opt.workers)
    rec = load_reconstructor(opt, device)
    stats, n_images, seconds = {}, 0, {}
    t0 = clock(device)
    for data in loader:
        with _no_tf32(), torch.inference_mode():
            _, Ae = rec.diff_render.render(**rec.encode(images(data, device)))
        for k, v in camera_stats(Ae).items():
            stats.setdefault(k, []).append(v)
        n_images += len(data["path"])
    seconds["encode_render"] = clock(device) - t0
    t0 = time.perf_counter()
    path = os.path.join(opt.outf, "camera_hist.png")
    save_histograms({k: np.concatenate(v) for k, v in stats.items()}, path)
    seconds["file_writes"] = time.perf_counter() - t0
    print("camera histogram written to", path)
    report_seconds("show_camera", seconds, n_images)
    return {"path": path, "images": n_images, "seconds": seconds}


if __name__ == "__main__":
    main()
