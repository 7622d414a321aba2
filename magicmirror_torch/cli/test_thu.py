"""THuman2 evaluation (reference test_THU.py), the port of
``magicmirror/cli/test_thu.py``, on the card: the rendered normal map of
each test render against its ground truth, the MSE under the photo's mask
(``eval/metrics.normal_mse``), averaged over the batches into
``result.txt``.

    python -m magicmirror_torch.cli.test_thu --name <model> --dataroot THUMAN_ROOT
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..data import DataLoader, THuman2Dataset
from ..eval.metrics import normal_mse
from ..eval.reports import ResultLog
from ..serve import _no_tf32
from .test import clock, eval_options, images, load_reconstructor, report_seconds


def main(argv=None, device="cuda"):
    """-> {"mse", "batches", "images", "seconds"}."""
    device = resolve_device(device)
    opt = eval_options(argv)
    dataset = THuman2Dataset(opt.dataroot, opt.imageSize, train=False, ratio=opt.ratio,
                             bg=opt.bg)
    loader = DataLoader(dataset, opt.batchSize, shuffle=False, num_workers=opt.workers)
    rec = load_reconstructor(opt, device)
    mses, n_images, seconds = [], 0, {}
    t0 = clock(device)
    for data in loader:
        if "normal" not in data:
            continue
        Xa = images(data, device)
        with _no_tf32(), torch.inference_mode():
            _, att = rec.diff_render.render(**rec.encode(Xa))
            gt = torch.as_tensor(data["normal"], device=device) * 2.0 - 1.0  # [0, 1] -> [-1, 1]
            mses.append(float(normal_mse(att["imnormal"], gt, Xa[..., 3])))
        n_images += len(data["path"])
    seconds["encode_render"] = clock(device) - t0
    mse = float(np.mean(mses)) if mses else float("nan")
    print("Normal-map MSE: %.4f" % mse)
    ResultLog(os.path.join(opt.outf, "result.txt")).write("THuman normal MSE: %.4f" % mse)
    report_seconds("test_thu", seconds, n_images)
    return {"mse": mse, "batches": len(mses), "images": n_images, "seconds": seconds}


if __name__ == "__main__":
    main()
