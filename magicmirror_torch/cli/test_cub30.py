"""CUB multi-view FID (reference test_CUB30.py), the port of
``magicmirror/cli/test_cub30.py``, on the card: the test photos rendered at
12 azimuth bins (-180 to 150 degrees, every 30) into ``fid30/azi<bin>``, the
photos into ``fid30/ori``, and the FID of each bin against them; their mean
goes to ``result.txt``.

    python -m magicmirror_torch.cli.test_cub30 --name <model> [--dataroot DIR]

The photos' Inception statistics are taken once for the 12 FIDs, whose
matrix square roots run at once in processes of their own.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import CUBDataset, DataLoader
from ..eval.fid import fids_against
from ..eval.images import save_images_parallel
from ..eval.reports import ResultLog
from ..render.renderer import deep_copy
from ..serve import _no_tf32
from .test import clock, eval_options, images, load_reconstructor, report_seconds

BINS = list(range(-180, 180, 30))


def main(argv=None, device="cuda"):
    """-> {"fid": [one a bin], "mean_fid", "images", "seconds"}."""
    device = resolve_device(device)
    opt = eval_options(argv)
    dataset = CUBDataset(opt.dataroot, opt.imageSize, train=False, aug=False, bg=opt.bg)
    loader = DataLoader(dataset, opt.batchSize, shuffle=False, num_workers=opt.workers)
    rec = load_reconstructor(opt, device)
    ori_dir = os.path.join(opt.outf, "fid30", "ori")
    bin_dirs = [os.path.join(opt.outf, "fid30", "azi%+04d" % azi) for azi in BINS]
    for d in (ori_dir, *bin_dirs):
        os.makedirs(d, exist_ok=True)

    to_save, n_images, seconds = [], 0, {}
    t0 = clock(device)
    for data in loader:
        Xa = images(data, device)
        att = deep_copy(rec.encode(Xa), detach=True)
        names = [os.path.basename(p) for p in data["path"]]
        photos = Xa[..., :3].cpu().numpy()
        to_save += [(photos[b], os.path.join(ori_dir, n)) for b, n in enumerate(names)]
        for azi, d in zip(BINS, bin_dirs):
            att["azimuths"] = torch.full((Xa.shape[0],), -float(azi), device=device)
            with _no_tf32(), torch.inference_mode():
                rgb = rec.diff_render.render(**att)[0][..., :3].cpu().numpy()
            to_save += [(rgb[b], os.path.join(d, n)) for b, n in enumerate(names)]
        n_images += len(names)
    seconds["encode_render"] = clock(device) - t0
    t0 = time.perf_counter()
    save_images_parallel(to_save, workers=4)
    seconds["file_writes"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fids = fids_against(ori_dir, bin_dirs, 64, device=device)
    seconds["fid"] = time.perf_counter() - t0
    for azi, fid in zip(BINS, fids):
        print("azi %+04d fid: %0.2f" % (azi, fid))
    mean_fid = float(np.mean(fids))
    print("Mean FID over 12 azimuth bins: %0.2f" % mean_fid)
    ResultLog(os.path.join(opt.outf, "result.txt")).write("CUB30 mean FID: %0.2f" % mean_fid)
    report_seconds("test_cub30", seconds, n_images)
    return {"fid": fids, "mean_fid": mean_fid, "images": n_images, "seconds": seconds}


if __name__ == "__main__":
    main()
