"""Ablation baseline: score the HMR segmentation masks themselves against the
ground-truth masks (reference ablation-study/test-hmr.py), the port of
``magicmirror/cli/ablation_hmr.py``: the no-learning baseline the paper
compares reconstruction SSIM / mask-IoU against.  No model: the Market test
split's masks (``MarketDataset(train=False)``) against the ground-truth
masks at the same place under ``--gt_sub``, SSIM and mask-IoU on ``device``.

    python -m magicmirror_torch.cli.ablation_hmr --dataroot ../Market/hq/seg_hmr \
        --gt_sub gt_mask --imageSize 64

Pillow reads and resizes the ground-truth masks, imported only there.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..configs.flags import build_parser
from ..data.market import MarketDataset
from ..eval.metrics import mask_iou_metric, ssim


def main(argv=None, device="cuda"):
    """-> {"ssim", "mask_iou", "samples"}: the means over the photos that
    have a ground-truth mask."""
    from PIL import Image

    device = resolve_device(device)
    parser = build_parser()
    parser.add_argument("--gt_sub", default="gt_mask",
                        help="sibling dir of ground-truth masks")
    opt = parser.parse_args(argv)

    dataset = MarketDataset(opt.dataroot, opt.imageSize, train=False, aug=False)
    ssims, ious = [], []
    for i in range(len(dataset)):
        sample = dataset[i]
        rgba = sample["images"]
        hmr_mask = rgba[..., 3]
        gt_path = sample["path"].replace("pytorch", opt.gt_sub)
        if not os.path.isfile(gt_path):
            continue
        gt = np.asarray(Image.open(gt_path).convert("L").resize(
            (hmr_mask.shape[1], hmr_mask.shape[0])), np.float32) / 255.0
        gt = (gt > 0.5).astype(np.float32)
        comp = rgba[..., :3] * gt[..., None] + (1 - gt[..., None])
        hmr_t, gt_t, rgb_t, comp_t = (torch.as_tensor(a, device=device)[None]
                                      for a in (hmr_mask, gt, rgba[..., :3], comp))
        ious.append(float(mask_iou_metric(hmr_t, gt_t)))
        ssims.append(float(ssim(rgb_t, comp_t)))
        if (i + 1) % 500 == 0:
            print(f"{i + 1} / {len(dataset)}")
    out = {"ssim": float(np.mean(ssims) if ssims else 0),
           "mask_iou": float(np.mean(ious) if ious else 0), "samples": len(ious)}
    print("HMR-mask baseline: SSIM %.3f  mask-IoU %.3f over %d samples"
          % (out["ssim"], out["mask_iou"], out["samples"]))
    return out


if __name__ == "__main__":
    main()
