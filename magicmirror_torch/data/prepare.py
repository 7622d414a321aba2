"""Offline data preparation (reference prepare_cub.py, prepare_market.py,
prepare_ATR.py, preproces_cub.py, prepare_cub_edge.py), the port of
``magicmirror/data/prepare.py``: fg-ratio computation + mask renaming
``*_%.2f.png``, ATR mask hole-filling, CUB bbox cropping, edge-map
extraction.  Host only: numpy, and Pillow imported inside the functions
that read and write images.

    python -c "from magicmirror_torch.data.prepare import prepare_masks; \
               prepare_masks('./data/CUB_Data', '*/*/*.png')"
"""
from __future__ import annotations

import glob
import os

import numpy as np


def fg_ratio(mask: np.ndarray) -> float:
    """Foreground fraction of a binary {0,1} mask."""
    return float(mask.sum()) / mask.size


def _meanpool3(x: np.ndarray) -> np.ndarray:
    """3x3 stride-1 mean filter with zero padding (torch AvgPool2d(3,1,1))."""
    p = np.pad(x, 1)
    out = np.zeros_like(x, dtype=np.float64)
    for dy in range(3):
        for dx in range(3):
            out += p[dy:dy + x.shape[0], dx:dx + x.shape[1]]
    return out / 9.0


def fill_holes(mask: np.ndarray, iters: int = 5) -> np.ndarray:
    """ATR mask hole-filling (reference prepare_ATR.py:27-31): 5 rounds of
    seg += meanpool3(seg); threshold at 4/9."""
    seg = mask.astype(np.float64)
    for _ in range(iters):
        seg = seg + _meanpool3(seg)
        seg = (seg > 4.0 / 9.0).astype(np.float64)
    return seg


def prepare_masks(download_path: str, pattern: str = "*/*/*.png",
                  rename: bool = True, hole_fill: bool = False,
                  out_replace: tuple[str, str] | None = None):
    """Compute per-mask fg ratios and rename/save ``*_%.2f.png``
    (reference prepare_cub.py:8-19, prepare_market.py, prepare_ATR.py)."""
    from PIL import Image

    seg_list = glob.glob(os.path.join(download_path, pattern))
    percentages = []
    for img_path in seg_list:
        seg = Image.open(img_path).convert("L")
        mask = (np.asarray(seg) > 0).astype(np.float64)
        if hole_fill:
            mask = fill_holes(mask)
        percentage = fg_ratio(mask)
        new_name = img_path.replace(".png", "_%.2f.png" % percentage)
        if out_replace:
            new_name = new_name.replace(*out_replace)
            os.makedirs(os.path.dirname(new_name), exist_ok=True)
        print(img_path, new_name)
        if hole_fill:
            Image.fromarray((mask * 255).astype(np.uint8)).save(new_name)
            if rename and new_name != img_path and not out_replace:
                os.remove(img_path)
        elif rename:
            os.rename(img_path, new_name)
        percentages.append(percentage)
    if percentages:
        print(sum(percentages) / len(percentages))
    return percentages


def preprocess_cub(root_dir: str = "./data/CUB_200_2011",
                   dst_dir: str = "./data/CUB_Data"):
    """Crop CUB images+segs by 1.1x-padded bbox into train/test trees
    (reference preproces_cub.py:21-46)."""
    from PIL import Image

    image_paths = np.loadtxt(os.path.join(root_dir, "images.txt"), dtype=str)
    split = np.loadtxt(os.path.join(root_dir, "train_test_split.txt"), dtype=int)
    bboxes = np.loadtxt(os.path.join(root_dir, "bounding_boxes.txt"), dtype=float)
    for i in range(image_paths.shape[0]):
        rel = image_paths[i, 1]
        phase = "train" if split[i, 1] else "test"
        dst_path = os.path.join(dst_dir, phase, rel)
        os.makedirs(os.path.dirname(dst_path), exist_ok=True)
        img = Image.open(os.path.join(root_dir, "images", rel)).convert("RGB")
        seg = Image.open(os.path.join(
            root_dir, "segmentations", rel.replace(".jpg", ".png"))).convert("L")
        width, height = img.size
        x, y, w, h = bboxes[i, 1:]
        x1 = int(min(max(x - w * 0.1, 0), width))
        y1 = int(min(max(y - h * 0.1, 0), height))
        x2 = int(min(max(x + w * 1.1, 0), width))
        y2 = int(min(max(y + h * 1.1, 0), height))
        img.crop((x1, y1, x2, y2)).save(dst_path, quality=100)
        seg.crop((x1, y1, x2, y2)).save(dst_path.replace(".jpg", ".png"))


def prepare_cub_edges(download_path: str = "./data/CUB_Data"):
    """Edge/coarse-edge maps from train masks (reference prepare_cub_edge.py)."""
    from PIL import Image, ImageFilter

    for img_path in glob.glob(os.path.join(download_path, "train", "*/*.png")):
        seg = Image.open(img_path).convert("RGB")
        seg = seg.point(lambda p: 255 if p > 160 else 0)
        seg.save(img_path.replace(".png", "_smooth.png"))
        edge = seg.filter(ImageFilter.FIND_EDGES)
        edge = edge.filter(ImageFilter.SMOOTH_MORE)
        edge = edge.point(lambda p: 255 if p > 20 else 0)
        edge.save(img_path.replace(".png", "_edge.png"))
        w, h = seg.size
        coarse = (np.asarray(seg, np.int16)
                  - np.asarray(seg.resize((w // 8, h // 8)).resize((w, h)),
                               np.int16))
        Image.fromarray(np.abs(coarse).astype(np.uint8)).save(
            img_path.replace(".png", "_coarse_edge.png"))

