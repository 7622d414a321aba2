"""Market-1501 re-ID dataset with HMR seg masks (reference
datasets/market.py), the port of ``magicmirror/data/market.py`` on uint8
arrays (``data/base.py``).

Layout: ``<root>/{train_all,query}/<id>/*_0.XX.png`` masks under
``seg_hmr``, with the RGB photos at the same place under the sibling
``pytorch`` tree (PNG).  Target shape (2W, W): ratio 2, no pad-to-square.
With ``hmr > 0`` (the chamfer to the HMR body mesh) each item's ``obj`` is
the vertices (N, 3) of ``bodymesh/.../<stem>.obj`` beside the mask (the
mask's path with ``seg_hmr`` -> ``bodymesh`` and ``_<ratio>.png`` ->
``.obj``), mirrored in x with the photo; without it float32 -1, as the JAX
dataset gives.
"""
from __future__ import annotations

import glob
import os
import random

import numpy as np

from ..eval.images import read_image, resize_bicubic
from ..geometry.obj_io import load_obj
from .base import (ImageDataset, binarize, crop, expand, filter_by_fg_ratio, load_rgb,
                   resize_nearest, to_rgba_array)


def _seg_loader(path):
    """The mask as grey, every nonzero pixel 255."""
    return binarize(read_image(path, "L"), 0)


class MarketDataset(ImageDataset):
    def __init__(self, root, image_size, train=True, aug=False,
                 threshold="0.09,0.64", bg=False, hmr=0.0, selected_index=(),
                 sub=""):
        self.root = root
        self.bg = bg
        self.hmr = hmr
        if sub:
            old_im_list = sorted(glob.glob(os.path.join(root, sub, "*/*.png")))
            self.class_dir = glob.glob(os.path.join(root, sub, "*"))
        elif train:
            old_im_list = glob.glob(os.path.join(root, "train_all", "*/*.png"))
            self.class_dir = glob.glob(os.path.join(root, "train_all", "*"))
        else:
            old_im_list = sorted(glob.glob(os.path.join(root, "query", "*/*.png")))
            self.class_dir = glob.glob(os.path.join(root, "query", "*"))
        self.im_list = filter_by_fg_ratio(old_im_list, threshold)
        if not train:
            self.im_list = old_im_list
        print(len(old_im_list), "After threshold:", len(self.im_list))
        self.imgs = [(p, self.class_dir.index(os.path.dirname(p)))
                     for p in self.im_list]
        self.train = train
        self.aug = aug
        self.image_size = image_size
        self.selected_index = list(selected_index)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, index):
        if self.selected_index:
            index = self.selected_index[index]
        seg_path, label = self.imgs[index]
        W = self.image_size
        size = (W, W * 2)
        img_path = seg_path.replace("seg_hmr", "pytorch")
        img_path = img_path[:-9] + ".png"
        img = load_rgb(img_path)
        seg = _seg_loader(seg_path)
        if self.hmr > 0.0:
            obj_path = seg_path.replace("seg_hmr", "bodymesh")[:-9] + ".obj"
            obj = load_obj(obj_path).vertices  # (6890, 3)
        else:
            obj = np.float32(-1)
        if self.train and self.aug:
            img = resize_bicubic(img, size)
            seg = binarize(resize_nearest(seg, size))
            img = expand(img, 10, 10, 10, 10)
            seg = expand(seg, 10, 10, 10, 10)
            left = random.randint(0, 20)
            upper = random.randint(0, 20)
            box = (left, upper, left + W, upper + W * 2)
            img, seg = crop(img, box), crop(seg, box)
            if random.uniform(0, 1) < 0.5:
                img, seg = img[:, ::-1], seg[:, ::-1]
                if self.hmr > 0.0:
                    obj = obj * np.float32([-1, 1, 1])
        img = resize_bicubic(img, size)
        seg = binarize(resize_nearest(seg, size))
        rgba = to_rgba_array(img, seg, self.bg)
        return {"images": rgba, "path": img_path, "label": label, "obj": obj}
