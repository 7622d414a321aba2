"""THuman2 rendered-scan dataset (reference datasets/thuman2.py:32-151), the
port of ``magicmirror/data/thuman2.py`` on uint8 arrays (``data/base.py``).

Layout: ``<root>/<scan>/depth_F/*.png`` (the last channel, alpha, is the
mask), the RGB render of the same name under ``render/``, the ground-truth
normals under ``normal_F/``.  A render at least 192 wide is cropped to its
columns 64..192 (the person's band of the square render); then the RGB and
the normals are resized bicubic to (imageSize, round(ratio * imageSize))
and the mask NEAREST, every nonzero pixel 255.  An item has ``normal`` (H,
W, 3) in [0, 1] where its normal map exists.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from ..eval.images import read_image, resize_bicubic
from .base import ImageDataset, binarize, crop, load_rgb, resize_nearest, to_rgba_array


class THuman2Dataset(ImageDataset):
    def __init__(self, root, image_size, train=True, aug=False, bg=False, ratio=2.0,
                 selected_index=()):
        self.root = root
        self.bg = bg
        self.image_size = image_size
        self.ratio = ratio
        self.im_list = sorted(glob.glob(os.path.join(root, "*", "depth_F", "*.png")))
        print("THuman2 images:", len(self.im_list))
        self.train = train
        self.aug = aug
        self.selected_index = list(selected_index)

    def __len__(self):
        return len(self.im_list)

    def __getitem__(self, index):
        if self.selected_index:
            index = self.selected_index[index]
        depth_path = self.im_list[index]
        img_path = depth_path.replace("depth_F", "render")
        normal_path = depth_path.replace("depth_F", "normal_F")

        depth = read_image(depth_path)
        mask = depth[..., -1] if depth.ndim == 3 else depth
        img = load_rgb(img_path)
        box = (64, 0, 192, img.shape[0]) if img.shape[1] >= 192 else None
        if box is not None:
            img, mask = crop(img, box), crop(mask, box)
        size = (self.image_size, round(self.ratio * self.image_size))
        img = resize_bicubic(img, size)
        mask = binarize(resize_nearest(mask, size), 0)
        out = {"images": to_rgba_array(img, mask, self.bg), "path": img_path, "label": 0}
        if os.path.isfile(normal_path):
            normal = load_rgb(normal_path)
            if box is not None:
                normal = crop(normal, box)
            out["normal"] = np.asarray(resize_bicubic(normal, size), np.float32) / 255.0
        return out
