"""ATR human-parsing dataset, 1:1 aspect (reference datasets/atr.py:29-131),
the port of ``magicmirror/data/atr.py`` on uint8 arrays (``data/base.py``).

The fixed split lists ``ATR_{train,test}.txt`` (16,000 / 1,706 mask names,
the port's copy of the JAX package's, under ``splits/``) are read from
``_LIST_DIR`` before ``root``: a tree that brings its own lists is read
through them only when ``_LIST_DIR`` points at it.  Masks under ``.../Seg/``,
the RGB under ``.../JPEGImages/``; the pad-to-square pipeline of CUB.
"""
from __future__ import annotations

import os

from ..eval.images import resize_bicubic
from .base import (ImageDataset, binarize, cub_style_aug, filter_by_fg_ratio, load_rgb,
                   load_seg, pad_to_square, resize_nearest, to_rgba_array)

_LIST_DIR = os.path.join(os.path.dirname(__file__), "splits")


def read_split(root: str, train: bool, list_dir: str | None = None):
    """Read the fixed ATR split list; paths are joined onto ``root``."""
    name = "ATR_train.txt" if train else "ATR_test.txt"
    for d in ([list_dir] if list_dir else []) + [_LIST_DIR, root, "datasets"]:
        path = os.path.join(d, name)
        if os.path.isfile(path):
            with open(path) as fp:
                return [line.strip() for line in fp if line.strip()]
    raise FileNotFoundError(f"split list {name} not found near {root}")


def split_paths(root: str, train: bool):
    """The split's mask paths under ``root``."""
    return [p if os.path.isabs(p) else os.path.join(root, p) for p in read_split(root, train)]


def image_path(seg_path: str) -> str:
    """The RGB photo of a mask: ``Seg`` -> ``JPEGImages``, the ``_0.XX``
    fg-ratio suffix stripped, ``.jpg``."""
    return seg_path.replace("Seg", "JPEGImages")[:-9] + ".jpg"


class ATRDataset(ImageDataset):
    def __init__(self, root, image_size, train=True, aug=False,
                 threshold="0.09,0.64", bg=False, selected_index=()):
        self.root = root
        self.bg = bg
        old_im_list = split_paths(root, train)
        self.im_list = filter_by_fg_ratio(old_im_list, threshold)
        if not train:
            self.im_list = old_im_list
        print(len(old_im_list), "After threshold:", len(self.im_list))
        self.imgs = [(p, -1) for p in self.im_list]  # no class label
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
        img_path = image_path(seg_path)
        img = load_rgb(img_path)
        seg = load_seg(seg_path)
        if self.train and self.aug:
            img, seg = cub_style_aug(img, seg)
        img, seg = pad_to_square(img, seg)
        size = (self.image_size, self.image_size)
        img = resize_bicubic(img, size)
        seg = binarize(resize_nearest(seg, size))
        rgba = to_rgba_array(img, seg, self.bg)
        return {"images": rgba, "path": img_path, "label": label}
