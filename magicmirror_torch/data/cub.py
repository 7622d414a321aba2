"""CUB bird dataset (reference datasets/bird.py:30-139), the port of
``magicmirror/data/cub.py`` on uint8 arrays (``data/base.py``).

Directory layout: ``<root>/{train,test}/<class>/*.png`` masks named
``<stem>_0.XX.png`` (fg-ratio suffix, written by prepare_cub) with the RGB at
``<stem>.jpg``; len = 2x images (reference bird.py:139).
"""
from __future__ import annotations

import glob
import os

from ..eval.images import resize_bicubic
from .base import (
    ImageDataset,
    binarize,
    cub_style_aug,
    filter_by_fg_ratio,
    load_rgb,
    load_seg,
    pad_to_square,
    resize_nearest,
    to_rgba_array,
)


class CUBDataset(ImageDataset):
    def __init__(self, root, image_size, train=True, aug=False,
                 threshold="0.09,0.64", bg=False, selected_index=()):
        self.root = root
        self.bg = bg
        split = "train" if train else "test"
        pattern = os.path.join(root, split, "*/*.png")
        old_im_list = glob.glob(pattern) if train else sorted(glob.glob(pattern))
        self.class_dir = glob.glob(os.path.join(root, split, "*"))
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
        return len(self.imgs) * 2  # each image serves twice per epoch

    def __getitem__(self, index):
        if self.selected_index:
            index = self.selected_index[index]
        index = index % len(self.imgs)
        seg_path, label = self.imgs[index]
        img_path = seg_path[:-9] + ".jpg"  # strip the _0.XX ratio suffix
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
