"""ATR dataset at a free aspect ratio (reference datasets/atr2.py:29-140),
the port of ``magicmirror/data/atr2.py`` on uint8 arrays
(``data/base.py``).

The split lists of ``atr.py``, but targets (round(ratio * W), W) WITHOUT
pad-to-square; the test split is fg-ratio filtered too.
"""
from __future__ import annotations

from ..eval.images import resize_bicubic
from .atr import image_path, split_paths
from .base import (ImageDataset, binarize, cub_style_aug, filter_by_fg_ratio, load_rgb,
                   load_seg, resize_nearest, to_rgba_array)


class ATR2Dataset(ImageDataset):
    def __init__(self, root, image_size, ratio=1.6666666, train=True, aug=False,
                 threshold="0.09,0.64", bg=False, selected_index=()):
        self.root = root
        self.bg = bg
        self.ratio = ratio
        old_im_list = split_paths(root, train)
        # unlike CUB and ATR, the test split keeps the fg-ratio filter
        self.im_list = filter_by_fg_ratio(old_im_list, threshold)
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
        W = self.image_size
        size = (W, round(self.ratio * W))
        if self.train and self.aug:
            # hflip + pad-10 + 95-99% crop, NO pad-to-square
            img, seg = cub_style_aug(img, seg)
        img = resize_bicubic(img, size)
        seg = binarize(resize_nearest(seg, size))
        rgba = to_rgba_array(img, seg, self.bg)
        return {"images": rgba, "path": img_path, "label": label}
