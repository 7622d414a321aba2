"""The port's CUB dataset and loader (``magicmirror_torch/data``) against
the JAX package's (``magicmirror/data``) on a tiny CUB-layout tree: the
generator of tests/test_trainer_integration.py, at two non-square photo
sizes so that the padding to a square shows.

Tolerances: the flip, the padding and the crop exact (uint8 equal); the
RGB resize within 1/255 (``eval/images.py::resize_bicubic`` reproduces
Pillow's fixed point, tests/test_torch_resize.py); the mask exact; the
loader's batches equal in paths and order.
"""
import os
import random
import sys

import numpy as np
import pytest
from PIL import Image

from magicmirror.data import base as jbase
from magicmirror.data.cub import CUBDataset as JCUBDataset
from magicmirror.data.loader import DataLoader as JDataLoader
from magicmirror_torch.data import base
from magicmirror_torch.data.cub import CUBDataset
from magicmirror_torch.data.loader import DataLoader

SIZES = ((40, 52), (48, 36))  # (height, width) of the photos, in turn
RGB_TOL = 1.0 / 255.0 + 1e-6


def cub_tree(root, n_train=4, n_test=2):
    """``root/{train,test}/c0/sN.jpg`` with masks ``sN_<fg ratio>.png``: random
    RGB, a rectangle of foreground (tests/test_trainer_integration.py's
    generator at two photo sizes)."""
    rs = np.random.RandomState(0)
    for split, n in (("train", n_train), ("test", n_test)):
        d = os.path.join(root, split, "c0")
        os.makedirs(d)
        for i in range(n):
            h, w = SIZES[i % 2]
            img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"s{i}.jpg"))
            mask = np.zeros((h, w), np.uint8)
            mask[8:h - 8, 6 + i:w - 6] = 255
            Image.fromarray(mask).save(os.path.join(d, "s%d_%.2f.png" % (i, mask.mean() / 255)))
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return cub_tree(tmp_path_factory.mktemp("cub"))


def test_flip_pad_and_crop_are_pillows_exactly(tree):
    """``cub_style_aug`` and ``pad_to_square`` on the arrays of each photo
    and mask, under the same ``random`` draws, against the JAX package's
    Pillow steps: equal, for both flips and several crops."""
    segs = sorted(p for p in os.listdir(os.path.join(tree, "train", "c0")) if p.endswith(".png"))
    flips = set()
    for name in segs:
        seg_path = os.path.join(tree, "train", "c0", name)
        img_path = seg_path[:-9] + ".jpg"
        pil_img, pil_seg = jbase.load_rgb(img_path), jbase.load_seg(seg_path)
        img, seg = base.load_rgb(img_path), base.load_seg(seg_path)
        assert np.array_equal(img, np.asarray(pil_img))
        assert np.array_equal(seg, np.asarray(pil_seg))
        for seed in range(6):
            random.seed(seed)
            flips.add(random.uniform(0, 1) < 0.5)
            random.seed(seed)
            ref = jbase.pad_to_square(*jbase.cub_style_aug(pil_img, pil_seg))
            random.seed(seed)
            ours = base.pad_to_square(*base.cub_style_aug(img, seg))
            for a, r in zip(ours, ref):
                assert np.array_equal(a, np.asarray(r))
    assert flips == {True, False}


def test_crop_outside_the_image_pads_with_zeros():
    rs = np.random.RandomState(1)
    img = rs.randint(0, 256, (9, 7, 3)).astype(np.uint8)
    for box in ((-3, -2, 5, 6), (4, 5, 12, 11), (-1, -1, 8, 10), (2, 3, 2, 3)):
        ref = np.asarray(Image.fromarray(img).crop(box))
        assert np.array_equal(base.crop(img, box), ref), box


@pytest.mark.parametrize("shape,size", [((52, 52), (32, 32)), ((17, 40), (64, 23)),
                                        ((128, 128), (128, 128)), ((30, 31), (7, 5))])
def test_nearest_resize_is_pillows(shape, size):
    seg = (np.random.RandomState(2).rand(*shape) > 0.5).astype(np.uint8) * 255
    ref = np.asarray(Image.fromarray(seg).resize(size, Image.NEAREST))
    assert np.array_equal(base.resize_nearest(seg, size), ref)


@pytest.mark.parametrize("train,aug", [(True, False), (True, True), (False, False)])
def test_dataset_items_match_the_jax_package(tree, train, aug):
    """Every item of the port's CUBDataset against the JAX package's, the
    augmented ones under the same ``random`` seed: paths, labels and the
    order equal, the mask exact, the RGB within 1/255."""
    kw = dict(train=train, aug=aug, threshold="0.1,0.9")
    ours, ref = CUBDataset(tree, 32, **kw), JCUBDataset(tree, 32, **kw)
    assert len(ours) == len(ref) == 2 * (4 if train else 2)
    for i in range(len(ours)):
        random.seed(100 + i)
        a = ours[i]
        random.seed(100 + i)
        r = ref[i]
        assert (a["path"], a["label"]) == (r["path"], r["label"])
        assert a["images"].shape == r["images"].shape == (32, 32, 4)
        assert a["images"].dtype == np.float32
        assert np.array_equal(a["images"][..., 3], r["images"][..., 3])
        assert np.abs(a["images"][..., :3] - r["images"][..., :3]).max() <= RGB_TOL


def test_loader_batches_match_the_jax_package_over_two_epochs(tree):
    kw = dict(train=True, aug=False, threshold="0.1,0.9")
    loaders = [cls(ds(tree, 32, **kw), 3, shuffle=True, drop_last=True, num_workers=1,
                   seed=5) for cls, ds in ((DataLoader, CUBDataset),
                                           (JDataLoader, JCUBDataset))]
    assert len(loaders[0]) == len(loaders[1]) == 2
    orders = []
    for _ in range(2):
        batches = [list(loader) for loader in loaders]
        for a, r in zip(*batches):
            assert a["path"] == r["path"]
            assert np.array_equal(a["label"], r["label"])
            assert a["images"].shape == r["images"].shape == (3, 32, 32, 4)
            assert np.abs(a["images"] - r["images"]).max() <= RGB_TOL
        orders.append([p for b in batches[0] for p in b["path"]])
    assert orders[0] != orders[1]  # a new shuffle each epoch


def test_loader_refuses_a_multi_host_shard():
    with pytest.raises(NotImplementedError):
        DataLoader([0, 1, 2, 3], 2, shard=(0, 2))
    assert len(DataLoader([0, 1, 2], 2, shard=(0, 1))) == 2


def test_without_pillow_a_jpeg_raises_and_says_why(tree, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="reading JPEG needs Pillow"):
        CUBDataset(tree, 32, train=True)[0]
