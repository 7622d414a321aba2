"""The port's Market, ATR and ATR2 datasets (``magicmirror_torch/data``)
against the JAX package's (``magicmirror/data``) on tiny trees of each
layout, with and without augmentation, the augmented items under the same
``random`` seed.

  * Market: ``seg_hmr/{train_all,query}/<id>/sN_<fg ratio>.png`` masks and
    the RGB at ``pytorch/.../sN.png``;
  * ATR / ATR2: ``Seg/aN_<fg ratio>.png`` masks, the RGB at
    ``JPEGImages/aN.jpg``, and the split lists of the tree in a directory of
    their own, which both packages' ``atr._LIST_DIR`` are pointed at
    (``monkeypatch``: the JAX module is not edited).

Photos at two sizes of each aspect, so that the resizes, the pad to a
square (ATR) and the crops show.  Tolerances, as tests/test_torch_data.py
holds CUB: paths, labels and order equal; the mask exact; the RGB within
1/255 (``eval/images.py::resize_bicubic`` is Pillow's fixed point).
"""
import filecmp
import os
import random

import numpy as np
import pytest
from PIL import Image

from magicmirror.data import atr as jatr
from magicmirror.data.atr import ATRDataset as JATRDataset
from magicmirror.data.atr2 import ATR2Dataset as JATR2Dataset
from magicmirror.data.market import MarketDataset as JMarketDataset
from magicmirror_torch.data import atr
from magicmirror_torch.data.atr import ATRDataset
from magicmirror_torch.data.atr2 import ATR2Dataset
from magicmirror_torch.data.market import MarketDataset
from torch_parity import REPO

RGB_TOL = 1.0 / 255.0 + 1e-6


def _photo_and_mask(rs, h, w, i):
    img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[h // 5:h - h // 5, w // 4 + i % 3:w - w // 4] = 255
    return img, mask, "%.2f" % (mask.mean() / 255)


def market_tree(root, n_train=5, n_test=3, sizes=((44, 20), (36, 22))):
    """``root/seg_hmr`` (the dataroot) and ``root/pytorch``: masks and RGB
    PNGs of identities ``0001`` and ``0002``."""
    rs = np.random.RandomState(0)
    for split, n in (("train_all", n_train), ("query", n_test)):
        for i in range(n):
            ident = "0001" if i % 2 else "0002"
            seg_dir = os.path.join(root, "seg_hmr", split, ident)
            img_dir = os.path.join(root, "pytorch", split, ident)
            os.makedirs(seg_dir, exist_ok=True)
            os.makedirs(img_dir, exist_ok=True)
            img, mask, ratio = _photo_and_mask(rs, *sizes[i % 2], i)
            Image.fromarray(img).save(os.path.join(img_dir, f"s{i}.png"))
            Image.fromarray(mask).save(os.path.join(seg_dir, f"s{i}_{ratio}.png"))
    return os.path.join(str(root), "seg_hmr")


def atr_tree(root, n_train=5, n_test=3, sizes=((50, 30), (40, 26))):
    """``root/Seg`` (the dataroot), ``root/JPEGImages`` and the split lists
    in ``root/lists`` -> (dataroot, list directory)."""
    rs = np.random.RandomState(1)
    seg_dir, img_dir = os.path.join(root, "Seg"), os.path.join(root, "JPEGImages")
    lists = os.path.join(root, "lists")
    for d in (seg_dir, img_dir, lists):
        os.makedirs(d, exist_ok=True)
    for split, n, first in (("train", n_train, 0), ("test", n_test, 100)):
        names = []
        for i in range(first, first + n):
            img, mask, ratio = _photo_and_mask(rs, *sizes[i % 2], i)
            Image.fromarray(img).save(os.path.join(img_dir, f"a{i}.jpg"), quality=95)
            names.append(f"a{i}_{ratio}.png")
            Image.fromarray(mask).save(os.path.join(seg_dir, names[-1]))
        with open(os.path.join(lists, f"ATR_{split}.txt"), "w") as fp:
            fp.write("\n".join(names) + "\n")
    return os.path.join(str(root), "Seg"), lists


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return {"market": market_tree(tmp_path_factory.mktemp("market")),
            "atr": atr_tree(tmp_path_factory.mktemp("ATR"))}


def _pair(kind, trees, train, aug):
    """(port dataset, JAX dataset) of ``kind`` with the same arguments."""
    kw = dict(train=train, aug=aug, threshold="0.1,0.9", bg=True)
    if kind == "market":
        return (MarketDataset(trees["market"], 16, **kw),
                JMarketDataset(trees["market"], 16, **kw), (32, 16))
    root = trees["atr"][0]
    if kind == "atr":
        return ATRDataset(root, 24, **kw), JATRDataset(root, 24, **kw), (24, 24)
    # ATR2 at the dataset's own ratio, 1.6666666: round(1.6666666 * 24) = 40
    return ATR2Dataset(root, 24, **kw), JATR2Dataset(root, 24, **kw), (40, 24)


@pytest.mark.parametrize("kind", ["market", "atr", "atr2"])
@pytest.mark.parametrize("train,aug", [(True, False), (True, True), (False, False)])
def test_dataset_items_match_the_jax_package(trees, monkeypatch, kind, train, aug):
    """Every item against the JAX package's: paths, labels and order equal,
    the mask exact, the RGB within 1/255; Market's ``obj`` is -1."""
    lists = trees["atr"][1]
    monkeypatch.setattr(atr, "_LIST_DIR", lists)
    monkeypatch.setattr(jatr, "_LIST_DIR", lists)
    ours, ref, shape = _pair(kind, trees, train, aug)
    assert len(ours) == len(ref) == (5 if train else 3)
    assert [p for p, _ in ours.imgs] == [p for p, _ in ref.imgs]
    for i in range(len(ours)):
        random.seed(100 + i)
        a = ours[i]
        random.seed(100 + i)
        r = ref[i]
        assert (a["path"], a["label"]) == (r["path"], r["label"])
        assert a["images"].shape == r["images"].shape == shape + (4,)
        assert a["images"].dtype == np.float32
        assert np.array_equal(a["images"][..., 3], r["images"][..., 3])
        assert np.abs(a["images"][..., :3] - r["images"][..., :3]).max() <= RGB_TOL
        if kind == "market":
            assert a["obj"] == r["obj"] == np.float32(-1)


def test_fg_ratio_filters_follow_the_jax_package(trees, monkeypatch):
    """A threshold that drops photos: the train splits filter in all three,
    the test split in ATR2 only."""
    lists = trees["atr"][1]
    monkeypatch.setattr(atr, "_LIST_DIR", lists)
    monkeypatch.setattr(jatr, "_LIST_DIR", lists)
    for cls, jcls, root in ((MarketDataset, JMarketDataset, trees["market"]),
                            (ATRDataset, JATRDataset, trees["atr"][0]),
                            (ATR2Dataset, JATR2Dataset, trees["atr"][0])):
        for train in (True, False):
            full = cls(root, 16, train=train, threshold="0.0,1.0")
            lowest = min(float(p[-8:-4]) for p in full.im_list)
            kw = dict(train=train, threshold=f"{lowest},1.0")  # drops the lowest ratio
            ours, ref = cls(root, 16, **kw), jcls(root, 16, **kw)
            assert ours.imgs == ref.imgs, (cls, train)
            assert (len(ours) < len(full)) == (train or cls is ATR2Dataset), (cls, train)


def test_split_lists_are_the_jax_packages():
    for name in ("ATR_train.txt", "ATR_test.txt"):
        ours = os.path.join(REPO, "magicmirror_torch", "data", "splits", name)
        ref = os.path.join(REPO, "magicmirror", "data", "splits", name)
        assert filecmp.cmp(ours, ref, shallow=False), name
    assert len(atr.read_split("/nowhere", True)) == 16000
    assert len(atr.read_split("/nowhere", False)) == 1706


def body_meshes(seg_root, n_vertices=20, seed=3):
    """``bodymesh/<split>/<id>/<stem>.obj`` beside ``seg_root`` (the
    ``seg_hmr`` tree) for every mask of it: seeded vertices, one face."""
    rs = np.random.RandomState(seed)
    for split in ("train_all", "query"):
        for ident in sorted(os.listdir(os.path.join(seg_root, split))):
            for mask in sorted(os.listdir(os.path.join(seg_root, split, ident))):
                d = os.path.join(os.path.dirname(seg_root), "bodymesh", split, ident)
                os.makedirs(d, exist_ok=True)
                with open(os.path.join(d, mask[:-9] + ".obj"), "w") as fp:
                    for v in rs.randn(n_vertices, 3):
                        fp.write("v %.6f %.6f %.6f\n" % tuple(v))
                    fp.write("f 1 2 3\n")


def test_market_body_mesh_prior_is_not_ported(trees):
    """The HMR body-mesh prior (``hmr > 0``), now ported: each item's
    ``obj`` is the vertices of the mesh beside its mask, mirrored in x with
    the photo, exactly the JAX dataset's, in every split and mode."""
    root = trees["market"]
    if not os.path.isdir(os.path.join(os.path.dirname(root), "bodymesh")):
        body_meshes(root)
    for train, aug in ((True, True), (True, False), (False, False)):
        kw = dict(train=train, aug=aug, threshold="0.1,0.9", hmr=1.0)
        ours, ref = MarketDataset(root, 16, **kw), JMarketDataset(root, 16, **kw)
        flips = 0
        for i in range(len(ours)):
            random.seed(200 + i)
            a = ours[i]
            random.seed(200 + i)
            r = ref[i]
            assert a["obj"].shape == (20, 3) and a["obj"].dtype == np.float32
            np.testing.assert_array_equal(a["obj"], r["obj"])
            np.testing.assert_array_equal(a["images"][..., 3], r["images"][..., 3])
            plain = MarketDataset(root, 16, train=train, aug=False, hmr=1.0,
                                  threshold="0.1,0.9")[i]["obj"]
            flips += int(not np.array_equal(a["obj"], plain))
        assert (flips > 0) == aug, flips
