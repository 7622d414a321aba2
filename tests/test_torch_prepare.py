"""The port's offline data preparation (``data/prepare.py``), its numpy
host functions (``data/native.py``) and its Poisson blend
(``eval/poisson.py``) against the JAX package's, on the CPU; every output
byte-equal.

  * ``prepare_masks`` on copies of one tree: CUB's rename, the rename left
    out, and ATR's hole-filling into another tree (``out_replace``): the
    same files with the same bytes, the same ratios;
  * ``preprocess_cub`` over a tiny CUB_200_2011 layout and
    ``prepare_cub_edges`` over its output: the same trees, byte for byte
    (both through the same Pillow);
  * ``native``: each of the six functions equal to the JAX module's compiled
    library (``libpreprocess.so``, which loads here), over random sizes up
    and down; ``resize_bilinear`` with its fused multiply-adds rounded once,
    as the library does (unfused float32 arithmetic differs: the witness);
  * ``poisson_edit``: equal uint8 output, with and without an offset, and
    for an empty mask.
"""
import filecmp
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from magicmirror.data import native as jnative
from magicmirror.data import prepare as jprepare
from magicmirror.eval.poisson import poisson_edit as jpoisson
from magicmirror_torch.data import native as pnative
from magicmirror_torch.data import prepare as pprepare
from magicmirror_torch.eval.poisson import poisson_edit


def _tree_equal(a, b):
    listing = [sorted(os.path.relpath(os.path.join(d, f), r) for d, _, fs in os.walk(r)
                      for f in fs) for r in (a, b)]
    assert listing[0] == listing[1] and listing[0]
    for f in listing[0]:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


def _masks(root, rs, pattern_dirs, n=3, holes=False):
    for d in pattern_dirs:
        os.makedirs(os.path.join(root, d), exist_ok=True)
        for i in range(n):
            h, w = rs.randint(20, 40, 2)
            m = np.zeros((h, w), np.uint8)
            m[h // 4:h - h // 5, w // 5 + i:w - w // 4] = rs.choice([1, 200, 255])
            if holes:
                m[rs.rand(h, w) < 0.1] = 0
            Image.fromarray(m).save(os.path.join(root, d, f"m{i}.png"))


@pytest.mark.parametrize("case", ["rename", "keep_names", "hole_fill"])
def test_prepare_masks_matches_reference(case, tmp_path):
    rs = np.random.RandomState(len(case))
    src = tmp_path / "src"
    if case == "hole_fill":
        _masks(os.path.join(src, "SegmentationClassAug"), rs, ["."], n=4, holes=True)
        kw = dict(pattern="SegmentationClassAug/*.png", hole_fill=True,
                  out_replace=("SegmentationClassAug", "Seg"))
    else:
        _masks(src, rs, ["train/c0", "test/c1"])
        kw = dict(pattern="*/*/*.png", rename=case == "rename")
    roots = [str(tmp_path / k) for k in ("jax", "port")]
    ratios = []
    for root, fn in zip(roots, (jprepare.prepare_masks, pprepare.prepare_masks)):
        shutil.copytree(src, root)
        ratios.append(sorted(fn(root, **kw)))
    assert ratios[0] == ratios[1] and len(ratios[1]) >= 4
    _tree_equal(*roots)
    names = [f for _, _, fs in os.walk(roots[1]) for f in fs]
    if case == "keep_names":
        assert all(len(f) == len("m0.png") for f in names)
    else:
        assert sum(f.count("_0.") + f.count("_1.") for f in names) >= 4


def _cub_root(root, rs, n=4):
    """CUB_200_2011's layout: images.txt, train_test_split.txt,
    bounding_boxes.txt, images/ and segmentations/."""
    rels = [f"00{c}.Bird/b_{i}.jpg" for i, c in enumerate((1, 1, 2, 2)[:n])]
    lines = {"images.txt": [], "train_test_split.txt": [], "bounding_boxes.txt": []}
    for i, rel in enumerate(rels):
        h, w = rs.randint(40, 70, 2)
        for sub, arr, name in (("images", (rs.rand(h, w, 3) * 255).astype(np.uint8), rel),
                               ("segmentations", (rs.rand(h, w) * 255).astype(np.uint8),
                                rel.replace(".jpg", ".png"))):
            os.makedirs(os.path.dirname(os.path.join(root, sub, name)), exist_ok=True)
            Image.fromarray(arr).save(os.path.join(root, sub, name))
        x, y = rs.uniform(-5, w / 2), rs.uniform(-5, h / 2)
        lines["images.txt"].append(f"{i + 1} {rel}")
        lines["train_test_split.txt"].append(f"{i + 1} {int(i % 3 != 2)}")
        lines["bounding_boxes.txt"].append(f"{i + 1} {x:.1f} {y:.1f} {w / 2:.1f} {h / 1.5:.1f}")
    for name, rows in lines.items():
        with open(os.path.join(root, name), "w") as fp:
            fp.write("\n".join(rows) + "\n")


def test_preprocess_cub_and_edges_match_reference(tmp_path):
    cub = str(tmp_path / "CUB_200_2011")
    _cub_root(cub, np.random.RandomState(0))
    dsts = [str(tmp_path / f"CUB_Data_{k}") for k in ("jax", "port")]
    jprepare.preprocess_cub(cub, dsts[0])
    pprepare.preprocess_cub(cub, dsts[1])
    _tree_equal(*dsts)
    assert os.path.isdir(os.path.join(dsts[1], "test"))
    jprepare.prepare_cub_edges(dsts[0])
    pprepare.prepare_cub_edges(dsts[1])
    _tree_equal(*dsts)
    edges = [f for _, _, fs in os.walk(dsts[1]) for f in fs if f.endswith("_coarse_edge.png")]
    assert len(edges) == 3


def test_native_functions_match_the_compiled_library(monkeypatch):
    assert jnative.HAVE_NATIVE
    rs = np.random.RandomState(0)
    cases = []
    for _ in range(120):
        h, w = (int(x) for x in rs.randint(1, 80, 2))
        dh, dw = (int(x) for x in rs.randint(1, 130, 2))
        c = int(rs.choice([1, 3, 4]))
        img = rs.randint(0, 256, (h, w, c)).astype(np.uint8)
        cases.append((img, dh, dw, jnative.resize_bilinear(img, dh, dw)))
        assert np.array_equal(pnative.resize_bilinear(img, dh, dw), cases[-1][3]), (
            h, w, c, dh, dw)
        m = rs.randint(0, 256, (h, w)).astype(np.uint8)
        assert np.array_equal(pnative.resize_bilinear(m, dh, dw),
                              jnative.resize_bilinear(m, dh, dw))
        assert np.array_equal(pnative.resize_nearest(m, dh, dw),
                              jnative.resize_nearest(m, dh, dw)), (h, w, dh, dw)
        assert np.array_equal(pnative.binarize(m, 160), jnative.binarize(m.copy(), 160))
        assert pnative.fg_ratio(m > 128) == jnative.fg_ratio((m > 128).astype(np.uint8))
        rgba = rs.rand(h, w, 4).astype(np.float32)
        assert np.array_equal(pnative.white_composite(rgba), jnative.white_composite(rgba.copy()))
        holes = (rs.rand(h, w) > 0.4).astype(np.float64)
        assert np.array_equal(pnative.fill_holes(holes), jnative.fill_holes(holes.copy()))
    # the witness: without the fused steps' single rounding some bytes differ
    monkeypatch.setattr(pnative, "_fma32", lambda a, b, c: (
        np.float32(a) * np.float32(b) + np.float32(c)).astype(np.float32))
    assert sum(int((pnative.resize_bilinear(img, dh, dw) != ref).sum())
               for img, dh, dw, ref in cases) > 0
    # the port writes no caller's array
    m = np.full((4, 4), 200, np.uint8)
    pnative.binarize(m)
    assert (m == 200).all()


def test_poisson_edit_matches_reference():
    rs = np.random.RandomState(1)
    src = (rs.rand(40, 30, 3) * 255).astype(np.uint8)
    tgt = (rs.rand(40, 30, 3) * 255).astype(np.uint8)
    mask = np.zeros((40, 30), np.uint8)
    mask[5:33, 4:25] = (rs.rand(28, 21) * 255).astype(np.uint8)
    for offset in ((0, 0), (3, -2)):
        ours = poisson_edit(src, tgt, mask, offset)
        assert ours.dtype == np.uint8 and np.array_equal(ours, jpoisson(src, tgt, mask, offset))
        assert not np.array_equal(ours, tgt)
    empty = np.zeros_like(mask)
    assert np.array_equal(poisson_edit(src, tgt, empty), jpoisson(src, tgt, empty))
