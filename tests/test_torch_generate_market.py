"""The port's ``generate_market`` against the JAX CLI's, on the CPU, in all
four modes (the default, ``--texture_swap``, ``--poisson``,
``--new_class9``), on one Market tree of eight photos of three identities
(Market's file names) and one checkpoint (the JAX package's, converted:
``torch_parity.jax_run`` / ``port_run``; the tiny model at 64 x 32 with the
Market recipe's ``--ratio 2 --ellipsoid 2 --bg``).  Both CLIs make their
own draws (the jitter, the swap, the new-class ids and backgrounds): none is
injected.

  * the written file lists are equal;
  * every composite, captured before it is written, to the slice's rgb
    rules (``parity.check_renders``: JAX vs the port, one device); the
    Poisson blends are uint8 solves of uint8 inputs, held to the same rules
    at 1/255 per level;
  * the written JPEGs, decoded, within 6 of 255 on 99.5% of each image's
    pixels, and their mean within 1: JPEG at quality 100 with Pillow's 4:2:0
    chroma rounds each 8 x 8 block once more, so an input pixel that moves
    by up to the slice's rgb cap (2.55 levels), or a silhouette pixel that
    flips (up to 64 an image), moves its decoded neighbours by a few levels.
  * no kernel launch (CPU tensors).

The JAX CLI's state is restored into zeros of its structure (its encoder
and render are jitted by the CLI itself).  Four cases of one test function:
the file compiles one JAX encoder and render (ROADMAP §1 rules).
"""
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import magicmirror.cli.generate_market as jgm
import magicmirror.cli.test as jtest
import magicmirror_torch.cli.generate_market as pgm
from magicmirror_torch import kernels, parity
from test_torch_recipe_data import _photo_and_mask
from torch_parity import jax_run, port_run, zeros_train_state

torch.set_num_threads(1)
NAME = "mkt"
MODES = {"default": [], "texture_swap": ["--texture_swap"], "poisson": ["--poisson"],
         "new_class9": ["--new_class9"]}
IDS = ("0001", "0002", "0007")


def market_photos(root, n=8):
    """``root/seg_hmr/train_all/<id>/<id>_c<k>s1_<frame>_00_<ratio>.png``
    masks and the RGB at the same place under ``root/pytorch`` -> the
    dataroot.  Market's names: the id before the first underscore."""
    rs = np.random.RandomState(5)
    for i in range(n):
        pid = IDS[i % 3]
        name = f"{pid}_c{1 + i % 6}s1_{1000 + 37 * i:06d}_00"
        img, mask, ratio = _photo_and_mask(rs, 48, 24, i)
        for sub, arr, fname in (("pytorch", img, name), ("seg_hmr", mask, f"{name}_{ratio}")):
            d = os.path.join(root, sub, "train_all", pid)
            os.makedirs(d, exist_ok=True)
            Image.fromarray(arr).save(os.path.join(d, fname + ".png"))
    return os.path.join(str(root), "seg_hmr")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree = market_photos(tmp_path_factory.mktemp("market"))
    jroot, proot = (str(tmp_path_factory.mktemp(k)) for k in ("jax", "port"))
    jax_run(jroot, name=NAME, dataroot=tree, extra=["--ratio", "2", "--ellipsoid", "2", "--bg"])
    port_run(jroot, proot, name=NAME)
    yield tree, jroot, proot
    for root in (jroot, proot):
        shutil.rmtree(root, ignore_errors=True)


def _run(module, root, argv, monkeypatch, **kwargs):
    """``module.main`` in ``root``, its composites captured -> ({relative
    path: the float array written}, what main returned)."""
    saved = {}
    real = module.save_array_image

    def capture(img, path, *args, **kw):
        saved[os.path.relpath(path, os.path.join(root, "out"))] = np.array(img, np.float32)
        real(img, path, *args, **kw)

    monkeypatch.setattr(module, "save_array_image", capture)
    monkeypatch.chdir(root)
    return saved, module.main(argv, **kwargs)


def _files(root):
    out = os.path.join(root, "out")
    return sorted(os.path.relpath(os.path.join(d, f), out)
                  for d, _, fs in os.walk(out) for f in fs)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_market_matches_the_jax_cli(mode, runs, monkeypatch):
    tree, jroot, proot = runs
    monkeypatch.setattr(jtest, "create_train_state", zeros_train_state)
    argv = ["--name", NAME, "--dataroot", tree, "--out", "out", "--batchSize", "4",
            *MODES[mode]]
    for root in (jroot, proot):
        shutil.rmtree(os.path.join(root, "out"), ignore_errors=True)
    launches = dict(kernels.LAUNCHES)
    ref, _ = _run(jgm, jroot, argv, monkeypatch)
    ours, out = _run(pgm, proot, argv, monkeypatch, device="cpu")
    assert kernels.LAUNCHES == launches  # CPU tensors never reach a kernel

    files = _files(jroot)
    assert files == _files(proot) == sorted(ref) == sorted(ours)
    assert sorted({os.path.relpath(f, "out") for f in out["files"]}) == files
    assert out["images"] == 8 and set(out["seconds"]) >= {"encode", "render", "composite",
                                                          "jpeg_writes", "total"}
    if mode == "new_class9":  # pair folders; pairs of one id write nothing
        assert 0 < len(files) < 8 * 3 * 3
        assert all(os.path.dirname(f).split(os.sep)[-1] in {
            a + b for a in IDS for b in IDS if a < b} for f in files)
    else:
        assert len(files) == 8 * 4
        assert {f.rsplit("_az", 1)[1] for f in files} == {"-60.jpg", "-30.jpg", "30.jpg",
                                                          "60.jpg"}

    a = np.stack([ref[f] for f in files])
    b = np.stack([ours[f] for f in files])
    stats = parity.render_stats([np.concatenate([a, np.zeros_like(a[..., :1])], -1)],
                                [np.concatenate([b, np.zeros_like(b[..., :1])], -1)])
    parity.check_renders(stats)

    for f in files:
        da, db = (np.asarray(Image.open(os.path.join(r, "out", f)), np.float32)
                  for r in (jroot, proot))
        assert da.shape == db.shape == (64, 32, 3), f
        d = np.abs(da - db).max(-1)
        assert (d <= 6).mean() >= 0.995 and np.abs(da - db).mean() <= 1.0, (f, d.max())
