"""The port's ``cli/tools.py`` and ``geometry/mesh.py::face_clocks``
against the JAX package's, on the CPU.

  * ``face_clocks`` on ``sphere.obj`` and ``smpl_uv.obj`` (their own
    vertices and random ones): within 1e-6 and every sign equal (the same
    products in the same order; seen bit for bit); the (B, V, 2) form is the
    (B, V, 3) form at z = 0 (the JAX function raises on it);
  * ``backface``: the same counts;
  * ``sphere2ellipsoid``: byte-equal OBJ files;
  * ``clear_model`` / ``clear_gif``: the same files left on two copies of a
    log tree (the JAX package's checkpoint directories); the port also
    removes its own ``latest_ckpt`` files, which the JAX tool leaves;
  * ``demo_mask_composite``: byte-equal PNG files;
  * ``ablation_hmr`` over a tiny Market query split with ground-truth masks
    for all photos but one: the same samples, SSIM and mask-IoU within 1e-5
    (float32 windowed sums in another order), the same printed line.
"""
import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import magicmirror.cli.ablation_hmr as jablation
import magicmirror.cli.tools as jtools
from magicmirror.geometry import mesh as jmesh
from magicmirror_torch.cli import ablation_hmr as pablation
from magicmirror_torch.cli import tools as ptools
from magicmirror_torch.geometry import mesh as pmesh
from magicmirror_torch.geometry.obj_io import load_obj
from test_torch_recipe_data import market_tree
from torch_parity import REPO

torch.set_num_threads(1)
TEMPLATES = ("sphere.obj", "smpl_uv.obj")


@pytest.mark.parametrize("name", TEMPLATES)
def test_face_clocks_and_backfaces_match_reference(name):
    path = os.path.join(REPO, "template", name)
    mesh = load_obj(path)
    rs = np.random.RandomState(len(name))
    for v in (mesh.vertices[None], rs.randn(2, *mesh.vertices.shape).astype(np.float32)):
        ref = np.asarray(jmesh.face_clocks(jnp.asarray(v), mesh.faces))
        ours = pmesh.face_clocks(torch.as_tensor(v), mesh.faces).numpy()
        assert ours.shape == ref.shape == (v.shape[0], mesh.faces.shape[0])
        assert np.abs(ours - ref).max() <= 1e-6
        assert np.array_equal(np.sign(ours), np.sign(ref))
        flat = v.copy()
        flat[..., 2] = 0.0
        assert np.array_equal(pmesh.face_clocks(torch.as_tensor(v[..., :2]), mesh.faces).numpy(),
                              pmesh.face_clocks(torch.as_tensor(flat), mesh.faces).numpy())
    counts = ptools.main(["backface", path])
    assert counts == jtools.check_backfaces(path)
    assert sum(counts) == mesh.faces.shape[0] and min(counts) > 0


def _log_tree(root):
    """A log/ tree of two runs: checkpoint directories and files, per-epoch
    GIFs and PNGs, and files the tools keep."""
    for run in ("a", "b"):
        ckpts = os.path.join(root, run, "ckpts")
        os.makedirs(os.path.join(ckpts, "latest_ckpt", "d"))
        os.makedirs(os.path.join(ckpts, "best_ckpt"))
        files = [os.path.join(ckpts, "latest_ckpt", "d", "x"), os.path.join(ckpts, "best_ckpt", "y"),
                 os.path.join(ckpts, "latest_ckpt.pth"), os.path.join(ckpts, "best_mesh.obj")]
        files += [os.path.join(root, run, f) for f in (
            "epoch_3_rotation.gif", "epoch_3_rotation90.gif", "epoch_5_Iter_7.png",
            "epoch_5_mesh_recon.png", "epoch_5_template.obj", "current_Xer.png", "opts.yaml")]
        for f in files:
            with open(f, "w") as fp:
                fp.write(f)


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, x), root)
                  for d, dirs, fs in os.walk(root) for x in dirs + fs)


def test_tools_write_and_delete_as_the_jax_tools(tmp_path):
    # sphere2ellipsoid: the same file
    src = os.path.join(REPO, "template", "sphere.obj")
    outs = [str(tmp_path / f"ellipsoid_{k}.obj") for k in ("jax", "port")]
    jtools.convert_sphere2ellipsoid(src, outs[0], 2.0)
    ptools.main(["sphere2ellipsoid", src, outs[1], "--squash", "2"])
    assert filecmp.cmp(*outs, shallow=False)
    v = load_obj(outs[1]).vertices
    assert np.allclose(v[:, 1], 2.0 * load_obj(src).vertices[:, 1], atol=1e-5)

    # clear_gif and clear_model on two copies of one tree
    roots = [str(tmp_path / f"log_{k}") for k in ("jax", "port")]
    for root in roots:
        _log_tree(root)
    jtools.clear_gif(roots[0])
    ptools.main(["clear_gif", "--log_dir", roots[1]])
    assert _listing(roots[0]) == _listing(roots[1])
    assert not any("rotation" in f or "Iter" in f or "recon" in f for f in _listing(roots[1]))
    jtools.clear_model(roots[0])
    ptools.main(["clear_model", "--log_dir", roots[1]])
    left = _listing(roots[1])
    assert _listing(roots[0]) == left
    assert not any("latest_ckpt" in f for f in left) and "a/ckpts/best_ckpt/y" in left
    # the port's checkpoints are files
    with open(os.path.join(roots[1], "a", "ckpts", "latest_ckpt"), "w") as fp:
        fp.write("state")
    ptools.clear_model(roots[1])
    assert _listing(roots[1]) == left

    # demo_mask_composite: the same PNG
    rs = np.random.RandomState(0)
    img, seg = str(tmp_path / "img.jpg"), str(tmp_path / "seg.png")
    Image.fromarray((rs.rand(20, 30, 3) * 255).astype(np.uint8)).save(img, quality=95)
    Image.fromarray((rs.rand(20, 30) * 255).astype(np.uint8)).save(seg)
    outs = [str(tmp_path / f"demo_{k}.png") for k in ("jax", "port")]
    jtools.demo_mask_composite(img, seg, outs[0])
    ptools.demo_mask_composite(img, seg, outs[1])
    assert filecmp.cmp(*outs, shallow=False)


def test_ablation_hmr_matches_reference(tmp_path, capsys, monkeypatch):
    dataroot = market_tree(tmp_path, n_train=1, n_test=4)
    rs = np.random.RandomState(6)
    query = os.path.join(tmp_path, "pytorch", "query")
    photos = sorted(os.path.join(d, f) for d, _, fs in os.walk(query) for f in fs)
    for path in photos[1:]:
        gt = path.replace("pytorch", "gt_mask")
        os.makedirs(os.path.dirname(gt), exist_ok=True)
        h, w = np.asarray(Image.open(path)).shape[:2]
        m = np.zeros((h, w), np.uint8)
        m[h // 3 + rs.randint(0, 3):h - 2, rs.randint(1, 4):w // 2 + 2] = 255  # cuts the photo
        Image.fromarray(m).save(gt)
    argv = ["--dataroot", dataroot, "--imageSize", "16"]
    seen = {"ssim": [], "iou": []}
    for name, key in (("ssim", "ssim"), ("mask_iou_metric", "iou")):
        real = getattr(jablation, name)
        monkeypatch.setattr(jablation, name, lambda *a, real=real, key=key: seen[key].append(
            float(real(*a))) or real(*a))
    jablation.main(argv)
    ref = capsys.readouterr().out.strip().splitlines()[-1]
    out = pablation.main(argv, device="cpu")
    assert capsys.readouterr().out.strip().splitlines()[-1] == ref
    assert out["samples"] == len(seen["ssim"]) == 3 and ref.endswith("over 3 samples")
    assert abs(out["ssim"] - np.mean(seen["ssim"])) <= 1e-5
    assert abs(out["mask_iou"] - np.mean(seen["iou"])) <= 1e-5
    assert 0.0 < out["mask_iou"] < 1.0 and 0.0 < out["ssim"] < 1.0
