"""Housekeeping and sanity tools (reference tool/clear_model.py,
tool/clear_gif.py, test_backface.py, demo.py, convert_sphere2ellipsoid.py),
the port of ``magicmirror/cli/tools.py``.  Host only.

    python -m magicmirror_torch.cli.tools clear_model [--log_dir log]
    python -m magicmirror_torch.cli.tools clear_gif [--log_dir log]
    python -m magicmirror_torch.cli.tools backface template/sphere.obj
    python -m magicmirror_torch.cli.tools sphere2ellipsoid SRC DST [--squash 2]
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil

import numpy as np
import torch

from ..geometry import mesh as mesh_ops
from ..geometry.obj_io import load_obj, save_mesh


def clear_model(log_dir="log"):
    """Delete the latest_ckpt checkpoints under log/ (reference
    tool/clear_model.py): the JAX package's checkpoint directories and the
    port's ``latest_ckpt`` files alike."""
    for path in glob.glob(os.path.join(log_dir, "*", "ckpts", "latest_ckpt")):
        print("removing", path)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            os.remove(path)
    for path in glob.glob(os.path.join(log_dir, "*", "ckpts", "latest_ckpt.pth")):
        os.remove(path)


def clear_gif(log_dir="log"):
    """Delete stale per-epoch artifacts under log/ (reference tool/clear_gif.py)."""
    patterns = ["epoch_*_rotation*.gif", "epoch_*_Iter_*.png", "epoch_*_mesh_recon.png"]
    for pat in patterns:
        for path in glob.glob(os.path.join(log_dir, "*", pat)):
            print("removing", path)
            os.remove(path)


def check_backfaces(template_path):
    """Signed-area orientation count on a template (reference
    test_backface.py:7-10) -> (faces with a positive area, with a negative)."""
    mesh = load_obj(template_path)
    clocks = mesh_ops.face_clocks(torch.as_tensor(mesh.vertices)[None], mesh.faces)
    n_pos = int((clocks > 0).sum())
    n_neg = int((clocks < 0).sum())
    print(f"{template_path}: {n_pos} CCW / {n_neg} CW faces")
    return n_pos, n_neg


def convert_sphere2ellipsoid(src, dst, squash=2.0):
    """Rewrite a sphere OBJ with y x squash (reference convert_sphere2ellipsoid.py)."""
    mesh = load_obj(src)
    v = mesh.vertices.copy()
    v[:, 1] *= squash
    save_mesh(dst, v, mesh.faces, mesh.uvs)
    print("wrote", dst)


def demo_mask_composite(img_path, seg_path, out_path):
    """White-background mask compositing demo (reference demo.py); Pillow
    reads and writes the images."""
    from PIL import Image

    img = np.asarray(Image.open(img_path).convert("RGB"), np.float32) / 255.0
    seg = np.asarray(Image.open(seg_path).convert("L"), np.float32) / 255.0
    m = (seg > 0.63)[..., None]
    out = img * m + (1 - m)
    Image.fromarray((out * 255).astype(np.uint8)).save(out_path)


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("clear_model").add_argument("--log_dir", default="log")
    sub.add_parser("clear_gif").add_argument("--log_dir", default="log")
    bp = sub.add_parser("backface")
    bp.add_argument("template")
    cp = sub.add_parser("sphere2ellipsoid")
    cp.add_argument("src")
    cp.add_argument("dst")
    cp.add_argument("--squash", type=float, default=2.0)
    args = p.parse_args(argv)
    if args.cmd == "clear_model":
        clear_model(args.log_dir)
    elif args.cmd == "clear_gif":
        clear_gif(args.log_dir)
    elif args.cmd == "backface":
        return check_backfaces(args.template)
    elif args.cmd == "sphere2ellipsoid":
        convert_sphere2ellipsoid(args.src, args.dst, args.squash)


if __name__ == "__main__":
    main()
