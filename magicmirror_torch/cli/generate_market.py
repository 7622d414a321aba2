"""Market++ augmented re-ID dataset synthesis (reference
tool/generate_market.py, generate_market++.py, generate_market_new_class9.py),
the port of ``magicmirror/cli/generate_market.py``, on the card: the trained
model re-renders every photo of the Market train split at azimuth offsets
{-60, -30, 30, 60} with a jittered distance and elevation, each render
composited onto the Gaussian-blurred photo, into a tree of the re-ID layout
(``<out>/hq/pytorch/<id>/<name>_az<delta>.jpg``).

    python -m magicmirror_torch.cli.generate_market --name <model> \
        --dataroot ../Market/hq/seg_hmr --out ../Magic_Market [--texture_swap]
        [--poisson]     # Poisson-blend composites (reference tool/generate_market_test.py:44)
        [--new_class9]  # pair-id mean-texture synthesis (generate_market_new_class9)

The draws are the JAX CLI's, all made on the host: the jitter from
``random.Random(0)`` (two uniforms per offset per batch), the texture swap's
``np.random.RandomState(0).permutation(B)`` made anew each batch, and the
new-class mode's ``np.random.RandomState(manualSeed)``.  Values reach 8 bits
as in the JAX CLI: masks and photos by truncation, the written composites
rounded by ``save_array_image`` (JPEG, quality 100).  Pillow blurs and
writes, imported only there.  Each run prints its seconds by part (encode,
render, composite, JPEG writes) and its images per second through the
loader.
"""
from __future__ import annotations

import os
import random

import numpy as np
import torch

from .. import resolve_device
from ..configs.flags import build_parser
from ..data import DataLoader, MarketDataset
from ..eval.images import save_array_image
from ..eval.poisson import poisson_edit
from ..render.renderer import DiffRender, deep_copy
from ..serve import Reconstructor, _no_tf32, serve_options
from .test import KEEP, clock, eval_options, images, load_eval_state, report_seconds

AZIMUTH_DELTAS = (-60, -30, 30, 60)
NEW_CLASS_DELTAS = (-45, 0, 45)
NEW_CLASS_REPEATS = 3


def to_uint8_trunc(x: np.ndarray) -> np.ndarray:
    """[0, 1] float -> uint8 as the JAX CLI converts: ``(x * 255)`` truncated."""
    return (x * 255).astype(np.uint8)


def gaussian_blur(arr: np.ndarray, radius: float) -> np.ndarray:
    """Pillow's ``GaussianBlur(radius)`` of a uint8 image -> float32 in [0, 1]."""
    from PIL import Image, ImageFilter

    blurred = Image.fromarray(arr).filter(ImageFilter.GaussianBlur(radius))
    return np.asarray(blurred, np.float32) / 255.0


def composite_on_blur(render_rgba: np.ndarray, blurred_bg: np.ndarray) -> np.ndarray:
    """Paste the render onto the blurred photo (reference
    tool/generate_market.py:294-311); ``blurred_bg`` is
    ``gaussian_blur(to_uint8_trunc(photo), 4)``."""
    mask = render_rgba[..., 3:4]
    return render_rgba[..., :3] * mask + blurred_bg * (1 - mask)


def pair_dir(old_id: str, new_id: str):
    """The class folder of a pair of ids (numeric order where both are
    numbers), or None for the same id."""
    try:
        same, lower = int(old_id) == int(new_id), int(old_id) < int(new_id)
    except ValueError:
        same, lower = old_id == new_id, old_id < new_id
    if same:
        return None
    return old_id + new_id if lower else new_id + old_id


class _Parts:
    """Seconds by part of a run."""

    def __init__(self, device):
        self.device, self.seconds = device, {}

    def start(self):
        self.t0 = clock(self.device)

    def stop(self, part):
        t1 = clock(self.device)
        self.seconds[part] = self.seconds.get(part, 0.0) + t1 - self.t0
        self.t0 = t1


def _render(diff_render, att):
    with _no_tf32(), torch.inference_mode():
        return diff_render.render(**att)[0].cpu().numpy()


def new_class9(opt, loader, rec, parts):
    """Two-pass 'new class' synthesis (reference
    generate_market_new_class9.py:268-362): pass 1 averages each person-id's
    predicted texture over the train set (float32 ``np.mean`` on the host);
    pass 2 re-renders every image at azimuth deltas {-45, 0, 45} x 3
    repeats with the texture blended 50/50 with a random person's mean
    texture, composited over a Gaussian-blurred random in-batch photo,
    written into pair-id class folders (the two ids in numeric order; pairs
    of one id skipped, and those draw no background) -> the paths written,
    in order (a path written twice is listed twice)."""
    device = rec.template.device
    mean_tex: dict[str, list] = {}
    parts.start()
    for i, data in enumerate(loader):
        parts.stop("loader")
        tex = rec.encode(images(data, device))["textures"].cpu().numpy()
        parts.stop("encode")
        for b, path in enumerate(data["path"]):
            mean_tex.setdefault(os.path.basename(path).split("_")[0], []).append(tex[b])
        print(f"pass 1: batch {i + 1} / {len(loader)}")
    names = sorted(mean_tex)
    mean_arr = np.stack([np.mean(mean_tex[p], axis=0) for p in names])

    rng = np.random.RandomState(opt.manualSeed)
    written = []
    parts.start()
    for i, data in enumerate(loader):
        parts.stop("loader")
        photos = np.asarray(data["images"])
        att = deep_copy(rec.encode(images(data, device)), detach=True)
        parts.stop("encode")
        B = photos.shape[0]
        blurred = [gaussian_blur(to_uint8_trunc(photos[b, :, :, :3]), 3) for b in range(B)]
        parts.stop("composite")
        for _ in range(NEW_CLASS_REPEATS):
            rand_ids = rng.randint(0, len(names), B)
            for delta in NEW_CLASS_DELTAS:
                jit = dict(att)
                jit["azimuths"] = att["azimuths"] - float(delta)
                jit["distances"] = att["distances"] - 0.5 * torch.as_tensor(
                    rng.randn(B).astype(np.float32), device=device)
                jit["elevations"] = att["elevations"] - 0.1 * torch.as_tensor(
                    rng.randn(B).astype(np.float32), device=device)
                jit["textures"] = 0.5 * att["textures"] + 0.5 * torch.as_tensor(
                    mean_arr[rand_ids], device=device)
                rgba = _render(rec.diff_render, jit)
                parts.stop("render")
                for b, path in enumerate(data["path"]):
                    dir_id = pair_dir(os.path.basename(path).split("_")[0], names[rand_ids[b]])
                    if dir_id is None:
                        continue
                    mask = gaussian_blur(to_uint8_trunc(rgba[b, :, :, 3]), 3)[..., None]
                    img = rgba[b, :, :, :3] * mask + blurred[rng.randint(0, B)] * (1 - mask)
                    base = os.path.splitext(os.path.basename(path))[0]
                    out_dir = os.path.join(opt.out, "hq", "pytorch", dir_id)
                    os.makedirs(out_dir, exist_ok=True)
                    parts.stop("composite")
                    written.append(os.path.join(out_dir, f"{base[:-4]}{delta:03d}.jpg"))
                    save_array_image(img, written[-1])
                    parts.stop("jpeg_writes")
        print(f"pass 2: batch {i + 1} / {len(loader)}")
        parts.stop("jpeg_writes")
    return written


def augment(opt, loader, rec, parts):
    """The default, ``--texture_swap`` and ``--poisson`` modes: four renders
    a batch -> the paths written, in order."""
    device = rec.template.device
    rng = random.Random(0)
    written = []
    parts.start()
    for i, data in enumerate(loader):
        parts.stop("loader")
        photos = np.asarray(data["images"])
        att = deep_copy(rec.encode(images(data, device)), detach=True)
        parts.stop("encode")
        B = photos.shape[0]
        if opt.texture_swap:
            perm = np.random.RandomState(0).permutation(B)
            att["textures"] = att["textures"][torch.as_tensor(perm, device=device)]
        targets = to_uint8_trunc(photos[..., :3])
        blurred = None if opt.poisson else [gaussian_blur(t, 4) for t in targets]
        parts.stop("composite")
        for delta in AZIMUTH_DELTAS:
            jitter = dict(att)
            jitter["azimuths"] = att["azimuths"] + float(delta)
            jitter["distances"] = att["distances"] * float(np.float32(rng.uniform(0.95, 1.05)))
            jitter["elevations"] = att["elevations"] + float(np.float32(rng.uniform(-3, 3)))
            rgba = _render(rec.diff_render, jitter)
            parts.stop("render")
            for b, path in enumerate(data["path"]):
                pid = os.path.basename(os.path.dirname(path))
                name = os.path.splitext(os.path.basename(path))[0]
                out_dir = os.path.join(opt.out, "hq", "pytorch", pid)
                os.makedirs(out_dir, exist_ok=True)
                if opt.poisson:
                    img = poisson_edit(to_uint8_trunc(rgba[b, :, :, :3]), targets[b],
                                       to_uint8_trunc(rgba[b, :, :, 3]))
                    img = img.astype(np.float32) / 255.0
                else:
                    img = composite_on_blur(rgba[b], blurred[b])
                parts.stop("composite")
                written.append(os.path.join(out_dir, f"{name}_az{delta}.jpg"))
                save_array_image(img, written[-1])
                parts.stop("jpeg_writes")
        print(f"batch {i + 1} / {len(loader)}")
        parts.stop("jpeg_writes")
    return written


def main(argv=None, device="cuda"):
    """-> {"files": the paths written, in order, "images": the photos read,
    "seconds": by part, "images_per_s": photos a second through the
    loader}."""
    device = resolve_device(device)
    parser = build_parser()
    parser.add_argument("--out", default="../Magic_Market")
    parser.add_argument("--texture_swap", action="store_true", default=False,
                        help="swap textures across a shuffled pairing "
                             "(generate_market++ mode)")
    parser.add_argument("--poisson", action="store_true", default=False)
    parser.add_argument("--new_class9", action="store_true", default=False,
                        help="pair-id mean-texture synthesis "
                             "(generate_market_new_class9 mode)")
    # --out keeps its default under --new_class9 too: the JAX CLI's fallback
    # to ../Magic_Market9 applies only to an empty --out
    opt = eval_options(argv, parser,
                       keep=KEEP + ("out", "texture_swap", "poisson", "new_class9"))

    dataset = MarketDataset(opt.dataroot, opt.imageSize, train=True, aug=False,
                            threshold=opt.threshold, bg=opt.bg)
    loader = DataLoader(dataset, opt.batchSize, shuffle=False, num_workers=opt.workers)
    diff_render = DiffRender(opt.template_path, opt.imageSize, ratio=opt.ratio,
                             init_ellipsoid=opt.ellipsoid, device=device)
    netE, template = load_eval_state(opt, diff_render, device)
    rec = Reconstructor(netE, diff_render, serve_options(opt), template=template)

    parts = _Parts(device)
    t0 = clock(device)
    if opt.new_class9:
        files = new_class9(opt, loader, rec, parts)
        print("new-class9 dataset written under", opt.out)
    else:
        files = augment(opt, loader, rec, parts)
        print("augmented dataset written under", opt.out)
    total = clock(device) - t0
    n_images = len(dataset)  # every photo: the loader keeps the last partial batch
    seconds = dict(parts.seconds, total=total)
    report_seconds("generate_market", seconds, n_images)
    print("generate_market images/s through the loader: %.2f" % (n_images / total))
    return {"files": files, "images": n_images, "seconds": seconds,
            "images_per_s": n_images / total}


if __name__ == "__main__":
    main()
