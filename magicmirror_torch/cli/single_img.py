"""Single-image demo (reference {CUB,MKT,ATR,THU}_single_img.py), the port
of ``magicmirror/cli/single_img.py``, on the card: one photo and its mask
(optionally corrupted: ``salt``, 5% of the mask's pixels flipped;
``blur``, a Gaussian blur of radius 4) -> ``<stem>_panel.png`` (the photo,
its reconstruction, the reconstruction at +45, +90 and +135 degrees, the
normal map) and ``<stem>_rotation.gif`` (36 views, 10 degrees apart, each
beside its normal map).

    python -m magicmirror_torch.cli.single_img --name <model> --img photo.jpg \
        --mask mask.png [--corrupt none|salt|blur]

The photo is padded to a square but for runs named MKT, ATR2 or THU.  The
GIF is the port's own writer (``eval/gifs.py``: a fixed 3-3-2 palette).
Pillow decodes a JPEG photo and blurs the mask, imported only there.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs.flags import build_parser
from ..data.base import (binarize, load_rgb, load_seg, pad_to_square, resize_nearest,
                         to_rgba_array)
from ..eval.gifs import write_gif
from ..eval.images import resize_bicubic, save_array_image, to_uint8
from ..render.renderer import deep_copy
from ..serve import _no_tf32
from .test import KEEP, clock, eval_options, load_reconstructor, report_seconds

ROTATION_STEP = 10  # degrees between the GIF's views


def gaussian_blur(seg: np.ndarray, radius: float) -> np.ndarray:
    """Pillow's ``ImageFilter.GaussianBlur(radius)`` of an (H, W) uint8 mask
    (Pillow is imported here, and only here)."""
    from PIL import Image, ImageFilter

    return np.asarray(Image.fromarray(seg).filter(ImageFilter.GaussianBlur(radius)))


def preprocess(img_path, mask_path, image_size, ratio, corrupt="none", square=True):
    """The photo and its mask as the model's input (H, W, 4), H =
    round(ratio * image_size): the mask binarised (> 160), corrupted, both
    padded to a square when ``square``, the photo resized bicubic and the
    mask NEAREST and binarised again."""
    img = load_rgb(img_path)
    seg = load_seg(mask_path)
    if corrupt == "salt":
        noise = np.random.RandomState(0).rand(*seg.shape) < 0.05
        seg = seg.copy()
        seg[noise] = 255 - seg[noise]
    elif corrupt == "blur":
        seg = gaussian_blur(seg, 4)
    if square:
        img, seg = pad_to_square(img, seg)
    size = (image_size, round(ratio * image_size))
    img = resize_bicubic(img, size)
    seg = binarize(resize_nearest(seg, size))
    return to_rgba_array(img, seg, bg=False)


def panel(rec, photo):
    """The panel of one photo (1, H, W, 4) -> ((H, 6W, 3), the attributes of
    the reconstruction)."""
    render = rec.diff_render.render
    with _no_tf32(), torch.inference_mode():
        Xer, Ae = render(**rec.encode(photo))
        views = [photo[0, :, :, :3], Xer[0, :, :, :3]]
        for delta in (45, 90, 135):
            a2 = deep_copy(Ae, detach=True)
            a2["azimuths"] = Ae["azimuths"] + float(delta)
            views.append(render(**a2)[0][0, :, :, :3])
    views.append(Ae["imnormal"][0] * 0.5 + 0.5)
    return np.concatenate([v.cpu().numpy() for v in views], axis=1), Ae


def main(argv=None, device="cuda"):
    """-> {"panel": its path, "gif": its path, "seconds"}."""
    device = resolve_device(device)
    parser = build_parser()
    parser.add_argument("--img", required=True)
    parser.add_argument("--mask", required=True)
    parser.add_argument("--corrupt", default="none", choices=["none", "salt", "blur"])
    opt = eval_options(argv, parser, keep=KEEP + ("img", "mask", "corrupt"))
    square = not any(k in opt.name for k in ("MKT", "ATR2", "THU"))
    photo = preprocess(opt.img, opt.mask, opt.imageSize, opt.ratio, corrupt=opt.corrupt,
                       square=square)
    rec = load_reconstructor(opt, device)

    seconds = {}
    t0 = clock(device)
    pan, Ae = panel(rec, torch.as_tensor(photo[None], device=device))
    azimuths = -torch.arange(0, 360, ROTATION_STEP, dtype=torch.float32, device=device)
    rgba, normal = rec.turntable(Ae, azimuths)
    strips = torch.cat([rgba[..., :3], normal * 0.5 + 0.5], dim=2).cpu().numpy()
    seconds["encode_render"] = clock(device) - t0

    t0 = time.perf_counter()
    stem = os.path.splitext(os.path.basename(opt.img))[0]
    os.makedirs(opt.outf, exist_ok=True)
    panel_path = os.path.join(opt.outf, f"{stem}_panel.png")
    gif_path = os.path.join(opt.outf, f"{stem}_rotation.gif")
    save_array_image(pan, panel_path)
    write_gif(gif_path, [to_uint8(s) for s in strips])
    seconds["file_writes"] = time.perf_counter() - t0
    print("wrote", panel_path)
    report_seconds("single_img", seconds, 1)
    return {"panel": panel_path, "gif": gif_path, "seconds": seconds}


if __name__ == "__main__":
    main()
