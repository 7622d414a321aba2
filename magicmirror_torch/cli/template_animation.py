"""Template-evolution animation (reference template-change-animation.py),
the port of ``magicmirror/cli/template_animation.py``, on the card: the
per-epoch ``epoch_*_template.obj`` files that the trainer writes into
``./log/<name>/``, each rendered in hard mode (``sigmainv`` 1e6: the soft
silhouette is nearly a step) at azimuth -30, elevation 15 and distance 2.5
with a grey texture, into ``template_evolution.gif`` (300 ms a frame, the
port's GIF writer) and ``template_evolution.png`` (up to eight frames side
by side).

    python -m magicmirror_torch.cli.template_animation --name <model> [--step 10]

The run's opts.yaml, where there is one, sets the size and the ratio.
"""
from __future__ import annotations

import glob
import os
import re
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs.flags import build_parser, load_options
from ..eval.gifs import write_gif
from ..eval.images import encode_png, to_uint8
from ..geometry.obj_io import load_obj
from ..render.renderer import DiffRender
from .test import clock, report_seconds

HARD_SIGMAINV = 1e6
FRAME_MS = 300


def template_attributes(vertices, n_vertices, gray, device):
    """The attribute dict of one template's frame."""
    def t(values):
        return torch.as_tensor(np.asarray(values, np.float32), device=device)

    return {"azimuths": t([-30.0]), "elevations": t([15.0]), "distances": t([2.5]),
            "biases": torch.zeros((1, 2), device=device), "vertices": t(vertices)[None],
            "delta_vertices": torch.zeros((1, n_vertices, 3), device=device),
            "textures": gray, "lights": t([[3.0, 0.3, 0.6, 0.3, 0, 0, 0, 0, 0]]), "bg": None}


def main(argv=None, device="cuda"):
    """-> {"gif", "png": their paths, "frames", "seconds"}."""
    device = resolve_device(device)
    parser = build_parser()
    parser.add_argument("--step", type=int, default=1)
    opt = parser.parse_args(argv)
    opt.outf = "./log/" + opt.name
    try:
        opt = load_options(opt, skip=("name", "outf", "step"))
    except FileNotFoundError:
        pass
    opt.outf = "./log/" + opt.name

    objs = sorted(glob.glob(os.path.join(opt.outf, "epoch_*_template.obj")))
    if not objs:
        raise FileNotFoundError("no epoch_*_template.obj under " + opt.outf)

    diff_render = DiffRender(objs[0], opt.imageSize, ratio=opt.ratio, init_ellipsoid=-1,
                             sigmainv=HARD_SIGMAINV, device=device)
    gray = torch.full((1, 2 * round(opt.ratio * opt.imageSize), opt.imageSize, 3), 0.7,
                      device=device)
    seconds = {}
    t0 = clock(device)
    frames = []
    with torch.inference_mode():
        for obj_path in objs[::opt.step]:
            epoch = int(re.findall(r"epoch_(\d+)_template", obj_path)[0])
            att = template_attributes(load_obj(obj_path).vertices, diff_render.num_vertices,
                                      gray, device)
            rgba, _ = diff_render.render(**att)
            frames.append((epoch, to_uint8(rgba[0, :, :, :3].cpu().numpy())))
    seconds["render"] = clock(device) - t0

    t0 = time.perf_counter()
    gif_path = os.path.join(opt.outf, "template_evolution.gif")
    write_gif(gif_path, [f for _, f in frames], delay_ms=FRAME_MS)
    strip = np.concatenate([f for _, f in frames[::max(1, len(frames) // 8)]], axis=1)
    png_path = os.path.join(opt.outf, "template_evolution.png")
    with open(png_path, "wb") as fp:
        fp.write(encode_png(strip))
    seconds["file_writes"] = time.perf_counter() - t0
    print("wrote", gif_path)
    report_seconds("template_animation", seconds, len(frames))
    return {"gif": gif_path, "png": png_path, "frames": len(frames), "seconds": seconds}


if __name__ == "__main__":
    main()
