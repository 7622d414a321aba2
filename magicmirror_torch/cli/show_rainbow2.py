"""Demo figures (reference show_rainbow2.py), the port of
``magicmirror/cli/show_rainbow2.py``, on the card: one batch of hand-picked
test photos -> ``rainbow_{Xa,Xer,Xir}.png`` grids, the first reconstructed
texture and mesh, the rainbow GIF (row i: every photo's shape and camera
under photo i's texture, turning 10 degrees a frame) and the azimuth,
elevation, distance and xy-bias sweeps.

    python -m magicmirror_torch.cli.show_rainbow2 --name <model> [--dataroot DIR]

The random view's azimuths come from a generator seeded with 0, or ``draws``.
GIFs are the port's own writer (``eval/gifs.py``: a fixed 3-3-2 palette).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..eval.gifs import azimuth_sweep, distance_sweep, elevation_sweep, write_gif
from ..eval.images import make_grid, save_array_image, save_image_grid, to_uint8
from ..geometry.obj_io import save_mesh
from ..render.renderer import deep_copy
from ..serve import _no_tf32
from .test import clock, eval_options, load_reconstructor, pick_dataset, report_seconds

# hand-picked hard test indices per dataset (reference show_rainbow2.py:174-233)
HARD_INDICES = {
    "MKT": [2328, 2614, 2661, 2700, 2835, 3012, 3152, 3213],
    "ATR": [91, 181, 271, 361, 451, 541, 631, 721],
    "CUB": [0, 1, 2, 3, 4, 5, 6, 7],
}
RAINBOW_STEP = 10  # degrees between the rainbow GIF's frames
BIASES = [v / 10.0 for v in range(-3, 4)]


def hard_indices(name: str) -> list[int]:
    return next((HARD_INDICES[k] for k in ("MKT", "ATR") if k in name), HARD_INDICES["CUB"])


def rainbow_frame(render, att, azimuth: float) -> np.ndarray:
    """One frame of the rainbow GIF: row i shows every image of ``att``
    with image i's texture, at ``azimuth``; the B x B views in one render."""
    B = att["azimuths"].shape[0]
    grid = {k: (None if v is None else v.repeat(B, *([1] * (v.dim() - 1))))
            for k, v in att.items()}  # view i * B + j: image j's ...
    grid["textures"] = att["textures"].repeat_interleave(B, dim=0)  # ... with texture i
    grid["azimuths"] = torch.full((B * B,), azimuth, device=att["azimuths"].device)
    rgb = render(**grid)[0][..., :3].cpu().numpy()
    H, W = rgb.shape[1:3]
    return rgb.reshape(B, B, H, W, 3).transpose(0, 2, 1, 3, 4).reshape(B * H, B * W, 3)


def main(argv=None, device="cuda", draws=None):
    """-> {"images": the batch's size, "seconds"}.  ``draws``: the random
    view's azimuths (B,) in place of the generator's."""
    device = resolve_device(device)
    opt = eval_options(argv)
    dataset = pick_dataset(opt)
    batch = [dataset[i % len(dataset)] for i in hard_indices(opt.name)]
    Xa = torch.as_tensor(np.stack([b["images"] for b in batch]), device=device)
    rec = load_reconstructor(opt, device)
    dr = rec.diff_render

    @_no_tf32()
    @torch.inference_mode()
    def render(**a):
        return dr.render(**a)

    seconds, out = {}, opt.outf
    os.makedirs(out, exist_ok=True)
    t0 = clock(device)
    az = None if draws is None else torch.as_tensor(draws, dtype=torch.float32, device=device)
    Xer, Xir, *_, Ae = rec(Xa, random_azimuths=az,
                           generator=torch.Generator(device=device).manual_seed(0))
    att = deep_copy(Ae, detach=True)
    B = att["azimuths"].shape[0]
    rainbow = [to_uint8(rainbow_frame(render, att, -float(azi)))
               for azi in range(0, 360, RAINBOW_STEP)]
    bias_frames = []
    for v in BIASES:
        att_b = dict(att, biases=torch.full((B, 2), v, device=device))
        bias_frames.append(to_uint8(make_grid(render(**att_b)[0][..., :3].cpu().numpy())))
    seconds["encode_render"] = clock(device) - t0

    t0 = time.perf_counter()
    Xa_np, Xer_np, Xir_np = (t[..., :3].cpu().numpy() for t in (Xa, Xer, Xir))
    save_image_grid(Xa_np, f"{out}/rainbow_Xa.png")
    save_image_grid(Xer_np, f"{out}/rainbow_Xer.png")
    save_image_grid(Xir_np, f"{out}/rainbow_Xir.png")
    save_array_image(Ae["textures"][0].cpu().numpy(), f"{out}/rainbow_texture.png")
    save_mesh(f"{out}/rainbow_mesh.obj", Ae["vertices"][0].cpu().numpy(),
              dr.faces.cpu().numpy(), dr.uvs)
    write_gif(f"{out}/rainbow.gif", rainbow)
    write_gif(f"{out}/rainbow_bias.gif", bias_frames)
    seconds["file_writes"] = time.perf_counter() - t0
    # the sweeps render and write frame by frame
    t0 = time.perf_counter()
    azimuth_sweep(render, att, f"{out}/rainbow_rotation.gif", azi_scope=opt.azi_scope)
    elevation_sweep(render, att, f"{out}/rainbow_elevation.gif", elev_range=opt.elev_range)
    distance_sweep(render, att, f"{out}/rainbow_distance.gif", dist_range=opt.dist_range)
    seconds["sweeps"] = time.perf_counter() - t0
    print("rainbow artifacts written to", out)
    report_seconds("show_rainbow2", seconds, B)
    return {"images": B, "seconds": seconds}


if __name__ == "__main__":
    main()
