"""Time the masked texture kernel's body by level: the port of
``benchmarks/bench_texcells_parts.py`` together with the camera sweep of
``benchmarks/dump_uv.py``.

    python3 -m magicmirror_torch.benchmarks.texture_parts

``uv_sweep`` renders ``template/sphere.obj`` under dump_uv's attributes (8
repetitions of 16 cameras drawn from ``np.random.RandomState(0)``) through
the rasterizer (``ops.rasterize.rasterize_fused``: K1 on the card) and keeps
the uv and the hard coverage in memory, the uv rounded through float16 as
dump_uv stores it.  ``main`` takes the first 32 images at 256^2 (the
probe's shape) and at 128^2 (the train step's), a random float32 texture
(2S, S, 3), and prints :func:`time_levels` for
``ops.sampling.texture_parts`` at levels 1, 4 and 5 (1: the mask read and
zeros written; 4: the uv, the taps and their weights too, zeros written; 5:
the whole masked bilinear sample, the texture kernel itself) and for
``F.grid_sample`` times the mask at level 5's shape.  It prints the covered
pixels per image (the TPU probe printed its live chunks per image) and one
JSON line per level.
Needs a CUDA device.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels, resolve_device
from ..ops.rasterize import rasterize_fused
from ..ops.sampling import TEXTURE_PARTS_LEVELS, texture_parts
from ..render.renderer import DiffRender
from .timing import burst_ms, card, clone_inputs, cold_copies, graph_ms
from .timing import bound_ms as work_bound_ms

SPHERE = Path(__file__).resolve().parents[2] / "template" / "sphere.obj"
BATCH, SIZES = 32, (256, 128)
# dump_uv's camera distance ranges, one per repetition in turn
DISTANCE_RANGES = ((2, 4), (2, 2.5), (2, 7), (3, 7))
FLOPS_PER_COVERED_PIXEL = 42  # the bilinear sample, counted from csrc/texture_fwd.cu


@torch.no_grad()
def uv_sweep(size: int = 256, device="cuda", reps: int = 8):
    """dump_uv's sweep, its first ``reps`` repetitions of 16 cameras ->
    (uv (16 reps, S, S, 2), hard (16 reps, S, S)), float32 on ``device``."""
    batch = 16
    dr = DiffRender(str(SPHERE), size, device=device)
    v0 = dr.vertices_init.cpu().numpy()
    rng = np.random.RandomState(0)
    uvs, hards = [], []
    for rep in range(reps):
        lo, hi = DISTANCE_RANGES[rep % 4]
        distances = rng.uniform(lo, hi, batch)
        att = {"azimuths": rng.uniform(-180, 180, batch),
               "elevations": rng.uniform(0, 30, batch),
               "distances": distances,
               "biases": rng.uniform(-0.2, 0.2, (batch, 2)),
               "vertices": v0[None] + rng.uniform(-0.08, 0.08, (batch, v0.shape[0], 3))}
        att = {k: torch.as_tensor(np.asarray(v, np.float32), device=dr.faces.device)
               for k, v in att.items()}
        fvc, fvi, fn = dr.project(att)
        _, _, uv, _, hard = rasterize_fused(fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn,
                                            sigmainv=dr.sigmainv, height=size, width=size)
        uvs.append(uv.half().float())
        hards.append(hard)
    return torch.cat(uvs), torch.cat(hards)


def random_texture(batch: int, size: int, device):
    """The probe's texture: U(0, 1) of (batch, 2S, S, 3), float32, from
    ``np.random.RandomState(0)``."""
    tex = np.random.RandomState(0).rand(batch, 2 * size, size, 3).astype(np.float32)
    return torch.as_tensor(tex, device=device)


def probe(uv, hard, tex, levels=TEXTURE_PARTS_LEVELS) -> dict:
    """The probe's path: one launch per level -> {level: output}."""
    return {level: texture_parts(uv, tex, hard, level) for level in levels}


def grid_sample_masked(uv, hard, tex):
    """The one PyTorch call that computes level 5: ``F.grid_sample`` at
    kaolin's uv convention on the NCHW view of the texture, times the mask
    -> (B, 3, H, W); with ``hard`` None the unmasked sampler's call."""
    uvc = uv.clamp(0.0, 1.0)
    grid = torch.stack([uvc[..., 0] * 2.0 - 1.0, -(uvc[..., 1] * 2.0 - 1.0)], dim=-1)
    out = F.grid_sample(tex.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out if hard is None else out * hard[:, None]


def texels_touched(uv, hard, tex) -> int:
    """The distinct texels that the four taps of the sampled pixels fall on
    (every pixel when ``hard`` is None, else those with hard > 0.5), taps
    outside the texture left out: in the sampler's own arithmetic
    (``csrc/texture_fwd.cu``)."""
    B, Ht, Wt = tex.shape[0], tex.shape[1], tex.shape[2]
    u = uv[..., 0].clamp(0.0, 1.0)
    v = uv[..., 1].clamp(0.0, 1.0)
    x0 = torch.floor(((u * 2.0 - 1.0 + 1.0) * Wt - 1.0) * 0.5).long()
    y0 = torch.floor(((-(v * 2.0 - 1.0) + 1.0) * Ht - 1.0) * 0.5).long()
    b = torch.arange(B, device=uv.device).view(B, 1, 1).expand_as(x0)
    if hard is not None:
        keep = hard > 0.5
        b, x0, y0 = b[keep], x0[keep], y0[keep]
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = y0 + dy, x0 + dx
            inside = (x >= 0) & (x < Wt) & (y >= 0) & (y < Ht)
            taps.append(((b * Ht + y) * Wt + x)[inside])
    return int(torch.unique(torch.cat(taps)).numel())


def texture_bytes(uv, hard, tex, level: int = 5, backward: bool = False) -> int:
    """The bytes a launch of the texture sampler must move, each input read
    where the kernel needs it and each output written once.  Forward (masked
    when ``hard`` is given): the mask at every pixel, the uv where a pixel
    is sampled, 12 B for each texel the taps touch, 12 B of output at every
    pixel; below level 4 only the mask and the output.  Backward: the mask,
    and g and the uv where sampled, the touched texels, 8 B of d_uv at every
    pixel and the whole d_texture."""
    P = uv.shape[0] * uv.shape[1] * uv.shape[2]
    mask = 4 * P if hard is not None else 0
    if level < 4:
        return mask + 12 * P
    sampled = P if hard is None else int((hard > 0.5).sum().item())
    texels = 12 * texels_touched(uv, hard, tex)
    if backward:
        return mask + 20 * sampled + texels + 8 * P + tex.numel() * 4
    return mask + 8 * sampled + texels + 12 * P


def bound_ms(level: int, uv, hard, tex) -> tuple[float, str]:
    """The least time the card could take for one launch at ``level``: the
    larger of its bytes (:func:`texture_bytes`) over the memory rate and its
    operations over the fp32 rate -> (ms, "bytes" or "operations")."""
    flops = int((hard > 0.5).sum().item()) * FLOPS_PER_COVERED_PIXEL if level >= 4 else 0
    return work_bound_ms(texture_bytes(uv, hard, tex, level), flops)


def time_levels(uv, hard, tex) -> dict:
    """Each level's time and bound on these inputs, and ``F.grid_sample`` times
    the mask at level 5: ``ms`` a burst of 100 launches from Python,
    ``warm_ms`` / ``cold_ms`` the device alone (:func:`graph_ms`) with the
    inputs kept in the L2 / read from device memory: as many copies of the
    inputs, taken in turn, as make the bytes the level reads
    (:func:`texture_bytes` less the output) three times the L2."""
    inputs, out_bytes = (uv, hard, tex), hard.numel() * 12
    n = {level: cold_copies(texture_bytes(uv, hard, tex, level) - out_bytes)
         for level in TEXTURE_PARTS_LEVELS}
    copies = clone_inputs(inputs, max(n.values()))
    t = {}
    for level in TEXTURE_PARTS_LEVELS:
        runs = [lambda u=u, h=h, x=x: texture_parts(u, x, h, level) for u, h, x in copies]
        t[f"level{level}_ms"] = burst_ms(runs[0])
        t[f"level{level}_warm_ms"] = graph_ms(runs[:1], kernels.LAUNCHES)
        t[f"level{level}_cold_ms"] = graph_ms(runs[:n[level]], kernels.LAUNCHES)
        t[f"level{level}_cold_copies"] = n[level]
        t[f"level{level}_bound_ms"], t[f"level{level}_bound_by"] = bound_ms(level, *inputs)
    # grid_sample reads at least what level 5 reads
    library = [lambda u=u, h=h, x=x: grid_sample_masked(u, h, x) for u, h, x in copies]
    t["level5_library_ms"] = burst_ms(library[0])
    t["level5_library_warm_ms"] = graph_ms(library[:1], kernels.LAUNCHES)
    t["level5_library_cold_ms"] = graph_ms(library[:n[5]], kernels.LAUNCHES)
    return t


def main():
    device = resolve_device("cuda")
    for size in SIZES:
        uv, hard = uv_sweep(size=size, device=device)
        uv, hard = uv[:BATCH].contiguous(), hard[:BATCH].contiguous()
        tex = random_texture(BATCH, size, device)
        covered = hard.reshape(BATCH, -1).sum(dim=1)
        shape = f"b{BATCH}/{size}^2"
        print(json.dumps({"card": card(), "shape": shape,
                          "covered_pixels_per_image": {"mean": float(covered.mean()),
                                                       "min": int(covered.min()),
                                                       "max": int(covered.max())},
                          "texels_touched": texels_touched(uv, hard, tex)}), flush=True)
        t = time_levels(uv, hard, tex)
        for level in TEXTURE_PARTS_LEVELS:
            print(json.dumps({"shape": shape, "level": level,
                              **{k.split("_", 1)[1]: v for k, v in t.items()
                                 if k.startswith(f"level{level}_")}}), flush=True)


if __name__ == "__main__":
    main()
