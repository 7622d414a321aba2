"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results on its own line; any failure exits
nonzero (nothing is caught, and there is no CPU fallback).  Three
configurations are driven: the defaults (sphere.obj, 128^2, soft_mode line),
"market_smpl" (the human-body recipe: smpl_uv.obj, 13,776 faces, ratio 2,
renders 128x64) and "cub_exact" (the defaults with soft_mode exact).
  1. toolchain: torch, CUDA, the card, nvcc, nvidia-smi's name and power limit;
  2. build: compile magicmirror_torch/csrc with nvcc;
  3. kernel parity on the card, each kernel against its plain PyTorch version:
     the 'line' rasterizer at the bench.py shape (b32, 256^2, sphere.obj) and
     at b32 and b4 / 128^2, the masked texture kernel on its outputs, the rasterizer's
     plain mode, the two backward kernels (random cotangent and the one a
     reconstruction loss produces; at b4 the whole backward of both autograd
     Functions against autograd of the plain path); the same two rasterizer
     kernels on the dense template at b32, 128x64 and 256^2, near and far
     cameras (counted under their dense names, nothing dropped, timed, with
     the share of the all-faces scan); the 'exact' soft mode, fused and
     plain, at the same three shapes, with its autograd backward at b4;
     the unmasked texture mode, forward and backward; the rasterizer's
     tiles where they work hardest (a tile that thousands of faces reach,
     survivors from every 256-face pass, a cotangent on every pixel, and
     the plain mode's sumlog itself on covered pixels); and K9c, the probe of
     the masked texture kernel's body by level (1, 4, 5), on the first 32
     images of dump_uv's camera sweep at 256^2 and 128^2: zeros below level
     5, level 5 the texture kernel's output bit for bit, timed by bursts of
     100 launches (magicmirror_torch/benchmarks/texture_parts.py); and the
     texture backward's stress cases against its plain version (every
     pixel on one texel, uv exactly 0 and 1, taps across the borders of the
     bands of rows that the kernel's blocks zero);
  4. the serving slice of each configuration: the full-width encoder (random
     weights from a seed, BatchNorm statistics re-estimated on the smoke
     batch) serving b4 synthetic RGBA photos through Reconstructor, plus a
     36-view turntable; the launch counters must show the configuration's
     kernels on that path and nothing dropped; the same slice with the same
     weights on the CPU must agree; for each of the five views, the faces
     that face the camera on one device only and the alpha differences;
  5. the training slice: for the defaults one D-then-G step at b4 on the card
     against the same step (weights, photos, draws; dropout off) on the CPU;
     then for each configuration 8 to 24 steps at b32 with dropout on: finite
     metrics, no skipped side, nothing dropped, a falling reconstruction
     loss, and the configuration's kernels launched twice a step each;
  6. timing: every kernel on the device alone, warm and cold, with its
     bound for these inputs and the library call where there is one
     (magicmirror_torch/benchmarks/kernel_times.py: CUDA-graph replays);
     the plain versions, the fused forward's wrapper as one launch and the
     'exact' mode's autograd backward with CUDA events (median after
     warm-up); for each configuration the serving step and the train step
     with its parts at b32;
  7. with ``--profile STEPS`` only: torch.profiler over STEPS serving steps,
     STEPS train steps and STEPS critic updates alone at b32 / 128^2 of the
     default configuration: the device's busy share of the step, the kernel
     launches per step, and device ms by kernel group;
  8. the file front end of ``python train.py``: a CUB-layout tree of 64
     train and 16 test photos (masks as PNG, the RGB as JPEG)
     through ``python -m magicmirror_torch.cli.train`` at the default flags
     and --niter 1 (cli.train.main), into build/frontend_smoke: opts.yaml
     read back equal, the loss lines, 4 steps an epoch, SWA from epoch 0
     with its BatchNorm refresh, the eval with and without SWA, the
     artifacts and checkpoints, and the launches of K1-K4 the run must make;
  9. the trainer (train.trainer.trainer) resumed from that run's checkpoint
     over the same loaders: the restore (into a fresh state first, tensor
     by tensor), one epoch with the EM template update and the BatchNorm
     refresh after it, the eval, the checkpoints, and the kernel launches;
 10. the evaluation and serving CLIs on that run (its checkpoint with SWA
     and best_mesh.obj, the tree's 16 test photos): cli.test (the fid/
     files, hist.png.npz, SSIM, mask-IoU, three FIDs; four photos' arrays
     held to a CPU run of the same eval step on the same checkpoint),
     show_camera, show_rainbow2 (the grids and five GIFs, their frames
     counted), single_img on one photo (its mask clean and salted),
     test_cub30 (12 bins, 12 FIDs), test_pck (keypoint files written for
     the photos) and test_thu (a THuman2 tree of the template's own renders
     and normals): each CLI's files, its seconds by part, and the K1 and K3
     launches of its renders;
 11. the three published recipes (docs/RECIPES.md: CUB, Market-HQ, ATR at
     160x96; --bg --hard, b48) through their CLIs (cli.train,
     cli.train_market, cli.train_atr2) at their own flags but --name,
     --dataroot and --niter 1, each over a tree of its dataset's layout
     written into build/recipes_smoke (96 train photos, 48 for CUB, and 16
     test photos: the template under random textures over a random
     background; the ATR split lists of the tree are read through
     ``data.atr._LIST_DIR``, pointed at them for the run): loss lines,
     opts.yaml, steps, artifacts, fid/ files, the kernel launches (three
     renders a step with the hard view, K2 and K4 where the step's
     train_shape leaves a gradient), the trained encoder's background; then
     serving and the train step of each recipe at b48 (fresh model), timed;
 12. the last entry points and tools: generate_market on the Market
     recipe's run (its 96 train photos, b48, 128x64) in each mode (the
     default, --texture_swap, --new_class9, --poisson): the files, K1 and K3
     four times a batch (nine in the new-class mode), and one batch of four
     photos card vs CPU; template_animation on the front end's run (one
     hard-mode render, sigmainv 1e6, a template) with those renders, and K1
     at 1e6 at b32, held to the plain versions; the data preparation,
     data/native.py, the Poisson blend and cli.tools on trees written into
     build/tools_smoke, each output held to a second computation in numpy.
 13. the off-default options, three sets at full width: the defaults with
     --norm ibn --makeup 2 --nolpl --inv 0.5 --gan_type lsgan --dis1 0.1
     --dis2 0.1 --lambda_lc 0.1; the defaults with --norm ln --makeup 5
     --sn_dis 1 --adamw (amsgrad off) --wd 1e-4; the Market recipe with
     --norm in --makeup 1 --hmr 1 (body meshes: smpl_uv.obj's vertices under
     a seeded jitter): a serving step (K1 and K3 five times), 8 train steps
     with dropout on (finite, nothing skipped or dropped, the default step's
     launches), one step at b4 card vs CPU, and the serving, train-step and
     D-update times.
Phase 3 also holds K1-K4 at the recipes' shapes at b48 (128^2, 128x64,
160x96) against their plain versions, and phase 5 one step of the Market
recipe at b4, 128x64, on the card against the CPU.

Order: 1-3, then the timing alone on the card (6, 7, the recipes' and the
option sets' times, each on a fresh model); then the rest side by side,
each lane a process of its own (``--lane``, internal): the slices (4-5;
the dense template's and the 'exact' mode's in a lane of their own), the
front end with the trainer and the eval CLIs (8-10), the recipes' runs
(11), after the dense slices the three option sets' checks (13), and after
the front end and the recipes the tools (12).  Lines of a lane carry its name; ``phase_seconds`` lines give
each phase's seconds and the FID distances' share of them (scipy's sqrtm
on the host).
The line before the last is the kernels' JSON summary (``ms`` and
``library_ms`` are cold device times, ``warm_ms`` warm ones, ``plain_ms``
CUDA events around the plain version); the last line is
{"ok": true, "device": {...}}.  Imports torch, numpy and magicmirror_torch
only.
"""
import argparse
import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")

from magicmirror_torch import kernels, parity  # noqa: E402
from magicmirror_torch.cli import generate_market as cli_generate_market  # noqa: E402
from magicmirror_torch.cli import show_camera as cli_show_camera  # noqa: E402
from magicmirror_torch.cli import show_rainbow2 as cli_show_rainbow2  # noqa: E402
from magicmirror_torch.cli import single_img as cli_single_img  # noqa: E402
from magicmirror_torch.cli import template_animation as cli_template_animation  # noqa: E402
from magicmirror_torch.cli import test as cli_test  # noqa: E402
from magicmirror_torch.cli import test_cub30 as cli_test_cub30  # noqa: E402
from magicmirror_torch.cli import test_pck as cli_test_pck  # noqa: E402
from magicmirror_torch.cli import test_thu as cli_test_thu  # noqa: E402
from magicmirror_torch.cli import tools as cli_tools  # noqa: E402
from magicmirror_torch.cli import train as cli_train  # noqa: E402
from magicmirror_torch.cli import train_atr2 as cli_train_atr2  # noqa: E402
from magicmirror_torch.cli import train_market as cli_train_market  # noqa: E402
from magicmirror_torch.configs import flags  # noqa: E402
from magicmirror_torch.configs.recipes import CLI_DEFAULTS, RECIPES, recipe_flags  # noqa: E402
from magicmirror_torch.data import atr as atr_data  # noqa: E402
from magicmirror_torch.data import native, prepare  # noqa: E402
from magicmirror_torch.eval import fid as fid_module  # noqa: E402
from magicmirror_torch.eval.images import (decode_png, encode_png, read_image,  # noqa: E402
                                           save_array_image, to_uint8)
from magicmirror_torch.eval.poisson import poisson_edit  # noqa: E402
from magicmirror_torch.geometry import mesh as mesh_ops  # noqa: E402
from magicmirror_torch.geometry.obj_io import load_obj  # noqa: E402
from magicmirror_torch.kernels import build  # noqa: E402
from magicmirror_torch.losses import recon  # noqa: E402
from magicmirror_torch.models.attribute_encoder import (CAMERA_FROZEN,  # noqa: E402
                                                       SHAPE_FROZEN, TEXTURE_FROZEN)
from magicmirror_torch.models.convert import init_from_seed  # noqa: E402
from magicmirror_torch.ops.face_rows import (DENSE_THRESHOLD,  # noqa: E402
                                             coeffs13, face_cull, face_rows)
from magicmirror_torch.ops.rasterize import (dibr_rasterization, pixel_grid,  # noqa: E402
                                             raster_bwd, raster_fwd, raster_fwd_plain,
                                             rasterize_fused, rasterize_fused_plain,
                                             rasterize_phase1, rasterize_plain,
                                             soft_backward_autograd, soft_backward_plain)
from magicmirror_torch.ops.shading import spherical_harmonic_lighting  # noqa: E402
from magicmirror_torch.ops.sampling import (TEXTURE_PARTS_LEVELS,  # noqa: E402
                                            texture_backward_plain,
                                            texture_bwd, texture_fwd, texture_mapping_plain,
                                            texture_render, texture_render_plain)
from magicmirror_torch.render import renderer as renderer_module  # noqa: E402
from magicmirror_torch.render.renderer import DiffRender  # noqa: E402
from magicmirror_torch.render.synthetic import (bench_attributes,  # noqa: E402
                                               smooth_random, to_torch)
from magicmirror_torch.serve import (Reconstructor, ServeOptions, _no_tf32,  # noqa: E402
                                     build_models, estimate_bn_stats, preset_options)
from magicmirror_torch.benchmarks import kernel_times  # noqa: E402
from magicmirror_torch.benchmarks import texture_parts as probe_bench  # noqa: E402
from magicmirror_torch.benchmarks.kernel_times import (live_pairs, raster_work,  # noqa: E402
                                                        work_bound)
from magicmirror_torch.benchmarks.timing import burst_ms  # noqa: E402
from magicmirror_torch.train import (TrainOptions, build_trainer, sample_draws,  # noqa: E402
                                     train_options)
from magicmirror_torch.train.checkpoints import CheckpointManager  # noqa: E402
from magicmirror_torch.train.trainer import _train_shape_policy  # noqa: E402
from magicmirror_torch.train.trainer import trainer as run_trainer  # noqa: E402
from magicmirror_torch.train.train_step import (METRIC_KEYS, e_outputs,  # noqa: E402
                                                running_statistics, update_d, update_e)

ROOT = os.path.dirname(os.path.abspath(__file__))
SPHERE = os.path.join(ROOT, "template", "sphere.obj")
SMPL = os.path.join(ROOT, "template", "smpl_uv.obj")
# the three configurations: name -> (preset of serve.PRESETS or None, template,
# the launches of one serving render, the launches of one train step)
CONFIGS = {
    "default": (None, SPHERE, {"raster_fwd": 1, "texture_fwd": 1},
                {"raster_fwd": 2, "texture_fwd": 2, "raster_bwd": 2, "texture_bwd": 2}),
    "market_smpl": ("market_smpl", SMPL, {"raster_fwd_dense": 1, "texture_fwd": 1},
                    {"raster_fwd_dense": 2, "texture_fwd": 2, "raster_bwd_dense": 2,
                     "texture_bwd": 2}),
    "cub_exact": ("cub_exact", SPHERE, {"raster_exact_fused": 1, "texture_unmasked_fwd": 1},
                  {"raster_exact_fused": 2, "texture_unmasked_fwd": 2,
                   "texture_unmasked_bwd": 2}),
}
# train steps at b32 per configuration (a step of "cub_exact" takes seconds:
# its silhouette backward is autograd of the plain phase 1; market_smpl's loss
# falls slowly, ROADMAP §3.2: 12 steps fell 1.1%, too close to the check)
TRAIN_STEPS = {"default": 12, "market_smpl": 24, "cub_exact": 8}
# the script's start: a lane process counts its lines' ``t`` from its parent's
START = float(os.environ.get("CHIP_SMOKE_START", time.time()))
T0 = time.perf_counter() - (time.time() - START)


def options(cls, config, **overrides):
    preset, template, _, _ = CONFIGS[config]
    if preset is None:
        return cls(template_path=template, **overrides)
    return preset_options(cls, preset, template_path=template, **overrides)


def shape_of(dr, batch):
    return f"b{batch}/{dr.render_height}x{dr.render_width}"
DEV = torch.device("cuda:0")
SEED = 0


def require(ok, what):
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def emit(phase, **fields):
    """One result line; ``t`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T0, 1), **fields}),
          flush=True)


# host seconds spent in the Frechet distances (scipy's sqrtm, in processes of
# their own) of every FID: the share of each phase that phase_time reports
FID_SECONDS = [0.0]
_frechet_distances = fid_module.frechet_distances


def _timed_frechet_distances(ref_stats, stats):
    t0 = time.perf_counter()
    try:
        return _frechet_distances(ref_stats, stats)
    finally:
        FID_SECONDS[0] += time.perf_counter() - t0


fid_module.frechet_distances = _timed_frechet_distances


class Laps:
    """``lap(name)`` emits the seconds since the previous lap (or since
    ``start``, a ``time.perf_counter()``; by default now) as the phase
    ``name``'s, with the FID distances' seconds in them and their share."""

    def __init__(self, start=None):
        self.t = time.perf_counter() if start is None else start
        self.fid = FID_SECONDS[0]

    def __call__(self, name):
        t, fid = time.perf_counter(), FID_SECONDS[0]
        seconds, fid_s = t - self.t, fid - self.fid
        self.t, self.fid = t, fid
        emit("phase_seconds", name=name, seconds=seconds, fid_s=fid_s,
             fid_share=fid_s / seconds if seconds else 0.0)


def cuda_ms(fn, warmup=3, iters=20):
    """Median milliseconds of ``fn`` over ``iters`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_GEMM_WORDS = ("conv", "gemm", "cudnn", "xmma", "cutlass", "fft", "winograd", "complex",
               "sm80_", "sm90_")


def _kernel_group(name):
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "memcpy_memset"
    for kernel in kernels.LAUNCHES:
        if f"{kernel}_kernel" in name:
            return kernel
    return "conv_gemm" if any(w in low for w in _GEMM_WORDS) else "elementwise_bn_copy"


def profile(fn, steps):
    """torch.profiler over ``steps`` runs of ``fn``, per step: wall ms (with
    the profiler on), device busy ms (the union of the device intervals) and
    share, kernel launches, and device ms and launches by kernel group."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    require(device, "the profiler saw no device activity")
    busy_us, end = 0.0, float("-inf")
    for e in device:  # union of the intervals
        start, stop = max(e.time_range.start, end), e.time_range.end
        busy_us += max(stop - start, 0.0)
        end = max(end, stop)
    groups, top = {}, {}
    for e in device:
        g = groups.setdefault(_kernel_group(e.name), {"ms": 0.0, "launches": 0})
        g["ms"] += e.time_range.elapsed_us() / 1e3 / steps
        g["launches"] += 1
        top[e.name[:80]] = top.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    for g in groups.values():
        g["launches"] /= steps
    return {"steps": steps, "wall_ms": wall_ms / steps, "busy_ms": busy_us / 1e3 / steps,
            "busy_share": busy_us / 1e3 / wall_ms,
            "kernels": sum(g["launches"] for k, g in groups.items() if k != "memcpy_memset"),
            "groups": groups,
            "top10_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:10])}


def chain_to_vertices(fvi, G):
    """d_fvi of the backward kernel's moments through coeffs13's autograd."""
    fvi = fvi.detach().requires_grad_(True)
    (coeffs13(fvi) * G).sum().backward()
    return fvi.grad


def synthetic_photos(dr, batch, seed, elev_range="0~30"):
    """RGBA photos: the template under a smooth random texture, rendered at
    bench.py's camera distribution, its elevations U(0, 30) mapped onto the
    configuration's ``elev_range`` (what its camera encoder can answer)."""
    att = bench_attributes(dr.vertices_init.cpu().numpy(), batch, dr.image_size, seed)
    if elev_range != "0~30":
        lo, hi = (float(v) for v in elev_range.split("~"))
        att["elevations"] = (lo + (hi - lo) * att["elevations"] / 30.0).astype("float32")
    att["textures"] = smooth_random((batch, 2 * dr.render_height, dr.render_width, 3), seed)
    with torch.no_grad():
        return dr.render(**to_torch(att, dr.vertices_init.device))[0]


def raster_case(size, batch, seed, template=SPHERE, height=None, distances=None):
    """The bench.py attribute distribution projected for the rasterizer; a
    render taller than wide is the Market shape (ratio = height / size with
    ellipsoid 2); ``distances`` = (lo, hi) replaces bench.py's U(2, 4)."""
    height = height or size
    dr = DiffRender(template, size, ratio=height / size,
                    init_ellipsoid=2.0 if height != size else 1.0, device=DEV)
    att = bench_attributes(dr.vertices_init.cpu().numpy(), batch, size, seed, height=height)
    if distances is not None:
        lo, hi = distances
        att["distances"] = (lo + (hi - lo) * (att["distances"] - 2.0) / 2.0).astype("float32")
    att = to_torch(att, DEV)
    fvc, fvi, fn = dr.project(att)
    return (fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn), att["textures"]


def once_ms(fn):
    """Milliseconds of one run of ``fn`` (CUDA events) -> (ms, result): for
    the plain versions that take seconds."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def dense_parity(height, width, distances, card, errs):
    """K1's and K2's kernels on the dense template (smpl_uv.obj, 13,776
    faces) at b32 against their plain versions, timed, with their bounds for
    these inputs and the time of the all-faces scan alone (the same launch on
    rows that all face away: every tile stages every chunk and finds nothing
    live) -> the timing dict."""
    B = 32
    args, _ = raster_case(width, B, SEED + height + int(10 * distances[1]), SMPL, height,
                          distances)
    fvi, fz, fnz = args[0], args[1], args[2]
    rows = face_rows(*args).contiguous()
    kernels.reset_launches()
    out = raster_fwd(rows, 7000.0, height, width)
    plain_ms, plain = once_ms(lambda: rasterize_fused_plain(*args, height=height, width=width))
    stats = parity.raster_stats(out, plain)
    _, _, dropped = rasterize_plain(fvi, fz, fnz, height=height, width=width)
    stats["dropped"] = int(dropped.sum())
    shape = f"b{B}/{height}x{width}/smpl_uv/dist{distances[0]:g}-{distances[1]:g}"
    # 128x64 is held like any template.  At 256^2 the all-faces sum is wider
    # (parity.py), and the sum over the faces the tiles keep shows why
    uncut = height == 256
    if uncut:
        culled = rasterize_fused_plain(*args, height=height, width=width, tile_cull=True)
        stats["soft_max_vs_tile_culled_plain"] = float((out[1] - culled[1]).abs().max())
        stats["margin_cut_max"] = float((plain[1] - culled[1]).abs().max())
        del culled
    emit("parity_raster_dense", shape=shape, **stats)
    parity.check_raster(stats, dense_uncut=uncut)
    require(stats.get("soft_max_vs_tile_culled_plain", 0.0) <= parity.RASTER_TOL["soft"], stats)
    require(stats["dropped"] == 0, stats)
    errs["raster_fwd_dense"] = max(errs["raster_fwd_dense"], stats["soft_max"],
                                   stats["normal_max"], stats["uv_max"])
    gen = torch.Generator(device=DEV).manual_seed(SEED + height)
    g_soft = torch.randn(out[1].shape, device=DEV, generator=gen)
    g_sumlog = (g_soft * (out[1] - 1.0)).reshape(B, -1).contiguous()
    G = raster_bwd(rows, g_sumlog, 7000.0, height, width)
    require({k: v for k, v in kernels.LAUNCHES.items() if v}
            == {"raster_fwd_dense": 2, "raster_bwd_dense": 1}, kernels.LAUNCHES)
    plain_bwd_ms, G_plain = once_ms(lambda: soft_backward_plain(fvi, fnz, g_sumlog, 7000.0,
                                                               height, width))
    bstats = parity.raster_bwd_stats(G, G_plain, chain_to_vertices(fvi, G),
                                     chain_to_vertices(fvi, G_plain))
    emit("parity_raster_bwd_dense", shape=shape, cotangent="random", **bstats)
    parity.check_raster_bwd(bstats)
    errs["raster_bwd_dense"] = max(errs["raster_bwd_dense"], float((G - G_plain).abs().max()))

    away = rows.clone()
    away[..., 25] = -1.0  # normal z: every face culled, only the scan is left
    cull, away_cull = face_cull(rows), face_cull(away)
    # single launches between CUDA events (the host's launch path included);
    # the device times are kernel_times' (phase 6)
    t = {"raster_fwd_dense_single_launch_ms": cuda_ms(
             lambda: raster_fwd(rows, 7000.0, height, width, cull=cull)),
         "raster_fwd_dense_scan_only_ms": cuda_ms(lambda: raster_fwd(away, 7000.0, height,
                                                                     width, cull=away_cull)),
         "raster_fwd_dense_plain_ms": plain_ms,
         "raster_bwd_dense_single_launch_ms": cuda_ms(
             lambda: raster_bwd(rows, g_sumlog, 7000.0, height, width, cull)),
         "raster_bwd_dense_scan_only_ms": cuda_ms(lambda: raster_bwd(away, g_sumlog, 7000.0,
                                                                     height, width, away_cull)),
         "raster_bwd_dense_plain_ms": plain_bwd_ms,
         "face_rows_ms": cuda_ms(lambda: face_cull(face_rows(*args).contiguous()))}
    work = {"raster_fwd": raster_work(rows, height, width),
            "raster_bwd": raster_work(rows, height, width, g_sumlog)}
    for name, (nbytes, units) in work.items():
        t[f"{name}_dense_bound_ms"], t[f"{name}_dense_bound_by"] = work_bound(name, nbytes, units)
    # the busiest tile: how far the far camera piles the faces up
    live = live_pairs(rows, height, width, per_tile=True)
    emit("timing_dense", shape=shape, card=card, covered_pixels=int(out[4].sum()),
         pairs=work["raster_fwd"][1], pairs_bwd=work["raster_bwd"][1],
         busiest_tile_faces=int(live.max()), mean_tile_faces=float(live.mean()), **t)
    return t


def exact_parity(size, batch, errs):
    """The 'exact' soft mode, fused and plain instantiation, against the
    plain 'exact' path; at b4 the backward (autograd of the plain phase 1 by
    chunks, and the winner's interpolation) of the fused and the two-phase
    form against autograd of the whole plain path."""
    shape = f"b{batch}/{size}^2"
    args, _ = raster_case(size, batch, SEED + size)
    fvi, fz, fnz = args[0], args[1], args[2]
    kernels.reset_launches()
    out = rasterize_fused(*args, height=size, width=size, soft_mode="exact")
    plain = rasterize_fused_plain(*args, height=size, width=size, soft_mode="exact")
    stats = parity.raster_stats(out, plain)
    line_soft = rasterize_fused(*args, height=size, width=size)[1]
    stats["soft_vs_line_max"] = float((out[1] - line_soft).abs().max())
    emit("parity_raster_exact_fused", shape=shape, **stats)
    parity.check_raster(stats)
    require(stats["soft_vs_line_max"] > 1e-3, stats)  # the mode does change the silhouette
    errs["raster_exact_fused"] = max(errs["raster_exact_fused"], stats["soft_max"],
                                     stats["normal_max"], stats["uv_max"])
    idx, sumlog, dropped = rasterize_plain(fvi, fz, fnz, height=size, width=size,
                                           soft_mode="exact")
    px, py = pixel_grid(size, size, DEV)
    idx_p, sumlog_p = rasterize_phase1(px, py, fvi, fz, fnz, 7000.0, "exact")
    pstats = {"idx_mismatch": int((idx.long() != idx_p).sum()),
              "soft_max": float((torch.exp(sumlog) - torch.exp(sumlog_p)).abs().max()),
              "dropped": int(dropped.sum())}
    emit("parity_raster_exact", shape=shape, **pstats)
    require(pstats["idx_mismatch"] <= parity.RASTER_TOL["idx_frac"] * idx.numel(), pstats)
    require(pstats["soft_max"] <= parity.RASTER_TOL["soft"], pstats)
    require(pstats["dropped"] == 0, pstats)
    require({k: v for k, v in kernels.LAUNCHES.items() if v}
            == {"raster_exact_fused": 1, "raster_fwd": 1, "raster_exact": 1}, kernels.LAUNCHES)
    errs["raster_exact"] = max(errs["raster_exact"], pstats["soft_max"])
    if batch > 4:  # autograd of the plain rasterizer keeps every (pixel, face) temporary
        return
    gen = torch.Generator(device=DEV).manual_seed(SEED + size + 5)
    ws = [torch.randn(s_, device=DEV, generator=gen)
          for s_ in (out[1].shape, out[2].shape, out[3].shape)]
    grads = []
    for fn in (rasterize_fused, dibr_rasterization, rasterize_fused_plain):
        leaves = [a.detach().requires_grad_(True) for a in args]
        _, soft_, uv_, normal_, _ = fn(*leaves, height=size, width=size, soft_mode="exact")
        ((soft_ * ws[0]).sum() + (uv_ * ws[1]).sum() + (normal_ * ws[2]).sum()).backward()
        grads.append((leaves[0].grad, leaves[4].grad))
    rel = {name: [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g, grads[2])]
           for name, g in (("fused", grads[0]), ("two_phase", grads[1]))}
    emit("parity_raster_exact_backward", shape=shape, d_fvi_and_d_normals_rel=rel)
    require(max(max(v) for v in rel.values()) <= 1e-2, rel)


def unmasked_parity(size, batch, errs):
    """The unmasked texture mode, forward and backward, on the uv field of a
    render: uncovered pixels carry uv = 0 and are sampled like any other; the
    cotangent is the one the 'exact' render hands back, zero where nothing is
    covered (it multiplies the sample by the coverage).  A random cotangent on
    those pixels too would sum ~26,000 terms into the one texel under uv = 0,
    where the order of the float32 sum alone moves d_textures by 1e-5 of its
    largest value."""
    args, textures = raster_case(size, batch, SEED + size)
    _, _, uv, _, hard = rasterize_fused(*args, height=size, width=size)
    kernels.reset_launches()
    out = texture_fwd(uv, textures)
    err = float((out - texture_mapping_plain(uv, textures)).abs().max())
    g = torch.randn(out.shape, device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(SEED + size + 6))
    g = g * hard[..., None]
    kernel_out = texture_bwd(g, uv, textures)
    plain_out = texture_backward_plain(g, uv, textures)
    stats = parity.texture_bwd_stats(kernel_out, plain_out, torch.ones_like(uv[..., 0]))
    emit("parity_texture_unmasked", shape=f"b{batch}/{size}^2", max_abs=err, **stats)
    require(err <= parity.TEXTURE_TOL, err)
    parity.check_texture_bwd(stats)
    require({k: v for k, v in kernels.LAUNCHES.items() if v}
            == {"texture_unmasked_fwd": 1, "texture_unmasked_bwd": 1}, kernels.LAUNCHES)
    errs["texture_unmasked_fwd"] = max(errs["texture_unmasked_fwd"], err)
    errs["texture_unmasked_bwd"] = max(
        errs["texture_unmasked_bwd"],
        *(float((a - b).abs().max()) for a, b in zip(kernel_out, plain_out)))


def backward_parity(size, batch, args, textures, fwd_out, errs, height=None):
    """The backward kernels against their plain versions on the card's own
    forward outputs: with a random cotangent, and with the cotangent a
    reconstruction loss against another render produces; at b4 the whole
    backward of both autograd Functions against autograd of the plain path.
    ``height``: a render taller than ``size`` (raster_case's)."""
    H, W = height or size, size
    shape = f"b{batch}/{size}^2" if H == W else f"b{batch}/{H}x{W}"
    fvi, _, fnz = args[0], args[1], args[2]
    _, soft, uv, _, hard = fwd_out
    rows = face_rows(*args).contiguous()
    gen = torch.Generator(device=DEV).manual_seed(SEED + size)
    target, _ = raster_case(size, batch, SEED + size + 1, height=H)
    target_soft = rasterize_fused(*target, height=H, width=W)[1]
    leaf = soft.detach().requires_grad_(True)
    pred = torch.cat([torch.ones_like(leaf)[..., None].expand(-1, -1, -1, 3), leaf[..., None]], -1)
    gt = torch.cat([torch.ones_like(pred[..., :3]), target_soft[..., None]], -1)
    recon.recon_data(pred, gt).backward()
    cotangents = {"random": torch.randn(soft.shape, device=DEV, generator=gen),
                  "recon_data": leaf.grad}
    for what, g_soft in cotangents.items():
        g_sumlog = (g_soft * (soft - 1.0)).reshape(batch, -1).contiguous()
        G = raster_bwd(rows, g_sumlog, 7000.0, H, W)
        G_plain = soft_backward_plain(fvi, fnz, g_sumlog, 7000.0, H, W)
        stats = parity.raster_bwd_stats(G, G_plain, chain_to_vertices(fvi, G),
                                        chain_to_vertices(fvi, G_plain))
        emit("parity_raster_bwd", shape=shape, cotangent=what, **stats)
        parity.check_raster_bwd(stats)
        errs["raster_bwd"] = max(errs["raster_bwd"], float((G - G_plain).abs().max()))
    g_tex = torch.randn((batch, H, W, 3), device=DEV, generator=gen)
    kernel_out = texture_bwd(g_tex, uv, textures, hard)
    plain_out = texture_backward_plain(g_tex, uv, textures, hard)
    tstats = parity.texture_bwd_stats(kernel_out, plain_out, hard)
    emit("parity_texture_bwd", shape=shape, **tstats)
    parity.check_texture_bwd(tstats)
    errs["texture_bwd"] = max(errs["texture_bwd"],
                              *(float((a - b).abs().max()) for a, b in zip(kernel_out, plain_out)))
    if batch > 4:  # autograd of the plain rasterizer keeps every (pixel, face) temporary
        return
    ws = [torch.randn(s, device=DEV, generator=gen)
          for s in (soft.shape, uv.shape, (*soft.shape, 3))]
    grads = []
    for fn in (rasterize_fused, rasterize_fused_plain):
        leaves = [a.detach().requires_grad_(True) for a in args]
        _, soft_, uv_, normal_, _ = fn(*leaves, height=H, width=W)
        ((soft_ * ws[0]).sum() + (uv_ * ws[1]).sum() + (normal_ * ws[2]).sum()).backward()
        grads.append((leaves[0].grad, leaves[4].grad))
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(*grads)]
    emit("parity_rasterize_fused_backward", shape=shape, d_fvi_rel=rel[0],
         d_face_normals_rel=rel[1])
    # the winners of a few edge pixels differ between the kernel and the plain
    # version (parity.RASTER_TOL), and each moves a whole pixel's uv gradient
    require(max(rel) <= 1e-2, rel)
    leaves = [uv.detach().requires_grad_(True), textures.detach().requires_grad_(True)]
    texture_render(*leaves, hard).backward(g_tex)
    full = parity.texture_bwd_stats((leaves[0].grad, leaves[1].grad), plain_out, hard)
    emit("parity_texture_render_backward", shape=shape, **full)
    parity.check_texture_bwd(full)


def plain_mode_parity(size, batch, args, errs):
    """The forward kernel's plain mode (idx and sumlog only) behind
    rasterize_plain against rasterize_phase1, and its backward (the backward
    kernel again) against the plain moments."""
    fvi, fz, fnz = (a.detach() for a in args[:3])
    leaf = fvi.clone().requires_grad_(True)
    count = kernels.LAUNCHES["raster_fwd"], kernels.LAUNCHES["raster_bwd"]
    idx, sumlog, dropped = rasterize_plain(leaf, fz, fnz, height=size, width=size)
    px, py = pixel_grid(size, size, DEV)
    idx_p, sumlog_p = rasterize_phase1(px, py, fvi, fz, fnz, 7000.0)
    g = torch.randn(sumlog.shape, device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(SEED + size + 2))
    g_sumlog = g * torch.exp(sumlog_p)  # a cotangent on soft = 1 - exp(sumlog), negated
    (sumlog * g_sumlog).sum().backward()
    d_plain = chain_to_vertices(fvi, soft_backward_plain(fvi, fnz, g_sumlog.contiguous(),
                                                          7000.0, size, size))
    stats = {"idx_mismatch": int((idx.long() != idx_p).sum()),
             "soft_max": float((torch.exp(sumlog.detach()) - torch.exp(sumlog_p)).abs().max()),
             "d_fvi_rel": float((leaf.grad - d_plain).abs().max() / d_plain.abs().max()),
             "dropped": int(dropped.sum())}
    emit("parity_raster_plain_mode", shape=f"b{batch}/{size}^2", **stats)
    require(stats["idx_mismatch"] <= parity.RASTER_TOL["idx_frac"] * idx.numel(), stats)
    require(stats["soft_max"] <= parity.RASTER_TOL["soft"], stats)
    require(stats["d_fvi_rel"] <= parity.RASTER_BWD_TOL, stats)
    require(stats["dropped"] == 0, stats)
    require((kernels.LAUNCHES["raster_fwd"], kernels.LAUNCHES["raster_bwd"])
            == (count[0] + 1, count[1] + 1), kernels.LAUNCHES)
    errs["raster_fwd"] = max(errs["raster_fwd"], stats["soft_max"])


def far_case(template, height, width, batch, distance, seed):
    """bench.py's attributes with every camera at ``distance``: the farther
    the camera, the more of the template's faces reach one 16x16 tile."""
    ratio = height / width
    dr = DiffRender(template, width, ratio=ratio, init_ellipsoid=2.0 if ratio != 1 else 1.0,
                    device=DEV)
    att = bench_attributes(dr.vertices_init.cpu().numpy(), batch, width, seed, height=height)
    att["distances"][:] = distance
    fvc, fvi, fn = dr.project(to_torch(att, DEV))
    return fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn


def texture_bwd_stress(errs):
    """The texture backward kernel where it works hardest
    (``parity.texture_bwd_stress``: every pixel of an image on one texel,
    uv exactly 0 and 1, taps straddling the borders between the bands of
    rows that the kernel's blocks zero) at b32 / 128^2, against the plain
    version in the case's dtype (``parity.TEXTURE_BWD_STRESS``)."""
    rows = 256 // 8  # texture_bwd.cu: 8 blocks an image share its 256 texture rows
    for case, dtype in parity.TEXTURE_BWD_STRESS.items():
        g, uv, tex, mask = (None if a is None else torch.as_tensor(a, device=DEV)
                            for a in parity.texture_bwd_stress(case, 32, 128, rows, SEED + 33))
        out = texture_bwd(g, uv, tex, mask)
        ref = tuple(r.float() for r in texture_backward_plain(
            *(None if a is None else a.to(dtype) for a in (g, uv, tex, mask))))
        covered = mask if mask is not None else torch.ones_like(uv[..., 0])
        stats = parity.texture_bwd_stats(out, ref, covered)
        emit("parity_texture_bwd_stress", case=case, shape="b32/128^2", band_rows=rows,
             plain_dtype=str(dtype), **stats)
        parity.check_texture_bwd(stats)
        name = "texture_bwd" if mask is not None else "texture_unmasked_bwd"
        errs[name] = max(errs[name], *(float((a - b).abs().max()) for a, b in zip(out, ref)))


def stress_parity(errs):
    """The rasterizer kernels where their tiles work hardest, each against
    its plain version at the usual tolerances: a tile that thousands of
    faces reach (smpl_uv.obj from afar), tiles whose survivors span every
    256-face pass (sphere.obj from afar), each with a random cotangent on
    every pixel (so no tile leaves early), and the plain mode's sumlog
    itself on the covered pixels (parity.sumlog_stats)."""
    cases = (("every_face_reaches", SMPL, 128, 64, 4, 10.0),
             ("survivors_span_passes", SPHERE, 64, 64, 32, 10.0),
             ("cotangent_on_every_pixel", SPHERE, 128, 128, 32, None))
    for what, template, height, width, batch, distance in cases:
        if distance is None:
            args, _ = raster_case(width, batch, SEED + 31)
        else:
            args = far_case(template, height, width, batch, distance, SEED + 31)
        fvi, fnz = args[0], args[2]
        rows = face_rows(*args).contiguous()
        out = raster_fwd(rows, 7000.0, height, width)
        plain = rasterize_fused_plain(*args, height=height, width=width)
        stats = parity.raster_stats(out, plain)
        parity.check_raster(stats)
        g_sumlog = torch.randn((batch, height * width), device=DEV,
                               generator=torch.Generator(device=DEV).manual_seed(SEED + 31))
        G = raster_bwd(rows, g_sumlog, 7000.0, height, width)
        G_plain = soft_backward_plain(fvi, fnz, g_sumlog, 7000.0, height, width)
        bstats = parity.raster_bwd_stats(G, G_plain, chain_to_vertices(fvi, G),
                                         chain_to_vertices(fvi, G_plain))
        busiest = int(live_pairs(rows, height, width, per_tile=True).max())
        emit("parity_raster_stress", case=what, shape=f"b{batch}/{height}x{width}",
             busiest_tile_faces=busiest, **stats, **{f"bwd_{k}": v for k, v in bstats.items()})
        parity.check_raster_bwd(bstats)
        require(busiest >= {"every_face_reaches": 4096, "survivors_span_passes": 257}.get(
            what, 1), busiest)
        fwd = "raster_fwd_dense" if template == SMPL else "raster_fwd"
        errs[fwd] = max(errs[fwd], stats["soft_max"], stats["normal_max"], stats["uv_max"])
        bwd = "raster_bwd_dense" if template == SMPL else "raster_bwd"
        errs[bwd] = max(errs[bwd], float((G - G_plain).abs().max()))
    args = far_case(SPHERE, 128, 128, 32, 3.0, SEED + 32)
    fvi, fz, fnz = args[0], args[1], args[2]
    idx, sumlog = raster_fwd_plain(face_rows(*args).contiguous(), 7000.0, 128, 128)
    px, py = pixel_grid(128, 128, DEV)
    idx_p, sumlog_p = rasterize_phase1(px, py, fvi, fz, fnz, 7000.0)
    stats = parity.sumlog_stats(sumlog, sumlog_p, idx_p, (px, py, fvi, fz, fnz), 7000.0)
    stats["idx_mismatch"] = int((idx.long() != idx_p).sum())
    emit("parity_raster_plain_mode_sumlog", shape="b32/128^2", **stats)
    parity.check_sumlog(stats)
    require(stats["idx_mismatch"] <= parity.RASTER_TOL["idx_frac"] * idx.numel(), stats)
    require(stats["sumlog_min_held"] < -30.0, stats)


# the render shapes of the three published recipes at their batch, b48: CUB
# 128^2, Market 128x64, ATR 160x96 (10 x 6 tiles of 16, not a power of two)
RECIPE_SHAPES = ((128, 128), (128, 64), (160, 96))


def recipe_shape_parity(errs):
    """K1-K4 at the recipes' render shapes at b48 against their plain
    versions: the fused forward, the masked texture sampler on its outputs,
    and the two backward kernels (backward_parity)."""
    B = 48
    for H, W in RECIPE_SHAPES:
        shape = f"b{B}/{H}x{W}"
        args, textures = raster_case(W, B, SEED + H + W, height=H)
        out = raster_fwd(face_rows(*args).contiguous(), 7000.0, H, W)
        stats = parity.raster_stats(out, rasterize_fused_plain(*args, height=H, width=W))
        emit("parity_raster", shape=shape, **stats)
        parity.check_raster(stats)
        errs["raster_fwd"] = max(errs["raster_fwd"], stats["soft_max"], stats["normal_max"],
                                 stats["uv_max"])
        _, _, uv, _, hard = out
        tstats = parity.texture_stats(texture_fwd(uv, textures, hard),
                                      texture_render_plain(uv, textures, hard), hard)
        emit("parity_texture", shape=shape, **tstats)
        parity.check_texture(tstats)
        errs["texture_fwd"] = max(errs["texture_fwd"], tstats["max_abs"])
        backward_parity(W, B, args, textures, out, errs, height=H)


VIEWS = ("Xer", "Xir", "Xir2", "Xer90", "Xer270")  # the eval step's renders


@torch.inference_mode()
def view_witness(dr, dr_cpu, att_gpu, att_cpu):
    """Where one view differs between the card and the CPU, and why: the
    faces that face the camera on one device only (and the largest |normal z|
    among them), the pixels whose winner, and whose coverage, differs between
    the devices, the pixels beyond the slice's alpha tolerance,
    and the alpha differences of the kernel against the plain path on the
    card's inputs and of the plain path on the card against it on the CPU."""
    H, W, sigma = dr.render_height, dr.render_width, dr.sigmainv
    fvc, fvi, fn = dr.project(att_gpu)
    fvc_c, fvi_c, fn_c = dr_cpu.project(att_cpu)
    args = (fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn)
    kw = dict(sigmainv=sigma, height=H, width=W, soft_mode=dr.soft_mode)
    idx_k1, soft_k1 = (t.cpu() for t in rasterize_fused(*args, **kw)[:2])
    soft_plain = rasterize_fused_plain(*args, **kw)[1].cpu()
    idx_cpu, soft_cpu = rasterize_fused_plain(fvi_c, fvc_c[..., 2], fn_c[..., 2],
                                              dr_cpu.face_uvs, fn_c, **kw)[:2]
    flips = (fn[..., 2] > 0).cpu() != (fn_c[..., 2] > 0)
    return {"facing_flips": int(flips.sum()),
            "winner_differs_pixels": int((idx_k1 != idx_cpu).sum()),
            "coverage_differs_pixels": int(((idx_k1 < 0) != (idx_cpu < 0)).sum()),
            "flipped_normal_z_max": (float(fn_c[..., 2].abs()[flips].max())
                                     if flips.any() else None),
            "alpha_over_pixels": int(((soft_k1 - soft_cpu).abs()
                                      > parity.SLICE_TOL["alpha"]).sum()),
            "alpha_max": float((soft_k1 - soft_cpu).abs().max()),
            "alpha_kernel_vs_plain_card_max": float((soft_k1 - soft_plain).abs().max()),
            "alpha_plain_card_vs_cpu_max": float((soft_plain - soft_cpu).abs().max())}


def metric_floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def build_slice(config):
    """The renderer (card and CPU), the full-width encoder with weights from
    the seed on both devices, b4 synthetic photos, the BatchNorm statistics
    re-estimated on them, and the two Reconstructors."""
    opt = options(ServeOptions, config)
    S = opt.imageSize
    kw = dict(ratio=opt.ratio, init_ellipsoid=opt.ellipsoid, soft_mode=opt.soft_mode)
    dr = DiffRender(opt.template_path, S, device=DEV, **kw)
    dr_cpu = DiffRender(opt.template_path, S, device="cpu", **kw)
    net_cpu = init_from_seed(build_models(opt, dr_cpu, "cpu"), SEED)
    netE = build_models(opt, dr, DEV)
    netE.load_state_dict(net_cpu.state_dict())
    photos = synthetic_photos(dr, 4, SEED + 1, opt.elev_range)
    estimate_bn_stats(netE, [photos], dr.vertices_init, dr.vertices_laplacian_matrix)
    net_cpu.load_state_dict(netE.state_dict())
    return opt, dr, dr_cpu, photos, Reconstructor(netE, dr, opt), Reconstructor(net_cpu, dr_cpu,
                                                                               opt)


def serving_slice(config):
    """Phase 4 for one configuration -> (launches of the served step and the
    turntable, the card's Reconstructor, both renderers, the b4 photos)."""
    opt, dr, dr_cpu, photos, rec, rec_cpu = build_slice(config)
    H, W = dr.render_height, dr.render_width
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    turn_az = -torch.arange(0, 360, 10, dtype=torch.float32, device=DEV)

    kernels.reset_launches()
    outs = rec(photos, generator=gen)
    turn_rgba, turn_normal = rec.turntable(outs[5], turn_az)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    renders = list(outs[:5]) + [turn_rgba]
    emit("slice", config=config, photos=list(photos.shape), faces=dr.num_faces,
         parameters=sum(p.numel() for p in rec.netE.parameters()), launches=launches,
         coverage=[round(float(r[..., 3].mean()), 4) for r in renders],
         azimuths=[round(float(a), 3) for a in outs[5]["azimuths"]],
         dropped_faces=int(outs[5]["dropped_faces"].sum()),
         dropped_tex_chunks=int(outs[5]["dropped_tex_chunks"].sum()))
    require(all(bool(torch.isfinite(r).all()) for r in renders + [turn_normal]),
            "non-finite render")
    require(all(float(r[..., 3].mean()) > 0.0 for r in renders), "a render covers nothing")
    require(turn_rgba.shape == (36, H, W, 4), turn_rgba.shape)
    require(int(outs[5]["dropped_faces"].sum()) == 0
            and int(outs[5]["dropped_tex_chunks"].sum()) == 0, "something was dropped")
    # six renders: each launches the configuration's forward kernels, and no other
    expect = {k: v * len(renders) for k, v in CONFIGS[config][2].items()}
    require({k: v for k, v in launches.items() if v} == expect, (launches, expect))

    # card vs CPU.  The plain rasterizer walks every face for every pixel: on
    # the dense template (half a minute a render there) and in 'exact' mode
    # (three segment distances a pair) the CPU takes two of the photos and
    # the witness the first view; the default four photos and two views
    slow = dr.num_faces >= DENSE_THRESHOLD or opt.soft_mode == "exact"
    n_cpu, n_views = (2, 1) if slow else (4, 2)
    u = torch.rand(4, generator=torch.Generator(device=DEV).manual_seed(SEED + 2), device=DEV)
    random_az = -(u * opt.azi_scope - opt.azi_scope / 2)[:n_cpu]
    outs_gpu = rec(photos[:n_cpu], random_azimuths=random_az)
    outs_cpu = rec_cpu(photos[:n_cpu].cpu(), random_azimuths=random_az.cpu())
    sstats = parity.slice_stats(outs_cpu[:5], outs_gpu[:5], outs_cpu[5], outs_gpu[5])
    emit("slice_gpu_vs_cpu", config=config, photos=n_cpu, **sstats)
    views_gpu = (outs_gpu[5],) + rec.reposed(outs_gpu[5], random_az)
    views_cpu = (outs_cpu[5],) + Reconstructor.reposed(outs_cpu[5], random_az.cpu())
    emit("slice_views_gpu_vs_cpu", config=config,
         views=[{"view": name, **view_witness(dr, dr_cpu, g, c)}
                for name, g, c in list(zip(VIEWS, views_gpu, views_cpu))[:n_views]])
    parity.check_slice(sstats, rgb_flip_pixels=4)
    return launches, rec, dr, dr_cpu, photos


def train_step_gpu_vs_cpu(dr, dr_cpu, photos, topt=None, config="default", Va=None,
                          adjust=None):
    """Phase 5 (a): one step at b4 on the card against the same step on the
    CPU: the same weights (drawn on the CPU from the seed), BatchNorm
    statistics, photos and draws; dropout off.  ``topt``: the options of
    ``config`` (the defaults when None); ``Va``: with ``hmr`` the photos'
    body meshes; ``adjust``: a change made to both train states' weights
    before the step."""
    lpl = dr.vertices_laplacian_matrix
    topt = topt or TrainOptions(template_path=SPHERE, droprate="0,0,0")
    on_card, on_cpu = build_trainer(topt), build_trainer(topt, device="cpu")
    if adjust is not None:
        adjust(on_card.state)
        adjust(on_cpu.state)
    estimate_bn_stats(on_card.state.netE, [photos], dr.vertices_init, lpl)
    on_cpu.state.netE.load_state_dict(on_card.state.netE.state_dict())
    draws = sample_draws(topt, photos.shape[0], torch.Generator(device=DEV).manual_seed(SEED + 3),
                         DEV, dr.num_faces)
    draws_cpu = {k: v.cpu() for k, v in draws.items()}
    # the two views the step will render, from copies of the state: where their
    # alpha differs between the devices, and why
    with torch.no_grad(), _no_tf32():
        views = []
        for trainer, x, d in ((on_card, photos, draws), (on_cpu, photos.cpu(), draws_cpu)):
            state = copy.deepcopy(trainer.state)
            state.netE.train()
            views.append(e_outputs(state, trainer.diff_render, topt, x, d, 0))
    emit("train_views_gpu_vs_cpu",
         views=[{"view": name, **view_witness(dr, dr_cpu, views[0][key], views[1][key])}
                for name, key in (("Xer", "Ae"), ("Xir", "Ai"))])
    kernels.reset_launches()
    m_card, Xer, Xir = on_card.step(photos, 1e-4, 1e-4, 1.0, 0, draws=draws, Va=Va)
    torch.cuda.synchronize()
    one_step = dict(kernels.LAUNCHES)
    m_cpu, Xer_cpu, Xir_cpu = on_cpu.step(photos.cpu(), 1e-4, 1e-4, 1.0, 0, draws=draws_cpu,
                                          Va=None if Va is None else Va.cpu())
    m_card, m_cpu = metric_floats(m_card), metric_floats(m_cpu)
    # each loss term relative to itself, but to no less than a thousandth of
    # its side's total: with the critic's head at its N(0, 1e-5) init the
    # adversarial terms are rounding noise around 1e-10
    floor = {k: 1e-3 * abs(m_cpu["lossD" if k.startswith("lossD") else "lossR"])
             for k in METRIC_KEYS if k.startswith("loss")}
    rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), floor.get(k, 1e-12))
           for k in METRIC_KEYS if k.startswith(("loss", "gnorm"))}
    rstats = parity.render_stats([Xer_cpu, Xir_cpu], [Xer, Xir])
    emit("train_step_gpu_vs_cpu", config=config, shape=shape_of(dr, photos.shape[0]),
         card=m_card, cpu=m_cpu, rel=rel, launches=one_step, **rstats)
    expect = step_launches(topt, 0)
    require({k: v for k, v in one_step.items() if v} == expect, (one_step, expect))
    require(all(torch.isfinite(torch.tensor(list(m_card.values())))), m_card)
    # float32 on both sides through two train-mode passes of a 56M-parameter
    # encoder and their backward; the gradient norms sum 56M squares
    for key, err in rel.items():
        require(err <= (5e-2 if key.startswith("gnorm") else 1e-2), (key, err, rel))
    parity.check_train_renders(rstats)


def train_steps(config, dr):
    """Phase 5 (b) for one configuration: its TRAIN_STEPS steps at b32 with
    dropout on, as examples/train_synthetic.py runs them (lr 3e-4, warm-up
    min(1, 0.01 + i / 20), four batches in turn) -> (kernel launches of the
    steps, the b32 trainer)."""
    trainer = build_trainer(options(TrainOptions, config))
    steps = TRAIN_STEPS[config]
    batches = [synthetic_photos(dr, 32, SEED + 10 + i, trainer.opt.elev_range)
               for i in range(4)]
    estimate_bn_stats(trainer.state.netE, batches[:1], dr.vertices_init,
                      dr.vertices_laplacian_matrix)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    history = [metric_floats(trainer.step(batches[i % 4], 3e-4, 3e-4,
                                          warm_up=min(1.0, 0.01 + i / 20.0))[0])
               for i in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    data = [m["lossR_data"] for m in history]
    first, last = statistics.mean(data[:4]), statistics.mean(data[-4:])
    emit("train_steps", config=config, shape=shape_of(dr, 32), steps=steps,
         seconds=seconds, launches=launches, lossR_data_first4=first, lossR_data_last4=last,
         better_percent=100.0 * (first - last) / first, lossR_data=data,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         first=history[0], last=history[-1])
    for i, m in enumerate(history):
        require(all(torch.isfinite(torch.tensor(list(m.values())))), (i, m))
        require(m["skipE"] == m["skipD"] == 0.0, (i, m))
        require(m["dropped_faces"] == m["dropped_tex_chunks"] == 0.0, (i, m))
    require(last < first, (first, last))
    expect = {k: v * steps for k, v in CONFIGS[config][3].items()}
    require({k: v for k, v in launches.items() if v} == expect, (launches, expect))
    return launches, trainer


def kernel_timing(size, card, device):
    """Every kernel mode that runs on sphere.obj at b32: its device times
    and bound from ``device`` (the lines of ``kernel_times.measure``), its
    plain version and the library call on the same inputs
    (``kernel_times.sphere_case``), the fused forward's wrapper as the
    renderer calls it (one launch between CUDA events: the host's launch
    path included), and the 'exact' mode's backward, which is autograd of
    the plain phase 1."""
    shape = f"b32/{size}^2"
    c = kernel_times.sphere_case(kernel_times.load_port(), size)
    args, uv, hard, textures = c["args"], c["uv"], c["hard"], c["textures"]
    fvi, fz, fnz = args[0], args[1], args[2]
    g_sumlog, g_tex, g_covered = c["g_sumlog"], c["g_tex"], c["g_covered"]
    lib_err = float((probe_bench.grid_sample_masked(uv, hard, textures).permute(0, 2, 3, 1)
                     - texture_fwd(uv, textures, hard)).abs().max())
    require(lib_err <= parity.TEXTURE_TOL, lib_err)
    lib_err_unmasked = float((probe_bench.grid_sample_masked(uv, None, textures)
                              .permute(0, 2, 3, 1) - texture_fwd(uv, textures)).abs().max())
    require(lib_err_unmasked <= parity.TEXTURE_TOL, lib_err_unmasked)
    px, py = pixel_grid(size, size, DEV)
    exact = dict(height=size, width=size, soft_mode="exact")
    t = {
        "raster_fwd_wrapper_single_launch_ms": cuda_ms(
            lambda: rasterize_fused(*args, height=size, width=size)),
        "raster_fwd_plain_ms": cuda_ms(lambda: rasterize_fused_plain(*args, height=size,
                                                                     width=size), 1, 5),
        "raster_fwd_plain_mode_plain_ms": cuda_ms(
            lambda: rasterize_phase1(px, py, fvi, fz, fnz, 7000.0), 1, 3),
        "texture_fwd_plain_ms": cuda_ms(lambda: texture_render_plain(uv, textures, hard)),
        "raster_bwd_plain_ms": cuda_ms(lambda: soft_backward_plain(fvi, fnz, g_sumlog, 7000.0,
                                                                   size, size), 1, 5),
        "texture_bwd_plain_ms": cuda_ms(lambda: texture_backward_plain(g_tex, uv, textures,
                                                                       hard)),
        "raster_exact_fused_plain_ms": cuda_ms(lambda: rasterize_fused_plain(*args, **exact),
                                               1, 3),
        "raster_exact_plain_ms": cuda_ms(
            lambda: rasterize_phase1(px, py, fvi, fz, fnz, 7000.0, "exact"), 1, 3),
        "texture_unmasked_fwd_plain_ms": cuda_ms(lambda: texture_mapping_plain(uv, textures)),
        "texture_unmasked_bwd_plain_ms": cuda_ms(
            lambda: texture_backward_plain(g_covered, uv, textures)),
    }
    if size == 128:  # the shape the train step runs it at; seconds at 256^2
        t["raster_exact_backward_autograd_ms"] = cuda_ms(
            lambda: soft_backward_autograd(fvi, fz, fnz, g_sumlog, 7000.0, size, size), 1, 3)
    for rec in device:
        if rec["shape"] == shape:
            t.update(device_entries(rec))
    emit("timing_kernels", shape=shape, card=card, covered_pixels=int((hard > 0.5).sum()),
         library_max_abs_err=lib_err, library_unmasked_max_abs_err=lib_err_unmasked, **t)
    return t


def device_entries(rec):
    """A ``kernel_times`` line as the kernels' summary reads it: ``ms`` is
    the cold device time."""
    name = rec["name"]
    return {f"{name}_ms": rec["cold_ms"], f"{name}_warm_ms": rec["warm_ms"],
            f"{name}_burst_ms": rec["burst_ms"], f"{name}_bound_ms": rec["bound_ms"],
            f"{name}_bound_by": rec["bound_by"],
            f"{name}_library_ms": rec.get("library_cold_ms")}


def training_timing(trainer, dr, batch, reps=10, Va=None):
    """The train step at b32 and its parts: the step as a user calls it
    (median of ``reps``); then its three phases between CUDA events; the
    encoder's train-mode forward, one render forward + backward and the two
    optimizer steps alone.  ``Va``: with ``hmr``, the photos' body meshes."""
    state, opt = trainer.state, trainer.opt
    step_ms = cuda_ms(lambda: trainer.step(batch, 3e-4, 3e-4, Va=Va), 2, reps)
    parts = {"forward_ms": [], "d_update_ms": [], "g_update_ms": []}
    with _no_tf32():
        for _ in range(max(2, reps // 2)):
            draws = sample_draws(opt, batch.shape[0], trainer.generator, DEV, dr.num_faces)
            before = [b.clone() for b in running_statistics(state.netE)]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            outs = e_outputs(state, dr, opt, batch, draws, 0)
            ev[1].record()
            update_d(state, outs, opt, draws, 3e-4, 1.0)
            ev[2].record()
            update_e(state, dr, opt, outs, batch, 3e-4, 1.0, before, Va)
            ev[3].record()
            torch.cuda.synchronize()
            for key, a, b in zip(parts, ev, ev[1:]):
                parts[key].append(a.elapsed_time(b))
        out = {k: statistics.median(v) for k, v in parts.items()}
        lpl = dr.vertices_laplacian_matrix
        out["encoder_forward_ms"] = cuda_ms(
            lambda: state.netE(batch, state.template, lpl), 2, 10)
        att = {k: (v.detach().requires_grad_(True) if v is not None and v.is_floating_point()
                   else v) for k, v in state.netE(batch, state.template, lpl).items()}
        w = torch.randn((*batch.shape[:3], 4), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(SEED))
        out["render_forward_backward_ms"] = cuda_ms(
            lambda: (dr.render(**att)[0] * w).sum().backward(), 2, reps)
        out["opt_e_step_ms"] = cuda_ms(state.opt_e.step, 2, 10)
        out["opt_d_step_ms"] = cuda_ms(state.opt_d.step, 2, 10)
    return {"step_ms": step_ms, "images_per_s": batch.shape[0] * 1000.0 / step_ms, **out}


def texture_parts_phase(size, card, errs):
    """K9c: the probe of the masked texture kernel's body, on the first 32
    images of ``uv_sweep`` (dump_uv's camera sweep through K1) at ``size``
    with the probe's random texture.  The probe's path (one launch a level)
    runs with the counts at 0; then levels 1 and 4 must be zeros, level 5
    the texture kernel's output bit for bit and the plain version's within
    K3's tolerance; then ``time_levels`` (a burst of 100 launches per CUDA
    event pair, and the device's time alone, with the L2 warm and cold) ->
    (the probe path's launches, the timing dict)."""
    B = 32
    uv, hard = probe_bench.uv_sweep(size=size, device=DEV)
    uv, hard = uv[:B].contiguous(), hard[:B].contiguous()
    tex = probe_bench.random_texture(B, size, DEV)
    kernels.reset_launches()
    outs = probe_bench.probe(uv, hard, tex)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require({k: v for k, v in launches.items() if v}
            == {"texture_parts": len(TEXTURE_PARTS_LEVELS)}, launches)
    plain = texture_render_plain(uv, tex, hard)
    stats = {"zeros_below_5": all(bool((outs[lv] == 0).all()) for lv in (1, 4)),
             "level5_equals_texture_fwd": bool(torch.equal(outs[5], texture_fwd(uv, tex, hard))),
             "level5_max_abs": float((outs[5] - plain).abs().max()),
             "covered_pixels": int(hard.sum().item())}
    emit("parity_texture_parts", shape=f"b{B}/{size}^2", launches=launches, **stats)
    require(stats["zeros_below_5"] and stats["level5_equals_texture_fwd"], stats)
    require(stats["level5_max_abs"] <= parity.TEXTURE_TOL, stats)
    errs["texture_parts"] = max(errs["texture_parts"], stats["level5_max_abs"])
    lib = probe_bench.grid_sample_masked(uv, hard, tex).permute(0, 2, 3, 1)
    require(float((lib - outs[5]).abs().max()) <= parity.TEXTURE_TOL, "grid_sample disagrees")
    t = probe_bench.time_levels(uv, hard, tex)
    t["level5_plain_ms"] = burst_ms(lambda: texture_render_plain(uv, tex, hard), 20)
    t["texture_fwd_ms"] = burst_ms(lambda: texture_fwd(uv, tex, hard))
    per_image = hard.reshape(B, -1).sum(dim=1)
    emit("timing_texture_parts", shape=f"b{B}/{size}^2", card=card,
         covered_pixels_per_image_mean=float(per_image.mean()),
         covered_pixels_per_image_min=int(per_image.min()),
         texels_touched=probe_bench.texels_touched(uv, hard, tex), **t)
    return launches, {"texture_parts_ms": t["level5_cold_ms"],
                      "texture_parts_warm_ms": t["level5_warm_ms"],
                      "texture_parts_burst_ms": t["level5_ms"],
                      "texture_parts_plain_ms": t["level5_plain_ms"],
                      "texture_parts_bound_ms": t["level5_bound_ms"],
                      "texture_parts_bound_by": t["level5_bound_by"],
                      "texture_parts_library_ms": t["level5_library_cold_ms"]}


def _same_state(a, b):
    """Whether two state dicts hold equal values, tensor by tensor."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_state(x, y) for x, y in zip(a, b))
    return a == b


def step_launches(opt, train_shape):
    """The kernel launches of one train step of ``opt`` (sphere.obj, 'line')
    at ``train_shape``: each render launches K1 and K3; K2 where its
    geometry takes a gradient (the shape, or the encoder's camera, trains)
    and K4 where its uv or its textures take one.  The interpolated view's
    camera is drawn; the hard view's azimuth is drawn, its elevation,
    distance and bias are the encoder's."""
    shape, camera, texture = (train_shape not in frozen
                              for frozen in (SHAPE_FROZEN, CAMERA_FROZEN, TEXTURE_FROZEN))
    geometry = [shape or camera]  # Xer
    if opt.lambda_ic > 0:
        geometry.append(shape)  # Xir
    if opt.hard:
        geometry.append(shape or camera)  # Xer90
    out = {"raster_fwd": len(geometry), "texture_fwd": len(geometry),
           "raster_bwd": sum(geometry), "texture_bwd": sum(g or texture for g in geometry)}
    return {k: v for k, v in out.items() if v}


def trainer_launches(opt, start_epoch, n_train, n_test):
    """The kernel launches a ``trainer`` call must make (sphere.obj,
    'line'): ``n_train`` steps an epoch (step_launches at the trainer's
    train_shape policy), one render a sweep frame of the artifact epochs,
    five renders an eval batch (``n_test`` batches)."""
    epochs = range(start_epoch, opt.niter + 1)
    lo, hi = (int(float(v)) for v in opt.elev_range.split("~"))
    dlo, dhi = (int(float(v)) for v in opt.dist_range.split("~"))
    frames = len(range(-int(opt.azi_scope / 2), int(opt.azi_scope / 2), 10)) + len(
        range(lo, hi, 10)) + len(range(dlo, dhi + 1))
    renders = (sum(frames for e in epochs if e % 10 == 0)
               + sum(5 * n_test * (2 if opt.swa and e >= opt.swa_start else 1)
                     for e in epochs if e % 20 == 0))
    total = {"raster_fwd": renders, "texture_fwd": renders}
    for _ in epochs:
        for it in range(n_train):
            for k, v in step_launches(opt, _train_shape_policy(opt, it)).items():
                total[k] = total.get(k, 0) + v
    return {k: v for k, v in total.items() if v}


def trainer_phase(card, argv, outf):
    """The trainer's other branches on the default configuration, full
    width, resumed from the front-end run's latest_ckpt (epoch 0, in
    ``outf``) over the front-end's loaders, with swa_start 1 (EM runs only
    before swa_start, and the front-end run took SWA from epoch 0): the
    restore, one epoch with the EM template update and the BatchNorm refresh
    after it, the artifacts, the eval and the checkpoints.  Before it, a
    fresh train state restored from that latest_ckpt must hold, tensor by
    tensor, what the file holds."""
    ns = flags.build_parser().parse_args(argv)
    train, test, noaug = cli_train.build_dataloaders(ns)
    # the cosine schedule divides by niter (in the JAX package too), so the
    # one-epoch resume takes "exp", whose rate at epoch 0 is the same lr
    opt = dataclasses.replace(train_options(ns), resume=True, niter=0, swa_start=1,
                              scheduler="exp", update_bn=True)
    path = os.path.join(outf, "ckpts", "latest_ckpt")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    fresh = build_trainer(opt).state
    CheckpointManager(os.path.dirname(path)).restore("latest_ckpt", fresh)
    fresh_equal = payload["epoch"] == 0 and _same_state(fresh.state_dict(), payload["state"])
    template0 = fresh.template.clone()
    del fresh, payload
    torch.cuda.empty_cache()

    timings = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = run_trainer(opt, train, test, noaug, outf, device=DEV, timings=timings)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    expect = trainer_launches(opt, 0, len(train), len(test))
    with open(os.path.join(outf, "result.txt")) as fp:
        results = fp.read().splitlines()
    epochs = [t for t in timings if "epoch" in t]
    restored = [t for t in timings if "restore_s" in t]
    template_moved = float((state.template - template0).abs().max())
    emit("trainer", card=card, shape="b32/128x128", seconds=seconds,
         epochs=[t["epoch"] for t in epochs],
         seconds_per_epoch=[t["train_s"] for t in epochs],
         train_images_per_s=[t["train_images"] / t["train_s"] for t in epochs],
         evals=[dict(e, epoch=t["epoch"]) for t in epochs for e in t["eval"]],
         em_sweep_s=[t.get("em_s") for t in epochs],
         em_update_bn_s=[t.get("em_update_bn_s") for t in epochs],
         artifacts_s=[t.get("artifacts_s") for t in epochs],
         checkpoints=[c for t in epochs for c in t["checkpoints"]], restore=restored,
         launches=launches, expected_launches=expect, result_lines=len(results),
         swa_n=state.swa_n, template_moved_max=template_moved, em_step=state.em_step,
         restore_into_fresh_state_equal=fresh_equal, fid_files=eval_file_counts(outf))
    require(launches == expect, (launches, expect))
    require(state.swa_n == 1, state.swa_n)  # the front-end run's epoch 0, restored
    require(fresh_equal and [t["restored_epoch"] for t in restored] == [0], restored)
    require(template_moved > 0.0 and state.em_step < 0.1, (template_moved, state.em_step))
    require(all("em_update_bn_s" in t for t in epochs), epochs)
    require(eval_file_counts(outf) == EVAL_FILES, eval_file_counts(outf))
    require(len(results) == 15 and sum("(SWA)" in ln for ln in results) == 5, results)
    require(all(k in " ".join(results[-5:]) for k in ("recon ssim", "recon MaskIoU",
                                                      "recon fid", "rotation fid",
                                                      "rotate90/270 fid")), results)


# what the front-end run (epochs 0 and 1, artifacts and eval at epoch 0) must
# leave in its directory, and the files an eval writes for its 16 test
# photos: one a photo, two a photo for the two rotations
FRONTEND_ARTIFACTS = ("opts.yaml", "result.txt", "current_Xer.png", "current_Xir.png",
                      "current_rotation.gif", "current_rotation_ele.gif",
                      "current_rotation_dist.gif", "epoch_000_template.obj",
                      "current_mesh_recon.obj", "ckpts/latest_ckpt", "ckpts/best_ckpt",
                      "ckpts/best_mesh.obj")
EVAL_FILES = {"ori": 16, "rec": 16, "inter": 32, "inter90": 32, "ori_mask": 16, "rec_mask": 16}


def eval_file_counts(outf):
    """The files in each of ``outf``'s fid/ directories."""
    return {d: len(os.listdir(os.path.join(outf, "fid", d))) for d in EVAL_FILES}


def cub_tree(root, dr, n_photos, first_seed, split, fg_range=(0.16, 0.64)):
    """``n_photos`` of ``synthetic_photos`` as a CUB-layout split under
    ``root``: ``<split>/c0/sNNN_<fg ratio>.png`` masks (the port's PNG
    codec) and the RGB as ``sNNN.jpg`` (Pillow, quality 100, as
    prepare_cub writes them).  Only photos whose foreground ratio lies
    inside ``fg_range`` (the default ``--threshold``) are kept, so that the
    train loader takes every one."""
    d = os.path.join(root, split, "c0")
    os.makedirs(d)
    kept, seed = 0, first_seed
    while kept < n_photos:
        photos = synthetic_photos(dr, 32, seed).cpu().numpy()
        seed += 1
        for b in range(32):
            mask = np.where(photos[b, :, :, 3] > 0.5, 255, 0).astype(np.uint8)
            ratio = "%.2f" % (mask.mean() / 255.0)
            if kept == n_photos or not fg_range[0] < float(ratio) < fg_range[1]:
                continue
            stem = os.path.join(d, f"s{kept:03d}")
            save_array_image(photos[b, :, :, :3], stem + ".jpg", quality=100)
            with open(f"{stem}_{ratio}.png", "wb") as fp:
                fp.write(encode_png(mask))
            kept += 1


def frontend_phase(card):
    """The file front end of ``python train.py`` on the card:
    ``cli.train.main`` at the default flags (b32, 128^2, hr18sv2 / res34,
    the WGAN critic) with ``--niter 1``, over a CUB-layout tree of 64 train
    and 16 test photos (``cub_tree``) in build/frontend_smoke: opts.yaml,
    the loaders (JPEG decode, augmentation, worker threads), and the
    trainer, which at niter 1 runs SWA from epoch 0 (swa_start = niter -
    100): 4 steps an epoch over 2 epochs, the SWA BatchNorm refresh, the
    artifacts, the eval with and without SWA, the checkpoints -> the
    kernel launches of the run."""
    work = os.path.join(ROOT, "build", "frontend_smoke")
    shutil.rmtree(work, ignore_errors=True)
    dr = DiffRender(SPHERE, 128, device=DEV)
    data = os.path.join(work, "data")
    # both loaders of the train split take every photo (--threshold and
    # --clean_threshold), so the EM sweep of the resume has 4 batches too
    cub_tree(data, dr, 64, SEED + 50, "train", fg_range=(0.25, 0.49))
    cub_tree(data, dr, 16, SEED + 60, "test")
    del dr
    argv = ["--name", "smoke", "--dataroot", data, "--template_path", SPHERE, "--niter", "1"]
    timings, out, cwd = [], io.StringIO(), os.getcwd()
    kernels.reset_launches()
    t0 = time.perf_counter()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(out):
            state = cli_train.main(argv, device=DEV, timings=timings)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        # the options main must have written: cli.train.prepare on a parsed
        # copy of argv, in a directory of its own (it writes ./log/<name>)
        os.makedirs(os.path.join(work, "expect"))
        os.chdir(os.path.join(work, "expect"))
        with contextlib.redirect_stdout(io.StringIO()):
            expect_opt = cli_train.prepare(flags.build_parser().parse_args(argv))
    finally:
        os.chdir(cwd)
    outf = os.path.join(work, "log", "smoke")
    opts_path = os.path.join(outf, "opts.yaml")
    saved = vars(flags.load_options(argparse.Namespace(), opts_path, skip=()))
    read_back = vars(flags.load_options(flags.build_parser().parse_args([]), opts_path, skip=()))
    written = vars(expect_opt)
    losses = [[float(x) for _, x in re.findall(r"(lossD|lossR): (\S+)", ln)]
              for ln in out.getvalue().splitlines() if "lossD:" in ln]
    expect = trainer_launches(train_options(expect_opt), 0, 4, 1)
    with open(os.path.join(outf, "result.txt")) as fp:
        results = fp.read().splitlines()
    epochs = [t for t in timings if "epoch" in t]
    missing = [a for a in FRONTEND_ARTIFACTS if not os.path.isfile(os.path.join(outf, a))]
    fid_files = eval_file_counts(outf)
    emit("frontend", card=card, shape="b32/128x128", argv=argv, seconds=seconds,
         epochs=[t["epoch"] for t in epochs],
         seconds_per_epoch=[t["train_s"] for t in epochs],
         train_images_per_s=[t["train_images"] / t["train_s"] for t in epochs],
         evals=[dict(e, epoch=t["epoch"]) for t in epochs for e in t["eval"]],
         swa_bn_refresh_s=[t.get("swa_bn_s") for t in epochs],
         artifacts_s=[t.get("artifacts_s") for t in epochs],
         checkpoints=[c for t in epochs for c in t["checkpoints"]],
         loss_lines=losses, launches=launches, expected_launches=expect,
         steps=state.step, swa_n=state.swa_n, result_lines=results,
         opts_yaml_equal=saved == written == read_back, missing_artifacts=missing,
         fid_files=fid_files)
    require(len(losses) == 2 and all(len(v) == 2 and all(map(math.isfinite, v))
                                     for v in losses), losses)
    require((state.step, state.swa_n) == (8, 2), (state.step, state.swa_n))
    require(launches == expect, (launches, expect))
    require(len(results) == 10 and sum("(SWA)" in ln for ln in results) == 5, results)
    require(saved == written == read_back, (saved, written, read_back))
    require(any("swa_bn_s" in t for t in epochs), epochs)  # SWA's BatchNorm refresh
    require(not missing, missing)
    require(fid_files == EVAL_FILES, fid_files)
    return launches, argv, outf


# the files the eval CLIs write over the front end's 16 test photos (CUB
# serves each twice, under one name): cli.test's fid/ directories, one
# test_cub30 directory a bin and one for the photos
TEST_FILES = {"ori": 16, "rec_tmp": 16, "inter": 32, "inter90": 32, "ori_mask": 16,
              "rec_mask": 16}
RAINBOW_FILES = ("rainbow_Xa.png", "rainbow_Xer.png", "rainbow_Xir.png", "rainbow_texture.png",
                 "rainbow_mesh.obj")
RAINBOW_GIFS = {"rainbow.gif": 36, "rainbow_bias.gif": 7, "rainbow_rotation.gif": 36,
                "rainbow_elevation.gif": 3, "rainbow_distance.gif": 6}


def gif_frames(path):
    """The frames of a GIF file, by its blocks."""
    with open(path, "rb") as fp:
        data = fp.read()
    pos, frames = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0), 0
    while data[pos] != 0x3B:
        if data[pos] == 0x2C:  # an image: its descriptor, a local palette, the LZW size
            frames += 1
            flags = data[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0) + 1
        else:  # an extension: its label
            pos += 2
        while data[pos]:  # the sub-blocks
            pos += data[pos] + 1
        pos += 1
    return frames


def eval_cli(name, main, argv, work, **kwargs):
    """One eval CLI's ``main(argv, device=card)`` in ``work`` -> (its result,
    the host seconds, the kernel launches it made, its "seconds" line)."""
    out, cwd = io.StringIO(), os.getcwd()
    kernels.reset_launches()
    t0 = time.perf_counter()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(out):
            result = main(argv, device=DEV, **kwargs)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    line = next((ln for ln in out.getvalue().splitlines() if ln.startswith(f"{name} seconds:")),
                None)
    require(line is not None, (name, "no seconds line", out.getvalue()[-2000:]))
    return result, seconds, launches, line


def thuman_tree(root, n):
    """A THuman2-layout tree of ``n`` scans, one view each, at 128^2: the
    template under smooth random textures at bench.py's cameras, its
    render as ``render/0.png``, its alpha as the last channel of
    ``depth_F/0.png``, its own ``imnormal`` as ``normal_F/0.png``."""
    dr = DiffRender(SPHERE, 128, device=DEV)
    att = bench_attributes(dr.vertices_init.cpu().numpy(), n, 128, SEED + 70)
    att["textures"] = smooth_random((n, 256, 128, 3), SEED + 70)
    with torch.no_grad():
        rgba, out = dr.render(**to_torch(att, DEV))
    rgba, normal = rgba.cpu().numpy(), out["imnormal"].cpu().numpy() * 0.5 + 0.5
    for i in range(n):
        files = {"render": to_uint8(rgba[i, :, :, :3]), "normal_F": to_uint8(normal[i]),
                 "depth_F": np.concatenate([to_uint8(rgba[i, :, :, :3]),
                                            (rgba[i, :, :, 3:] > 0.5).astype(np.uint8) * 255],
                                           axis=-1)}
        for sub, arr in files.items():
            os.makedirs(os.path.join(root, f"scan{i:02d}", sub))
            with open(os.path.join(root, f"scan{i:02d}", sub, "0.png"), "wb") as fp:
                fp.write(encode_png(arr))
    return root


def keypoint_files(root, data):
    """CUB_200_2011's ``images.txt`` and ``parts/part_locs.txt`` for the test
    photos of the tree ``data``: 15 parts a photo at pixels of its mask
    (seeded), every eighth not visible."""
    rs = np.random.RandomState(SEED + 80)
    test = os.path.join(data, "test", "c0")
    masks = sorted(f for f in os.listdir(test) if f.endswith(".png"))
    os.makedirs(os.path.join(root, "parts"))
    with open(os.path.join(root, "images.txt"), "w") as fp_img, \
            open(os.path.join(root, "parts", "part_locs.txt"), "w") as fp_kp:
        for i, name in enumerate(masks):
            fp_img.write(f"{i + 1} c0/{name[:-9]}.jpg\n")
            with open(os.path.join(test, name), "rb") as fm:
                ys, xs = np.nonzero(decode_png(fm.read()))
            for part, j in enumerate(rs.randint(0, len(xs), 15)):
                fp_kp.write(f"{i + 1} {part + 1} {xs[j]}.0 {ys[j]}.0 {int(part % 8 != 7)}\n")
    return root


def eval_clis_phase(card, outf):
    """The evaluation and serving CLIs on the front end's run (``outf``, the
    default configuration at full width after the trainer phase: a
    checkpoint with SWA and best_mesh.obj) over its tree of 16 test photos:
    ``cli.test``, ``show_camera``, ``show_rainbow2``, ``single_img`` on one
    photo (``--corrupt none`` and ``salt``), ``test_cub30``, ``test_pck``
    (over keypoint files this writes for the photos) and ``test_thu`` (over
    a THuman2 tree this writes).  Each must write its files, print its
    seconds, and launch its renders' K1 and K3.  cli.test's arrays of four
    photos are held to a CPU run of the same eval step on the same
    checkpoint -> the kernel launches of all of them."""
    work = os.path.dirname(os.path.dirname(outf))
    data = os.path.join(work, "data")
    argv = ["--name", os.path.basename(outf), "--dataroot", data]
    t_phase = time.perf_counter()
    total, lines = {}, []

    def record(cli, seconds, launches, line, **fields):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        lines.append(line)
        emit("eval_cli", cli=cli, card=card, seconds=seconds, launches=launches,
             cli_seconds=json.loads(line.split("seconds: ", 1)[1]), **fields)

    def renders(n):
        return {"raster_fwd": n, "texture_fwd": n}

    # cli.test at b32 (the run's flags), the random views drawn here so that
    # the CPU can take the same; its writes kept for the comparison
    saved, real_save = [], cli_test.save_images_parallel
    cli_test.save_images_parallel = lambda pairs, workers=4: (saved.extend(pairs),
                                                              real_save(pairs, workers))
    u = torch.rand(32, generator=torch.Generator(device=DEV).manual_seed(SEED + 90), device=DEV)
    draws = -(u * 360.0 - 180.0)
    try:
        result, seconds, launches, line = eval_cli("test", cli_test.main, argv, work,
                                                   draws=[draws])
    finally:
        cli_test.save_images_parallel = real_save
    files = {d: len(os.listdir(os.path.join(outf, "fid", d))) for d in TEST_FILES}
    with open(os.path.join(outf, "result.txt")) as fp:
        final = [ln for ln in fp.read().splitlines() if ln.startswith("Final")]
    with np.load(os.path.join(outf, "hist.png.npz")) as z:
        hist = {k: z[k] for k in z.files}
    record("test", seconds, launches, line, files=files, ssim=result["ssim"],
           mask_iou=result["mask_iou"], fid=result["fid"], images=result["images"],
           images_per_s_through_loader=result["images"] / result["seconds"]["encode_render"])
    require(launches == renders(5), launches)
    require(files == TEST_FILES and len(final) == 5, (files, final))
    require(all(math.isfinite(v) for v in [result["ssim"], result["mask_iou"], *result["fid"]]),
            result)
    require(sorted(hist) == sorted(["azimuths", "elevations", "distances", "bias_x", "bias_y",
                                    "delta_norm"]) and all(v.shape == (32,) for v in hist.values()),
            {k: v.shape for k, v in hist.items()})

    # the same eval step of four of the photos on the CPU, same checkpoint and draws
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            opt = cli_test.eval_options(argv)
            rec_cpu = cli_test.load_reconstructor(opt, "cpu")
            items = [cli_test.pick_dataset(opt)[i] for i in range(4)]
    finally:
        os.chdir(cwd)
    photos = torch.as_tensor(np.stack([it["images"] for it in items]))
    outs_cpu = rec_cpu(photos, random_azimuths=draws[:4].cpu())
    views_card = [np.stack([saved[8 * b + k][0] for b in range(4)]) for k in range(5)]
    alpha_card = np.stack([saved[8 * b + 5][0] for b in range(4)])
    card_r, cpu_r = [], []
    for k, view in enumerate(views_card):  # rgb, and the reconstruction's alpha
        a, b = np.zeros(view.shape[:3] + (4,), np.float32), outs_cpu[k].numpy().copy()
        a[..., :3] = view
        if k == 0:
            a[..., 3] = alpha_card
        else:
            b[..., 3] = 0.0
        card_r.append(a)
        cpu_r.append(b)
    rstats = parity.render_stats(cpu_r, card_r)
    cams = {k: float(np.abs(hist[k][:4] - v).max()) for k, v in
            cli_test.camera_stats(outs_cpu[5]).items()}
    cams["azimuths"] = float(np.abs((hist["azimuths"][:4] - outs_cpu[5]["azimuths"].numpy()
                                     + 180.0) % 360.0 - 180.0).max())
    emit("eval_test_gpu_vs_cpu", card=card, photos=4, seconds=time.perf_counter() - t0,
         camera_max=cams, **rstats)
    parity.check_renders(rstats, rgb_flip_pixels=4)
    for k, err in cams.items():
        require(err <= parity.SLICE_TOL["angle_deg" if k in ("azimuths", "elevations")
                                         else "attr"], (k, err))
    del rec_cpu, saved

    # show_camera: an encode and one render a batch
    result, seconds, launches, line = eval_cli("show_camera", cli_show_camera.main, argv, work)
    with np.load(os.path.join(outf, "camera_hist.png.npz")) as z:
        shapes = {k: z[k].shape for k in z.files}
    record("show_camera", seconds, launches, line, shapes=shapes)
    require(launches == renders(1) and len(shapes) == 5
            and all(v == (32,) for v in shapes.values()), (launches, shapes))

    # show_rainbow2: the eval step, the rainbow (one render a frame), the bias
    # frames and the three sweeps
    result, seconds, launches, line = eval_cli("show_rainbow2", cli_show_rainbow2.main, argv,
                                               work)
    gifs = {g: gif_frames(os.path.join(outf, g)) for g in RAINBOW_GIFS}
    missing = [f for f in RAINBOW_FILES if not os.path.isfile(os.path.join(outf, f))]
    record("show_rainbow2", seconds, launches, line, gif_frames=gifs, missing=missing)
    require(launches == renders(5 + sum(RAINBOW_GIFS.values())), launches)
    require(gifs == RAINBOW_GIFS and not missing, (gifs, missing))

    # single_img on one photo, its mask clean and salted
    test_dir = os.path.join(data, "test", "c0")
    mask = sorted(f for f in os.listdir(test_dir) if f.endswith(".png"))[0]
    photo = os.path.join(test_dir, mask[:-9] + ".jpg")
    for corrupt in ("none", "salt"):
        result, seconds, launches, line = eval_cli(
            "single_img", cli_single_img.main,
            argv[:2] + ["--img", photo, "--mask", os.path.join(test_dir, mask),
                        "--corrupt", corrupt], work)
        panel = read_image(os.path.join(work, result["panel"]))
        frames = gif_frames(os.path.join(work, result["gif"]))
        record("single_img", seconds, launches, line, corrupt=corrupt,
               panel_shape=list(panel.shape), gif_frames=frames)
        require(launches == renders(5) and panel.shape == (128, 6 * 128, 3) and frames == 36,
                (launches, panel.shape, frames))

    # test_cub30: 12 renders a batch, 12 FIDs against the photos
    result, seconds, launches, line = eval_cli("test_cub30", cli_test_cub30.main, argv, work)
    files = {d: len(os.listdir(os.path.join(outf, "fid30", d)))
             for d in os.listdir(os.path.join(outf, "fid30"))}
    record("test_cub30", seconds, launches, line, files=files, fid=result["fid"],
           mean_fid=result["mean_fid"])
    require(launches == renders(12), launches)
    require(len(files) == 13 and set(files.values()) == {16}, files)
    require(len(result["fid"]) == 12 and all(map(math.isfinite, result["fid"])), result["fid"])

    # test_pck over keypoints at pixels of the photos' masks: encodes only
    cub_root = os.path.join(work, "CUB_200_2011")
    shutil.rmtree(cub_root, ignore_errors=True)
    keypoint_files(cub_root, data)
    result, seconds, launches, line = eval_cli("test_pck", cli_test_pck.main,
                                               argv + ["--cub_root", cub_root], work)
    record("test_pck", seconds, launches, line, pck=result["pck"], pairs=result["pairs"])
    require(not launches and result["pairs"] == 16, (launches, result["pairs"]))
    require(all(0.0 <= v <= 1.0 for v in result["pck"].values()), result["pck"])

    # test_thu over a THuman2 tree of the template's own renders and normals
    thu = os.path.join(work, "thuman2")
    shutil.rmtree(thu, ignore_errors=True)
    thuman_tree(thu, 16)
    result, seconds, launches, line = eval_cli("test_thu", cli_test_thu.main,
                                               argv[:2] + ["--dataroot", thu], work)
    record("test_thu", seconds, launches, line, mse=result["mse"], batches=result["batches"],
           images=result["images"])
    require(launches == renders(1) and result["images"] == 16, (launches, result))
    require(math.isfinite(result["mse"]) and 0.0 <= result["mse"] <= 4.0, result["mse"])

    emit("eval_clis", card=card, seconds=time.perf_counter() - t_phase, launches=total)
    return total


def recipe_photos(dr, batch, seed, elev_range, distances):
    """RGBA photos for the recipes: the template under smooth random
    textures at bench.py's cameras (the elevations mapped onto
    ``elev_range``, distances U(``distances``)) over a smooth random
    background in [0.1, 0.9], so that the background encoder has something to
    fit.  Rendered over that background (``no_mask``), divided by each
    image's SH coefficient at a zero normal so that it shows as drawn."""
    H, W = dr.render_height, dr.render_width
    att = bench_attributes(dr.vertices_init.cpu().numpy(), batch, W, seed, height=H)
    lo, hi = (float(v) for v in elev_range.split("~"))
    att["elevations"] = (lo + (hi - lo) * att["elevations"] / 30.0).astype("float32")
    att["distances"] = np.random.RandomState(seed).uniform(*distances, batch).astype("float32")
    att["textures"] = smooth_random((batch, 2 * H, W, 3), seed)
    att = to_torch(att, DEV)
    coef = spherical_harmonic_lighting(torch.zeros((batch, 1, 1, 3), device=DEV), att["lights"])
    bg = 0.1 + 0.8 * smooth_random((batch, H, W, 3), seed + 7919)
    att["bg"] = torch.as_tensor(bg, device=DEV) / coef[..., None]
    with torch.no_grad():
        return dr.render(no_mask=True, **att)[0]


def recipe_photo_files(dr, n, seed, elev_range, distances, fg_range):
    """``n`` recipe photos whose foreground ratio lies inside ``fg_range``
    -> [(rgb (H, W, 3) uint8, mask (H, W) uint8, the ratio as "%.2f")]."""
    out, first = [], seed
    while len(out) < n:
        require(seed < first + 20, ("too few photos inside", fg_range, len(out)))
        photos = recipe_photos(dr, 32, seed, elev_range, distances).cpu().numpy()
        seed += 1
        for b in range(32):
            mask = np.where(photos[b, :, :, 3] > 0.5, 255, 0).astype(np.uint8)
            ratio = "%.2f" % (mask.mean() / 255.0)
            if len(out) < n and fg_range[0] < float(ratio) < fg_range[1]:
                out.append((to_uint8(photos[b, :, :, :3]), mask, ratio))
    return out


def recipe_tree(layout, root, train, test):
    """The photos as a tree of the dataset's layout under ``root`` ->
    (dataroot, the directory of the ATR split lists or None).  ``cub``:
    ``{train,test}/c0/sNNN.jpg`` with ``sNNN_<ratio>.png`` masks;
    ``market``: ``seg_hmr/{train_all,query}/0001/sNNN_<ratio>.png`` masks with
    the RGB as PNG at the same place under ``pytorch``; ``atr``:
    ``Seg/<name>_<ratio>.png`` masks, ``JPEGImages/<name>.jpg`` and the
    split lists ``lists/ATR_{train,test}.txt``."""
    def write_png(arr, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as fp:
            fp.write(encode_png(arr))

    def write_jpeg(arr, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_array_image(arr, path, quality=100)

    splits = (("train", train), ("test", test))
    if layout == "cub":
        for split, photos in splits:
            for i, (rgb, mask, ratio) in enumerate(photos):
                stem = os.path.join(root, split, "c0", f"s{i:03d}")
                write_jpeg(rgb, stem + ".jpg")
                write_png(mask, f"{stem}_{ratio}.png")
        return root, None
    if layout == "market":
        for split, photos in (("train_all", train), ("query", test)):
            for i, (rgb, mask, ratio) in enumerate(photos):
                write_png(rgb, os.path.join(root, "pytorch", split, "0001", f"s{i:03d}.png"))
                write_png(mask, os.path.join(root, "seg_hmr", split, "0001",
                                             f"s{i:03d}_{ratio}.png"))
        return os.path.join(root, "seg_hmr"), None
    lists = os.path.join(root, "lists")
    os.makedirs(lists)
    for split, photos in splits:
        names = []
        for i, (rgb, mask, ratio) in enumerate(photos):
            write_jpeg(rgb, os.path.join(root, "JPEGImages", f"{split}{i:03d}.jpg"))
            names.append(f"{split}{i:03d}_{ratio}.png")
            write_png(mask, os.path.join(root, "Seg", names[-1]))
        with open(os.path.join(lists, f"ATR_{split}.txt"), "w") as fp:
            fp.write("\n".join(names) + "\n")
    return os.path.join(root, "Seg"), lists


# the published recipes' runs: name -> (the CLI's module, the tree's layout,
# train photos (two steps an epoch at b48: CUB serves each photo twice), test
# photos, camera distances that put most photos' foreground inside both
# train thresholds)
RECIPE_RUNS = {
    "recipe_cub": (cli_train, "cub", 48, 16, (2.9, 3.9)),
    "recipe_market": (cli_train_market, "market", 96, 16, (2.9, 3.3)),
    "recipe_atr2": (cli_train_atr2, "atr", 96, 16, (3.6, 4.2)),
}


def recipe_phase(name, card):
    """One published recipe through its CLI on the card, as its command line
    has it (docs/RECIPES.md) but for --name, --dataroot and --niter 1, over
    a tree of its dataset's layout that this writes into
    build/recipes_smoke/<name> (its ``./template`` a link to the repo's).
    The ATR tree's split lists are read through ``data.atr._LIST_DIR``,
    which this points at them for the run.  Checks the loss lines,
    opts.yaml, the steps, the artifacts and fid/ files, the kernel launches
    of the run (three renders a step with the hard view), and the background
    of the trained encoder -> the run's kernel launches.  (``recipe_timing``
    times the recipe.)"""
    cli_mod, layout, n_train, n_test, distances = RECIPE_RUNS[name]
    work = os.path.join(ROOT, "build", "recipes_smoke", name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.symlink(os.path.join(ROOT, "template"), os.path.join(work, "template"))
    dr, fg_range = recipe_renderer(name)
    H, W = dr.render_height, dr.render_width
    recipe = recipe_flags(name)
    t0 = time.perf_counter()
    train = recipe_photo_files(dr, n_train, SEED + 100, recipe["elev_range"], distances,
                               fg_range)
    test = recipe_photo_files(dr, n_test, SEED + 200, recipe["elev_range"], distances,
                              fg_range)
    dataroot, lists = recipe_tree(layout, os.path.join(work, "data"), train, test)
    tree_s = time.perf_counter() - t0
    argv = list(RECIPES[name][1])
    argv[argv.index("--name") + 1] = "smoke"
    argv += ["--dataroot", dataroot, "--niter", "1"]

    list_dir = atr_data._LIST_DIR
    if lists:
        atr_data._LIST_DIR = lists
    timings, out, cwd = [], io.StringIO(), os.getcwd()
    kernels.reset_launches()
    t0 = time.perf_counter()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(out):
            state = cli_mod.main(argv, device=DEV, timings=timings)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        os.makedirs(os.path.join(work, "expect"))
        os.chdir(os.path.join(work, "expect"))
        with contextlib.redirect_stdout(io.StringIO()):
            expect_opt = cli_train.prepare(
                flags.build_parser(CLI_DEFAULTS[RECIPES[name][0]]).parse_args(argv))
    finally:
        os.chdir(cwd)
        atr_data._LIST_DIR = list_dir
    outf = os.path.join(work, "log", "smoke")
    opts_path = os.path.join(outf, "opts.yaml")
    saved = vars(flags.load_options(argparse.Namespace(), opts_path, skip=()))
    written = vars(expect_opt)
    opt = train_options(expect_opt)
    steps = (2 if layout == "cub" else 1) * n_train // opt.batchSize
    expect = trainer_launches(opt, 0, steps, 1)
    losses = [[float(x) for _, x in re.findall(r"(lossD|lossR): (\S+)", ln)]
              for ln in out.getvalue().splitlines() if "lossD:" in ln]
    with open(os.path.join(outf, "result.txt")) as fp:
        results = fp.read().splitlines()
    missing = [a for a in FRONTEND_ARTIFACTS if not os.path.isfile(os.path.join(outf, a))]
    fid_files = eval_file_counts(outf)
    photos = torch.as_tensor(np.stack([np.concatenate([rgb, mask[..., None]], -1)
                                       for rgb, mask, _ in train[:opt.batchSize]]),
                             device=DEV).float() / 255.0
    bg = Reconstructor(state.netE, dr, opt, template=state.template).encode(photos)["bg"]
    epochs = [t for t in timings if "epoch" in t]
    emit("recipe", config=name, card=card, shape=shape_of(dr, opt.batchSize), argv=argv,
         tree_s=tree_s, seconds=seconds, epochs=[t["epoch"] for t in epochs],
         seconds_per_epoch=[t["train_s"] for t in epochs],
         train_images_per_s=[t["train_images"] / t["train_s"] for t in epochs],
         evals=[dict(e, epoch=t["epoch"]) for t in epochs for e in t["eval"]],
         artifacts_s=[t.get("artifacts_s") for t in epochs], loss_lines=losses,
         launches=launches, expected_launches=expect, steps=state.step, swa_n=state.swa_n,
         opts_yaml_equal=saved == written, missing_artifacts=missing, fid_files=fid_files,
         bg_shape=list(bg.shape))
    require(len(losses) == 2 and all(len(v) == 2 and all(map(math.isfinite, v))
                                     for v in losses), losses)
    require((state.step, state.swa_n) == (2 * steps, 2), (state.step, state.swa_n))
    require(launches == expect, (launches, expect))
    require(len(results) == 10 and sum("(SWA)" in ln for ln in results) == 5, results)
    require(saved == written, (saved, written))
    require(not missing, missing)
    require(fid_files == EVAL_FILES, fid_files)
    require(tuple(bg.shape) == (opt.batchSize, H, W, 3) and bool(torch.isfinite(bg).all()),
            bg.shape)
    del state, bg
    torch.cuda.empty_cache()
    return launches


def recipe_renderer(name):
    """The recipe's renderer on sphere.obj, and the foreground ratios inside
    both its train thresholds (both train loaders take every photo)."""
    recipe = recipe_flags(name)
    dr = DiffRender(SPHERE, recipe["imageSize"], ratio=recipe["ratio"],
                    init_ellipsoid=recipe["ellipsoid"], device=DEV)
    (a, b), (c, d) = ((float(v) for v in recipe[k].split(","))
                      for k in ("threshold", "clean_threshold"))
    return dr, (max(a, c), min(b, d))


def recipe_timing(name, card):
    """Serving and the train step of the recipe at b48 with a fresh model,
    on the first batch of its run's train photos."""
    _, _, _, _, distances = RECIPE_RUNS[name]
    dr, fg_range = recipe_renderer(name)
    topt = preset_options(TrainOptions, name, template_path=SPHERE)
    first = recipe_photo_files(dr, topt.batchSize, SEED + 100, topt.elev_range, distances,
                               fg_range)
    photos = torch.as_tensor(np.stack([np.concatenate([rgb, mask[..., None]], -1)
                                       for rgb, mask, _ in first]), device=DEV).float() / 255.0
    trainer = build_trainer(topt)
    tdr = trainer.diff_render
    estimate_bn_stats(trainer.state.netE, [photos], tdr.vertices_init,
                      tdr.vertices_laplacian_matrix)
    rec = Reconstructor(trainer.state.netE, tdr, topt)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    att = rec.encode(photos)
    serving = {"encode_ms": cuda_ms(lambda: rec.encode(photos), iters=10),
               "render_ms": cuda_ms(lambda: tdr.render(**att), iters=10),
               "step_ms": cuda_ms(lambda: rec(photos, generator=gen), iters=10)}
    serving["images_per_s"] = photos.shape[0] * 1000.0 / serving["step_ms"]
    kernels.reset_launches()
    trainer.step(photos, 3e-4, 3e-4, train_shape=0)
    torch.cuda.synchronize()
    one_step = {k: v for k, v in kernels.LAUNCHES.items() if v}
    torch.cuda.reset_peak_memory_stats()
    training = training_timing(trainer, tdr, photos, reps=4)
    emit("timing_recipe", config=name, card=card, shape=shape_of(tdr, photos.shape[0]),
         serving=serving, training=training, step_launches=one_step,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    require(one_step == step_launches(topt, 0), (one_step, step_launches(topt, 0)))
    del trainer, rec, att
    torch.cuda.empty_cache()


def recipes_phase(card):
    """The three published recipes' runs (recipe_phase) -> the kernel
    launches of their runs, summed."""
    t0 = time.perf_counter()
    total = {}
    for name in RECIPES:
        for k, v in recipe_phase(name, card).items():
            total[k] = total.get(k, 0) + v
    emit("recipes", card=card, seconds=time.perf_counter() - t0, launches=total)
    return total


def recipe_step_gpu_vs_cpu():
    """Phase 5 (a) for the Market recipe (--bg --hard, 128x64): one step at
    b4 on the card against the same step on the CPU."""
    topt = preset_options(TrainOptions, "recipe_market", template_path=SPHERE,
                          droprate="0,0,0", batchSize=4)
    kw = dict(ratio=topt.ratio, init_ellipsoid=topt.ellipsoid)
    dr = DiffRender(SPHERE, topt.imageSize, device=DEV, **kw)
    dr_cpu = DiffRender(SPHERE, topt.imageSize, device="cpu", **kw)
    photos = recipe_photos(dr, 4, SEED + 5, topt.elev_range, RECIPE_RUNS["recipe_market"][4])
    train_step_gpu_vs_cpu(dr, dr_cpu, photos, topt, "recipe_market")


# the options phase: name -> (the preset the options change, None for the
# flags' defaults (sphere.obj, 128^2, hr18sv2 / res34, b32); the options)
OPTION_SETS = {
    "options_encoder_critic": (None, dict(norm="ibn", makeup=2, nolpl=True, inv=0.5,
                                          gan_type="lsgan", dis1=0.1, dis2=0.1,
                                          lambda_lc=0.1)),
    "options_ln_sn_adamw": (None, dict(norm="ln", makeup=5, sn_dis=1, adamw=True,
                                       amsgrad=False, wd=1e-4)),
    "options_market_hmr": ("recipe_market", dict(norm="in", makeup=1, hmr=1.0)),
}
OPTION_STEPS = 8
# the sets photographed over a smooth random background (the recipes'
# photos), with their camera distances; the others white-composited.  The
# makeup refinement (1-4) needs it: on white, the texture map the flow
# samples is nearly flat, and float32 noise fills it (the port on the CPU
# against itself in float64 at b4/128^2: 21.5% of the refined texels 1e-3
# apart on white photos, 6.0% over a background; 2.5% and 0.13% unrefined)
OPTION_BACKGROUNDS = {"options_encoder_critic": (2.9, 3.9),
                      "options_market_hmr": RECIPE_RUNS["recipe_market"][4]}
# The card-vs-CPU step of a set with the makeup refinement (1-4) scales the
# refinement's last conv by this on both devices.  At its init scale three
# texels in four sit past the refinement's clip, and its InstanceNorm
# spreads each texel's float32 noise over its neighbours: card vs CPU
# missed the rule on white photos (24% of Xir's pixels past 1e-3), and at
# this scale over a background it holds with a wide margin (99.98% within,
# the worst 2.1e-3).  The whole-step parity tests scale it alike
# (tests/torch_option_step.py).
REFINEMENT_SCALE = 0.02


def quiet_refinement(state):
    """Scale the makeup refinement's last conv by REFINEMENT_SCALE."""
    enc = state.netE.texture_enc
    if enc.refine:
        conv = getattr(enc, enc.refine[-1]).Conv_0
        with torch.no_grad():
            conv.weight.mul_(REFINEMENT_SCALE)
            conv.bias.mul_(REFINEMENT_SCALE)


def option_options(name, **overrides):
    """``TrainOptions`` of the option set ``name`` (on sphere.obj)."""
    preset, changes = OPTION_SETS[name]
    if preset is None:
        return TrainOptions(template_path=SPHERE, **changes, **overrides)
    return preset_options(TrainOptions, preset, template_path=SPHERE, **changes, **overrides)


def option_photos(name, dr, batch, seed):
    """The set's photos: the recipes' (over a smooth background) for the sets
    of OPTION_BACKGROUNDS, else the other phases' synthetic photos."""
    opt = option_options(name)
    if name in OPTION_BACKGROUNDS:
        return recipe_photos(dr, batch, seed, opt.elev_range, OPTION_BACKGROUNDS[name])
    return synthetic_photos(dr, batch, seed, opt.elev_range)


def body_meshes(batch, seed):
    """(batch, 6890, 3) body meshes on the card for ``--hmr``: smpl_uv.obj's
    vertices, normalised as a template is, each under a seeded jitter (a
    scale an axis and noise)."""
    v = mesh_ops.normalize_template(load_obj(SMPL).vertices)
    rs = np.random.RandomState(seed)
    meshes = v[None] * rs.uniform(0.9, 1.1, (batch, 1, 3)) + 0.01 * rs.randn(batch, *v.shape)
    return torch.as_tensor(meshes.astype(np.float32), device=DEV)


def options_timing(name, card):
    """The option set's serving step and train step (with the D update's ms
    on its own) at its batch, a fresh model at full width."""
    opt = option_options(name)
    trainer = build_trainer(opt)
    dr, B = trainer.diff_render, opt.batchSize
    photos = option_photos(name, dr, B, SEED + 300)
    Va = body_meshes(B, SEED + 301) if opt.hmr > 0 else None
    estimate_bn_stats(trainer.state.netE, [photos], dr.vertices_init,
                      dr.vertices_laplacian_matrix)
    rec = Reconstructor(trainer.state.netE, dr, opt)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    att = rec.encode(photos)
    serving = {"encode_ms": cuda_ms(lambda: rec.encode(photos), iters=10),
               "render_ms": cuda_ms(lambda: dr.render(**att), iters=10),
               "step_ms": cuda_ms(lambda: rec(photos, generator=gen), iters=10)}
    serving["images_per_s"] = B * 1000.0 / serving["step_ms"]
    torch.cuda.reset_peak_memory_stats()
    training = training_timing(trainer, dr, photos, reps=4, Va=Va)
    emit("timing_options", config=name, card=card, shape=shape_of(dr, B),
         options=OPTION_SETS[name][1], critic=type(trainer.state.netD).__name__,
         serving=serving, training=training,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del trainer, rec, att
    torch.cuda.empty_cache()


def options_checks(name, card):
    """The option set at full width on the card: a serving step through
    Reconstructor (K1 and K3 five times), OPTION_STEPS train steps with
    dropout on (finite metrics, no skipped side, nothing dropped, the
    launches of the default step at the same train_shape: the options add
    encoder passes, a critic and losses, no render), and one step at b4 on
    the card against the same step on the CPU (train_step_gpu_vs_cpu) ->
    the kernel launches of the serving and the train steps."""
    t0 = time.perf_counter()
    opt = option_options(name)
    trainer = build_trainer(opt)
    dr, B = trainer.diff_render, opt.batchSize
    lpl = dr.vertices_laplacian_matrix
    batches = [option_photos(name, dr, B, SEED + 310 + i) for i in range(4)]
    meshes = [body_meshes(B, SEED + 320 + i) if opt.hmr > 0 else None for i in range(4)]
    estimate_bn_stats(trainer.state.netE, batches[:1], dr.vertices_init, lpl)
    rec = Reconstructor(trainer.state.netE, dr, opt)
    kernels.reset_launches()
    outs = rec(batches[0], generator=torch.Generator(device=DEV).manual_seed(SEED))
    torch.cuda.synchronize()
    serving = {k: v for k, v in kernels.LAUNCHES.items() if v}
    require(all(bool(torch.isfinite(r).all()) for r in outs[:5]), "non-finite render")
    require(serving == {"raster_fwd": 5, "texture_fwd": 5}, serving)

    kernels.reset_launches()
    history = [metric_floats(trainer.step(batches[i % 4], 3e-4, 3e-4,
                                          warm_up=min(1.0, 0.01 + i / 20.0),
                                          Va=meshes[i % 4])[0])
               for i in range(OPTION_STEPS)]
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    expect = {k: v * OPTION_STEPS for k, v in step_launches(opt, 0).items()}
    emit("options_train_steps", config=name, card=card, shape=shape_of(dr, B),
         options=OPTION_SETS[name][1], critic=type(trainer.state.netD).__name__,
         steps=OPTION_STEPS, launches=launches, expected_launches=expect,
         serving_launches=serving, first=history[0], last=history[-1],
         lossR_data=[m["lossR_data"] for m in history])
    for i, m in enumerate(history):
        require(all(math.isfinite(v) for v in m.values()), (i, m))
        require(m["skipE"] == m["skipD"] == 0.0, (i, m))
        require(m["dropped_faces"] == m["dropped_tex_chunks"] == 0.0, (i, m))
    require(launches == expect, (launches, expect))
    del trainer, rec, outs, batches
    torch.cuda.empty_cache()

    topt = option_options(name, droprate="0,0,0", batchSize=4)
    kw = dict(ratio=topt.ratio, init_ellipsoid=topt.ellipsoid)
    dr4 = DiffRender(SPHERE, topt.imageSize, device=DEV, **kw)
    dr_cpu = DiffRender(SPHERE, topt.imageSize, device="cpu", **kw)
    train_step_gpu_vs_cpu(dr4, dr_cpu, option_photos(name, dr4, 4, SEED + 5), topt, name,
                          Va=body_meshes(4, SEED + 6) if topt.hmr > 0 else None,
                          adjust=quiet_refinement)
    emit("options", config=name, card=card, seconds=time.perf_counter() - t0)
    return {k: serving.get(k, 0) + launches.get(k, 0) for k in {*serving, *launches}}


# the modes of generate_market: flags, and renders a batch (K1 and K3 each)
GENERATE_MODES = {"default": ([], 4), "texture_swap": (["--texture_swap"], 4),
                  "new_class9": (["--new_class9"], 9), "poisson": (["--poisson"], 4)}


def files_under(root):
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs)


def generate_market_phase(card):
    """``cli.generate_market`` on the Market recipe's run (the `recipes`
    phase's: --bg, b48, 128x64, sphere.obj at ellipsoid 2, hr18sv2 / res34)
    over its 96 train photos in each mode: every expected file written and
    decodable, K1 and K3 four times a batch (nine in the new-class mode) and
    no other kernel; then one batch of four photos, the default mode, on
    the card and on the CPU, the composites held to the slice's card-vs-CPU
    rules -> the kernel launches of the four runs."""
    work = os.path.join(ROOT, "build", "recipes_smoke", "recipe_market")
    dataroot = os.path.join(work, "data", "seg_hmr")
    stems = sorted(os.path.basename(p).rsplit("_", 1)[0] for p in
                   files_under(os.path.join(dataroot, "train_all")))
    n = len(stems)
    total = {}
    for mode, (flags_, renders) in GENERATE_MODES.items():
        out = os.path.join(ROOT, "build", "tools_smoke", mode)
        shutil.rmtree(out, ignore_errors=True)
        argv = ["--name", "smoke", "--dataroot", dataroot, "--batchSize", "48", "--out", out,
                *flags_]
        result, seconds, launches, line = eval_cli("generate_market", cli_generate_market.main,
                                                   argv, work)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        written, on_disk = sorted(set(result["files"])), files_under(out)
        if mode == "new_class9":  # pair folders; a pair of one id writes nothing
            ok = (0.8 * 9 * n <= len(result["files"]) <= 9 * n and all(
                os.path.basename(f) in ("-45.jpg", "000.jpg", "045.jpg") for f in written))
        else:
            ok = written == sorted(os.path.join(out, "hq", "pytorch", "0001", f"{s}_az{d}.jpg")
                                   for s in stems for d in cli_generate_market.AZIMUTH_DELTAS)
            ok = ok and len(result["files"]) == 4 * n
        shapes = {read_image(f).shape for f in on_disk}
        emit("generate_market", mode=mode, card=card, photos=result["images"], seconds=seconds,
             cli_seconds=json.loads(line.split("seconds: ", 1)[1]),
             images_per_s_through_loader=result["images_per_s"], files=len(on_disk),
             writes=len(result["files"]), launches=launches)
        batches = math.ceil(n / 48)
        require(launches == {"raster_fwd": renders * batches, "texture_fwd": renders * batches},
                (mode, launches))
        require(ok and on_disk == written and shapes == {(128, 64, 3)},
                (mode, len(written), len(on_disk), shapes))

    # one batch of four photos on the card and on the CPU, the composites kept
    sub = os.path.join(ROOT, "build", "tools_smoke", "sub")
    shutil.rmtree(sub, ignore_errors=True)
    for kind in ("seg_hmr", "pytorch"):
        src = os.path.join(work, "data", kind, "train_all", "0001")
        dst = os.path.join(sub, kind, "train_all", "0001")
        os.makedirs(dst)
        for name in sorted(os.listdir(src))[:4]:
            shutil.copy(os.path.join(src, name), dst)
    composites, real_save = {}, cli_generate_market.save_array_image
    t0 = time.perf_counter()
    try:
        for label, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
            store = composites.setdefault(label, {})
            cli_generate_market.save_array_image = lambda img, path, store=store: store.update(
                {os.path.basename(path): np.array(img, np.float32)})
            argv = ["--name", "smoke", "--dataroot", os.path.join(sub, "seg_hmr"),
                    "--batchSize", "4", "--out", os.path.join(sub, "out_" + label)]
            cwd = os.getcwd()
            os.chdir(work)
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    cli_generate_market.main(argv, device=dev)
            finally:
                os.chdir(cwd)
    finally:
        cli_generate_market.save_array_image = real_save
    names = sorted(composites["cpu"])
    card_r, cpu_r = (np.stack([composites[k][f] for f in names]) for k in ("card", "cpu"))
    rstats = parity.render_stats(  # rgb only: alpha 0 on both sides
        [np.concatenate([cpu_r, np.zeros_like(cpu_r[..., :1])], -1)],
        [np.concatenate([card_r, np.zeros_like(card_r[..., :1])], -1)])
    emit("generate_market_gpu_vs_cpu", card=card, photos=4, composites=len(names),
         seconds=time.perf_counter() - t0, **rstats)
    require(sorted(composites["card"]) == names and len(names) == 16, names)
    parity.check_renders(rstats, rgb_flip_pixels=4)
    return total


@contextlib.contextmanager
def plain_render():
    """DiffRender.render through the plain versions of K1 and K3, on the
    same tensors."""
    saved = renderer_module.rasterize_fused, renderer_module.texture_render
    renderer_module.rasterize_fused = rasterize_fused_plain
    renderer_module.texture_render = texture_render_plain
    try:
        yield
    finally:
        renderer_module.rasterize_fused, renderer_module.texture_render = saved


def template_animation_phase(card, outf):
    """``cli.template_animation`` over the templates of this script's runs
    (128^2): a run directory (build/tools_smoke/anim) with the front end's
    opts.yaml and, as epochs 0, 1, 2..., the front end's
    epoch_000_template.obj (its artifacts come every 10 epochs), its
    ckpts/best_mesh.obj (after the trainer phase's EM update) and each
    recipe run's epoch_000_template.obj: one hard-mode render (sigmainv
    1e6) a template, the GIF's frames and the strip.  Then the same renders,
    and each template at 8 azimuths, against the plain versions of K1 and
    K3 on the card, and K1 alone at 1e6 at b32 / 128^2 against its plain
    version (the rasterizer's rules, and the renders' on one device: no rgb
    value past its cap) -> the kernel launches of the CLI."""
    anim = os.path.join(ROOT, "build", "tools_smoke", "anim", "log", "smoke")
    shutil.rmtree(os.path.dirname(os.path.dirname(anim)), ignore_errors=True)
    os.makedirs(anim)
    shutil.copy(os.path.join(outf, "opts.yaml"), anim)
    sources = [os.path.join(outf, "epoch_000_template.obj"),
               os.path.join(outf, "ckpts", "best_mesh.obj")]
    sources += [p for p in (os.path.join(ROOT, "build", "recipes_smoke", name, "log", "smoke",
                                         "epoch_000_template.obj") for name in RECIPES)
                if os.path.isfile(p)]
    objs = [f"epoch_{k:03d}_template.obj" for k in range(len(sources))]
    for src, name in zip(sources, objs):
        shutil.copy(src, os.path.join(anim, name))
    work = os.path.dirname(os.path.dirname(anim))
    result, seconds, launches, line = eval_cli("template_animation",
                                               cli_template_animation.main, ["--name", "smoke"],
                                               work)
    frames = gif_frames(os.path.join(work, result["gif"]))
    strip = read_image(os.path.join(work, result["png"]))
    emit("template_animation", card=card, templates=len(objs), frames=frames,
         strip_shape=list(strip.shape), seconds=seconds,
         cli_seconds=json.loads(line.split("seconds: ", 1)[1]), launches=launches)
    require(len(objs) >= 3 and result["frames"] == frames == len(objs), (objs, frames))
    require(launches == {"raster_fwd": len(objs), "texture_fwd": len(objs)}, launches)
    require(strip.shape == (128, 128 * len(objs[::max(1, len(objs) // 8)]), 3), strip.shape)
    outf = anim

    sigmainv = cli_template_animation.HARD_SIGMAINV
    dr = DiffRender(os.path.join(outf, objs[0]), 128, init_ellipsoid=-1, sigmainv=sigmainv,
                    device=DEV)
    gray = torch.full((1, 256, 128, 3), 0.7, device=DEV)
    atts = [cli_template_animation.template_attributes(
        load_obj(os.path.join(outf, f)).vertices, dr.num_vertices, gray, DEV) for f in objs]
    batch = {k: (None if v is None else torch.cat([a[k] for a in atts]).repeat_interleave(8, 0))
             for k, v in atts[0].items()}
    batch["azimuths"] = torch.arange(-180.0, 180.0, 45.0, device=DEV).repeat(len(objs))
    rstats, kstats = [], []
    with torch.no_grad():
        for att in atts + [batch]:
            ours = dr.render(**att)[0]
            with plain_render():
                plain = dr.render(**att)[0]
            fvc, fvi, fn = dr.project(att)
            args = (fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn)
            kstats.append(parity.raster_stats(
                raster_fwd(face_rows(*args).contiguous(), sigmainv, 128, 128),
                rasterize_fused_plain(*args, sigmainv=sigmainv, height=128, width=128)))
            rstats.append(parity.render_stats([plain], [ours]))
    args, _ = raster_case(128, 32, SEED + 400)
    b32 = parity.raster_stats(raster_fwd(face_rows(*args).contiguous(), sigmainv, 128, 128),
                              rasterize_fused_plain(*args, sigmainv=sigmainv, height=128,
                                                    width=128))
    emit("parity_hard_mode", card=card, sigmainv=sigmainv, renders=len(atts) * 9,
         render=rstats, raster=kstats, raster_b32=b32)
    for r, k in zip(rstats, kstats):
        parity.check_raster(k)
        parity.check_renders(r)
    parity.check_raster(b32)
    return launches


def host_tools_phase(card):
    """The host tools on trees written here (build/tools_smoke/host): the
    data preparation (``prepare_masks`` with its rename and its hole-filling,
    ``preprocess_cub``, ``prepare_cub_edges``), ``data/native.py``,
    ``poisson_edit``, and ``cli.tools`` (``backface``, ``sphere2ellipsoid``,
    ``demo_mask_composite``, and ``clear_gif`` / ``clear_model`` on a copy
    of the front end's run, hard links of its files), each output held to a
    second computation of it in numpy."""
    from PIL import Image  # writes the trees as the tools read them
    import PIL
    import scipy
    from scipy.signal import convolve2d

    root = os.path.join(ROOT, "build", "tools_smoke", "host")
    shutil.rmtree(root, ignore_errors=True)
    rs = np.random.RandomState(SEED + 300)
    checks = {}

    def mask(h, w, holes=0.0):
        m = np.zeros((h, w), np.uint8)
        m[rs.randint(2, h // 4):h - rs.randint(2, h // 4), rs.randint(2, w // 4):w - 3] = 255
        m[rs.rand(h, w) < holes] = 0
        return m

    def save(arr, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path)

    # prepare_masks: CUB's rename; ATR's hole-filling into Seg/
    masks = {os.path.join(root, "cub", s, "c0", f"m{i}.png"): mask(60, 40)
             for s in ("train", "test") for i in range(3)}
    for path, m in masks.items():
        save(m, path)
    with contextlib.redirect_stdout(io.StringIO()):  # a line a mask
        ratios = prepare.prepare_masks(os.path.join(root, "cub"), "*/*/*.png")
    want = sorted(p[:-4] + "_%.2f.png" % (m > 0).mean() for p, m in masks.items())
    checks["prepare_masks"] = (files_under(os.path.join(root, "cub")) == want
                               and len(ratios) == len(masks))
    atr = {os.path.join(root, "atr", "SegmentationClassAug", f"a{i}.png"): mask(50, 30, 0.1)
           for i in range(3)}
    for path, m in atr.items():
        save(m, path)
    with contextlib.redirect_stdout(io.StringIO()):
        prepare.prepare_masks(os.path.join(root, "atr"), "SegmentationClassAug/*.png",
                              hole_fill=True, out_replace=("SegmentationClassAug", "Seg"))
    ok = True
    for path, m in atr.items():
        filled = (m > 0).astype(np.float64)
        for _ in range(5):  # the hole-filling's 3 x 3 sums as a convolution
            filled = (filled + convolve2d(filled, np.ones((3, 3)), mode="same") / 9.0
                      > 4.0 / 9.0).astype(np.float64)
        out = path.replace("SegmentationClassAug", "Seg")[:-4] + "_%.2f.png" % filled.mean()
        ok = ok and os.path.isfile(out) and np.array_equal(
            read_image(out), (filled * 255).astype(np.uint8))
    checks["prepare_masks_hole_fill"] = ok

    # preprocess_cub over a CUB_200_2011 layout, then prepare_cub_edges
    cub = os.path.join(root, "CUB_200_2011")
    rows, crops = {"images.txt": [], "train_test_split.txt": [], "bounding_boxes.txt": []}, []
    for i in range(4):
        rel = f"001.Bird/b{i}.jpg"
        h, w = 80 + 4 * i, 100 - 6 * i
        img = to_uint8(smooth_random((1, h, w, 3), SEED + 310 + i)[0])
        seg = mask(h, w)
        save(img, os.path.join(cub, "images", rel))
        save(seg, os.path.join(cub, "segmentations", rel[:-4] + ".png"))
        x, y, bw, bh = 10.0 + i, 5.0 + 2 * i, w / 2, h / 1.5
        rows["images.txt"].append(f"{i + 1} {rel}")
        rows["train_test_split.txt"].append(f"{i + 1} {int(i != 3)}")
        rows["bounding_boxes.txt"].append(f"{i + 1} {x} {y} {bw} {bh}")
        x1, y1 = int(min(max(x - bw * 0.1, 0), w)), int(min(max(y - bh * 0.1, 0), h))
        x2, y2 = int(min(max(x + bw * 1.1, 0), w)), int(min(max(y + bh * 1.1, 0), h))
        crops.append(("train" if i != 3 else "test", rel, seg[y1:y2, x1:x2]))
    for name, lines in rows.items():
        with open(os.path.join(cub, name), "w") as fp:
            fp.write("\n".join(lines) + "\n")
    dst = os.path.join(root, "CUB_Data")
    prepare.preprocess_cub(cub, dst)
    checks["preprocess_cub"] = all(
        np.array_equal(read_image(os.path.join(dst, s, rel[:-4] + ".png")), seg)
        and read_image(os.path.join(dst, s, rel)).shape == seg.shape + (3,)
        for s, rel, seg in crops)
    prepare.prepare_cub_edges(dst)
    ok = True
    for s, rel, seg in crops[:3]:
        stem = os.path.join(dst, s, rel[:-4])
        smooth, edge = read_image(stem + "_smooth.png"), read_image(stem + "_edge.png")
        ok = ok and np.array_equal(smooth, np.repeat(np.where(seg > 160, 255, 0).astype(
            np.uint8)[..., None], 3, -1)) and set(np.unique(edge)) <= {0, 255}
        ok = ok and read_image(stem + "_coarse_edge.png").shape == seg.shape + (3,)
    checks["prepare_cub_edges"] = ok

    # native: the library's float32 steps against float64 formulas
    img = rs.randint(0, 256, (37, 23, 3)).astype(np.uint8)
    y, x = ((np.arange(n) + 0.5) * s / n - 0.5 for n, s in ((61, 37), (45, 23)))
    y0, x0 = np.floor(y).astype(int), np.floor(x).astype(int)
    wy, wx = (y - y0)[:, None, None], (x - x0)[None, :, None]
    yc = [np.clip(y0 + k, 0, 36) for k in (0, 1)]
    xc = [np.clip(x0 + k, 0, 22) for k in (0, 1)]
    f = img.astype(np.float64)
    bil = ((1 - wy) * ((1 - wx) * f[yc[0]][:, xc[0]] + wx * f[yc[0]][:, xc[1]])
           + wy * ((1 - wx) * f[yc[1]][:, xc[0]] + wx * f[yc[1]][:, xc[1]]))
    d = np.abs(native.resize_bilinear(img, 61, 45).astype(int) - np.floor(bil + 0.5))
    rgba = rs.rand(9, 7, 4).astype(np.float32)
    white = rgba[..., :3].astype(np.float64) * rgba[..., 3:] + (1 - rgba[..., 3:])
    checks["native"] = (d.max() <= 1 and (d == 0).mean() > 0.99
                        and np.abs(native.white_composite(rgba)[..., :3] - white).max() <= 1e-6)

    # poisson_edit: the discrete Poisson equation inside the mask, the
    # target outside it
    src, tgt = (to_uint8(smooth_random((1, 128, 64, 3), SEED + k)[0]) for k in (320, 321))
    m = mask(128, 64)
    t0 = time.perf_counter()
    out = poisson_edit(src, tgt, m).astype(np.float64)
    poisson_s = time.perf_counter() - t0
    omega = m > 0
    omega[0], omega[-1], omega[:, 0], omega[:, -1] = False, False, False, False

    def lap(a):
        return 4 * a[1:-1, 1:-1] - a[:-2, 1:-1] - a[2:, 1:-1] - a[1:-1, :-2] - a[1:-1, 2:]

    resid = np.abs(lap(out) - lap(src.astype(np.float64)))[omega[1:-1, 1:-1]]
    clipped = ((out == 0) | (out == 255))[1:-1, 1:-1][omega[1:-1, 1:-1]]
    checks["poisson_edit"] = (np.array_equal(out[~omega], tgt[~omega].astype(np.float64))
                              and np.percentile(resid[~clipped], 99) <= 4.0)

    # cli.tools
    counts = {}
    for t in (SPHERE, SMPL):
        mesh = load_obj(t)
        v = mesh.vertices.astype(np.float64)[mesh.faces]
        d0, d1 = v[:, 0] - v[:, 1], v[:, 1] - v[:, 2]
        area = 0.5 * np.cross(d0, d1).sum(-1)
        with contextlib.redirect_stdout(io.StringIO()):
            counts[os.path.basename(t)] = cli_tools.main(["backface", t])
        sure = np.abs(area) > 1e-6
        checks["backface_" + os.path.basename(t)] = (
            sum(counts[os.path.basename(t)]) == len(area)
            and abs(counts[os.path.basename(t)][0] - int((area > 0).sum())) <= int((~sure).sum()))
    ell = os.path.join(root, "ellipsoid.obj")
    with contextlib.redirect_stdout(io.StringIO()):
        cli_tools.main(["sphere2ellipsoid", SPHERE, ell])
    a, b = load_obj(SPHERE).vertices, load_obj(ell).vertices
    checks["sphere2ellipsoid"] = (np.abs(b[:, 1] - 2 * a[:, 1]).max() <= 1e-5
                                  and np.abs(b[:, ::2] - a[:, ::2]).max() <= 1e-6)
    photo, seg = os.path.join(root, "demo.jpg"), os.path.join(root, "demo_seg.png")
    save(to_uint8(smooth_random((1, 40, 30, 3), SEED + 330)[0]), photo)
    save((rs.rand(40, 30) * 255).astype(np.uint8), seg)
    cli_tools.demo_mask_composite(photo, seg, os.path.join(root, "demo_out.png"))
    rgb = read_image(photo).astype(np.float32) / 255.0
    keep = (read_image(seg).astype(np.float32) / 255.0 > 0.63)[..., None]
    checks["demo_mask_composite"] = np.array_equal(
        read_image(os.path.join(root, "demo_out.png")),
        ((rgb * keep + (1 - keep)) * 255).astype(np.uint8))

    # clear_gif and clear_model on a copy of the front end's run (hard links)
    run = os.path.join(root, "log", "smoke")
    shutil.copytree(os.path.join(ROOT, "build", "frontend_smoke", "log", "smoke"), run,
                    copy_function=os.link)
    before = files_under(run)
    with contextlib.redirect_stdout(io.StringIO()):
        cli_tools.main(["clear_gif", "--log_dir", os.path.join(root, "log")])
        cli_tools.main(["clear_model", "--log_dir", os.path.join(root, "log")])
    gone = {f for f in before if re.fullmatch(
        r"epoch_\d+_(rotation.*\.gif|Iter_.*\.png|mesh_recon\.png)", os.path.basename(f))}
    gone.add(os.path.join(run, "ckpts", "latest_ckpt"))
    checks["clear_gif_clear_model"] = (files_under(run) == sorted(set(before) - gone)
                                       and len(gone) >= 4
                                       and os.path.isfile(os.path.join(run, "ckpts",
                                                                       "best_ckpt")))
    checks = {k: bool(v) for k, v in checks.items()}
    emit("host_tools", card=card, pillow=PIL.__version__, scipy=scipy.__version__,
         backface=counts, poisson_s=poisson_s, checks=checks)
    require(all(checks.values()), checks)


def tools_phase(card, outf):
    """generate_market, template_animation and the host tools -> the kernel
    launches of the CLIs."""
    t0 = time.perf_counter()
    total = generate_market_phase(card)
    for k, v in template_animation_phase(card, outf).items():
        total[k] = total.get(k, 0) + v
    host_tools_phase(card)
    emit("tools", card=card, seconds=time.perf_counter() - t0, launches=total)
    return total


def timing_models(config):
    """For the timing: a b32 trainer of the configuration (weights from the
    seed, BatchNorm statistics re-estimated on a batch as the train steps'
    are) and a Reconstructor on its encoder -> (Reconstructor, renderer, b4
    photos (the serving slice's), trainer)."""
    trainer = build_trainer(options(TrainOptions, config))
    dr, opt = trainer.diff_render, trainer.opt
    estimate_bn_stats(trainer.state.netE, [synthetic_photos(dr, 32, SEED + 10, opt.elev_range)],
                      dr.vertices_init, dr.vertices_laplacian_matrix)
    photos = synthetic_photos(dr, 4, SEED + 1, opt.elev_range)
    return Reconstructor(trainer.state.netE, dr, opt), dr, photos, trainer


# The phases after the timing run side by side, each lane a process of its
# own (``python3 chip_smoke.py --lane NAME``): the lane -> the lanes it waits
# for.  The card's 80 GB set the grouping: the dense template's slice takes
# 32 GB at b32 and the 'exact' one 23 GB, so they share a lane, and the
# option sets (18, 8 and 10 GB) wait for it and the default's slice; the
# tools read the front end's and the Market recipe's runs.
LANES = {"slices_dense": (), "slices": (), "frontend": (), "recipes": (),
         **{name: ("slices_dense", "slices") for name in OPTION_SETS},
         "tools": ("frontend", "recipes")}
FRONTEND_OUTF = os.path.join(ROOT, "build", "frontend_smoke", "log", "smoke")


def slices(configs):
    """4. the serving slice and 5. the training slice of ``configs`` ->
    (serving launches, train-step launches) by configuration."""
    serve, train = {}, {}
    for config in configs:
        serve[config], _, dr, dr_cpu, photos = serving_slice(config)
        if config == "default":
            train_step_gpu_vs_cpu(dr, dr_cpu, photos)
        train[config], _ = train_steps(config, dr)
        del dr_cpu
        torch.cuda.empty_cache()
    return serve, train


# the lanes whose host work is torch on the CPU (the CPU halves of the
# card-vs-CPU checks): they yield the host to the lanes that wait on FID's
# sqrtm processes, the longest
BACKGROUND_LANES = ("slices", "slices_dense", *OPTION_SETS)


def run_lane(name, card):
    """The phases of the lane ``name``, in this process -> its results."""
    if name in BACKGROUND_LANES:
        os.nice(10)
    lap = Laps()
    if name in ("slices", "slices_dense"):
        serve, train = slices(("default",) if name == "slices" else
                              ("market_smpl", "cub_exact"))
        if name == "slices":
            # a step of the Market recipe (--bg --hard) on the card against the CPU
            recipe_step_gpu_vs_cpu()
        lap(name)
        return {"serve_launches": serve, "train_launches": train}
    if name == "frontend":
        # 8. the file front end of python train.py: a CUB-layout tree through
        # cli.train.main; 9. the trainer around the step: epochs, SWA, EM,
        # eval, FID, checkpoints; 10. the evaluation and serving CLIs on that run
        frontend_launches, argv, outf = frontend_phase(card)
        lap("frontend")
        torch.cuda.empty_cache()
        trainer_phase(card, argv, outf)
        lap("trainer")
        torch.cuda.empty_cache()
        eval_launches = eval_clis_phase(card, outf)
        lap("eval_clis")
        require(outf == FRONTEND_OUTF, (outf, FRONTEND_OUTF))
        return {"frontend": frontend_launches, "eval_clis": eval_launches}
    if name == "recipes":  # 11. the three published recipes through their CLIs
        launches = recipes_phase(card)
        lap("recipes")
        return {"recipes": launches}
    if name == "tools":
        # 12. generate_market on the Market recipe's run, template_animation
        # on the front end's, and the host tools
        launches = tools_phase(card, FRONTEND_OUTF)
        lap("tools")
        return {"tools": launches}
    launches = options_checks(name, card)  # the option sets
    lap(name)
    return {"options": launches}


def run_lanes():
    """Run every lane of LANES, each once the lanes it waits for have ended,
    their lines relayed as they come with the lane's name in them -> {lane:
    its results}.  A lane that fails fails the script; every lane process,
    and what it started (a lane is a process group of its own), is ended
    before this returns."""
    # OpenMP threads that wait sleep: the lanes' threads outnumber the CPUs;
    # and the lanes' allocators map memory as they grow, holding no reserve
    env = {**os.environ, "CHIP_SMOKE_START": repr(START), "OMP_WAIT_POLICY": "PASSIVE",
           "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
    procs, results, relays, lock = {}, {}, [], threading.Lock()

    def relay(name, proc):
        for line in proc.stdout:
            if line.startswith('{"lane_result"'):
                results[name] = json.loads(line)["lane_result"]
                continue
            if line.startswith('{"phase"'):
                line = json.dumps({**json.loads(line), "lane": name}) + "\n"
            with lock:
                sys.stdout.write(line)
                sys.stdout.flush()

    pending = dict(LANES)
    try:
        while pending or any(p.poll() is None for p in procs.values()):
            for name, waits in list(pending.items()):
                if all(w in procs and procs[w].poll() == 0 for w in waits):
                    procs[name] = subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__), "--lane", name],
                        stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT,
                        start_new_session=True)
                    relays.append(threading.Thread(target=relay, args=(name, procs[name])))
                    relays[-1].start()
                    del pending[name]
            failed = {n: p.returncode for n, p in procs.items() if p.poll() not in (None, 0)}
            require(not failed, ("lanes failed", failed))
            time.sleep(0.5)
    finally:
        for proc in procs.values():
            try:  # the lane and the processes it started (FID's sqrtm)
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        for thread in relays:
            thread.join()
    require(set(results) == set(LANES), ("lanes without results", set(LANES) - set(results)))
    return results


def main(profile_steps=0):
    lap = Laps(T0)
    # 1. toolchain
    card = kernel_times.card()
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    emit("toolchain", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0), nvcc=nvcc)
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.library()
    ptxas = [ln.strip() for ln in build.BUILD_INFO["log"].splitlines() if "Used" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=round(build.BUILD_INFO["seconds"], 3), ptxas=ptxas)
    lap("toolchain_build")

    # 3. kernel parity, kernel vs plain on the same inputs
    errs = dict.fromkeys(kernels.LAUNCHES, 0.0)
    # b32 / 128^2 is the shape the default and the cub_exact train steps run at
    for size, batch in ((256, 32), (128, 32), (128, 4)):
        args, textures = raster_case(size, batch, SEED + size)
        out = raster_fwd(face_rows(*args).contiguous(), 7000.0, size, size)
        plain = rasterize_fused_plain(*args, height=size, width=size)
        stats = parity.raster_stats(out, plain)
        emit("parity_raster", shape=f"b{batch}/{size}^2", **stats)
        parity.check_raster(stats)
        errs["raster_fwd"] = max(errs["raster_fwd"], stats["soft_max"],
                                 stats["normal_max"], stats["uv_max"])
        _, _, uv, _, hard = out
        tex = texture_fwd(uv, textures, hard)
        tstats = parity.texture_stats(tex, texture_render_plain(uv, textures, hard), hard)
        emit("parity_texture", shape=f"b{batch}/{size}^2", **tstats)
        parity.check_texture(tstats)
        errs["texture_fwd"] = max(errs["texture_fwd"], tstats["max_abs"])
        backward_parity(size, batch, args, textures, out, errs)
        plain_mode_parity(size, batch, args, errs)
        exact_parity(size, batch, errs)
        unmasked_parity(size, batch, errs)
    stress_parity(errs)
    texture_bwd_stress(errs)
    # K1-K4 at the three published recipes' shapes, b48
    recipe_shape_parity(errs)
    # the dense template: the Market shape and bench.py's, near and far cameras,
    # and the recipe's own distance range (the main path's, kept for the summary)
    dense = {(h, w, d): dense_parity(h, w, d, card, errs)
             for h, w, d in ((128, 64, (2.0, 2.0)), (128, 64, (6.5, 6.5)),
                             (128, 64, (2.0, 6.0)), (256, 256, (2.0, 2.0)),
                             (256, 256, (6.5, 6.5)))}
    # K9c: the probe of the texture kernel's body, at the probe's 256^2 and at 128^2
    probe_launches, probe_times = {}, {}
    for size in (256, 128):
        launches, probe_times[size] = texture_parts_phase(size, card, errs)
        for k, v in launches.items():
            probe_launches[k] = probe_launches.get(k, 0) + v
    torch.cuda.synchronize()
    lap("kernel_parity")

    # 6. timing (CUDA events, median after warm-up), alone on the card: the
    # kernels, the configurations' serving and train steps (fresh models at
    # full width), the recipes' and the option sets'
    models = {config: timing_models(config) for config in CONFIGS}
    recs = {config: m[:3] for config, m in models.items()}
    trainers = {config: m[3] for config, m in models.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    # every kernel on the device alone, warm and cold (kernel_times), then
    # the plain versions and the library calls on the same inputs
    device = kernel_times.measure(kernel_times.load_port())
    for rec in device:
        emit("timing_device", card=card, **rec)
    times = {size: kernel_timing(size, card, device) for size in (256, 128)}
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    for config, (rec, dr, photos) in recs.items():
        batch = photos.repeat(8, 1, 1, 1)  # b32
        rec.netE.eval()
        encode_ms = cuda_ms(lambda: rec.encode(batch), iters=10)
        att32 = rec.encode(batch)
        render_ms = cuda_ms(lambda: dr.render(**att32), iters=10)
        step_ms = cuda_ms(lambda: rec(batch, generator=gen), iters=10)
        emit("timing_serving", config=config, shape=shape_of(dr, 32), card=card,
             sm_clock_power_temp=smi, encode_ms=encode_ms, render_ms=render_ms,
             step_ms=step_ms, images_per_s=32 * 1000.0 / step_ms)
        train_batch = synthetic_photos(dr, 32, SEED + 20, trainers[config].opt.elev_range)
        emit("timing_training", config=config, shape=shape_of(dr, 32), card=card,
             **training_timing(trainers[config], dr, train_batch,
                               reps=4 if config == "cub_exact" else 10))
    if profile_steps:
        rec, dr, photos = recs["default"]
        trainer = trainers["default"]
        batch = photos.repeat(8, 1, 1, 1)
        rec.netE.eval()
        train_batch = synthetic_photos(dr, 32, SEED + 20)
        emit("profile_serving", shape="b32/128^2", card=card,
             **profile(lambda: rec(batch, generator=gen), profile_steps))
        emit("profile_training", shape="b32/128^2", card=card,
             **profile(lambda: trainer.step(train_batch, 3e-4, 3e-4), profile_steps))
        # the critic's update alone, on the detached renders of one forward
        with torch.no_grad(), _no_tf32():
            draws = sample_draws(trainer.opt, 32, trainer.generator, DEV)
            outs = e_outputs(trainer.state, dr, trainer.opt, train_batch, draws, 0)
        emit("profile_d_update", shape="b32/128^2", card=card,
             **profile(_no_tf32()(lambda: update_d(trainer.state, outs, trainer.opt, draws,
                                                   3e-4, 1.0)), profile_steps))
    del trainers, recs, models
    torch.cuda.empty_cache()
    lap("timing")
    for name in RECIPES:
        recipe_timing(name, card)
    lap("recipe_timing")
    for name in OPTION_SETS:
        options_timing(name, card)
    lap("options_timing")

    # 4.-5. the serving and training slices, 8.-10. the file front end, the
    # trainer and the eval CLIs on its run, 11. the recipes' runs, the
    # options' checks and 12. the tools: side by side, each lane a process of
    # its own
    gc.collect()
    torch.cuda.empty_cache()
    emit("lanes_start", main_reserved_gib=torch.cuda.memory_reserved() / 2 ** 30)
    results = run_lanes()
    serve_launches = {**results["slices"]["serve_launches"],
                      **results["slices_dense"]["serve_launches"]}
    train_launches = {**results["slices"]["train_launches"],
                      **results["slices_dense"]["train_launches"]}
    frontend_launches = results["frontend"]["frontend"]
    eval_launches = results["frontend"]["eval_clis"]
    recipe_launches = results["recipes"]["recipes"]
    tools_launches = results["tools"]["tools"]
    option_launches = {}
    for name in OPTION_SETS:
        for k, v in results[name]["options"].items():
            option_launches[k] = option_launches.get(k, 0) + v
    lap("lanes")

    # the kernels' summary: name -> (source, the TPU kernel it replaces, the
    # configuration whose main path launches it, where its times were taken)
    csrc, pallas = "magicmirror_torch/csrc/", "magicmirror/ops/pallas/"
    t128, market = times[128], dict(dense[(128, 64, (2.0, 6.0))])
    for rec in device:
        if rec["shape"] == "b32/128x64/smpl_uv/dist2-6":
            market.update(device_entries(rec))
    kernel_table = {
        "raster_fwd": ("raster_fwd.cu", pallas + "rasterize_v4.py:988", "default", t128),
        "texture_fwd": ("texture_fwd.cu", pallas + "texture_cells.py:214", "default", t128),
        "raster_bwd": ("raster_bwd.cu", pallas + "rasterize_v4.py:581", "default", t128),
        "texture_bwd": ("texture_bwd.cu", pallas + "texture_cells.py:355", "default", t128),
        # the plain mode of the forward kernel and its backward: on no main path
        "raster_fwd_plain_mode": ("raster_fwd.cu", pallas + "rasterize_v4.py:372", None, t128),
        "raster_bwd_plain_mode": ("raster_bwd.cu", pallas + "rasterize_v4.py:482", None, t128),
        "raster_fwd_dense": ("raster_fwd.cu", pallas + "rasterize_v6.py:142", "market_smpl",
                             market),
        "raster_bwd_dense": ("raster_bwd.cu", pallas + "rasterize_v6.py:288", "market_smpl",
                             market),
        # phase 1 alone in 'exact' mode (rasterize_plain, dibr_rasterization):
        # on no main path either, the render is the fused instantiation
        "raster_exact": ("raster_fwd.cu", pallas + "rasterize_tpu.py:70,236,355", None, t128),
        "raster_exact_fused": ("raster_fwd.cu", pallas + "rasterize_tpu.py:621", "cub_exact",
                               t128),
        "texture_unmasked_fwd": ("texture_fwd.cu", pallas + "texture_tpu.py:35", "cub_exact",
                                 t128),
        "texture_unmasked_bwd": ("texture_bwd.cu", pallas + "texture_tpu.py:35", "cub_exact",
                                 t128),
        # K9c: the probe's own path (the benchmark), at its own shape, b32/256^2
        "texture_parts": ("texture_fwd.cu", "benchmarks/bench_texcells_parts.py:23", None,
                          probe_times[256]),
    }
    summary = []
    for name, (source, replaces, config, t) in kernel_table.items():
        counted = {"raster_fwd_plain_mode": "raster_fwd",
                   "raster_bwd_plain_mode": "raster_bwd"}.get(name, name)
        timed = "raster_bwd" if name == "raster_bwd_plain_mode" else name
        summary.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": replaces, "config": config,
            "launches": ((train_launches[config][name] or serve_launches[config][name])
                         if config else probe_launches.get(name, 0)),
            "launches_training": train_launches[config][name] if config else 0,
            "launches_serving": serve_launches[config][name] if config else 0,
            "launches_frontend": frontend_launches.get(name, 0),
            "launches_recipes": recipe_launches.get(name, 0),
            "launches_eval_clis": eval_launches.get(name, 0),
            "launches_tools": tools_launches.get(name, 0),
            "launches_options": option_launches.get(name, 0),
            "max_abs_err": errs[counted], "ms": t[f"{timed}_ms"],
            "warm_ms": t[f"{timed}_warm_ms"],
            "plain_ms": t[f"{timed}_plain_ms"], "bound_ms": t[f"{timed}_bound_ms"],
            "bound_by": t[f"{timed}_bound_by"], "library_ms": t.get(f"{timed}_library_ms")})
        if config or name == "texture_parts":
            require(summary[-1]["launches"] > 0, summary[-1])
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", type=int, default=0, metavar="STEPS",
                        help="after the timing, trace STEPS serving steps with "
                             "torch.profiler and print the device's busy share, "
                             "launches and time by kernel group")
    parser.add_argument("--lane", choices=sorted(LANES), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.lane:  # one lane of run_lanes, started by the script itself
        result = run_lane(args.lane, kernel_times.card())
        print(json.dumps({"lane_result": result}), flush=True)
    else:
        main(args.profile)
