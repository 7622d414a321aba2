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
     100 launches (magicmirror_torch/benchmarks/texture_parts.py);
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
  8. the trainer (train.trainer.trainer) on the default configuration at
     b32 / 128^2 over 4 train and 2 test batches of synthetic photos, in two
     calls into build/trainer_smoke: epochs 0-1 (artifacts, eval with FID,
     checkpoints, the EM template update and the BatchNorm refresh after it,
     an SWA update), then a resume from that checkpoint with SWA from epoch 0
     (the SWA BatchNorm refresh, the eval with and without SWA); the
     artifacts, result.txt, the checkpoint round trip and the kernel launches
     each call must make are checked, and its times printed.
The line before the last is the kernels' JSON summary (``ms`` and
``library_ms`` are cold device times, ``warm_ms`` warm ones, ``plain_ms``
CUDA events around the plain version); the last line is
{"ok": true, "device": {...}}.  Imports torch, numpy and magicmirror_torch
only.
"""
import argparse
import copy
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")

from magicmirror_torch import kernels, parity  # noqa: E402
from magicmirror_torch.kernels import build  # noqa: E402
from magicmirror_torch.losses import recon  # noqa: E402
from magicmirror_torch.models.convert import init_from_seed  # noqa: E402
from magicmirror_torch.ops.face_rows import (DENSE_THRESHOLD,  # noqa: E402
                                             coeffs13, face_cull, face_rows)
from magicmirror_torch.ops.rasterize import (dibr_rasterization, pixel_grid,  # noqa: E402
                                             raster_bwd, raster_fwd, raster_fwd_plain,
                                             rasterize_fused, rasterize_fused_plain,
                                             rasterize_phase1, rasterize_plain,
                                             soft_backward_autograd, soft_backward_plain)
from magicmirror_torch.ops.sampling import (TEXTURE_PARTS_LEVELS,  # noqa: E402
                                            texture_backward_plain, texture_bwd, texture_fwd,
                                            texture_mapping_plain, texture_render,
                                            texture_render_plain)
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
from magicmirror_torch.train import TrainOptions, build_trainer, sample_draws  # noqa: E402
from magicmirror_torch.train.checkpoints import CheckpointManager  # noqa: E402
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
# its silhouette backward is autograd of the plain phase 1)
TRAIN_STEPS = {"default": 12, "market_smpl": 24, "cub_exact": 8}
T0 = time.perf_counter()


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


def backward_parity(size, batch, args, textures, fwd_out, errs):
    """The backward kernels against their plain versions on the card's own
    forward outputs: with a random cotangent, and with the cotangent a
    reconstruction loss against another render produces; at b4 the whole
    backward of both autograd Functions against autograd of the plain path."""
    shape = f"b{batch}/{size}^2"
    fvi, _, fnz = args[0], args[1], args[2]
    _, soft, uv, _, hard = fwd_out
    rows = face_rows(*args).contiguous()
    gen = torch.Generator(device=DEV).manual_seed(SEED + size)
    target, _ = raster_case(size, batch, SEED + size + 1)
    target_soft = rasterize_fused(*target, height=size, width=size)[1]
    leaf = soft.detach().requires_grad_(True)
    pred = torch.cat([torch.ones_like(leaf)[..., None].expand(-1, -1, -1, 3), leaf[..., None]], -1)
    gt = torch.cat([torch.ones_like(pred[..., :3]), target_soft[..., None]], -1)
    recon.recon_data(pred, gt).backward()
    cotangents = {"random": torch.randn(soft.shape, device=DEV, generator=gen),
                  "recon_data": leaf.grad}
    for what, g_soft in cotangents.items():
        g_sumlog = (g_soft * (soft - 1.0)).reshape(batch, -1).contiguous()
        G = raster_bwd(rows, g_sumlog, 7000.0, size, size)
        G_plain = soft_backward_plain(fvi, fnz, g_sumlog, 7000.0, size, size)
        stats = parity.raster_bwd_stats(G, G_plain, chain_to_vertices(fvi, G),
                                        chain_to_vertices(fvi, G_plain))
        emit("parity_raster_bwd", shape=shape, cotangent=what, **stats)
        parity.check_raster_bwd(stats)
        errs["raster_bwd"] = max(errs["raster_bwd"], float((G - G_plain).abs().max()))
    g_tex = torch.randn((batch, size, size, 3), device=DEV, generator=gen)
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
        _, soft_, uv_, normal_, _ = fn(*leaves, height=size, width=size)
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


def train_step_gpu_vs_cpu(dr, dr_cpu, photos):
    """Phase 5 (a), default configuration: one step at b4 on the card against
    the same step on the CPU: the same weights (drawn on the CPU from the
    seed), BatchNorm statistics, photos and draws; dropout off."""
    S = dr.image_size
    lpl = dr.vertices_laplacian_matrix
    topt = TrainOptions(template_path=SPHERE, droprate="0,0,0")
    on_card, on_cpu = build_trainer(topt), build_trainer(topt, device="cpu")
    estimate_bn_stats(on_card.state.netE, [photos], dr.vertices_init, lpl)
    on_cpu.state.netE.load_state_dict(on_card.state.netE.state_dict())
    draws = sample_draws(topt, photos.shape[0], torch.Generator(device=DEV).manual_seed(SEED + 3),
                         DEV)
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
    m_card, Xer, Xir = on_card.step(photos, 1e-4, 1e-4, 1.0, 0, draws=draws)
    torch.cuda.synchronize()
    one_step = dict(kernels.LAUNCHES)
    m_cpu, Xer_cpu, Xir_cpu = on_cpu.step(photos.cpu(), 1e-4, 1e-4, 1.0, 0, draws=draws_cpu)
    m_card, m_cpu = metric_floats(m_card), metric_floats(m_cpu)
    # each loss term relative to itself, but to no less than a thousandth of
    # its side's total: with the critic's head at its N(0, 1e-5) init the
    # adversarial terms are rounding noise around 1e-10
    floor = {k: 1e-3 * abs(m_cpu["lossD" if k.startswith("lossD") else "lossR"])
             for k in METRIC_KEYS if k.startswith("loss")}
    rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), floor.get(k, 1e-12))
           for k in METRIC_KEYS if k.startswith(("loss", "gnorm"))}
    rstats = parity.render_stats([Xer_cpu, Xir_cpu], [Xer, Xir])
    emit("train_step_gpu_vs_cpu", shape=f"b{photos.shape[0]}/{S}^2", card=m_card, cpu=m_cpu,
         rel=rel, launches=one_step, **rstats)
    require({k: v for k, v in one_step.items() if v} == CONFIGS["default"][3], one_step)
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


def training_timing(trainer, dr, batch, reps=10):
    """The train step at b32 and its parts: the step as a user calls it
    (median of ``reps``); then its three phases between CUDA events; the
    encoder's train-mode forward, one render forward + backward and the two
    optimizer steps alone."""
    state, opt = trainer.state, trainer.opt
    step_ms = cuda_ms(lambda: trainer.step(batch, 3e-4, 3e-4), 2, reps)
    parts = {"forward_ms": [], "d_update_ms": [], "g_update_ms": []}
    with _no_tf32():
        for _ in range(max(2, reps // 2)):
            draws = sample_draws(opt, batch.shape[0], trainer.generator, DEV)
            before = [b.clone() for b in running_statistics(state.netE)]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            outs = e_outputs(state, dr, opt, batch, draws, 0)
            ev[1].record()
            update_d(state, outs, opt, draws, 3e-4, 1.0)
            ev[2].record()
            update_e(state, dr, opt, outs, batch, 3e-4, 1.0, before)
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


class PhotoLoader:
    """Batches of ``{"images", "path"}`` as the trainer reads a loader."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def photo_loader(dr, n_batches, first_seed, named_from=0, batch=32):
    """``n_batches`` b32 batches of ``synthetic_photos``, named sNNN.png."""
    return PhotoLoader([
        {"images": synthetic_photos(dr, batch, first_seed + i),
         "path": [f"s{named_from + batch * i + b:03d}.png" for b in range(batch)]}
        for i in range(n_batches)])


def _same_state(a, b):
    """Whether two state dicts hold equal values, tensor by tensor."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_state(x, y) for x, y in zip(a, b))
    return a == b


def trainer_launches(opt, start_epoch, n_train, n_test):
    """The kernel launches a ``trainer`` call must make on the default
    configuration: two renders with their backward a step, one render a
    sweep frame of the artifact epochs, five renders an eval batch."""
    epochs = range(start_epoch, opt.niter + 1)
    lo, hi = (int(float(v)) for v in opt.elev_range.split("~"))
    dlo, dhi = (int(float(v)) for v in opt.dist_range.split("~"))
    frames = len(range(-int(opt.azi_scope / 2), int(opt.azi_scope / 2), 10)) + len(
        range(lo, hi, 10)) + len(range(dlo, dhi + 1))
    steps = len(epochs) * n_train
    renders = (sum(frames for e in epochs if e % 10 == 0)
               + sum(5 * n_test * (2 if opt.swa and e >= opt.swa_start else 1)
                     for e in epochs if e % 20 == 0))
    return {"raster_fwd": 2 * steps + renders, "texture_fwd": 2 * steps + renders,
            "raster_bwd": 2 * steps, "texture_bwd": 2 * steps}


def trainer_phase(card):
    """The trainer at the default configuration, full width, b32 at 128^2, in
    two calls under the JAX package's cadence (EM runs only before
    swa_start, so one call cannot show both EM and the SWA BatchNorm
    refresh).  Call 1: epochs 0 and 1 (artifacts, eval, checkpoints, EM and
    the BatchNorm refresh at epoch 0; one SWA update at epoch 1).  Call 2:
    resumes from call 1's latest_ckpt (epoch 0) with swa_start 0: one epoch,
    an SWA update, the SWA BatchNorm refresh, the eval with and without SWA."""
    outf = os.path.join(ROOT, "build", "trainer_smoke")
    shutil.rmtree(outf, ignore_errors=True)
    dr = DiffRender(SPHERE, 128, device=DEV)
    train = photo_loader(dr, 4, SEED + 30)
    test = photo_loader(dr, 2, SEED + 40)
    opt1 = TrainOptions(template_path=SPHERE, niter=1, warm_epoch=1, swa_start=1,
                        swa_interval=1, em=1.0, em_gap=1, update_bn=True)
    # the cosine schedule divides by niter (in the JAX package too), so the
    # one-epoch resume takes "exp", whose rate at epoch 0 is the same lr
    opt2 = dataclasses.replace(opt1, resume=True, niter=0, swa_start=0, scheduler="exp")

    calls = []
    for call, opt in ((1, opt1), (2, opt2)):
        timings = []
        kernels.reset_launches()
        t0 = time.perf_counter()
        state = run_trainer(opt, train, test, train, outf, device=DEV, timings=timings)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        # both calls start at epoch 0: call 2 resumes call 1's epoch-0 checkpoint
        expect = trainer_launches(opt, 0, len(train), len(test))
        lines = open(os.path.join(outf, "result.txt")).read().splitlines()
        calls.append((call, state.swa_n, timings, launches, expect, seconds, lines))
        if call == 1:
            template_moved = float((state.template - dr.vertices_init).abs().max())
            em_step = state.em_step
            # a fresh state restored from latest_ckpt holds, tensor by tensor,
            # what the file holds: call 1's state at epoch 0, before EM
            path = os.path.join(outf, "ckpts", "latest_ckpt")
            payload = torch.load(path, map_location="cpu", weights_only=True)
            fresh = build_trainer(opt1).state
            CheckpointManager(os.path.dirname(path)).restore("latest_ckpt", fresh)
            fresh_equal = (payload["epoch"] == 0
                           and _same_state(fresh.state_dict(), payload["state"]))
            del fresh, payload
        del state
        torch.cuda.empty_cache()

    artifacts = ["current_Xer.png", "current_Xir.png", "current_rotation.gif",
                 "current_rotation_ele.gif", "current_rotation_dist.gif",
                 "epoch_000_template.obj", "current_mesh_recon.obj", "result.txt",
                 "ckpts/latest_ckpt", "ckpts/best_ckpt", "ckpts/best_mesh.obj"]
    missing = [a for a in artifacts if not os.path.isfile(os.path.join(outf, a))]
    fid_files = {d: len(os.listdir(os.path.join(outf, "fid", d)))
                 for d in ("ori", "rec", "inter", "inter90", "ori_mask", "rec_mask")}
    for call, swa_n, timings, launches, expect, seconds, lines in calls:
        epochs = [t for t in timings if "epoch" in t]
        emit("trainer", call=call, card=card, shape="b32/128x128", seconds=seconds,
             epochs=[t["epoch"] for t in epochs],
             seconds_per_epoch=[t["train_s"] for t in epochs],
             train_images_per_s=[t["train_images"] / t["train_s"] for t in epochs],
             evals=[dict(e, epoch=t["epoch"]) for t in epochs for e in t["eval"]],
             em_sweep_s=[t.get("em_s") for t in epochs],
             em_update_bn_s=[t.get("em_update_bn_s") for t in epochs],
             swa_bn_refresh_s=[t.get("swa_bn_s") for t in epochs],
             artifacts_s=[t.get("artifacts_s") for t in epochs],
             checkpoints=[c for t in epochs for c in t["checkpoints"]],
             restore=[t for t in timings if "restore_s" in t],
             launches=launches, expected_launches=expect, result_lines=len(lines), swa_n=swa_n)
        require(launches == expect, (call, launches, expect))
        require(swa_n == 1, (call, swa_n))
    (_, _, _, _, _, _, lines1), (_, _, t2, _, _, _, lines2) = calls
    checks = {"missing_artifacts": missing, "fid_files": fid_files,
              "result_lines": [len(lines1), len(lines2)],
              "swa_lines_call2": sum("(SWA)" in ln for ln in lines2),
              "template_moved_max": template_moved, "em_step": em_step,
              "restore_into_fresh_state_equal": fresh_equal,
              "call2_restored": [t for t in t2 if "restore_s" in t],
              "swa_bn_refresh_in_call2": any("swa_bn_s" in t for t in t2)}
    emit("trainer_checks", **checks)
    require(not missing, missing)
    require(fid_files == {"ori": 64, "rec": 64, "inter": 128, "inter90": 128, "ori_mask": 64,
                          "rec_mask": 64}, fid_files)
    require(len(lines1) == 5 and len(lines2) == 15 and checks["swa_lines_call2"] == 5, checks)
    require(all(k in " ".join(lines1) for k in ("recon ssim", "recon MaskIoU", "recon fid",
                                                 "rotation fid", "rotate90/270 fid")), lines1)
    require(template_moved > 0.0 and em_step < 0.1, checks)
    require(fresh_equal and [t["restored_epoch"] for t in checks["call2_restored"]] == [0],
            checks)
    require(checks["swa_bn_refresh_in_call2"], checks)


def main(profile_steps=0):
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

    # 4. the serving slice and 5. the training slice of each configuration
    serve_launches, train_launches, recs, trainers = {}, {}, {}, {}
    for config in CONFIGS:
        serve_launches[config], rec, dr, dr_cpu, photos = serving_slice(config)
        if config == "default":
            train_step_gpu_vs_cpu(dr, dr_cpu, photos)
        train_launches[config], trainers[config] = train_steps(config, dr)
        recs[config] = (rec, dr, photos)
        del dr_cpu

    # 6. timing (CUDA events, median after warm-up)
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

    # 8. the trainer around the step: epochs, SWA, EM, eval, FID, checkpoints
    del trainers, recs
    torch.cuda.empty_cache()
    trainer_phase(card)

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
    main(parser.parse_args().profile)
