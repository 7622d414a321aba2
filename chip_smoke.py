"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results on its own line; any failure exits
nonzero (nothing is caught, and there is no CPU fallback):
  1. toolchain: torch, CUDA, the card, nvcc, nvidia-smi's name and power limit;
  2. build: compile magicmirror_torch/csrc with nvcc;
  3. kernel parity on the card: the rasterizer kernel at the bench.py shape
     (b32, 256^2, sphere.obj) and at b4 / 128^2, the texture kernel on its
     outputs, each against its plain PyTorch version;
  4. the slice: the default-configuration encoder (random weights from a
     seed, BatchNorm statistics re-estimated on the smoke batch) serving b4
     synthetic RGBA photos at 128^2 through Reconstructor, plus a 36-view
     turntable; the launch counters must show both kernels on that path; the
     same slice with the same weights on the CPU must agree; for each of
     the five views, the faces that face the camera on one device only and
     the alpha differences (kernel vs plain on the card, card vs CPU);
  5. timing with CUDA events (3 warm-up runs, median of 20): both kernels
     against their plain versions at b32 / 256^2 and b32 / 128^2, and the
     serving step in images/s at b32 / 128^2.
  6. with ``--profile STEPS`` only: torch.profiler over STEPS serving steps
     at b32 / 128^2: the device's busy share of the step, the kernel
     launches per step, and device ms by kernel group.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.  Imports torch, numpy and magicmirror_torch
only.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")

from magicmirror_torch import kernels, parity  # noqa: E402
from magicmirror_torch.kernels import build  # noqa: E402
from magicmirror_torch.models.convert import init_from_seed  # noqa: E402
from magicmirror_torch.ops.face_rows import face_rows  # noqa: E402
from magicmirror_torch.ops.rasterize import (raster_fwd, rasterize_fused,  # noqa: E402
                                             rasterize_fused_plain)
from magicmirror_torch.ops.sampling import (texture_fwd, texture_render,  # noqa: E402
                                            texture_render_plain)
from magicmirror_torch.render.renderer import DiffRender  # noqa: E402
from magicmirror_torch.render.synthetic import (bench_attributes,  # noqa: E402
                                               smooth_random, to_torch)
from magicmirror_torch.serve import (Reconstructor, ServeOptions, build_models,  # noqa: E402
                                     update_bn)

ROOT = os.path.dirname(os.path.abspath(__file__))
SPHERE = os.path.join(ROOT, "template", "sphere.obj")
DEV = torch.device("cuda:0")
SEED = 0


def require(ok, what):
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def raster_case(size, batch, seed):
    """The bench.py attribute distribution projected for the rasterizer."""
    dr = DiffRender(SPHERE, size, device=DEV)
    att = to_torch(bench_attributes(dr.vertices_init.cpu().numpy(), batch, size, seed), DEV)
    fvc, fvi, fn = dr.project(att)
    return (fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn), att["textures"]


VIEWS = ("Xer", "Xir", "Xir2", "Xer90", "Xer270")  # the eval step's renders


@torch.inference_mode()
def view_witness(dr, dr_cpu, att_gpu, att_cpu):
    """Where one view's alpha differs between the card and the CPU, and why:
    the faces that face the camera on one device only (and the largest
    |normal z| among them), the pixels beyond the slice's alpha tolerance,
    and the alpha differences of the kernel against the plain path on the
    card's inputs and of the plain path on the card against it on the CPU."""
    H, W, sigma = dr.render_height, dr.render_width, dr.sigmainv
    fvc, fvi, fn = dr.project(att_gpu)
    fvc_c, fvi_c, fn_c = dr_cpu.project(att_cpu)
    args = (fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn)
    soft_k1 = rasterize_fused(*args, sigmainv=sigma, height=H, width=W)[1].cpu()
    soft_plain = rasterize_fused_plain(*args, sigmainv=sigma, height=H, width=W)[1].cpu()
    soft_cpu = rasterize_fused_plain(fvi_c, fvc_c[..., 2], fn_c[..., 2], dr_cpu.face_uvs, fn_c,
                                     sigmainv=sigma, height=H, width=W)[1]
    flips = (fn[..., 2] > 0).cpu() != (fn_c[..., 2] > 0)
    return {"facing_flips": int(flips.sum()),
            "flipped_normal_z_max": (float(fn_c[..., 2].abs()[flips].max())
                                     if flips.any() else None),
            "alpha_over_pixels": int(((soft_k1 - soft_cpu).abs()
                                      > parity.SLICE_TOL["alpha"]).sum()),
            "alpha_max": float((soft_k1 - soft_cpu).abs().max()),
            "alpha_kernel_vs_plain_card_max": float((soft_k1 - soft_plain).abs().max()),
            "alpha_plain_card_vs_cpu_max": float((soft_plain - soft_cpu).abs().max())}


def main(profile_steps=0):
    # 1. toolchain
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
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
    errs = {"raster_fwd": 0.0, "texture_fwd": 0.0}
    for size, batch in ((256, 32), (128, 4)):
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
    torch.cuda.synchronize()

    # 4. the slice at the default configuration
    opt = ServeOptions(template_path=SPHERE)
    S = opt.imageSize
    dr = DiffRender(opt.template_path, S, ratio=opt.ratio, init_ellipsoid=opt.ellipsoid,
                    soft_mode=opt.soft_mode, device=DEV)
    net_cpu = init_from_seed(build_models(opt, DiffRender(opt.template_path, S), "cpu"), SEED)
    netE = build_models(opt, dr, DEV)
    netE.load_state_dict(net_cpu.state_dict())
    # synthetic photos: the template under a smooth random texture, rendered
    photo_np = bench_attributes(dr.vertices_init.cpu().numpy(), 4, S, SEED + 1)
    photo_np["textures"] = smooth_random((4, 2 * S, S, 3), SEED + 1)
    photo_att = to_torch(photo_np, DEV)
    photos, _ = dr.render(**photo_att)
    update_bn(netE, [photos], dr.vertices_init, dr.vertices_laplacian_matrix)
    net_cpu.load_state_dict(netE.state_dict())
    rec = Reconstructor(netE, dr, opt)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    turn_az = -torch.arange(0, 360, 10, dtype=torch.float32, device=DEV)

    kernels.reset_launches()
    outs = rec(photos, generator=gen)
    turn_rgba, turn_normal = rec.turntable(outs[5], turn_az)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    renders = list(outs[:5]) + [turn_rgba]
    emit("slice", photos=list(photos.shape), launches=launches,
         coverage=[round(float(r[..., 3].mean()), 4) for r in renders],
         azimuths=[round(float(a), 3) for a in outs[5]["azimuths"]])
    require(all(bool(torch.isfinite(r).all()) for r in renders + [turn_normal]),
            "non-finite render")
    require(all(float(r[..., 3].mean()) > 0.0 for r in renders), "a render covers nothing")
    require(turn_rgba.shape == (36, S, S, 4), turn_rgba.shape)
    for name in ("raster_fwd", "texture_fwd"):
        require(launches[name] >= len(renders), launches)

    dr_cpu = DiffRender(opt.template_path, S, ratio=opt.ratio, init_ellipsoid=opt.ellipsoid)
    rec_cpu = Reconstructor(net_cpu, dr_cpu, opt)
    u = torch.rand(4, generator=torch.Generator(device=DEV).manual_seed(SEED + 2), device=DEV)
    random_az = -(u * opt.azi_scope - opt.azi_scope / 2)
    outs_gpu = rec(photos, random_azimuths=random_az)
    outs_cpu = rec_cpu(photos.cpu(), random_azimuths=random_az.cpu())
    sstats = parity.slice_stats(outs_cpu[:5], outs_gpu[:5], outs_cpu[5], outs_gpu[5])
    emit("slice_gpu_vs_cpu", **sstats)
    views_gpu = (outs_gpu[5],) + rec.reposed(outs_gpu[5], random_az)
    views_cpu = (outs_cpu[5],) + Reconstructor.reposed(outs_cpu[5], random_az.cpu())
    emit("slice_views_gpu_vs_cpu",
         views=[{"view": name, **view_witness(dr, dr_cpu, g, c)}
                for name, g, c in zip(VIEWS, views_gpu, views_cpu)])
    parity.check_slice(sstats)

    # 5. timing (CUDA events, median of 20 after 3 warm-ups)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    times = {}
    for size in (256, 128):
        args, textures = raster_case(size, 32, SEED + 7)
        rows = face_rows(*args).contiguous()
        _, _, uv, _, hard = rasterize_fused(*args, height=size, width=size)
        t = {
            "raster_fwd_ms": cuda_ms(lambda: rasterize_fused(*args, height=size, width=size)),
            "raster_kernel_only_ms": cuda_ms(lambda: raster_fwd(rows, 7000.0, size, size)),
            "raster_plain_ms": cuda_ms(lambda: rasterize_fused_plain(*args, height=size,
                                                                     width=size)),
            "texture_fwd_ms": cuda_ms(lambda: texture_render(uv, textures, hard)),
            "texture_plain_ms": cuda_ms(lambda: texture_render_plain(uv, textures, hard)),
        }
        times[size] = t
        emit("timing_kernels", shape=f"b32/{size}^2", card=card, **t)
    batch = photos.repeat(8, 1, 1, 1)  # b32 / 128^2
    encode_ms = cuda_ms(lambda: rec.encode(batch))
    att32 = rec.encode(batch)
    render_ms = cuda_ms(lambda: dr.render(**att32))
    step_ms = cuda_ms(lambda: rec(batch, generator=gen))
    emit("timing_serving", shape="b32/128^2", card=card, sm_clock_power_temp=smi,
         encode_ms=encode_ms, render_ms=render_ms, step_ms=step_ms,
         images_per_s=32 * 1000.0 / step_ms)
    if profile_steps:
        emit("profile_serving", shape="b32/128^2", card=card,
             **profile(lambda: rec(batch, generator=gen), profile_steps))

    summary = []
    for name, route_src, replaces, tkey, pkey in (
            ("raster_fwd", "magicmirror_torch/csrc/raster_fwd.cu",
             "magicmirror/ops/pallas/rasterize_v4.py:988", "raster_fwd_ms", "raster_plain_ms"),
            ("texture_fwd", "magicmirror_torch/csrc/texture_fwd.cu",
             "magicmirror/ops/pallas/texture_cells.py:214", "texture_fwd_ms",
             "texture_plain_ms")):
        summary.append({"name": name, "route": "cuda", "source": route_src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": times[128][tkey],
                        "plain_ms": times[128][pkey]})
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
