"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results on its own line; any failure exits
nonzero (nothing is caught, and there is no CPU fallback):
  1. toolchain: torch, CUDA, the card, nvcc, nvidia-smi's name and power limit;
  2. build: compile magicmirror_torch/csrc with nvcc;
  3. kernel parity on the card: the rasterizer kernel at the bench.py shape
     (b32, 256^2, sphere.obj) and at b4 / 128^2, the texture kernel on its
     outputs, each against its plain PyTorch version; the rasterizer's plain
     mode (idx and sumlog only) against phase 1 of the plain path; the two
     backward kernels against theirs, with a random cotangent and with the
     one a reconstruction loss produces; at b4 / 128^2 the whole backward of
     the rasterizer and of the texture sampler against autograd of the plain
     path;
  4. the slice: the default-configuration encoder (random weights from a
     seed, BatchNorm statistics re-estimated on the smoke batch) serving b4
     synthetic RGBA photos at 128^2 through Reconstructor, plus a 36-view
     turntable; the launch counters must show both kernels on that path; the
     same slice with the same weights on the CPU must agree; for each of
     the five views, the faces that face the camera on one device only and
     the alpha differences (kernel vs plain on the card, card vs CPU);
  5. the training slice: the default-configuration trainer (weights from
     seed 0, BatchNorm statistics re-estimated on the smoke batch); one
     D-then-G step at b4 / 128^2 on the card against the same step (weights,
     photos, draws; dropout off) on the CPU; then 40 steps at b32 with dropout
     on: finite metrics, no skipped side, nothing dropped, a falling
     reconstruction loss, and each of the four kernels launched twice a step;
  6. timing with CUDA events (median after warm-up): the four kernels
     against their plain versions (and the texture forward against
     F.grid_sample) at b32 / 256^2 and b32 / 128^2 with each kernel's bound
     for this run's inputs, the serving step and the train step with its
     parts at b32 / 128^2;
  7. with ``--profile STEPS`` only: torch.profiler over STEPS serving steps,
     STEPS train steps and STEPS critic updates alone at b32 / 128^2: the
     device's busy share of the step, the kernel launches per step, and
     device ms by kernel group.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.  Imports torch, numpy and magicmirror_torch
only.
"""
import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")

import torch.nn.functional as F  # noqa: E402

from magicmirror_torch import kernels, parity  # noqa: E402
from magicmirror_torch.kernels import build  # noqa: E402
from magicmirror_torch.losses import recon  # noqa: E402
from magicmirror_torch.models.convert import init_from_seed  # noqa: E402
from magicmirror_torch.ops.face_rows import SOFT_MARGIN, coeffs13, face_rows  # noqa: E402
from magicmirror_torch.ops.rasterize import (pixel_grid, raster_bwd, raster_fwd,  # noqa: E402
                                             raster_fwd_plain, rasterize_fused,
                                             rasterize_fused_plain, rasterize_phase1,
                                             rasterize_plain, soft_backward_plain)
from magicmirror_torch.ops.sampling import (texture_backward_plain,  # noqa: E402
                                            texture_bwd, texture_fwd, texture_render,
                                            texture_render_plain)
from magicmirror_torch.render.renderer import DiffRender  # noqa: E402
from magicmirror_torch.render.synthetic import (bench_attributes,  # noqa: E402
                                               smooth_random, to_torch)
from magicmirror_torch.serve import (Reconstructor, ServeOptions, _no_tf32,  # noqa: E402
                                     build_models, update_bn)
from magicmirror_torch.train import TrainOptions, build_trainer, sample_draws  # noqa: E402
from magicmirror_torch.train.train_step import (METRIC_KEYS, e_outputs,  # noqa: E402
                                                running_statistics, update_d, update_e)

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


# the card's published peaks (H100 SXM data sheet): device memory and fp32
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# float operations per unit of data-dependent work, counted from the kernels'
# sources: per (pixel, surviving face) pair for the rasterizer, per covered
# pixel for the texture sampler
FLOPS_PER_UNIT = {"raster_fwd": 34, "raster_bwd": 46, "texture_fwd": 42, "texture_bwd": 78}


def live_pairs(rows, height, width, g=None):
    """The (pixel, face) pairs the rasterizer kernels visit for these face
    rows: per 16x16 tile the faces that survive the kernels' culling rule
    (front-facing, bbox +- the soft margin meets the tile), times 256 pixels.
    With ``g`` (B, H, W), only the tiles where g is not all zero count: the
    backward kernel leaves the others at once."""
    dev = rows.device
    nz, xmin, xmax = rows[..., 25], rows[..., 12], rows[..., 13]
    ymin, ymax = rows[..., 14], rows[..., 15]
    c0 = torch.arange(0, width, 16, device=dev, dtype=torch.float32)
    r0 = torch.arange(0, height, 16, device=dev, dtype=torch.float32)
    x_lo = -1.0 + 2.0 * c0 / width - SOFT_MARGIN
    x_hi = -1.0 + 2.0 * (c0 + 16).clamp(max=width) / width + SOFT_MARGIN
    y_hi = 1.0 - 2.0 * r0 / height + SOFT_MARGIN
    y_lo = 1.0 - 2.0 * (r0 + 16).clamp(max=height) / height - SOFT_MARGIN
    in_x = (xmax[:, None, :] >= x_lo[None, :, None]) & (xmin[:, None, :] <= x_hi[None, :, None])
    in_y = (ymax[:, None, :] >= y_lo[None, :, None]) & (ymin[:, None, :] <= y_hi[None, :, None])
    front = (nz > 0)[:, None, :]
    # faces live per tile, (B, TY, TX): the product of the two overlaps
    counts = torch.einsum("byf,bxf->byx", (in_y & front).float(), in_x.float())
    if g is not None:
        B = g.shape[0]
        active = g.reshape(B, height // 16, 16, width // 16, 16).abs().amax(dim=(2, 4)) > 0
        counts = counts * active
    return int(counts.sum().item()) * 256


def bound_ms(name, nbytes, units):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the fp32 rate -> (ms, which)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = units * FLOPS_PER_UNIT[name] / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chain_to_vertices(fvi, G):
    """d_fvi of the backward kernel's moments through coeffs13's autograd."""
    fvi = fvi.detach().requires_grad_(True)
    (coeffs13(fvi) * G).sum().backward()
    return fvi.grad


def synthetic_photos(dr, batch, seed):
    """RGBA photos: the template under a smooth random texture, rendered at
    bench.py's camera distribution."""
    att = bench_attributes(dr.vertices_init.cpu().numpy(), batch, dr.image_size, seed)
    att["textures"] = smooth_random((batch, 2 * dr.image_size, dr.image_size, 3), seed)
    with torch.no_grad():
        return dr.render(**to_torch(att, dr.vertices_init.device))[0]


def raster_case(size, batch, seed):
    """The bench.py attribute distribution projected for the rasterizer."""
    dr = DiffRender(SPHERE, size, device=DEV)
    att = to_torch(bench_attributes(dr.vertices_init.cpu().numpy(), batch, size, seed), DEV)
    fvc, fvi, fn = dr.project(att)
    return (fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn), att["textures"]


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


def metric_floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def training_slice(dr, dr_cpu, photos):
    """Phase 5 -> (kernel launches of the 40 steps, the b32 trainer)."""
    S = dr.image_size
    lpl = dr.vertices_laplacian_matrix

    # (a) one step at b4 on the card against the same step on the CPU: the
    # same weights (drawn on the CPU from the seed), BatchNorm statistics,
    # photos and draws; dropout off
    topt = TrainOptions(template_path=SPHERE, droprate="0,0,0")
    on_card, on_cpu = build_trainer(topt), build_trainer(topt, device="cpu")
    update_bn(on_card.state.netE, [photos], dr.vertices_init, lpl)
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
    require(all(v == 2 for v in one_step.values()), one_step)
    require(all(torch.isfinite(torch.tensor(list(m_card.values())))), m_card)
    # float32 on both sides through two train-mode passes of a 56M-parameter
    # encoder and their backward; the gradient norms sum 56M squares
    for key, err in rel.items():
        require(err <= (5e-2 if key.startswith("gnorm") else 1e-2), (key, err, rel))
    parity.check_train_renders(rstats)

    # (b) 40 steps at b32 with dropout on, as examples/train_synthetic.py runs
    # them: lr 3e-4, warm-up min(1, 0.01 + i / 20), four batches in turn
    trainer = build_trainer(TrainOptions(template_path=SPHERE))
    batches = [synthetic_photos(dr, 32, SEED + 10 + i) for i in range(4)]
    update_bn(trainer.state.netE, batches[:1], dr.vertices_init, lpl)
    steps = 40
    kernels.reset_launches()
    t0 = time.perf_counter()
    history = [metric_floats(trainer.step(batches[i % 4], 3e-4, 3e-4,
                                          warm_up=min(1.0, 0.01 + i / 20.0))[0])
               for i in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    data = [m["lossR_data"] for m in history]
    first, last = statistics.mean(data[:5]), statistics.mean(data[-5:])
    emit("train_40_steps", shape=f"b32/{S}^2", seconds=seconds, launches=launches,
         lossR_data_first5=first, lossR_data_last5=last,
         better_percent=100.0 * (first - last) / first, first=history[0], last=history[-1])
    for i, m in enumerate(history):
        require(all(torch.isfinite(torch.tensor(list(m.values())))), (i, m))
        require(m["skipE"] == m["skipD"] == 0.0, (i, m))
        require(m["dropped_faces"] == m["dropped_tex_chunks"] == 0.0, (i, m))
    require(last < first, (first, last))
    require(all(v == 2 * steps for v in launches.values()), launches)
    return launches, trainer


def kernel_timing(size, card):
    """The four kernels, their plain versions and the library call at b32,
    with each kernel's bound for these inputs."""
    B = 32
    args, textures = raster_case(size, B, SEED + 7)
    fvi, fnz = args[0], args[2]
    rows = face_rows(*args).contiguous()
    _, soft, uv, _, hard = rasterize_fused(*args, height=size, width=size)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    g_soft = torch.randn(soft.shape, device=DEV, generator=gen)
    g_sumlog = (g_soft * (soft - 1.0)).reshape(B, -1).contiguous()
    g_tex = torch.randn((B, size, size, 3), device=DEV, generator=gen)
    # the one PyTorch call that computes the texture forward: grid_sample at
    # kaolin's uv convention on the NCHW view of the texture, times the mask
    uvc = uv.clamp(0.0, 1.0)
    grid = torch.stack([uvc[..., 0] * 2.0 - 1.0, -(uvc[..., 1] * 2.0 - 1.0)], dim=-1)
    tex_nchw, mask_nchw = textures.permute(0, 3, 1, 2), hard[:, None]

    def library():
        return F.grid_sample(tex_nchw, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False) * mask_nchw

    lib_err = float((library().permute(0, 2, 3, 1) - texture_fwd(uv, textures, hard)).abs().max())
    require(lib_err <= parity.TEXTURE_TOL, lib_err)
    t = {
        "raster_fwd_wrapper_ms": cuda_ms(lambda: rasterize_fused(*args, height=size, width=size)),
        "raster_fwd_ms": cuda_ms(lambda: raster_fwd(rows, 7000.0, size, size)),
        "raster_fwd_plain_mode_ms": cuda_ms(lambda: raster_fwd_plain(rows, 7000.0, size, size)),
        "raster_fwd_plain_ms": cuda_ms(lambda: rasterize_fused_plain(*args, height=size,
                                                                     width=size), 1, 5),
        "texture_fwd_ms": cuda_ms(lambda: texture_fwd(uv, textures, hard)),
        "texture_fwd_plain_ms": cuda_ms(lambda: texture_render_plain(uv, textures, hard)),
        "texture_fwd_library_ms": cuda_ms(library),
        "raster_bwd_ms": cuda_ms(lambda: raster_bwd(rows, g_sumlog, 7000.0, size, size)),
        "raster_bwd_plain_ms": cuda_ms(lambda: soft_backward_plain(fvi, fnz, g_sumlog, 7000.0,
                                                                   size, size), 1, 5),
        "texture_bwd_ms": cuda_ms(lambda: texture_bwd(g_tex, uv, textures, hard)),
        "texture_bwd_plain_ms": cuda_ms(lambda: texture_backward_plain(g_tex, uv, textures,
                                                                       hard)),
    }
    P, F1 = B * size * size, rows.shape[1]
    covered = int(hard.sum().item())
    pairs = live_pairs(rows, size, size)
    pairs_bwd = live_pairs(rows, size, size, g_sumlog.reshape(B, size, size))
    work = {  # name: (bytes read once and written once, units of data-dependent work)
        "raster_fwd": (rows.numel() * 4 + P * 32, pairs),
        "raster_bwd": (rows.numel() * 4 + P * 4 + B * (F1 - 1) * 13 * 4, pairs_bwd),
        "texture_fwd": (P * 24 + textures.numel() * 4, covered),
        "texture_bwd": (P * 32 + 2 * textures.numel() * 4, covered),
    }
    for name, (nbytes, units) in work.items():
        t[f"{name}_bound_ms"], t[f"{name}_bound_by"] = bound_ms(name, nbytes, units)
    emit("timing_kernels", shape=f"b32/{size}^2", card=card, covered_pixels=covered,
         pairs=pairs, pairs_bwd=pairs_bwd, library_max_abs_err=lib_err, **t)
    return t


def training_timing(trainer, dr, batch):
    """The train step at b32 and its parts: the step as a user calls it; then
    its three phases between CUDA events; the encoder's train-mode forward,
    one render forward + backward and the two optimizer steps alone."""
    state, opt = trainer.state, trainer.opt
    step_ms = cuda_ms(lambda: trainer.step(batch, 3e-4, 3e-4), 2, 10)
    parts = {"forward_ms": [], "d_update_ms": [], "g_update_ms": []}
    with _no_tf32():
        for _ in range(5):
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
            lambda: (dr.render(**att)[0] * w).sum().backward(), 2, 10)
        out["opt_e_step_ms"] = cuda_ms(state.opt_e.step, 2, 10)
        out["opt_d_step_ms"] = cuda_ms(state.opt_d.step, 2, 10)
    return {"step_ms": step_ms, "images_per_s": batch.shape[0] * 1000.0 / step_ms, **out}


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
    errs = dict.fromkeys(kernels.LAUNCHES, 0.0)
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
        backward_parity(size, batch, args, textures, out, errs)
        plain_mode_parity(size, batch, args, errs)
    torch.cuda.synchronize()

    # 4. the slice at the default configuration
    opt = ServeOptions(template_path=SPHERE)
    S = opt.imageSize
    dr = DiffRender(opt.template_path, S, ratio=opt.ratio, init_ellipsoid=opt.ellipsoid,
                    soft_mode=opt.soft_mode, device=DEV)
    net_cpu = init_from_seed(build_models(opt, DiffRender(opt.template_path, S, device="cpu"),
                                           "cpu"), SEED)
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

    dr_cpu = DiffRender(opt.template_path, S, ratio=opt.ratio, init_ellipsoid=opt.ellipsoid,
                         device="cpu")
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

    # 5. the training slice at the default configuration
    train_launches, trainer = training_slice(dr, dr_cpu, photos)

    # 6. timing (CUDA events, median after warm-up)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    times = {size: kernel_timing(size, card) for size in (256, 128)}
    batch = photos.repeat(8, 1, 1, 1)  # b32 / 128^2
    encode_ms = cuda_ms(lambda: rec.encode(batch), iters=10)
    att32 = rec.encode(batch)
    render_ms = cuda_ms(lambda: dr.render(**att32), iters=10)
    step_ms = cuda_ms(lambda: rec(batch, generator=gen), iters=10)
    emit("timing_serving", shape="b32/128^2", card=card, sm_clock_power_temp=smi,
         encode_ms=encode_ms, render_ms=render_ms, step_ms=step_ms,
         images_per_s=32 * 1000.0 / step_ms)
    train_batch = synthetic_photos(dr, 32, SEED + 20)
    emit("timing_training", shape="b32/128^2", card=card,
         **training_timing(trainer, dr, train_batch))
    if profile_steps:
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

    sources = {
        "raster_fwd": ("magicmirror_torch/csrc/raster_fwd.cu",
                       "magicmirror/ops/pallas/rasterize_v4.py:988"),
        "texture_fwd": ("magicmirror_torch/csrc/texture_fwd.cu",
                        "magicmirror/ops/pallas/texture_cells.py:214"),
        "raster_bwd": ("magicmirror_torch/csrc/raster_bwd.cu",
                       "magicmirror/ops/pallas/rasterize_v4.py:581"),
        "texture_bwd": ("magicmirror_torch/csrc/texture_bwd.cu",
                        "magicmirror/ops/pallas/texture_cells.py:355"),
    }
    summary = []
    for name, (source, replaces) in sources.items():
        t = times[128]
        summary.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": train_launches[name], "launches_serving": launches[name],
                        "max_abs_err": errs[name], "ms": t[f"{name}_ms"],
                        "plain_ms": t[f"{name}_plain_ms"], "bound_ms": t[f"{name}_bound_ms"],
                        "bound_by": t[f"{name}_bound_by"],
                        "library_ms": t.get(f"{name}_library_ms")})
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
