"""The port's CUDA kernels against their plain PyTorch versions, and the
wrappers' device dispatch.

This file imports no JAX, so it also runs where only torch is installed:
on the card,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

runs the ``cuda`` tests too; elsewhere they skip.  The tolerances are those
of ``magicmirror_torch/parity.py``, which states their reasons.
"""
import os

import numpy as np
import pytest
import torch

from magicmirror_torch import kernels, parity
from magicmirror_torch.kernels import build
from magicmirror_torch.ops.face_rows import coeffs13, face_cull, face_rows, face_verts
from magicmirror_torch.ops.rasterize import (_tile_overlaps, dibr_rasterization, pixel_grid,
                                             raster_bwd,
                                             raster_fwd, raster_fwd_plain, rasterize_fused,
                                             rasterize_fused_plain, rasterize_phase1,
                                             rasterize_plain, soft_backward_plain)
from magicmirror_torch.ops.sampling import (texture_backward_plain, texture_bwd, texture_fwd,
                                            texture_mapping, texture_mapping_plain,
                                            texture_parts, texture_render,
                                            texture_render_plain)
from magicmirror_torch.render.renderer import DiffRender
from magicmirror_torch.render.synthetic import bench_attributes, to_torch

torch.set_num_threads(1)
TEMPLATES = os.path.join(os.path.dirname(__file__), "..", "template")
SPHERE = os.path.join(TEMPLATES, "sphere.obj")
SMPL = os.path.join(TEMPLATES, "smpl_uv.obj")
ZERO = dict.fromkeys(kernels.LAUNCHES, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels build and run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _raster_inputs(size, batch, device, seed=0):
    dr = DiffRender(SPHERE, size, device=device)
    att = to_torch(bench_attributes(dr.vertices_init.cpu().numpy(), batch, size, seed),
                   device)
    fvc, fvi, fn = dr.project(att)
    return (fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn), dr, att


def test_nothing_builds_at_import():
    assert build._LIB is None


def test_wrappers_refuse_cpu_tensors():
    args, _, _ = _raster_inputs(32, 1, "cpu")
    rows = face_rows(*args)
    with pytest.raises(ValueError, match="CUDA"):
        raster_fwd(rows, 7000.0, 32, 32)
    uv, tex, mask = torch.rand(1, 8, 8, 2), torch.rand(1, 16, 8, 3), torch.ones(1, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        texture_fwd(uv, tex, mask)
    with pytest.raises(ValueError, match="CUDA"):
        raster_bwd(rows, torch.zeros(1, 32 * 32), 7000.0, 32, 32)
    with pytest.raises(ValueError, match="CUDA"):
        texture_bwd(torch.zeros(1, 8, 8, 3), uv, tex, mask)
    with pytest.raises(ValueError, match="CUDA"):
        raster_fwd_plain(rows, 7000.0, 32, 32)
    with pytest.raises(ValueError, match="CUDA"):
        raster_fwd(rows, 7000.0, 32, 32, verts=face_verts(args[0]))
    with pytest.raises(ValueError, match="CUDA"):
        texture_fwd(uv, tex)
    with pytest.raises(ValueError, match="CUDA"):
        texture_bwd(torch.zeros(1, 8, 8, 3), uv, tex)
    assert build._LIB is None


def test_texture_parts_takes_the_plain_path_on_the_cpu():
    uv, tex, mask = torch.rand(1, 8, 8, 2), torch.rand(1, 16, 8, 3), torch.ones(1, 8, 8)
    count = dict(kernels.LAUNCHES)
    assert torch.equal(texture_parts(uv, tex, mask, 1), torch.zeros(1, 8, 8, 3))
    assert torch.equal(texture_parts(uv, tex, mask, 5), texture_render_plain(uv, tex, mask))
    with pytest.raises(ValueError, match="level"):
        texture_parts(uv, tex, mask, 3)
    assert kernels.LAUNCHES == count and build._LIB is None


def test_cpu_backward_takes_the_plain_path():
    _, dr, att = _raster_inputs(32, 2, "cpu")
    for key in ("vertices", "textures", "lights", "azimuths"):
        att[key].requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    rgba, _ = dr.render(**att)
    rgba.square().sum().backward()
    assert kernels.LAUNCHES == before and build._LIB is None
    for key in ("vertices", "textures", "lights", "azimuths"):
        assert torch.isfinite(att[key].grad).all() and att[key].grad.abs().max() > 0


def test_cpu_render_takes_the_plain_path():
    args, dr, att = _raster_inputs(32, 2, "cpu")
    before = dict(kernels.LAUNCHES)
    rgba, out = dr.render(**att)
    assert kernels.LAUNCHES == before
    ref = rasterize_fused_plain(*args, height=32, width=32)
    assert torch.equal(rgba[..., 3], ref[1])
    assert out["dropped_faces"].dtype == torch.int32 and not out["dropped_faces"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("size,batch", [(64, 2), (128, 4), (256, 8)])
def test_raster_kernel_matches_plain(cuda_device, size, batch):
    args, _, _ = _raster_inputs(size, batch, cuda_device, seed=size)
    count = kernels.LAUNCHES["raster_fwd"]
    out = rasterize_fused(*args, height=size, width=size)
    assert kernels.LAUNCHES["raster_fwd"] == count + 1
    stats = parity.raster_stats(out, rasterize_fused_plain(*args, height=size, width=size))
    assert stats["covered"] > 0.05 * stats["pixels"]
    parity.check_raster(stats)


@pytest.mark.cuda
def test_texture_kernel_matches_plain(cuda_device):
    rs = np.random.RandomState(5)
    uv = torch.as_tensor(rs.uniform(-0.2, 1.2, (3, 64, 64, 2)).astype(np.float32),
                         device=cuda_device)
    tex = torch.as_tensor(rs.rand(3, 128, 64, 3).astype(np.float32), device=cuda_device)
    mask = torch.as_tensor((rs.rand(3, 64, 64) > 0.4).astype(np.float32),
                           device=cuda_device)
    count = kernels.LAUNCHES["texture_fwd"]
    out = texture_render(uv, tex, mask)
    assert kernels.LAUNCHES["texture_fwd"] == count + 1
    parity.check_texture(parity.texture_stats(out, texture_render_plain(uv, tex, mask), mask))


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 4, 5])
def test_texture_parts_levels_match_plain(cuda_device, level):
    """K9c: the masked texture kernel's body by level; zeros below 5, and at
    5 the texture kernel's own output, bit for bit."""
    rs = np.random.RandomState(6)
    uv = torch.as_tensor(rs.uniform(-0.2, 1.2, (3, 64, 64, 2)).astype(np.float32),
                         device=cuda_device)
    tex = torch.as_tensor(rs.rand(3, 128, 64, 3).astype(np.float32), device=cuda_device)
    mask = torch.as_tensor((rs.rand(3, 64, 64) > 0.4).astype(np.float32),
                           device=cuda_device)
    count = kernels.LAUNCHES["texture_parts"]
    out = texture_parts(uv, tex, mask, level)
    assert kernels.LAUNCHES["texture_parts"] == count + 1
    if level < 5:
        assert torch.equal(out, torch.zeros_like(out))
    else:
        assert torch.equal(out, texture_fwd(uv, tex, mask))
        parity.check_texture(parity.texture_stats(out, texture_render_plain(uv, tex, mask),
                                                  mask))


@pytest.mark.cuda
def test_cuda_render_goes_through_both_kernels(cuda_device):
    _, dr, att = _raster_inputs(128, 4, cuda_device)
    kernels.reset_launches()
    rgba, _ = dr.render(**att)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**ZERO, "raster_fwd": 1, "texture_fwd": 1}
    assert torch.isfinite(rgba).all() and rgba[..., 3].mean() > 0.05


def _chain(fvi, G):
    """d_fvi of the moments G through coeffs13's autograd."""
    fvi = fvi.detach().requires_grad_(True)
    (coeffs13(fvi) * G).sum().backward()
    return fvi.grad


@pytest.mark.cuda
@pytest.mark.parametrize("size,batch", [(64, 2), (128, 4), (256, 4), (100, 3)])
def test_raster_bwd_kernel_matches_plain(cuda_device, size, batch):
    args, _, _ = _raster_inputs(size, batch, cuda_device, seed=size)
    fvi, fz, fnz = args[0], args[1], args[2]
    g = torch.randn((batch, size * size), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(size))
    soft = rasterize_fused(*args, height=size, width=size)[1].reshape(batch, -1)
    g_sumlog = (g * (soft - 1.0)).contiguous()
    count = kernels.LAUNCHES["raster_bwd"]
    G = raster_bwd(face_rows(*args).contiguous(), g_sumlog, 7000.0, size, size)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["raster_bwd"] == count + 1
    G_plain = soft_backward_plain(fvi, fnz, g_sumlog, 7000.0, size, size)
    parity.check_raster_bwd(parity.raster_bwd_stats(G, G_plain, _chain(fvi, G),
                                                    _chain(fvi, G_plain)))


@pytest.mark.cuda
@pytest.mark.parametrize("size,batch", [(64, 2), (128, 4)])
def test_raster_plain_mode_matches_phase1(cuda_device, size, batch):
    args, _, _ = _raster_inputs(size, batch, cuda_device, seed=size + 1)
    fvi, fz, fnz = args[0].clone().requires_grad_(True), args[1], args[2]
    counts = kernels.LAUNCHES["raster_fwd"], kernels.LAUNCHES["raster_bwd"]
    idx, sumlog, dropped = rasterize_plain(fvi, fz, fnz, height=size, width=size)
    px, py = pixel_grid(size, size, cuda_device)
    idx_p, sumlog_p = rasterize_phase1(px, py, args[0], fz, fnz, 7000.0)
    assert (idx.long() != idx_p).sum() <= parity.RASTER_TOL["idx_frac"] * idx.numel()
    assert (torch.exp(sumlog) - torch.exp(sumlog_p)).abs().max() <= parity.RASTER_TOL["soft"]
    assert not dropped.any()
    g_sumlog = torch.exp(sumlog_p) * torch.randn(
        sumlog.shape, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(2))
    (sumlog * g_sumlog).sum().backward()
    assert (kernels.LAUNCHES["raster_fwd"], kernels.LAUNCHES["raster_bwd"]) == (
        counts[0] + 1, counts[1] + 1)
    d_plain = _chain(args[0], soft_backward_plain(args[0], fnz, g_sumlog.contiguous(), 7000.0,
                                                  size, size))
    assert (fvi.grad - d_plain).abs().max() <= parity.RASTER_BWD_TOL * d_plain.abs().max()


@pytest.mark.cuda
def test_texture_bwd_kernel_matches_plain(cuda_device):
    rs = np.random.RandomState(6)
    uv_np = rs.uniform(-0.2, 1.2, (3, 64, 64, 2)).astype(np.float32)
    uv_np[0, 0, :2] = [[0.0, 1.0], [1.0, 0.0]]  # exactly on the clip
    uv = torch.as_tensor(uv_np, device=cuda_device)
    tex = torch.as_tensor(rs.rand(3, 128, 64, 3).astype(np.float32), device=cuda_device)
    mask = torch.as_tensor((rs.rand(3, 64, 64) > 0.4).astype(np.float32),
                           device=cuda_device)
    g = torch.as_tensor(rs.randn(3, 64, 64, 3).astype(np.float32), device=cuda_device)
    count = kernels.LAUNCHES["texture_bwd"]
    out = texture_bwd(g, uv, tex, mask)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["texture_bwd"] == count + 1
    parity.check_texture_bwd(parity.texture_bwd_stats(
        out, texture_backward_plain(g, uv, tex, mask), mask))


@pytest.mark.cuda
def test_cuda_backward_goes_through_both_backward_kernels(cuda_device):
    """The render's backward on the card launches each backward kernel once,
    and the rasterizer's and the texture sampler's gradients agree with
    autograd of their plain versions on the same card inputs."""
    args, dr, att = _raster_inputs(128, 4, cuda_device)
    keys = ("vertices", "textures", "lights", "azimuths", "elevations", "distances", "biases")
    for key in keys:
        att[key].requires_grad_(True)
    gen = torch.Generator(cuda_device).manual_seed(1)
    kernels.reset_launches()
    rgba, _ = dr.render(**att)
    (rgba * torch.randn(rgba.shape, device=cuda_device, generator=gen)).sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**ZERO, "raster_fwd": 1, "texture_fwd": 1, "raster_bwd": 1,
                                "texture_bwd": 1}
    assert all(torch.isfinite(att[k].grad).all() and att[k].grad.abs().max() > 0 for k in keys)

    ws = [torch.randn(shape, device=cuda_device, generator=gen)
          for shape in ((4, 128, 128), (4, 128, 128, 2), (4, 128, 128, 3))]
    grads = []
    for fn in (rasterize_fused, rasterize_fused_plain):
        leaves = [a.detach().requires_grad_(True) for a in args]
        _, soft, uv, normal, _ = fn(*leaves, height=128, width=128)
        ((soft * ws[0]).sum() + (uv * ws[1]).sum() + (normal * ws[2]).sum()).backward()
        grads.append((leaves[0].grad, leaves[4].grad))
        assert fn is rasterize_fused_plain or (leaves[1].grad is None
                                               and leaves[2].grad is None)
    # the winners of a few edge pixels differ between the kernel and the plain
    # version (parity.RASTER_TOL), and each moves a whole pixel's uv gradient
    for ours, ref in zip(*grads):
        assert (ours - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
def test_texture_render_backward_on_cuda(cuda_device):
    rs = np.random.RandomState(7)
    uv, tex, mask, g = (torch.as_tensor(a.astype(np.float32), device=cuda_device) for a in (
        rs.uniform(-0.1, 1.1, (2, 32, 32, 2)), rs.rand(2, 64, 32, 3),
        rs.rand(2, 32, 32) > 0.3, rs.randn(2, 32, 32, 3)))
    uv.requires_grad_(True)
    tex.requires_grad_(True)
    mask.requires_grad_(True)
    texture_render(uv, tex, mask).backward(g)
    assert mask.grad is None
    parity.check_texture_bwd(parity.texture_bwd_stats(
        (uv.grad, tex.grad), texture_backward_plain(g, uv, tex, mask), mask))


def test_cpu_exact_render_takes_the_plain_path():
    """soft_mode='exact' on the CPU: no launch, the alpha of the plain
    'exact' rasterizer, and gradients to every attribute."""
    args, _, att = _raster_inputs(32, 2, "cpu")
    dr = DiffRender(SPHERE, 32, soft_mode="exact", device="cpu")
    for key in ("vertices", "textures", "lights", "azimuths"):
        att[key].requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    rgba, _ = dr.render(**att)
    rgba.square().sum().backward()
    assert kernels.LAUNCHES == before
    ref = rasterize_fused_plain(*args, height=32, width=32, soft_mode="exact")
    assert torch.equal(rgba[..., 3].detach(), ref[1])
    line = rasterize_fused_plain(*args, height=32, width=32)
    assert not torch.equal(ref[1], line[1]) and torch.equal(ref[0], line[0])
    for key in ("vertices", "textures", "lights", "azimuths"):
        assert torch.isfinite(att[key].grad).all() and att[key].grad.abs().max() > 0
    with torch.no_grad():  # served and trained renders are one form
        served, _ = dr.render(**att)
    assert torch.equal(served, rgba.detach())


@pytest.mark.parametrize("soft_mode", ["line", "exact"])
def test_tile_culled_plain_sum_is_the_margin_cut(soft_mode):
    """``tile_cull``: the plain sum over the faces the kernels' tiles keep.
    The winner is untouched, soft only loses mass, by less than the bound
    the kernels are held to, and a face table's cull rule keeps exactly
    those faces (``face_cull`` against ``_tile_overlaps`` on the first tile)."""
    args, _, _ = _raster_inputs(128, 1, "cpu")
    full = rasterize_fused_plain(*args, height=128, width=128, soft_mode=soft_mode)
    cut = rasterize_fused_plain(*args, height=128, width=128, soft_mode=soft_mode,
                                tile_cull=True)
    assert all(torch.equal(a, b) for a, b in zip(full[2:], cut[2:]))
    assert torch.equal(full[0], cut[0])
    lost = full[1] - cut[1]
    assert lost.min() >= -1e-7 and 0 < lost.max() <= parity.RASTER_TOL["soft"]
    cull = face_cull(face_rows(*args))[:, :-1]
    in_x, in_y = _tile_overlaps(args[0], 128, 128)
    margin, front = 0.035, args[2] > 0
    live = ((cull[..., 1] >= -0.25 - margin) & (cull[..., 0] <= 0.0 + margin)  # tile (3, 3)
            & (cull[..., 3] >= 0.0 - margin) & (cull[..., 2] <= 0.25 + margin))
    assert torch.equal(live, in_x[:, 48] & in_y[:, 48] & front) and live.any()


def _dense_inputs(height, width, batch, distance, device, seed=0):
    """The SMPL template at the Market shape (ratio = height / width,
    ellipsoid 2) with every camera at ``distance``."""
    dr = DiffRender(SMPL, width, ratio=height / width, init_ellipsoid=2.0, device=device)
    att = bench_attributes(dr.vertices_init.cpu().numpy(), batch, width, seed)
    att["distances"][:] = distance
    att["elevations"] -= 15.0
    fvc, fvi, fn = dr.project(to_torch(att, device))
    return (fvi, fvc[..., 2], fn[..., 2], dr.face_uvs, fn), dr


@pytest.mark.cuda
@pytest.mark.parametrize("height,width,distance", [(128, 64, 2.0), (128, 64, 6.0),
                                                   (128, 128, 7.0)])
def test_dense_template_kernels_match_plain(cuda_device, height, width, distance):
    """K1's and K2's kernels on 13,776 faces (the last pass holds 208 faces
    and the sentinel), at ratio 2 and 1, near and far: counted under the
    dense names, against the plain versions."""
    args, _ = _dense_inputs(height, width, 2, distance, cuda_device)
    fvi, _, fnz = args[0], args[1], args[2]
    kernels.reset_launches()
    out = rasterize_fused(*args, height=height, width=width)
    stats = parity.raster_stats(out, rasterize_fused_plain(*args, height=height, width=width))
    assert stats["covered"] > 0
    parity.check_raster(stats)
    g = torch.randn((2, height * width), device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(3))
    g_sumlog = (g * (out[1].reshape(2, -1) - 1.0)).contiguous()
    G = raster_bwd(face_rows(*args).contiguous(), g_sumlog, 7000.0, height, width)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**ZERO, "raster_fwd_dense": 1, "raster_bwd_dense": 1}
    G_plain = soft_backward_plain(fvi, fnz, g_sumlog, 7000.0, height, width)
    parity.check_raster_bwd(parity.raster_bwd_stats(G, G_plain, _chain(fvi, G),
                                                    _chain(fvi, G_plain)))


@pytest.mark.cuda
@pytest.mark.parametrize("size,batch", [(64, 2), (128, 4), (100, 3)])
def test_exact_mode_kernels_match_plain(cuda_device, size, batch):
    """The 'exact' soft mode, fused and plain instantiation, against the
    plain 'exact' path; its soft differs from the 'line' mode's."""
    args, _, _ = _raster_inputs(size, batch, cuda_device, seed=size)
    kernels.reset_launches()
    out = rasterize_fused(*args, height=size, width=size, soft_mode="exact")
    plain = rasterize_fused_plain(*args, height=size, width=size, soft_mode="exact")
    parity.check_raster(parity.raster_stats(out, plain))
    line = rasterize_fused(*args, height=size, width=size)
    assert (out[1] - line[1]).abs().max() > 1e-3
    idx, sumlog, dropped = rasterize_plain(*args[:3], height=size, width=size,
                                           soft_mode="exact")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**ZERO, "raster_exact_fused": 1, "raster_fwd": 1,
                                "raster_exact": 1}
    assert torch.equal(idx.reshape(out[0].shape), out[0]) and not dropped.any()
    assert (1.0 - torch.exp(sumlog).reshape(out[1].shape) - out[1]).abs().max() <= 1e-6


@pytest.mark.cuda
def test_exact_mode_backward_on_cuda(cuda_device):
    """No backward kernel in 'exact' mode: the fused form's and the two-phase
    form's gradients against autograd of the plain 'exact' path."""
    size, batch = 64, 2
    args, _, _ = _raster_inputs(size, batch, cuda_device, seed=9)
    gen = torch.Generator(cuda_device).manual_seed(4)
    ws = [torch.randn(shape, device=cuda_device, generator=gen)
          for shape in ((batch, size, size), (batch, size, size, 2), (batch, size, size, 3))]
    grads = []
    kernels.reset_launches()
    for fn in (rasterize_fused, dibr_rasterization, rasterize_fused_plain):
        leaves = [a.detach().requires_grad_(True) for a in args]
        _, soft, uv, normal, _ = fn(*leaves, height=size, width=size, soft_mode="exact")
        ((soft * ws[0]).sum() + (uv * ws[1]).sum() + (normal * ws[2]).sum()).backward()
        grads.append((leaves[0].grad, leaves[4].grad))
    assert kernels.LAUNCHES == {**ZERO, "raster_exact_fused": 1, "raster_exact": 1}
    for ours in grads[:2]:
        for a, ref in zip(ours, grads[2]):
            assert (a - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
def test_unmasked_texture_kernels_match_plain(cuda_device):
    rs = np.random.RandomState(8)
    uv_np = rs.uniform(-0.2, 1.2, (3, 64, 32, 2)).astype(np.float32)
    uv_np[0, 0, :2] = [[0.0, 1.0], [1.0, 0.0]]  # exactly on the clip
    uv = torch.as_tensor(uv_np, device=cuda_device).requires_grad_(True)
    tex = torch.as_tensor(rs.rand(3, 128, 32, 3).astype(np.float32),
                          device=cuda_device).requires_grad_(True)
    g = torch.as_tensor(rs.randn(3, 64, 32, 3).astype(np.float32), device=cuda_device)
    kernels.reset_launches()
    out = texture_mapping(uv, tex)
    out.backward(g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**ZERO, "texture_unmasked_fwd": 1, "texture_unmasked_bwd": 1}
    assert (out - texture_mapping_plain(uv, tex)).abs().max() <= parity.TEXTURE_TOL
    everywhere = torch.ones(uv.shape[:3], device=cuda_device)
    parity.check_texture_bwd(parity.texture_bwd_stats(
        (uv.grad, tex.grad), texture_backward_plain(g, uv, tex), everywhere))


@pytest.mark.cuda
def test_cuda_exact_render_goes_through_the_exact_and_unmasked_kernels(cuda_device):
    _, _, att = _raster_inputs(128, 4, cuda_device)
    dr = DiffRender(SPHERE, 128, soft_mode="exact", device=cuda_device)
    kernels.reset_launches()
    with torch.no_grad():
        served, _ = dr.render(**att)
    assert kernels.LAUNCHES == {**ZERO, "raster_exact_fused": 1, "texture_unmasked_fwd": 1}
    att["vertices"].requires_grad_(True)
    att["textures"].requires_grad_(True)
    kernels.reset_launches()
    rgba, _ = dr.render(**att)
    rgba.square().sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {**ZERO, "raster_exact_fused": 1, "texture_unmasked_fwd": 1,
                                "texture_unmasked_bwd": 1}
    # served and trained renders are the fused form alike
    assert (served - rgba).abs().max() <= 1e-6
    assert all(torch.isfinite(att[k].grad).all() and att[k].grad.abs().max() > 0
               for k in ("vertices", "textures"))
