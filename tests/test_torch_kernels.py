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
from magicmirror_torch.ops.face_rows import face_rows
from magicmirror_torch.ops.rasterize import raster_fwd, rasterize_fused, rasterize_fused_plain
from magicmirror_torch.ops.sampling import texture_fwd, texture_render, texture_render_plain
from magicmirror_torch.render.renderer import DiffRender
from magicmirror_torch.render.synthetic import bench_attributes, to_torch

torch.set_num_threads(1)
SPHERE = os.path.join(os.path.dirname(__file__), "..", "template", "sphere.obj")


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
    assert build._LIB is None


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
def test_cuda_render_goes_through_both_kernels(cuda_device):
    _, dr, att = _raster_inputs(128, 4, cuda_device)
    kernels.reset_launches()
    rgba, _ = dr.render(**att)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"raster_fwd": 1, "texture_fwd": 1}
    assert torch.isfinite(rgba).all() and rgba[..., 3].mean() > 0.05
