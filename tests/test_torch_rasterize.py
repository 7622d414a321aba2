"""Port parity: the face-row precompute and the plain forward rasterizer
(magicmirror_torch/ops vs the JAX golden path and the v5 Pallas kernel).

Tolerances: face rows 1e-6 (relative and absolute: the same formulas in
float32).  Plain vs the golden XLA path: idx exact, uv / normal / hard /
soft 1e-5.  Plain vs the Pallas stream kernel in interpret mode: idx exact,
uv / normal 1e-5, soft 3e-4 (the kernel culls faces beyond its 0.035 soft
margin, as tests/test_rasterize_v4.py allows).  The CUDA kernel is held
to the plain version in tests/test_torch_kernels.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.geometry import camera as jcam
from magicmirror.ops.pallas.rasterize_v4 import _face_rows, rasterize_fused_v5
from magicmirror.ops.rasterize import dibr_rasterization
from magicmirror_torch import kernels
from magicmirror_torch.geometry import mesh as mesh_ops
from magicmirror_torch.geometry.obj_io import load_obj
from magicmirror_torch.ops.face_rows import face_rows
from magicmirror_torch.ops.rasterize import rasterize_fused, rasterize_fused_plain
from torch_parity import SPHERE, n, t

torch.set_num_threads(1)
H = W = 64
B = 2


@pytest.fixture(scope="module")
def scene():
    """The scene of tests/test_rasterize_v4.py: two jittered spheres."""
    mesh = load_obj(SPHERE, with_materials=True)
    v = mesh_ops.normalize_template(mesh.vertices, 1.0)
    rng = np.random.RandomState(0)
    verts = jnp.asarray(v[None] + rng.uniform(-0.05, 0.05, (B,) + v.shape), jnp.float32)
    proj = jcam.perspective_projection(math.atan(1.0 / 2.5) * 2, ratio=1.0)
    cpos = jcam.camera_position_from_spherical_angles(
        jnp.asarray([2.5, 3.5], jnp.float32), jnp.asarray([10.0, 20.0], jnp.float32),
        jnp.asarray([30.0, -120.0], jnp.float32), degrees=True)
    tr = jcam.generate_transformation_matrix(
        cpos, jnp.zeros((B, 3), jnp.float32),
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], jnp.float32), (B, 3)))
    fvc, fvi, fn = jcam.prepare_vertices(verts, jnp.asarray(mesh.faces), proj, tr)
    arrays = dict(fvi=fvi, fz=fvc[:, :, :, 2], fnz=fn[:, :, 2],
                  face_uvs=jnp.asarray(mesh.uvs[mesh.face_uvs_idx]), fn=fn)
    return {k: np.asarray(a) for k, a in arrays.items()}


def _args(scene, device="cpu"):
    return [t(scene[k], device) for k in ("fvi", "fz", "fnz", "face_uvs", "fn")]


def test_face_rows_match_reference(scene):
    ours = n(face_rows(*_args(scene)))
    ref = np.stack([np.asarray(_face_rows(scene["fvi"][b], scene["fz"][b], scene["fnz"][b],
                                          scene["face_uvs"], scene["fn"][b]))
                    for b in range(B)])
    assert ours.shape == ref.shape == (B, scene["fvi"].shape[1] + 1, 26)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_plain_matches_golden(scene):
    F = scene["fvi"].shape[1]
    attrs = [jnp.ones((B, F, 3, 1), jnp.float32),
             jnp.broadcast_to(scene["face_uvs"][None], (B, F, 3, 2)),
             jnp.asarray(scene["fn"])[:, :, None, :].repeat(3, axis=2)]
    feats, soft_g, idx_g = dibr_rasterization(
        H, W, jnp.asarray(scene["fz"]), jnp.asarray(scene["fvi"]), attrs,
        jnp.asarray(scene["fnz"]), soft_mode="line")
    before = dict(kernels.LAUNCHES)
    idx, soft, uv, normal, hard = rasterize_fused(*_args(scene), height=H, width=W)
    assert kernels.LAUNCHES == before  # a CPU tensor takes the plain path
    assert np.array_equal(n(idx), np.asarray(idx_g))
    assert (n(idx) >= 0).mean() > 0.2
    np.testing.assert_allclose(n(uv), np.asarray(feats[1]), atol=1e-5)
    np.testing.assert_allclose(n(normal), np.asarray(feats[2]), atol=1e-5)
    np.testing.assert_allclose(n(hard), np.asarray(feats[0])[..., 0], atol=1e-5)
    np.testing.assert_allclose(n(soft), np.asarray(soft_g), atol=1e-5)


def test_plain_matches_pallas_stream_kernel(scene):
    ref = rasterize_fused_v5(*(jnp.asarray(scene[k]) for k in
                               ("fvi", "fz", "fnz", "face_uvs", "fn")),
                             height=H, width=W, interpret=True)
    idx_r, soft_r, uv_r, normal_r, hard_r, dropped = (np.asarray(a) for a in ref)
    assert np.all(dropped == 0)
    idx, soft, uv, normal, hard = (n(a) for a in rasterize_fused_plain(
        *_args(scene), height=H, width=W))
    assert np.array_equal(idx, idx_r.reshape(B, H, W))
    np.testing.assert_allclose(uv, uv_r.reshape(B, H, W, 2), atol=1e-5)
    np.testing.assert_allclose(normal, normal_r.reshape(B, H, W, 3), atol=1e-5)
    np.testing.assert_allclose(hard, hard_r.reshape(B, H, W), atol=1e-5)
    np.testing.assert_allclose(soft, soft_r.reshape(B, H, W), atol=3e-4)
