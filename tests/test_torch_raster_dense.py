"""Port parity on dense templates and at ratio 2: the plain 'line' rasterizer
of the port (the CPU path, and the oracle of the CUDA kernels when they run
under their dense names) against the JAX golden path and against the dense
Pallas kernels ``rasterize_fused_v6`` in interpret mode.

Scenes as tests/test_rasterize_v6.py makes them: ``sphere2.obj`` (5,120
faces) and ``smpl_uv.obj`` (13,776 faces), b2, at 32x32 (ratio 1) and 32x16
(ratio 2: the template squashed by ellipsoid 2, the projection with
ratio = 1/2), camera distances 2 and 6 (at 6 the whole body falls into a few
cells).

Tolerances: idx exact; soft 3e-4 against the Pallas kernel (it culls beyond
the 0.035 soft margin) and 1e-5 against the golden path; uv and normal 1e-5;
the gradient of one loss with respect to the vertices within 2e-3 of the
golden path's in the L2 norm, as tests/test_rasterize_v6.py holds v6.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.geometry import camera as jcam
from magicmirror.ops.pallas.rasterize_v6 import rasterize_fused_v6
from magicmirror.ops.rasterize import dibr_rasterization
from magicmirror_torch import kernels
from magicmirror_torch.geometry import mesh as mesh_ops
from magicmirror_torch.geometry.obj_io import load_obj
from magicmirror_torch.ops.rasterize import rasterize_fused
from torch_parity import REPO, n, t

torch.set_num_threads(1)
B = 2
CASES = [("sphere2.obj", 32, 32, 2.0), ("smpl_uv.obj", 32, 32, 6.0),
         ("smpl_uv.obj", 32, 16, 2.0)]


def _scene(template, height, width, dist):
    ratio = height / width
    mesh = load_obj(f"{REPO}/template/{template}", with_materials=True)
    v = mesh_ops.normalize_template(mesh.vertices, 2.0 if ratio != 1 else 1.0)
    rng = np.random.RandomState(0)
    verts = jnp.asarray(v[None] + rng.uniform(-0.03, 0.03, (B,) + v.shape), jnp.float32)
    proj = jcam.perspective_projection(math.atan(1.0 / 2.5) * 2, ratio=1.0 / ratio)
    cpos = jcam.camera_position_from_spherical_angles(
        jnp.asarray([dist, dist + 0.5], jnp.float32), jnp.asarray([15.0, 5.0], jnp.float32),
        jnp.asarray([40.0, -120.0], jnp.float32), degrees=True)
    tr = jcam.generate_transformation_matrix(
        cpos, jnp.zeros((B, 3), jnp.float32),
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], jnp.float32), (B, 3)))
    fvc, fvi, fn = jcam.prepare_vertices(verts, jnp.asarray(mesh.faces), proj, tr)
    return dict(fvi=fvi, fz=fvc[:, :, :, 2], fnz=fn[:, :, 2], fn=fn,
                face_uvs=jnp.asarray(mesh.uvs[mesh.face_uvs_idx]))


def _golden(s, height, width):
    F = s["fvi"].shape[1]
    attrs = [jnp.broadcast_to(s["face_uvs"][None], (B, F, 3, 2)),
             s["fn"][:, :, None, :].repeat(3, axis=2)]
    return dibr_rasterization(height, width, s["fz"], s["fvi"], attrs, s["fnz"],
                              soft_mode="line")


@pytest.mark.parametrize("template,height,width,dist", CASES)
def test_dense_plain_matches_golden_and_v6(template, height, width, dist):
    s = _scene(template, height, width, dist)
    before = dict(kernels.LAUNCHES)
    idx, soft, uv, normal, hard = (n(a) for a in rasterize_fused(
        *(t(s[k]) for k in ("fvi", "fz", "fnz", "face_uvs", "fn")), height=height,
        width=width))
    assert kernels.LAUNCHES == before  # CPU tensors take the plain path
    assert (idx >= 0).mean() > 0.01

    (uv_g, normal_g), soft_g, idx_g = _golden(s, height, width)
    assert np.array_equal(idx, np.asarray(idx_g))
    np.testing.assert_allclose(soft, np.asarray(soft_g), atol=1e-5)
    np.testing.assert_allclose(uv, np.asarray(uv_g), atol=1e-5)
    np.testing.assert_allclose(normal, np.asarray(normal_g), atol=1e-5)

    idx6, soft6, uv6, normal6, hard6, dropped = rasterize_fused_v6(
        s["fvi"], s["fz"], s["fnz"], s["face_uvs"], s["fn"], height=height, width=width,
        interpret=True)
    assert int(np.asarray(dropped).sum()) == 0
    assert np.array_equal(idx, np.asarray(idx6).reshape(B, height, width))
    np.testing.assert_allclose(soft, np.asarray(soft6).reshape(B, height, width), atol=3e-4)
    np.testing.assert_allclose(uv, np.asarray(uv6).reshape(B, height, width, 2), atol=1e-5)
    np.testing.assert_allclose(normal, np.asarray(normal6).reshape(B, height, width, 3),
                               atol=1e-5)
    np.testing.assert_array_equal(hard, np.asarray(hard6).reshape(B, height, width))


def test_dense_gradient_matches_golden():
    """d(loss)/d(fvi) and d(loss)/d(face normals) on sphere2.obj at ratio 2,
    through RasterizeFused's CPU backward (the plain moments and the
    winner's interpolation) against jax.grad of the golden path."""
    height, width = 32, 16
    s = _scene("sphere2.obj", height, width, 2.5)

    def loss_golden(fvi, fn):
        (uv, normal), soft, _ = _golden({**s, "fvi": fvi, "fn": fn}, height, width)
        return jnp.sum(soft * jnp.sin(soft)) + jnp.sum(uv * 0.3) + jnp.sum(normal ** 2)

    g_fvi, g_fn = jax.grad(loss_golden, argnums=(0, 1))(s["fvi"], s["fn"])
    fvi, fn = t(s["fvi"]).requires_grad_(True), t(s["fn"]).requires_grad_(True)
    _, soft, uv, normal, _ = rasterize_fused(fvi, t(s["fz"]), t(s["fnz"]), t(s["face_uvs"]),
                                             fn, height=height, width=width)
    ((soft * torch.sin(soft)).sum() + (uv * 0.3).sum() + (normal ** 2).sum()).backward()
    for ours, ref in ((fvi.grad, g_fvi), (fn.grad, g_fn)):
        ref = np.asarray(ref)
        assert np.linalg.norm(ref) > 0
        assert np.linalg.norm(n(ours) - ref) / np.linalg.norm(ref) < 2e-3
