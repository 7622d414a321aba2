"""Port parity of the rasterizer's backward: ``coeffs13``,
``soft_backward_plain`` and the whole ``RasterizeFused`` backward against
``jax.grad`` of the JAX golden XLA path.  The comparisons with the VJPs of the
Pallas kernels in interpret mode are in tests/test_torch_raster_grad_pallas.py,
which uses this file's scenes.

sphere.obj at 32^2 and 64^2, B = 2 with a near (distance 2) and a far
(distance 6) camera, plus a hand-built mesh with a sliver seen edge-on, a
degenerate face and a face with two equal x (a tie in the bbox's min / max).

Tolerance: 1e-4 of the largest absolute gradient, the bound
tests/test_rasterize_v4.py holds the Pallas backward to.  It is the same
formula summed in another order; seen here: 2e-6 against the golden path.
The CUDA kernel is held to ``soft_backward_plain`` on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.geometry import camera as jcam
from magicmirror.ops.pallas.rasterize_v4 import _coeffs13
from magicmirror.ops.rasterize import dibr_rasterization
from magicmirror_torch.geometry import mesh as mesh_ops
from magicmirror_torch.geometry.obj_io import load_obj
from magicmirror_torch.ops.face_rows import coeffs13
from magicmirror_torch.ops.rasterize import rasterize_fused
from torch_parity import SPHERE, n, t

torch.set_num_threads(1)
B = 2
REL_TOL = 1e-4


def _scene(size):
    """Two jittered spheres, one seen from near and one from far."""
    mesh = load_obj(SPHERE, with_materials=True)
    v = mesh_ops.normalize_template(mesh.vertices, 1.0)
    rng = np.random.RandomState(size)
    verts = jnp.asarray(v[None] + rng.uniform(-0.05, 0.05, (B,) + v.shape), jnp.float32)
    proj = jcam.perspective_projection(math.atan(1.0 / 2.5) * 2, ratio=1.0)
    cpos = jcam.camera_position_from_spherical_angles(
        jnp.asarray([2.0, 6.0], jnp.float32), jnp.asarray([10.0, 25.0], jnp.float32),
        jnp.asarray([40.0, -110.0], jnp.float32), degrees=True)
    tr = jcam.generate_transformation_matrix(
        cpos, jnp.zeros((B, 3), jnp.float32),
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], jnp.float32), (B, 3)))
    fvc, fvi, fn = jcam.prepare_vertices(verts, jnp.asarray(mesh.faces), proj, tr)
    arrays = dict(fvi=fvi, fz=fvc[:, :, :, 2], fnz=fn[:, :, 2],
                  face_uvs=jnp.asarray(mesh.uvs[mesh.face_uvs_idx]), fn=fn)
    scene = {k: np.asarray(a) for k, a in arrays.items()}
    w = np.random.RandomState(size + 1)
    P = size * size
    scene.update(size=size, w_soft=w.randn(B, P).astype(np.float32),
                 w_uv=w.randn(B, P, 2).astype(np.float32),
                 w_n=w.randn(B, P, 3).astype(np.float32))
    return scene


@pytest.fixture(scope="module", params=[32, 64])
def scene(request):
    return _scene(request.param)


def _close(ours, ref, what):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(n(ours) - ref).max())
    assert err < REL_TOL * scale, (what, err, scale)


def _golden_loss(scene, soft_only):
    S, F = scene["size"], scene["fvi"].shape[1]
    fz, fnz = jnp.asarray(scene["fz"]), jnp.asarray(scene["fnz"])

    def loss(fvi_, uvs_, fn_):
        attrs = [jnp.broadcast_to(uvs_[None], (B, F, 3, 2)), fn_[:, :, None, :].repeat(3, axis=2)]
        (uv_im, n_im), soft, _ = dibr_rasterization(S, S, fz, fvi_, attrs, fnz,
                                                    soft_mode="line")
        total = jnp.sum(soft.reshape(B, -1) * scene["w_soft"])
        if not soft_only:
            total = (total + jnp.sum(uv_im.reshape(B, -1, 2) * scene["w_uv"])
                     + jnp.sum(n_im.reshape(B, -1, 3) * scene["w_n"]))
        return total

    return loss


def _port_grads(scene, soft_only):
    S = scene["size"]
    fvi, fz, fnz, uvs, fn = (t(scene[k]).requires_grad_(True)
                             for k in ("fvi", "fz", "fnz", "face_uvs", "fn"))
    _, soft, uv, normal, _ = rasterize_fused(fvi, fz, fnz, uvs, fn, height=S, width=S)
    total = (soft.reshape(B, -1) * t(scene["w_soft"])).sum()
    if not soft_only:
        total = (total + (uv.reshape(B, -1, 2) * t(scene["w_uv"])).sum()
                 + (normal.reshape(B, -1, 3) * t(scene["w_n"])).sum())
    total.backward()
    return fvi, fz, fnz, uvs, fn


def _jargs(scene):
    return tuple(jnp.asarray(scene[k]) for k in ("fvi", "face_uvs", "fn"))


def test_soft_backward_matches_golden(scene):
    ref = jax.grad(_golden_loss(scene, soft_only=True))(*_jargs(scene))
    fvi, *_ = _port_grads(scene, soft_only=True)
    _close(fvi.grad, ref, "d_fvi")


def test_fused_backward_matches_golden(scene):
    ref = jax.grad(_golden_loss(scene, soft_only=False), argnums=(0, 1, 2))(*_jargs(scene))
    fvi, _, _, uvs, fn = _port_grads(scene, soft_only=False)
    for ours, r, what in zip((fvi, uvs, fn), ref, ("d_fvi", "d_face_uvs", "d_face_normals")):
        _close(ours.grad, r, what)


def test_no_gradient_reaches_z_or_normal_z(scene):
    _, fz, fnz, _, _ = _port_grads(scene, soft_only=False)
    assert fz.grad is None and fnz.grad is None


def _hand_built(axis_aligned):
    """Four front faces in a 32^2 image: an ordinary one, a sliver seen almost
    edge-on, a collinear one and a right-angled one.  With ``axis_aligned``
    the collinear one is exactly degenerate (area 0) along y = -0.8 and the
    right angle has two equal x and two equal y (ties in the bbox's min and
    max); without, both are slightly turned (the collinear one then has an
    area of 1e-8, above the degeneracy threshold)."""
    if axis_aligned:
        flat = [[-0.5, -0.8], [0.0, -0.8], [0.5, -0.8]]
        right = [[0.3, -0.2], [0.3, 0.4], [0.8, 0.4]]
    else:
        flat = [[-0.5, -0.9], [0.0, -0.8], [0.5, -0.7]]
        right = [[0.3, -0.2], [0.33, 0.4], [0.8, 0.43]]
    fvi = np.array([[[[-0.6, -0.5], [0.5, -0.4], [-0.1, 0.6]],
                     [[-0.8, 0.7], [0.7, 0.7005], [0.0, 0.7001]], flat, right]], np.float32)
    fnz = np.ones((1, 4), np.float32)
    fz = -np.array([[[2.0, 2.1, 2.2], [1.5, 1.5, 1.5], [1.0, 1.0, 1.0], [3.0, 2.5, 2.0]]],
                   np.float32)
    rs = np.random.RandomState(3)
    uvs = rs.rand(4, 3, 2).astype(np.float32)
    fn = rs.randn(1, 4, 3).astype(np.float32)
    return dict(fvi=fvi, fz=fz, fnz=fnz, face_uvs=uvs, fn=fn, size=32,
                w_soft=rs.randn(1, 1024).astype(np.float32),
                w_uv=rs.randn(1, 1024, 2).astype(np.float32),
                w_n=rs.randn(1, 1024, 3).astype(np.float32))


def _hand_built_port_grads(scene):
    fvi, fz, fnz, uvs, fn = (t(scene[k]).requires_grad_(True)
                             for k in ("fvi", "fz", "fnz", "face_uvs", "fn"))
    _, soft, uv, normal, _ = rasterize_fused(fvi, fz, fnz, uvs, fn, height=32, width=32)
    ((soft.reshape(1, -1) * t(scene["w_soft"])).sum()
     + (uv.reshape(1, -1, 2) * t(scene["w_uv"])).sum()
     + (normal.reshape(1, -1, 3) * t(scene["w_n"])).sum()).backward()
    return fvi, uvs, fn


def test_hand_built_faces_match_golden():
    scene = _hand_built(axis_aligned=False)
    S, F = 32, 4
    fz, fnz = jnp.asarray(scene["fz"]), jnp.asarray(scene["fnz"])

    def loss(fvi_, uvs_, fn_):
        attrs = [jnp.broadcast_to(uvs_[None], (1, F, 3, 2)), fn_[:, :, None, :].repeat(3, axis=2)]
        (uv_im, n_im), soft, _ = dibr_rasterization(S, S, fz, fvi_, attrs, fnz,
                                                    soft_mode="line")
        return (jnp.sum(soft.reshape(1, -1) * scene["w_soft"])
                + jnp.sum(uv_im.reshape(1, -1, 2) * scene["w_uv"])
                + jnp.sum(n_im.reshape(1, -1, 3) * scene["w_n"]))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*_jargs(scene))
    assert all(np.isfinite(np.asarray(r)).all() for r in ref)
    for ours, r, what in zip(_hand_built_port_grads(scene), ref,
                             ("d_fvi", "d_face_uvs", "d_face_normals")):
        _close(ours.grad, r, what)


def test_coeffs13_and_its_vjp_match_reference():
    """Values and cotangents of the 13 coefficients, ties in min / max
    included: both frameworks split the gradient evenly among tied vertices."""
    fvi = _hand_built(axis_aligned=True)["fvi"][0]
    g = np.random.RandomState(5).randn(4, 13).astype(np.float32)
    ref, vjp = jax.vjp(_coeffs13, jnp.asarray(fvi))
    ours_in = t(fvi).requires_grad_(True)
    ours = coeffs13(ours_in)
    np.testing.assert_allclose(n(ours), np.asarray(ref), rtol=1e-6, atol=1e-6)
    ours.backward(t(g))
    np.testing.assert_allclose(n(ours_in.grad), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)
