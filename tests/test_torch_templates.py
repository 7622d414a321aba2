"""Port parity on the templates and shapes of the human-body configuration:
the dense templates of ``template/`` through the topology precompute, the
encoders at a 2:1 input with the vertex count of ``sphere2.obj``, converted
weights included, and the chamfer loss walked image by image.

Tolerances: the topology is exact (the same numpy arithmetic, ``flip_index``
in row blocks); the encoders as tests/test_torch_models.py holds them at the
square input (1e-4; the shape head 1e-3 of its largest value; angles 1e-2
degrees; the texture on 99.5% of texels); the chamfer loss and its gradient
1e-6 relative between the two walks and 1e-5 against the JAX package.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.geometry import mesh as jmesh
from magicmirror.geometry.obj_io import load_obj as jload_obj
from magicmirror.losses.chamfer import chamfer_distance as jchamfer_distance
from magicmirror.models import encoders as je
from magicmirror_torch.geometry import mesh as mesh_ops
from magicmirror_torch.geometry.obj_io import load_obj
from magicmirror_torch.losses import chamfer
from magicmirror_torch.models import encoders as te
from magicmirror_torch.render.synthetic import smooth_random
from test_torch_models import TOL, _image, _pair
from torch_parity import REPO, n, t

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["sphere2.obj", "ellipsoid2.obj", "smpl_uv.obj"])
def test_dense_template_topology_matches_reference(name):
    path = os.path.join(REPO, "template", name)
    mesh, ref = load_obj(path, with_materials=True), jload_obj(path, with_materials=True)
    for field in ("vertices", "faces", "uvs", "face_uvs_idx"):
        assert np.array_equal(getattr(mesh, field), getattr(ref, field)), field
    v = mesh_ops.normalize_template(mesh.vertices, 2.0)
    assert np.array_equal(v, jmesh.normalize_template(mesh.vertices, 2.0))
    assert np.abs(v[:, 0]).max() <= 0.45 + 1e-6 and np.abs(v[:, 1]).max() <= 0.9 + 1e-6
    assert np.array_equal(mesh_ops.flip_index(v), jmesh.flip_index(v))
    edges, e2f = mesh_ops.edge2faces(mesh.faces)
    jedges, je2f = jmesh.edge2faces(mesh.faces)
    assert np.array_equal(edges, jedges) and np.array_equal(e2f, je2f)
    L = mesh_ops.uniform_laplacian(v.shape[0], mesh.faces)
    assert L.shape == (v.shape[0], v.shape[0])
    assert np.array_equal(L, jmesh.uniform_laplacian(v.shape[0], mesh.faces))


@pytest.fixture(scope="module")
def sphere2():
    mesh = load_obj(os.path.join(REPO, "template", "sphere2.obj"))
    v = mesh_ops.normalize_template(mesh.vertices, 2.0)
    return v, mesh_ops.uniform_laplacian(v.shape[0], mesh.faces)


def test_encoders_match_reference_at_a_2_to_1_input(sphere2):
    """Shape, camera (the Market ranges), texture and light encoders on
    (2, 64, 32, 4) photos with V = 2,562, Flax variables converted."""
    v, lpl = sphere2
    V = v.shape[0]
    x = _image((2, 64, 32, 4), 31)
    ref, module = _pair(je.ShapeEncoder(pretrain="none", num_vertices=V),
                        te.ShapeEncoder(pretrain="none", num_vertices=V),
                        (jnp.asarray(x), jnp.asarray(v), jnp.asarray(lpl)), {"train": False},
                        seed=31)
    assert module.linear3.weight.shape == (3 * V, 3 * V)
    with torch.no_grad():
        out = n(module(t(x), t(v), t(lpl)))
    assert out.shape == (2, V, 3)
    assert np.abs(out - np.asarray(ref)).max() <= 1e-3 * np.abs(np.asarray(ref)).max()

    kw = dict(coordconv=True, pretrain="none", elev_range="-15~15", dist_range="2~6")
    ref, module = _pair(je.CameraEncoder(**kw), te.CameraEncoder(**kw),
                        (jnp.asarray(x), jnp.asarray(v)), {"train": False}, seed=32)
    with torch.no_grad():
        outs = module(t(x), t(v))
    for key, out, r in zip(("azimuths", "elevations", "distances", "biases"), outs, ref):
        d = n(out) - np.asarray(r)
        if key == "azimuths":
            d = (d + 180.0) % 360.0 - 180.0
        assert np.abs(d).max() <= (1e-2 if key in ("azimuths", "elevations") else TOL), key
    assert -15.0 <= float(outs[1].min()) and float(outs[1].max()) <= 15.0

    smooth = smooth_random((2, 64, 32, 4), 33)  # photo-like, as the square test's input
    ref, module = _pair(je.TextureEncoder(pretrain="none"), te.TextureEncoder(pretrain="none"),
                        (jnp.asarray(smooth),), {"train": False}, seed=33)
    with torch.no_grad():
        out = n(module(t(smooth)))
    assert out.shape == np.asarray(ref).shape == (2, 128, 32, 3)
    assert (np.abs(out - np.asarray(ref)) <= TOL).mean() >= 0.995

    ref, module = _pair(je.LightEncoder(coordconv=True), te.LightEncoder(coordconv=True),
                        (jnp.asarray(x),), {"train": False}, seed=34)
    with torch.no_grad():
        np.testing.assert_allclose(n(module(t(x))), np.asarray(ref), atol=TOL, rtol=TOL)


def test_chamfer_walked_image_by_image_is_the_same_loss(monkeypatch):
    rs = np.random.RandomState(5)
    x, y = rs.randn(3, 70, 3).astype(np.float32), rs.randn(3, 90, 3).astype(np.float32)
    y[0, :70] = x[0]  # exact zeros in the distance matrix
    results = []
    for limit in (1 << 27, 16):  # the whole batch at once; one image at a time
        monkeypatch.setattr(chamfer, "_DENSE_ELEMS", limit)
        a, b = t(x).requires_grad_(True), t(y).requires_grad_(True)
        loss, _ = chamfer.chamfer_distance(a, b)
        loss.backward()
        results.append((float(loss), n(a.grad), n(b.grad)))
    (l0, ga0, gb0), (l1, ga1, gb1) = results
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    np.testing.assert_allclose(ga1, ga0, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(gb1, gb0, rtol=1e-6, atol=1e-9)
    ref, (gx, gy) = jax.value_and_grad(lambda p, q: jchamfer_distance(p, q)[0], argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    assert abs(l1 - float(ref)) <= 1e-5 * abs(float(ref))
    np.testing.assert_allclose(ga1, np.asarray(gx), atol=1e-5 * np.abs(gx).max())
    np.testing.assert_allclose(gb1, np.asarray(gy), atol=1e-5 * np.abs(gy).max())
