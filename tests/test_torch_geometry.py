"""Port parity: OBJ reader, template topology and camera math
(magicmirror_torch/geometry vs magicmirror/geometry).

Tolerances: arrays from the OBJ reader and the topology are exact; the
camera math is float32 with another op order, held to 1e-5.  Unit face
normals through the whole of ``prepare_vertices`` are held to 1e-4: they
come from differences of camera-space coordinates of magnitude up to 7,
where one float32 rounding (5e-7) over a 0.1-long edge moves a normal by
~1e-5 (2.8e-5 seen); from the same camera vertices they agree to 1e-5.
"""
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.geometry import camera as jcam
from magicmirror.geometry import mesh as jmesh
from magicmirror.geometry.obj_io import load_obj as jload_obj
from magicmirror_torch.geometry import camera as cam
from magicmirror_torch.geometry import mesh as mesh_ops
from magicmirror_torch.geometry.obj_io import load_obj
from torch_parity import REPO, SPHERE, n, t

torch.set_num_threads(1)
ATOL = 1e-5
NORMAL_ATOL = 1e-4


@pytest.mark.parametrize("name", ["sphere.obj", "smpl_uv.obj"])
def test_load_obj_matches_reference(name):
    path = os.path.join(REPO, "template", name)
    ours, ref = load_obj(path, with_materials=True), jload_obj(path, with_materials=True)
    for field in ("vertices", "faces", "uvs", "face_uvs_idx"):
        a, b = getattr(ours, field), getattr(ref, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field
    assert ours.materials == ref.materials


def test_topology_matches_reference():
    mesh = load_obj(SPHERE)
    for ell in (1.0, 2.0, -1):
        assert np.array_equal(mesh_ops.normalize_template(mesh.vertices, ell),
                              jmesh.normalize_template(mesh.vertices, ell))
    e, inv = mesh_ops.unique_edges(mesh.faces)
    je, jinv = jmesh.unique_edges(mesh.faces)
    assert np.array_equal(e, je) and np.array_equal(inv, jinv)
    L = mesh_ops.uniform_laplacian(mesh.vertices.shape[0], mesh.faces)
    assert np.array_equal(L, jmesh.uniform_laplacian(mesh.vertices.shape[0], mesh.faces))


def test_camera_matches_reference():
    rs = np.random.RandomState(0)
    B = 4
    dist = rs.uniform(2, 7, B).astype(np.float32)
    elev = rs.uniform(0, 30, B).astype(np.float32)
    azim = rs.uniform(-180, 180, B).astype(np.float32)
    look = np.concatenate([rs.uniform(-0.3, 0.3, (B, 2)), np.zeros((B, 1))], 1).astype(np.float32)
    up = np.tile(np.float32([[0, 1, 0]]), (B, 1))
    mesh = load_obj(SPHERE)
    verts = (mesh_ops.normalize_template(mesh.vertices)[None]
             + rs.uniform(-0.05, 0.05, (B,) + mesh.vertices.shape)).astype(np.float32)

    pos = cam.camera_position_from_spherical_angles(t(dist), t(elev), t(azim))
    jpos = jcam.camera_position_from_spherical_angles(dist, elev, azim)
    np.testing.assert_allclose(n(pos), np.asarray(jpos), atol=ATOL)

    tr = cam.generate_transformation_matrix(pos, t(look), t(up))
    jtr = jcam.generate_transformation_matrix(jpos, jnp.asarray(look), jnp.asarray(up))
    np.testing.assert_allclose(n(tr), np.asarray(jtr), atol=ATOL)

    for ratio in (1.0, 0.5):
        fovy = math.atan(1.0 / 2.5) * 2
        np.testing.assert_allclose(n(cam.perspective_projection(fovy, ratio)),
                                   np.asarray(jcam.perspective_projection(fovy, ratio)),
                                   rtol=1e-7)
    proj = cam.perspective_projection(math.atan(1.0 / 2.5) * 2)
    ours = cam.prepare_vertices(t(verts), torch.as_tensor(mesh.faces.astype(np.int64)),
                                proj, tr)
    ref = jcam.prepare_vertices(jnp.asarray(verts), jnp.asarray(mesh.faces),
                                jcam.perspective_projection(math.atan(1.0 / 2.5) * 2), jtr)
    for a, b, atol in zip(ours, ref, (ATOL, ATOL, NORMAL_ATOL)):
        assert a.shape == b.shape
        np.testing.assert_allclose(n(a), np.asarray(b), atol=atol)
    np.testing.assert_allclose(
        n(cam.face_normals_from_vertices(t(ref[0]), unit=True)),
        np.asarray(jcam.face_normals_from_vertices(ref[0], unit=True)), atol=ATOL)


@pytest.mark.parametrize("name", ["sphere.obj", "sphere_dryrun.obj"])
def test_flip_index_and_edge2faces_match_reference(name):
    mesh = load_obj(os.path.join(REPO, "template", name))
    v = mesh_ops.normalize_template(mesh.vertices)
    assert np.array_equal(mesh_ops.flip_index(v), jmesh.flip_index(v))
    edges, e2f = mesh_ops.edge2faces(mesh.faces)
    jedges, je2f = jmesh.edge2faces(mesh.faces)
    assert np.array_equal(edges, jedges) and np.array_equal(e2f, je2f)
    assert edges.dtype == e2f.dtype == np.int64  # torch indexes with int64


def test_edge2faces_duplicates_the_face_of_a_boundary_edge():
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    edges, e2f = mesh_ops.edge2faces(faces)
    jedges, je2f = jmesh.edge2faces(faces)
    assert np.array_equal(edges, jedges) and np.array_equal(e2f, je2f)
    shared = np.flatnonzero((edges == [0, 2]).all(1))[0]
    assert sorted(e2f[shared]) == [0, 1]
    assert all(e2f[i, 0] == e2f[i, 1] for i in range(len(edges)) if i != shared)
