"""Port parity: DiffRender.render on the CPU (the plain rasterizer and
texture paths) vs the JAX DiffRender(backend='xla') golden path, at 64^2,
B=2, with bench.py's attribute distribution on sphere.obj.

Tolerance 1e-5, except: the face normals and the per-pixel normals taken
from them, 1e-4, for the float32 conditioning stated in
tests/test_torch_geometry.py; and rgb, 1e-4: bench.py's textures are
per-texel noise, so the ~1e-7 by which the two camera paths place a vertex
moves uv by as much and the sampled colour by up to 64 texels per unit uv
times a texel step of up to 1 (2.2e-5 seen).
The render's gradients are in tests/test_torch_renderer_grad.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.render.renderer import DiffRender as JDiffRender
from magicmirror_torch.render.renderer import DiffRender, deep_copy
from magicmirror_torch.render.synthetic import bench_attributes, to_torch
from torch_parity import SPHERE, n

torch.set_num_threads(1)
S, B = 64, 2


@pytest.fixture(scope="module")
def renders():
    jdr = JDiffRender(SPHERE, S, backend="xla")
    dr = DiffRender(SPHERE, S, device="cpu")
    att = bench_attributes(np.asarray(jdr.vertices_init), B, S, seed=0)
    ref_rgba, ref_att = jdr.render(**{k: jnp.asarray(v) for k, v in att.items()}, bg=None)
    rgba, out = dr.render(**to_torch(att, "cpu"))
    return np.asarray(ref_rgba), ref_att, n(rgba), out


def test_template_and_topology_match(renders):
    jdr = JDiffRender(SPHERE, S, backend="xla")
    dr = DiffRender(SPHERE, S, device="cpu")
    assert (dr.num_faces, dr.num_vertices) == (jdr.num_faces, jdr.num_vertices)
    assert np.array_equal(n(dr.vertices_init), np.asarray(jdr.vertices_init))
    assert np.array_equal(n(dr.faces), np.asarray(jdr.faces))
    assert np.array_equal(n(dr.face_uvs), np.asarray(jdr.face_uvs))
    assert np.array_equal(n(dr.vertices_laplacian_matrix),
                          np.asarray(jdr.vertices_laplacian_matrix))
    np.testing.assert_allclose(n(dr.cam_proj), np.asarray(jdr.cam_proj), rtol=1e-7)


def test_rgba_matches_reference(renders):
    ref_rgba, _, rgba, _ = renders
    assert rgba.shape == ref_rgba.shape == (B, S, S, 4)
    assert 0.05 < ref_rgba[..., 3].mean() < 0.95
    np.testing.assert_allclose(rgba[..., 3], ref_rgba[..., 3], atol=1e-5)
    np.testing.assert_allclose(rgba[..., :3], ref_rgba[..., :3], atol=1e-4)


@pytest.mark.parametrize("key,atol", [("face_normals", 1e-4), ("imnormal", 1e-4),
                                      ("faces_image", 1e-5), ("visiable_faces", 0.0)])
def test_attributes_match_reference(renders, key, atol):
    _, ref_att, _, out = renders
    assert tuple(out[key].shape) == tuple(ref_att[key].shape)
    np.testing.assert_allclose(n(out[key]), np.asarray(ref_att[key]), atol=atol)


def test_deep_copy_selects_and_clones():
    att = to_torch(bench_attributes(np.zeros((4, 3), np.float32), 3, 8, seed=1), "cpu")
    one = deep_copy(att, index=slice(1, 2))
    assert one["bg"] is None and one["vertices"].shape == (1, 4, 3)
    one["azimuths"] += 1.0
    assert att["azimuths"][1] + 1.0 == one["azimuths"][0]


def test_render_refuses_the_background_path():
    dr = DiffRender(SPHERE, 16, device="cpu")
    att = to_torch(bench_attributes(n(dr.vertices_init), 1, 16, seed=0), "cpu")
    with pytest.raises(NotImplementedError, match="no_mask"):
        dr.render(no_mask=True, **att)


def test_deep_copy_detaches():
    x = torch.ones(2, 3, requires_grad=True)
    att = {"vertices": x * 2.0, "bg": None, "other": x}
    kept = deep_copy(att)
    cut = deep_copy(att, index=torch.tensor([1, 0]), detach=True)
    assert kept["vertices"].requires_grad and not cut["vertices"].requires_grad
    assert set(cut) == {"vertices", "bg"} and cut["bg"] is None


def test_entry_points_build_on_the_card_unless_told_otherwise():
    from magicmirror_torch import resolve_device
    from magicmirror_torch.serve import ServeOptions, build_models
    from magicmirror_torch.train import TrainOptions, build_trainer

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert DiffRender(SPHERE, 16).faces.is_cuda
        return
    dr = DiffRender(SPHERE, 16, device="cpu")
    for build in (lambda: DiffRender(SPHERE, 16),
                  lambda: build_models(ServeOptions(template_path=SPHERE), dr),
                  lambda: build_trainer(TrainOptions(template_path=SPHERE))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
