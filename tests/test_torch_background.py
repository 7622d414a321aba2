"""The ``--bg`` option in the port against the JAX package on the CPU: the
background encoder, ``AttributeEncoder(bg=True)``, and ``DiffRender.render
(no_mask=True)``, forward and gradients, at the Market recipe's geometry
(ratio 2, ellipsoid 2, ``sphere.obj``).

Weights are numpy-drawn Flax variables converted into the port (eval mode on
both sides); the render's inputs are bench.py's attribute distribution with
a uniform random background.

Tolerances:
  * the background encoder's output 1e-5 (float32 convolutions summed in
    another order; a sigmoid in (0, 1));
  * ``AttributeEncoder(bg=True)``: its background 1e-5 against the Flax
    module's ``bg_enc`` in the same variables; its other heads equal to the
    same encoder's without ``bg``;
  * the render's alpha 1e-5 and rgb 1e-4 on all but 2 pixels, as
    tests/test_torch_renderer.py holds the default render (a pixel centre on
    the edge between two faces may go to either face);
  * the gradients of a fixed random linear functional of rgba: 1e-4 of each
    gradient's largest value for the vertices, the textures, the lights and
    the background, 1e-3 for the four camera parameters, as
    tests/test_torch_renderer_grad.py holds the default.  The background is
    lit: at an uncovered pixel the normal is zero, so the lights take a
    gradient from every background pixel.

The encoders run at 64 x 32: the tiny texture encoder's pyramid needs both
sides divisible by 32 (at 32 x 16 its fusion adds a 2 x 2 map to a 2 x 1 one,
in both packages).  The render runs at 32 x 16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.models.attribute_encoder import AttributeEncoder as JAttributeEncoder
from magicmirror.models.encoders import BackgroundEncoder as JBackgroundEncoder
from magicmirror.render.renderer import DiffRender as JDiffRender
from magicmirror_torch.models.attribute_encoder import AttributeEncoder
from magicmirror_torch.models.convert import load_flax_variables
from magicmirror_torch.models.encoders import BackgroundEncoder
from magicmirror_torch.render.renderer import DiffRender
from magicmirror_torch.render.synthetic import bench_attributes, to_torch
from torch_parity import SPHERE, flax_shapes, n, random_variables, t

torch.set_num_threads(1)
B = 2
GRAD_KEYS = ("vertices", "textures", "lights", "bg", "azimuths", "elevations", "distances",
             "biases")


def _photos(h, w, seed=0):
    rs = np.random.RandomState(seed)
    imgs = rs.rand(B, h, w, 4).astype(np.float32)
    imgs[..., 3] = 0.0
    imgs[:, h // 4:3 * h // 4, w // 4:3 * w // 4, 3] = 1.0
    return imgs


def test_background_encoder_matches_reference():
    """``BackgroundEncoder`` with and without dropout, eval mode."""
    imgs = _photos(64, 32)
    for droprate in (0.0, 0.2):
        jenc = JBackgroundEncoder(droprate=droprate)
        variables = random_variables(flax_shapes(jenc, jnp.asarray(imgs), train=False), seed=2)
        ref = np.asarray(jenc.apply(variables, jnp.asarray(imgs), train=False))
        enc = load_flax_variables(BackgroundEncoder(droprate=droprate),
                                  variables["params"]).eval()
        assert enc.drop.rate == droprate / 2
        with torch.no_grad():
            out = n(enc(t(imgs)))
        assert out.shape == ref.shape == (B, 64, 32, 3)
        np.testing.assert_allclose(out, ref, atol=1e-5)


def test_attribute_encoder_with_bg_matches_reference():
    """The background of ``AttributeEncoder(bg=True)`` against the Flax
    module's ``bg_enc`` in the same variables (the whole tree converted
    strictly: the head sits where Flax puts it); the other heads are those of
    the same encoder without ``bg``."""
    jdr = JDiffRender(SPHERE, 32, ratio=2.0, init_ellipsoid=2.0, backend="xla")
    imgs = _photos(64, 32, seed=1)
    kw = dict(pretraint="none", pretrains="none", droprate="0.2,0.2,0.2")
    jnet = JAttributeEncoder(num_vertices=jdr.num_vertices, bg=True, **kw)
    lpl = jdr.vertices_laplacian_matrix
    variables = random_variables(flax_shapes(jnet, jnp.asarray(imgs), jdr.vertices_init, lpl,
                                             train=False), seed=3)
    ref = jnet.apply(variables, jnp.asarray(imgs), train=False,
                     method=lambda m, x, train: m.bg_enc(x, train=train))
    net = AttributeEncoder(num_vertices=jdr.num_vertices, bg=True, **kw)
    load_flax_variables(net, variables["params"], variables["batch_stats"]).eval()
    assert net.bg_enc.drop.rate == 0.1  # half the texture rate
    without = {k: v for k, v in variables["params"].items() if k != "bg_enc"}
    plain = AttributeEncoder(num_vertices=jdr.num_vertices, **kw)
    load_flax_variables(plain, without, variables["batch_stats"]).eval()
    with torch.no_grad():
        out = net(t(imgs), t(jdr.vertices_init), t(lpl))
        out_plain = plain(t(imgs), t(jdr.vertices_init), t(lpl))
    assert out["bg"].shape == (B, 64, 32, 3) and out_plain["bg"] is None
    np.testing.assert_allclose(n(out["bg"]), np.asarray(ref), atol=1e-5)
    for key, value in out_plain.items():
        if value is not None:
            assert torch.equal(out[key], value), key


def test_render_over_the_background_matches_reference():
    """The Market geometry at 32 x 16: the forward, then the gradients of a
    fixed random functional of rgba, in both packages."""
    H, W = 32, 16
    jdr = JDiffRender(SPHERE, W, ratio=2.0, init_ellipsoid=2.0, backend="xla")
    dr = DiffRender(SPHERE, W, ratio=2.0, init_ellipsoid=2.0, device="cpu")
    att = bench_attributes(np.asarray(jdr.vertices_init), B, W, seed=5, height=H)
    rs = np.random.RandomState(6)
    att["bg"] = rs.rand(B, H, W, 3).astype(np.float32)
    w = rs.randn(B, H, W, 4).astype(np.float32)

    def loss(wrt):
        full = {k: jnp.asarray(v) for k, v in att.items()}
        full.update(wrt)
        rgba, _ = jdr.render(no_mask=True, **full)
        return jnp.sum(rgba * w), rgba

    ref_grad, ref_rgba = jax.jit(jax.grad(loss, has_aux=True))(
        {k: jnp.asarray(att[k]) for k in GRAD_KEYS})
    ref_rgba = np.asarray(ref_rgba)
    ours = to_torch(att, "cpu")
    for key in GRAD_KEYS:
        ours[key].requires_grad_(True)
    rgba, _ = dr.render(no_mask=True, **ours)
    (rgba * t(w)).sum().backward()
    rgba = n(rgba)

    assert rgba.shape == ref_rgba.shape == (B, H, W, 4)
    assert 0.05 < ref_rgba[..., 3].mean() < 0.95
    np.testing.assert_allclose(rgba[..., 3], ref_rgba[..., 3], atol=1e-5)
    off = np.abs(rgba[..., :3] - ref_rgba[..., :3]).max(-1) > 1e-4
    assert off.sum() <= 2, int(off.sum())
    # the uncovered pixels show the lit background, not white
    uncovered = ref_rgba[..., 3] < 1e-6
    assert uncovered.any() and (rgba[..., :3][uncovered] < 0.999).any()
    # without no_mask the same attributes render over white, and the
    # background path asks for a background
    with torch.no_grad():
        white, _ = dr.render(**to_torch(att, "cpu"))
    assert np.allclose(n(white)[..., :3][uncovered], 1.0)
    with pytest.raises(ValueError, match="bg"):
        dr.render(no_mask=True, **{**to_torch(att, "cpu"), "bg": None})

    for key in GRAD_KEYS:
        r = np.asarray(ref_grad[key])
        assert np.abs(r).max() > 0, key
        tol = 1e-3 if key in ("azimuths", "elevations", "distances", "biases") else 1e-4
        assert np.abs(n(ours[key].grad) - r).max() <= tol * np.abs(r).max(), key
