"""The encoder options off the default, the port against the JAX package
on the same numpy-drawn variables and inputs, eval mode on both sides:
``nolpl`` in the camera and shape encoders (the pooled features alone),
``makeup`` 1-5 in the texture encoder (the InstanceNorm refinement at 1-4,
its dropout at 2-4, the unclipped flow at 5), ``FeatureEncoder`` (the
landmark head's features) under BatchNorm and IBN, and the ``--inv``
preconditioner: ``make_inv_preconditioner`` and the backward of the
identity it rides on.

Tolerances, with what was seen (float32 on both sides): the camera's angles
1e-2 degrees and the rest 1e-4 (as tests/test_torch_models.py); the shape
offsets 1e-4 of their largest value; the textures 1e-4 on 99.5% of texels
(the texture encoder's rule there: the photo resampled at a predicted
flow), and at makeup 5, whose flow is not clipped, the same; the features
1e-4 of their largest value; M exactly the JAX function's (the same numpy);
the preconditioned gradient 1e-5 of its largest value; the refinement with
its clip engaged (most texels past it, the init scale): output and
gradients 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from magicmirror.models import attribute_encoder as jae
from magicmirror.models import blocks as jb
from magicmirror.models import encoders as je
from magicmirror_torch.models import attribute_encoder as tae
from magicmirror_torch.models import encoders as te
from magicmirror_torch.models.convert import flax_to_state_dict, load_flax_variables
from magicmirror_torch.render.synthetic import smooth_random
from torch_parity import flax_shapes, n, random_variables, sphere_template, t

torch.set_num_threads(1)
TOL = 1e-4


def _pair(jmodule, tmodule, jargs, seed):
    variables = random_variables(flax_shapes(jmodule, *jargs, train=False), seed)
    ref = jax.jit(lambda v, *a: jmodule.apply(v, *a, train=False))(variables, *jargs)
    load_flax_variables(tmodule, variables["params"], variables.get("batch_stats"))
    return ref, tmodule.eval()


@pytest.fixture(scope="module")
def template():
    return sphere_template()


def test_nolpl_camera_and_shape_encoders(template):
    v, lpl = template
    x = np.random.RandomState(0).rand(2, 32, 32, 4).astype(np.float32)
    ref, module = _pair(je.CameraEncoder(pretrain="none", nolpl=True),
                        te.CameraEncoder(pretrain="none", nolpl=True),
                        (jnp.asarray(x), jnp.asarray(v)), seed=1)
    assert not hasattr(module, "avgpool2")
    with torch.no_grad():
        outs = module(t(x), t(v))
    for key, out, r in zip(("azimuths", "elevations", "distances", "biases"), outs, ref):
        d = n(out) - np.asarray(r)
        if key == "azimuths":
            d = (d + 180.0) % 360.0 - 180.0
        assert np.abs(d).max() <= (1e-2 if key in ("azimuths", "elevations") else TOL), key
    ref, module = _pair(je.ShapeEncoder(pretrain="none", num_vertices=v.shape[0], nolpl=True),
                        te.ShapeEncoder(pretrain="none", num_vertices=v.shape[0], nolpl=True),
                        (jnp.asarray(x), jnp.asarray(v), jnp.asarray(lpl)), seed=2)
    assert not hasattr(module, "conv1") and module.linear3.weight.shape == (
        3 * v.shape[0], 288)
    with torch.no_grad():
        out = n(module(t(x), t(v), t(lpl)))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, v.shape[0], 3)
    assert np.abs(out - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("makeup", [1, 2, 3, 4, 5])
def test_texture_encoder_makeup(makeup):
    x = smooth_random((2, 32, 32, 4), 3)
    ref, module = _pair(je.TextureEncoder(pretrain="none", makeup=makeup, droprate=0.2),
                        te.TextureEncoder("none", makeup=makeup, droprate=0.2),
                        (jnp.asarray(x),), seed=10 + makeup)
    layers = [type(getattr(module, name)).__name__ for name in module.refine]
    assert layers == {1: ["Conv2dBlock", "ResBlock", "ResBlock", "Conv2dBlock"],
                      2: ["Conv2dBlock", "ResBlock", "ResBlock", "Dropout", "Conv2dBlock"],
                      3: ["Conv2dBlock", "Dropout", "Conv2dBlock"],
                      4: ["Conv2dBlock", "Dropout", "Conv2dBlock"], 5: []}[makeup]
    assert module.TextureBiFPN_0.final_tanh == (makeup != 5)
    with torch.no_grad():
        out = n(module(t(x)))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, 64, 32, 3)
    assert (np.abs(out - ref) <= TOL).mean() >= 0.995
    if makeup < 5:
        assert 0.0 <= out.min() and out.max() <= 1.0


class _JRefinement(nn.Module):
    """The makeup refinement of the JAX TextureEncoder (encoders.py:323-345)
    on a sampled texture map, as that module composes it."""

    @nn.compact
    def __call__(self, textures, train: bool = True):
        ref = jnp.concatenate([textures, textures[:, :, ::-1, :]], axis=-1)
        h = jb.Conv2dBlock(32, 5, 1, 2, norm="in", activation="lrelu")(ref, train=train)
        h = jb.ResBlock(32, norm="in")(h, train=train)
        h = jb.ResBlock(32, norm="in")(h, train=train)
        h = jb.Conv2dBlock(3, 3, 1, 1, norm="none", activation="none")(h, train=train)
        return jnp.clip(textures + h, 0.0, 1.0)


def test_makeup_refinement_gradient_with_the_clip_engaged():
    """The port's refinement layers (makeup 1: conv, two residual blocks,
    conv, all under InstanceNorm) and its clip, against the JAX module's, at
    the init scale, where most texels sit past the clip: the output, the
    gradient of the texture map and of every weight (the biases in front of
    an InstanceNorm have a gradient of rounding noise and are held to the
    module's largest gradient)."""
    rs = np.random.RandomState(8)
    tex = rs.rand(2, 32, 16, 3).astype(np.float32)
    cot = rs.randn(*tex.shape).astype(np.float32)
    jm = _JRefinement()
    variables = random_variables(flax_shapes(jm, jnp.asarray(tex)), seed=9)
    ref = np.asarray(jm.apply(variables, jnp.asarray(tex)))
    gp, gx = jax.jit(jax.grad(lambda p, a: jnp.sum(jm.apply({"params": p}, a) * cot),
                              argnums=(0, 1)))(variables["params"], jnp.asarray(tex))
    module = te.TextureEncoder("none", makeup=1)
    refine = {name: getattr(module, name) for name in module.refine}
    params = {name: variables["params"][name] for name in variables["params"]}
    params = {new: params[old] for new, old in zip(
        module.refine, ("Conv2dBlock_0", "ResBlock_0", "ResBlock_1", "Conv2dBlock_1"))}
    for name, layer in refine.items():
        load_flax_variables(layer, params[name])
    x = t(tex).requires_grad_(True)
    h = te._nchw(torch.cat([x, x.flip(2)], dim=-1))
    for layer in refine.values():
        h = layer(h)
    from magicmirror_torch.ops import clip01
    out = clip01(x + h.permute(0, 2, 3, 1))
    clipped = float(((n(out) == 0) | (n(out) == 1)).mean())
    assert clipped > 0.5, clipped
    assert np.abs(n(out) - ref).max() <= 1e-5
    (out * t(cot)).sum().backward()
    assert np.abs(n(x.grad) - np.asarray(gx)).max() <= 1e-5 * np.abs(np.asarray(gx)).max()
    floor = max(np.abs(np.asarray(g)).max() for g in jax.tree_util.tree_leaves(gp))
    for name, layer in refine.items():
        grads = flax_to_state_dict(jax.device_get(gp[{v: k for k, v in zip(
            ("Conv2dBlock_0", "ResBlock_0", "ResBlock_1", "Conv2dBlock_1"), module.refine)}[name]]))
        for key, p in layer.named_parameters():
            r = grads[key]
            # a conv bias in front of an InstanceNorm: its gradient is rounding noise
            owner = layer.get_submodule(key.rsplit(".", 2)[0]) if key.count(".") > 1 else layer
            noise = key.endswith("bias") and owner.norm == "InstanceNorm_0"
            scale = floor if noise else np.abs(r).max()
            assert np.abs(n(p.grad) - r).max() <= 1e-5 * scale, (name, key)


@pytest.mark.parametrize("norm", ["bn", "ibn"])
def test_feature_encoder(norm):
    x = np.random.RandomState(4).rand(2, 32, 32, 4).astype(np.float32)
    ref, module = _pair(je.FeatureEncoder(norm=norm), te.FeatureEncoder(norm=norm),
                        (jnp.asarray(x),), seed=5)
    with torch.no_grad():
        out = n(module(t(x)))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, 8, 8, 256)
    assert np.abs(out - ref).max() <= TOL * np.abs(ref).max()


def test_inv_preconditioner(template):
    _, lpl = template
    M = tae.make_inv_preconditioner(lpl, 0.5)
    assert M.dtype == np.float32
    np.testing.assert_array_equal(M, jae.make_inv_preconditioner(lpl, 0.5))
    rs = np.random.RandomState(6)
    delta = rs.randn(2, lpl.shape[0], 3).astype(np.float32)
    cot = rs.randn(*delta.shape).astype(np.float32)

    def f(d):
        return jnp.sum(jae._precondition(d, jnp.asarray(M)) ** 2 * cot)

    ref = np.asarray(jax.grad(f)(jnp.asarray(delta)))
    d = t(delta).requires_grad_(True)
    out = tae.Precondition.apply(d, t(M))
    assert torch.equal(out, d)
    ((out ** 2) * t(cot)).sum().backward()
    assert np.abs(n(d.grad) - ref).max() <= 1e-5 * np.abs(ref).max()
