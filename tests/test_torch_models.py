"""Port parity of the blocks, backbones and encoders
(magicmirror_torch/models vs magicmirror/models), with Flax variables drawn
in numpy, converted by ``load_flax_variables``, and randomised BatchNorm
running statistics; eval mode on both sides.

Tolerance: rtol = atol = 1e-4 (float32, convolutions summed in another
order); HRNet-w18-small-v2 and the shape encoder built on it: 1e-3 of the
output's max abs (some 60 layers of random weights and statistics grow the
activations).  The texture encoder's output is the photo resampled at a
predicted flow and is held to 1e-4 on 99.5% of texels of a smooth photo
(see magicmirror_torch/parity.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.models import backbones as jbb
from magicmirror.models import backbones_zoo as jzoo
from magicmirror.models import blocks as jb
from magicmirror.models import encoders as je
from magicmirror_torch.geometry import mesh as mesh_ops
from magicmirror_torch.geometry.obj_io import load_obj
from magicmirror_torch.models import backbones as tbb
from magicmirror_torch.models import backbones_zoo as tzoo
from magicmirror_torch.models import blocks as tb
from magicmirror_torch.models import encoders as te
from magicmirror_torch.models.convert import init_from_seed, load_flax_variables
from magicmirror_torch.render.synthetic import smooth_random
from torch_parity import SPHERE, flax_shapes, n, random_variables, t

torch.set_num_threads(1)
TOL = 1e-4


def _pair(jmodule, tmodule, jargs, jkw, seed):
    """Random Flax variables -> (JAX output, the torch module loaded with
    the same variables, in eval mode)."""
    variables = random_variables(flax_shapes(jmodule, *jargs, **jkw), seed)
    ref = jmodule.apply(variables, *jargs, **jkw)
    load_flax_variables(tmodule, variables["params"], variables.get("batch_stats"))
    return ref, tmodule.eval()


def _image(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _nchw(a):
    return t(a).permute(0, 3, 1, 2)


def _close_nhwc(out, ref, tol=TOL):
    np.testing.assert_allclose(n(out.permute(0, 2, 3, 1)), np.asarray(ref), rtol=tol, atol=tol)


BLOCKS = {
    "conv2dblock_bn_coordconv": (
        lambda: jb.Conv2dBlock(8, 3, 1, 1, norm="bn", coordconv=True),
        lambda: tb.Conv2dBlock(5, 8, 3, 1, 1, norm="bn", coordconv=True), (2, 8, 8, 5), True),
    "conv2dblock_reflect_dilation": (
        lambda: jb.Conv2dBlock(6, 3, 1, 2, activation="tanh", padding_mode="reflect",
                               dilation=2),
        lambda: tb.Conv2dBlock(4, 6, 3, 1, 2, activation="tanh", padding_mode="reflect",
                               dilation=2), (2, 8, 8, 4), True),
    "conv2dblock_stride2_relu": (
        lambda: jb.Conv2dBlock(4, 5, 2, 2, norm="bn", activation="relu"),
        lambda: tb.Conv2dBlock(3, 4, 5, 2, 2, norm="bn", activation="relu"), (2, 9, 8, 3), True),
    "resblock": (lambda: jb.ResBlock(8), lambda: tb.ResBlock(8), (2, 8, 8, 8), True),
    "resblockhalf": (lambda: jb.ResBlockHalf(8), lambda: tb.ResBlockHalf(8), (2, 8, 8, 8), True),
    "resblocks": (lambda: jb.ResBlocks(2, 16), lambda: tb.ResBlocks(2, 16), (2, 6, 6, 16), True),
    "channel_attention": (lambda: jb.ChannelAttention(16), lambda: tb.ChannelAttention(16),
                          (2, 5, 5, 16), False),
    # dilation 8 on an 8x8 map: reflect padding wider than the map
    "aspp": (lambda: jb.ASPP(16), lambda: tb.ASPP(16), (2, 8, 8, 16), False),
    "mmpool": (lambda: jb.MMPool((2, 2)), lambda: tb.MMPool((2, 2)), (2, 7, 5, 6), False),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_reference(name):
    make_j, make_t, shape, has_train = BLOCKS[name]
    x = _image(shape, seed=len(name))
    ref, module = _pair(make_j(), make_t(), (jnp.asarray(x),),
                        {"train": False} if has_train else {}, seed=len(name))
    with torch.no_grad():
        _close_nhwc(module(_nchw(x)), ref)


def test_linear_block_and_helpers_match_reference():
    x = np.random.RandomState(0).randn(4, 12).astype(np.float32)
    ref, module = _pair(jb.LinearBlock(10), tb.LinearBlock(12, 10), (jnp.asarray(x),),
                        {"train": False}, seed=1)
    with torch.no_grad():
        np.testing.assert_allclose(n(module(t(x))), np.asarray(ref), rtol=TOL, atol=TOL)
    img = _image((2, 7, 5, 3), 2)
    _close_nhwc(tb.upsample2x(_nchw(img)), jb.upsample2x(jnp.asarray(img)))
    _close_nhwc(tb.adaptive_pool(_nchw(img), (3, 2), "max"),
                jb.adaptive_pool(jnp.asarray(img), (3, 2), "max"))
    _close_nhwc(tb.adaptive_pool(_nchw(img), (3, 2), "avg"),
                jb.adaptive_pool(jnp.asarray(img), (3, 2), "avg"))


def test_base4c_matches_reference():
    x = _image((2, 32, 32, 4), 3)
    ref, module = _pair(jbb.Base4C(coordconv=True), tbb.Base4C(coordconv=True),
                        (jnp.asarray(x),), {"train": False}, seed=3)
    with torch.no_grad():
        _close_nhwc(module(_nchw(x)), ref)


def test_resnet34_pyramid_matches_reference():
    x = _image((2, 32, 32, 4), 4)
    ref, module = _pair(jbb.Resnet4C(arch="res34", stride=2, return_pyramid=True),
                        tbb.Resnet4C(arch="res34", stride=2, return_pyramid=True),
                        (jnp.asarray(x),), {"train": False}, seed=4)
    with torch.no_grad():
        outs = module(_nchw(x))
    assert len(outs) == len(ref) == 5
    for out, r in zip(outs, ref):
        _close_nhwc(out, r)


def test_hrnet_w18_small_v2_matches_reference():
    x = _image((2, 64, 64, 4), 5)
    ref, module = _pair(jzoo.HRNetW18SmallV2_4C(), tzoo.HRNetW18SmallV2_4C(),
                        (jnp.asarray(x),), {"train": False}, seed=5)
    with torch.no_grad():
        out = n(module(_nchw(x)).permute(0, 2, 3, 1))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, 2, 2, 2048)
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()


@pytest.fixture(scope="module")
def template():
    mesh = load_obj(SPHERE)
    v = mesh_ops.normalize_template(mesh.vertices)
    return v, mesh_ops.uniform_laplacian(v.shape[0], mesh.faces)


def test_camera_encoder_matches_reference(template):
    v, _ = template
    x = _image((2, 32, 32, 4), 6)
    ref, module = _pair(je.CameraEncoder(coordconv=True, pretrain="none"),
                        te.CameraEncoder(coordconv=True, pretrain="none"),
                        (jnp.asarray(x), jnp.asarray(v)), {"train": False}, seed=6)
    with torch.no_grad():
        outs = module(t(x), t(v))
    for key, out, r in zip(("azimuths", "elevations", "distances", "biases"), outs, ref):
        d = n(out) - np.asarray(r)
        if key == "azimuths":
            d = (d + 180.0) % 360.0 - 180.0
        assert np.abs(d).max() <= (1e-2 if key in ("azimuths", "elevations") else TOL), key


def test_shape_encoder_matches_reference(template):
    v, lpl = template
    x = _image((2, 32, 32, 4), 7)
    ref, module = _pair(je.ShapeEncoder(pretrain="hr18sv2", num_vertices=v.shape[0]),
                        te.ShapeEncoder(pretrain="hr18sv2", num_vertices=v.shape[0]),
                        (jnp.asarray(x), jnp.asarray(v), jnp.asarray(lpl)), {"train": False},
                        seed=7)
    with torch.no_grad():
        out = n(module(t(x), t(v), t(lpl)))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, v.shape[0], 3)
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()


def test_light_encoder_matches_reference():
    x = _image((2, 32, 32, 4), 8)
    ref, module = _pair(je.LightEncoder(coordconv=True), te.LightEncoder(coordconv=True),
                        (jnp.asarray(x),), {"train": False}, seed=8)
    with torch.no_grad():
        np.testing.assert_allclose(n(module(t(x))), np.asarray(ref), rtol=TOL, atol=TOL)


def test_texture_encoder_matches_reference():
    x = smooth_random((2, 32, 32, 4), 9)
    ref, module = _pair(je.TextureEncoder(pretrain="res34"), te.TextureEncoder("res34"),
                        (jnp.asarray(x),), {"train": False}, seed=9)
    with torch.no_grad():
        out = n(module(t(x)))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == (2, 64, 32, 3)
    assert (np.abs(out - ref) <= TOL).mean() >= 0.995


def test_converter_is_strict():
    shapes = flax_shapes(jb.LinearBlock(10), jnp.zeros((4, 12)), train=False)
    variables = random_variables(shapes, 0)
    params = {k: dict(v) for k, v in variables["params"].items()}
    stats = variables["batch_stats"]
    del params["Dense_0"]["bias"]
    with pytest.raises(ValueError, match="Dense_0.bias"):
        load_flax_variables(tb.LinearBlock(12, 10), params, stats)
    params["Dense_0"]["bias"] = np.zeros(10, np.float32)
    params["Extra_0"] = {"kernel": np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError, match="Extra_0.weight"):
        load_flax_variables(tb.LinearBlock(12, 10), params, stats)
    del params["Extra_0"]
    params["Dense_0"]["kernel"] = np.zeros((10, 12), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(tb.LinearBlock(12, 10), params, stats)


def test_init_from_seed_follows_the_jax_laws():
    a = init_from_seed(te.LightEncoder(coordconv=True), 3)
    b = init_from_seed(te.LightEncoder(coordconv=True), 3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.Conv2dBlock_3.Conv_0.weight.detach()
    std = math.sqrt(2.0 / w[0].numel())
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(a.Dense_0.weight.detach().abs().max()) < 1e-4  # classifier head N(0, 1e-5)
    bn = a.Conv2dBlock_3.BatchNorm_0.requires_grad_(False)
    assert abs(float(bn.weight.mean()) - 1.0) < 0.01 and 0.01 < float(bn.weight.std()) < 0.03
    assert float(bn.running_var.min()) == 1.0 and float(bn.running_mean.abs().max()) == 0.0
    assert float(a.MMPool_0.p.detach()) == 0.0
