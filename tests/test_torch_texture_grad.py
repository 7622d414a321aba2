"""Port parity of the texture sampling's backward: ``TextureRender`` (on the
CPU: ``texture_backward_plain``) against ``jax.grad`` of the fp32 golden
path ``texture_mapping(uv) * mask``, for d_textures and d_texcoord.

The inputs hold uv outside [0, 1] (the clip stops the gradient), uv at
exactly 0 and 1 (``jnp.clip`` passes half the gradient there, and so does the
port), taps on the texture's border (zeros padding) and an image that is all
background.  Tolerance 1e-5 absolute on gradients of order 1 (seen: 1e-6):
the same float32 formula on both sides.  The CUDA kernel is held to
``texture_backward_plain`` on the card (tests/test_torch_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.ops.sampling import texture_mapping as jtexture_mapping
from magicmirror_torch import kernels
from magicmirror_torch.ops import clip01
from magicmirror_torch.ops.sampling import (texture_backward_plain, texture_bwd,
                                            texture_render, texture_render_plain)
from torch_parity import n, t

torch.set_num_threads(1)
B, H, W, HT, WT = 3, 16, 16, 32, 16
TOL = 1e-5


@pytest.fixture(scope="module")
def case():
    rs = np.random.RandomState(11)
    uv = rs.uniform(-0.2, 1.2, (B, H, W, 2)).astype(np.float32)
    uv[0, 0, :4] = [[0.0, 0.0], [1.0, 1.0], [0.0, 0.5], [0.5, 1.0]]  # exactly on the clip
    uv[0, 1, :4] = [[0.01, 0.99], [0.99, 0.01], [0.999, 0.999], [0.001, 0.001]]  # border taps
    mask = (rs.rand(B, H, W) > 0.3).astype(np.float32)
    mask[0, :2] = 1.0
    mask[2] = 0.0  # an all-background image
    tex = rs.rand(B, HT, WT, 3).astype(np.float32)
    g = rs.randn(B, H, W, 3).astype(np.float32)

    def loss(uv_, tex_):
        return jnp.sum(jtexture_mapping(uv_, tex_) * mask[..., None] * g)

    d_uv, d_tex = jax.grad(loss, argnums=(0, 1))(jnp.asarray(uv), jnp.asarray(tex))
    return dict(uv=uv, mask=mask, tex=tex, g=g, d_uv=np.asarray(d_uv), d_tex=np.asarray(d_tex))


def _port_grads(case):
    uv, tex, mask = (t(case[k]).requires_grad_(True) for k in ("uv", "tex", "mask"))
    before = dict(kernels.LAUNCHES)
    out = texture_render(uv, tex, mask)
    out.backward(t(case["g"]))
    assert kernels.LAUNCHES == before  # CPU tensors take the plain versions
    return uv, tex, mask


def test_forward_is_the_plain_version(case):
    out = texture_render(t(case["uv"]), t(case["tex"]), t(case["mask"]))
    ref = np.asarray(jtexture_mapping(jnp.asarray(case["uv"]), jnp.asarray(case["tex"])))
    np.testing.assert_allclose(n(out), ref * case["mask"][..., None], atol=1e-6)


def test_d_textures_matches_golden(case):
    _, tex, _ = _port_grads(case)
    assert np.abs(case["d_tex"]).max() > 1.0
    np.testing.assert_allclose(n(tex.grad), case["d_tex"], atol=TOL, rtol=0)


def test_d_texcoord_matches_golden(case):
    uv, _, _ = _port_grads(case)
    assert np.abs(case["d_uv"]).max() > 1.0
    np.testing.assert_allclose(n(uv.grad), case["d_uv"], atol=TOL * np.abs(case["d_uv"]).max(),
                               rtol=0)


def test_clip_passes_half_the_gradient_at_exactly_0_and_1(case):
    uv, _, _ = _port_grads(case)
    on_clip = case["uv"][0, 0, :2]  # (0, 0) and (1, 1)
    assert set(on_clip.ravel()) == {0.0, 1.0}
    inside = case["uv"].copy()
    inside[0, 0, :2] = [[1e-6, 1e-6], [1 - 1e-6, 1 - 1e-6]]
    d_inside, _ = texture_backward_plain(t(case["g"]), t(inside), t(case["tex"]),
                                         t(case["mask"]))
    np.testing.assert_allclose(n(uv.grad)[0, 0, :2], 0.5 * n(d_inside)[0, 0, :2],
                               rtol=1e-3, atol=1e-4)
    x = torch.tensor([-1.0, 0.0, 0.5, 1.0, 2.0], requires_grad=True)
    clip01(x).sum().backward()
    assert x.grad.tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]


def test_outside_the_clip_and_outside_the_mask_get_no_gradient(case):
    uv, _, _ = _port_grads(case)
    g = n(uv.grad)
    outside = (case["uv"] < 0) | (case["uv"] > 1)
    assert outside.any() and not g[outside].any()
    assert not g[case["mask"] == 0].any() and not g[2].any()


def test_mask_gets_no_gradient(case):
    _, _, mask = _port_grads(case)
    assert mask.grad is None


def test_plain_backward_is_autograd_of_the_plain_forward(case):
    uv, tex = t(case["uv"]).requires_grad_(True), t(case["tex"]).requires_grad_(True)
    texture_render_plain(uv, tex, t(case["mask"])).backward(t(case["g"]))
    d_uv, d_tex = texture_backward_plain(t(case["g"]), t(case["uv"]), t(case["tex"]),
                                         t(case["mask"]))
    assert torch.equal(d_uv, uv.grad) and torch.equal(d_tex, tex.grad)


def test_backward_wrapper_refuses_cpu_tensors(case):
    with pytest.raises(ValueError, match="CUDA"):
        texture_bwd(t(case["g"]), t(case["uv"]), t(case["tex"]), t(case["mask"]))
