"""Port parity of the unmasked texture sampling (``texture_mapping``, whose
CUDA form is the unmasked mode of the texture kernels): forward against the
JAX golden path ``ops.sampling.texture_mapping`` and against the Pallas
kernel ``texture_bilinear_pallas`` in interpret mode; backward against
``jax.grad`` of the golden path.

The inputs hold uv outside [0, 1] (clipped), uv at exactly 0 and 1 (half the
gradient passes), and taps on the texture's border (zeros padding).

Tolerances: 1e-5 against the float32 golden path, forward and gradients (the
same formula on both sides; seen 1e-6).  Against the Pallas kernel 1e-2: it
samples through bfloat16 tent-weight matmuls on a bfloat16 copy of the
texture (8 bits of mantissa on values in [0, 1], two products: seen 4.4e-3),
so it checks the sampling geometry, not the last digits.  The CUDA kernel is
held to ``texture_mapping_plain`` on the card (tests/test_torch_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.ops.pallas.texture_tpu import texture_bilinear_pallas
from magicmirror.ops.sampling import texture_mapping as jtexture_mapping
from magicmirror_torch import kernels
from magicmirror_torch.ops.sampling import (TextureRender, texture_backward_plain,
                                            texture_mapping, texture_mapping_plain)
from torch_parity import n, t

torch.set_num_threads(1)
B, H, W, HT, WT = 2, 32, 16, 64, 16


@pytest.fixture(scope="module")
def case():
    rs = np.random.RandomState(21)
    uv = rs.uniform(-0.2, 1.2, (B, H, W, 2)).astype(np.float32)
    uv[0, 0, :4] = [[0.0, 0.0], [1.0, 1.0], [0.0, 0.5], [0.5, 1.0]]  # exactly on the clip
    uv[0, 1, :4] = [[0.01, 0.99], [0.99, 0.01], [0.999, 0.999], [0.001, 0.001]]  # border taps
    tex = rs.rand(B, HT, WT, 3).astype(np.float32)
    g = rs.randn(B, H, W, 3).astype(np.float32)
    return dict(uv=uv, tex=tex, g=g)


def test_forward_matches_golden_and_pallas(case):
    before = dict(kernels.LAUNCHES)
    out = n(texture_mapping(t(case["uv"]), t(case["tex"])))
    assert kernels.LAUNCHES == before  # CPU tensors take the plain version
    ref = np.asarray(jtexture_mapping(jnp.asarray(case["uv"]), jnp.asarray(case["tex"])))
    assert out.shape == ref.shape == (B, H, W, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    pallas = np.asarray(texture_bilinear_pallas(jnp.asarray(case["uv"]),
                                                jnp.asarray(case["tex"]), interpret=True))
    np.testing.assert_allclose(out, pallas, atol=1e-2)


def test_backward_matches_jax_grad(case):
    def loss(uv_, tex_):
        return jnp.sum(jtexture_mapping(uv_, tex_) * case["g"])

    d_uv, d_tex = jax.grad(loss, argnums=(0, 1))(jnp.asarray(case["uv"]),
                                                 jnp.asarray(case["tex"]))
    uv, tex = t(case["uv"]).requires_grad_(True), t(case["tex"]).requires_grad_(True)
    texture_mapping(uv, tex).backward(t(case["g"]))
    np.testing.assert_allclose(n(uv.grad), np.asarray(d_uv), atol=1e-5)
    np.testing.assert_allclose(n(tex.grad), np.asarray(d_tex), atol=1e-5)
    assert n(uv.grad)[0, 0, 0].tolist() != [0.0, 0.0]  # half the gradient at the clip
    # the autograd Function's CPU route (no mask) and the plain backward agree exactly
    uv2, tex2 = t(case["uv"]).requires_grad_(True), t(case["tex"]).requires_grad_(True)
    TextureRender.apply(uv2, tex2, None).backward(t(case["g"]))
    plain = texture_backward_plain(t(case["g"]), t(case["uv"]), t(case["tex"]))
    assert torch.equal(uv2.grad, plain[0]) and torch.equal(tex2.grad, plain[1])
    assert torch.equal(uv2.grad, uv.grad)
    assert torch.equal(texture_mapping_plain(uv2, tex2), texture_mapping(uv, tex))
