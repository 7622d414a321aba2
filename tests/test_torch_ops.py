"""Port parity: grid sampling, UV texture mapping, the texture kernel's
wrapper and SH lighting (magicmirror_torch/ops vs magicmirror/ops).

Tolerance 1e-5: float32 on both sides, with another op order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.ops import sampling as jsampling
from magicmirror.ops.shading import spherical_harmonic_lighting as jsh
from magicmirror_torch import kernels
from magicmirror_torch.ops import sampling
from magicmirror_torch.ops.shading import spherical_harmonic_lighting
from torch_parity import n, t

torch.set_num_threads(1)
ATOL = 1e-5


def _uv_and_texture(seed, B=2, H=24, W=20, Ht=32, Wt=16):
    rs = np.random.RandomState(seed)
    uv = rs.uniform(-0.2, 1.2, (B, H, W, 2)).astype(np.float32)
    tex = rs.rand(B, Ht, Wt, 3).astype(np.float32)
    mask = (rs.rand(B, H, W) > 0.4).astype(np.float32)
    return uv, tex, mask


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_reference(mode, align_corners):
    rs = np.random.RandomState(1)
    img = rs.randn(2, 9, 11, 5).astype(np.float32)
    grid = rs.uniform(-1.2, 1.2, (2, 6, 7, 2)).astype(np.float32)
    ours = sampling.grid_sample(t(img), t(grid), mode=mode, align_corners=align_corners)
    ref = jsampling.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode=mode,
                                padding_mode="zeros", align_corners=align_corners)
    np.testing.assert_allclose(n(ours), np.asarray(ref), atol=ATOL)


def test_texture_mapping_matches_reference():
    uv, tex, _ = _uv_and_texture(2)
    ours = sampling.texture_mapping(t(uv), t(tex))
    ref = jsampling.texture_mapping(jnp.asarray(uv), jnp.asarray(tex))
    np.testing.assert_allclose(n(ours), np.asarray(ref), atol=ATOL)


def test_texture_render_on_cpu_is_masked_mapping():
    uv, tex, mask = _uv_and_texture(3)
    before = dict(kernels.LAUNCHES)
    ours = sampling.texture_render(t(uv), t(tex), t(mask))
    assert kernels.LAUNCHES == before  # a CPU tensor takes the plain path
    ref = jsampling.texture_mapping(jnp.asarray(uv), jnp.asarray(tex)) * mask[..., None]
    np.testing.assert_allclose(n(ours), np.asarray(ref), atol=ATOL)
    assert np.all(n(ours)[mask == 0] == 0.0)


def test_sh_lighting_matches_reference():
    rs = np.random.RandomState(4)
    nrm = rs.randn(2, 8, 8, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    lights = rs.randn(2, 9).astype(np.float32)
    np.testing.assert_allclose(n(spherical_harmonic_lighting(t(nrm), t(lights))),
                               np.asarray(jsh(jnp.asarray(nrm), jnp.asarray(lights))),
                               atol=ATOL)
