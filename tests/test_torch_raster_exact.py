"""Port parity of ``soft_mode='exact'`` (kaolin's segment distance): the
port's plain rasterizer (the CPU path and the oracle of the CUDA kernel's
'exact' mode) against the JAX golden path, against the Pallas phase-1 kernels
of ``rasterize_tpu.py`` in interpret mode, and its backward against
``jax.grad`` of the golden path.

Scenes as tests/test_pallas_rasterize.py makes them: random triangles with
random facing (F = 7, 40, 60 at 16^2 and 32^2), and the jittered sphere of
tests/test_torch_rasterize.py at 32^2 for the gradient.

Tolerances: idx exact; sumlog 1e-4 (absolute and relative) against the golden
scan and 5e-4 against the Pallas kernels, which cull faces beyond their 0.035
margin (the bounds of tests/test_pallas_rasterize.py; the one 'line' case,
which the same Pallas entry also runs, 2e-4 relative: its distance goes
through an rsqrt that XLA and torch round differently, seen 1.5e-4 on one
pixel of 1,024 with sumlog = -8.6); uv / normal / soft
1e-5 against ``dibr_rasterization``; d_fvi within 1e-3 of jax.grad's in the
L2 norm (float32 sums over all faces in another order), for the fused form
(``RasterizeFused``) and the two-phase form (``dibr_rasterization``) alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.ops.pallas.rasterize_tpu import (rasterize_phase1_pallas,
                                                  rasterize_standard_pallas)
from magicmirror.ops.rasterize import _rasterize_phase1
from magicmirror.ops.rasterize import dibr_rasterization as jdibr
from magicmirror.ops.rasterize import pixel_grid as jpixel_grid
from magicmirror_torch import kernels
from magicmirror_torch.ops.rasterize import (dibr_rasterization, pixel_grid, rasterize_fused,
                                             rasterize_phase1, rasterize_plain,
                                             soft_backward_autograd)
from torch_parity import n, t

torch.set_num_threads(1)


def _triangles(F, seed, batch=None):
    rs = np.random.RandomState(seed)
    lead = () if batch is None else (batch,)
    return (rs.uniform(-1, 1, lead + (F, 3, 2)).astype(np.float32),
            rs.uniform(-4, -2, lead + (F, 3)).astype(np.float32),
            rs.uniform(-1, 1, lead + (F,)).astype(np.float32))


@pytest.mark.parametrize("F,size,soft_mode", [(7, 16, "exact"), (60, 16, "exact"),
                                              (40, 32, "exact"), (40, 32, "line")])
def test_phase1_matches_golden_scan_and_pallas_kernels(F, size, soft_mode):
    """One mesh, as the Pallas entry takes it: the static chunk-loop kernel
    (no width), and the banded / whole-image kernels (width given)."""
    fvi, fz, fnz = _triangles(F, F + size)
    px, py = jpixel_grid(size, size)
    j = [jnp.asarray(a) for a in (fvi, fz, fnz)]
    rtol = 1e-4 if soft_mode == "exact" else 2e-4
    idx_ref, sum_ref = _rasterize_phase1(px, py, *j, 7000.0, 64, soft_mode=soft_mode)
    tpx, tpy = pixel_grid(size, size)
    idx, sumlog = rasterize_phase1(tpx, tpy, t(fvi)[None], t(fz)[None], t(fnz)[None], 7000.0,
                                   soft_mode)
    np.testing.assert_array_equal(n(idx[0]), np.asarray(idx_ref))
    np.testing.assert_allclose(n(sumlog[0]), np.asarray(sum_ref), atol=1e-4, rtol=rtol)
    if soft_mode == "exact":  # the static chunk loop has no 'line' mode
        idx_s, sum_s = rasterize_phase1_pallas(px, py, *j, 7000.0, tile_pixels=128, chunk=64,
                                               interpret=True)
        np.testing.assert_array_equal(n(idx[0]), np.asarray(idx_s))
        np.testing.assert_allclose(n(sumlog[0]), np.asarray(sum_s), atol=5e-4, rtol=1e-4)
    idx_b, sum_b = rasterize_phase1_pallas(px, py, *j, 7000.0, chunk=64, interpret=True,
                                           width=size, band_rows=8, soft_mode=soft_mode)
    np.testing.assert_array_equal(n(idx[0]), np.asarray(idx_b))
    np.testing.assert_allclose(n(sumlog[0]), np.asarray(sum_b), atol=5e-4, rtol=rtol)


def test_exact_render_outputs_match_golden_and_fused_pallas():
    """The whole 'exact' rasterization, batched: the fused form and the
    two-phase form against ``dibr_rasterization(soft_mode='exact')`` and,
    per mesh, against ``rasterize_standard_pallas`` (the fused Pallas
    kernel) in interpret mode."""
    B, F, size = 2, 24, 16
    fvi, fz, fnz = _triangles(F, 3, batch=B)
    rs = np.random.RandomState(4)
    face_uvs = rs.rand(F, 3, 2).astype(np.float32)
    normals = rs.randn(B, F, 3).astype(np.float32)
    normals[..., 2] = fnz
    attrs = [jnp.broadcast_to(jnp.asarray(face_uvs)[None], (B, F, 3, 2)),
             jnp.asarray(normals)[:, :, None, :].repeat(3, axis=2)]
    (uv_g, normal_g), soft_g, idx_g = jdibr(size, size, jnp.asarray(fz), jnp.asarray(fvi),
                                            attrs, jnp.asarray(fnz), soft_mode="exact")
    args = [t(a) for a in (fvi, fz, fnz, face_uvs, normals)]
    before = dict(kernels.LAUNCHES)
    for fn in (rasterize_fused, dibr_rasterization):
        idx, soft, uv, normal, hard = (n(a) for a in fn(*args, height=size, width=size,
                                                        soft_mode="exact"))
        assert np.array_equal(idx, np.asarray(idx_g))
        np.testing.assert_allclose(soft, np.asarray(soft_g), atol=1e-5)
        np.testing.assert_allclose(uv, np.asarray(uv_g), atol=1e-5)
        np.testing.assert_allclose(normal, np.asarray(normal_g), atol=1e-5)
        np.testing.assert_array_equal(hard, (idx >= 0).astype(np.float32))
    assert kernels.LAUNCHES == before  # CPU tensors take the plain path
    line_soft = n(rasterize_fused(*args, height=size, width=size)[1])
    assert np.abs(line_soft - soft).max() > 1e-3  # the mode is not a no-op
    for b in range(B):
        idx_p, soft_p, uv_p, normal_p, hard_p = (np.asarray(a) for a in rasterize_standard_pallas(
            *(jnp.asarray(a) for a in (fvi[b], fz[b], fnz[b], face_uvs, normals[b])),
            height=size, width=size, interpret=True, soft_mode="exact"))
        assert np.array_equal(idx[b].reshape(-1), idx_p)
        np.testing.assert_allclose(soft[b].reshape(-1), soft_p, atol=3e-4)
        np.testing.assert_allclose(normal[b].reshape(-1, 3), normal_p, atol=1e-5)
        np.testing.assert_allclose(uv[b].reshape(-1, 2), uv_p, atol=1e-5)


def test_exact_gradient_matches_jax_grad_of_golden_path():
    B, F, size = 2, 30, 16
    fvi, fz, fnz = _triangles(F, 11, batch=B)
    rs = np.random.RandomState(12)
    face_uvs = rs.rand(F, 3, 2).astype(np.float32)
    normals = rs.randn(B, F, 3).astype(np.float32)
    normals[..., 2] = fnz
    w_soft = rs.randn(B, size, size).astype(np.float32)

    def loss_golden(fvi_, uvs_, normals_):
        attrs = [jnp.broadcast_to(uvs_[None], (B, F, 3, 2)),
                 normals_[:, :, None, :].repeat(3, axis=2)]
        (uv, normal), soft, _ = jdibr(size, size, jnp.asarray(fz), fvi_, attrs,
                                      jnp.asarray(fnz), soft_mode="exact")
        return jnp.sum(soft * w_soft) + jnp.sum(uv * 0.3) + jnp.sum(normal ** 2)

    ref = [np.asarray(g) for g in jax.jit(jax.grad(loss_golden, argnums=(0, 1, 2)))(
        jnp.asarray(fvi), jnp.asarray(face_uvs), jnp.asarray(normals))]
    for fn in (rasterize_fused, dibr_rasterization):
        leaves = [t(a).requires_grad_(True) for a in (fvi, face_uvs, normals)]
        _, soft, uv, normal, _ = fn(leaves[0], t(fz), t(fnz), leaves[1], leaves[2],
                                    height=size, width=size, soft_mode="exact")
        ((soft * t(w_soft)).sum() + (uv * 0.3).sum() + (normal ** 2).sum()).backward()
        for ours, r in zip(leaves, ref):
            assert np.linalg.norm(r) > 0
            assert np.linalg.norm(n(ours.grad) - r) / np.linalg.norm(r) < 1e-3, fn.__name__

    # phase 1 alone: the sumlog cotangent, by chunks, against jax.vjp of the scan
    g_sumlog = rs.randn(B, size * size).astype(np.float32)
    px, py = jpixel_grid(size, size)
    ref = np.stack([np.asarray(jax.grad(lambda v: jnp.sum(_rasterize_phase1(
        px, py, v, jnp.asarray(fz[b]), jnp.asarray(fnz[b]), 7000.0, 64,
        soft_mode="exact")[1] * g_sumlog[b]))(jnp.asarray(fvi[b]))) for b in range(B)])
    ours = soft_backward_autograd(t(fvi), t(fz), t(fnz), t(g_sumlog), 7000.0, size, size)
    assert np.linalg.norm(n(ours) - ref) / np.linalg.norm(ref) < 1e-3
    leaf = t(fvi).requires_grad_(True)
    _, sumlog, dropped = rasterize_plain(leaf, t(fz), t(fnz), height=size, width=size,
                                         soft_mode="exact")
    (sumlog * t(g_sumlog)).sum().backward()
    assert torch.equal(leaf.grad, ours) and not dropped.any()
