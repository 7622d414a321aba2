"""Port parity of the rasterizer's backward against the VJPs of the Pallas
kernels in interpret mode (``rasterize_fused_v5``, ``rasterize_plain_v4``):
the whole ``RasterizeFused`` backward at 32^2 and 64^2, ``soft_backward_plain``
and ``rasterize_plain`` at 32^2, and a hand-built mesh with axis-aligned edges.
Scenes, helpers and the tolerance (1e-4 of the largest gradient; seen 5e-6:
the Pallas culling drops pairs with p < 2e-4) are those of
tests/test_torch_raster_grad.py.

Slow (Pallas in interpret mode), and two test functions on purpose: under
``pytest -n 6 --dist loadfile`` the files with the most tests are handed out
first, so a slow file with few tests runs beside the suite's long files and
not ahead of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from magicmirror.ops.pallas.rasterize_v4 import rasterize_fused_v5, rasterize_plain_v4
from magicmirror_torch.ops.face_rows import coeffs13
from magicmirror_torch.ops.rasterize import (pixel_grid, rasterize_phase1, rasterize_plain,
                                             soft_backward_plain)
from test_torch_raster_grad import (B, _close, _hand_built, _hand_built_port_grads, _jargs,
                                    _port_grads, _scene)
from torch_parity import n, t

torch.set_num_threads(1)


def test_backward_matches_the_pallas_vjps():
    scene32 = _scene(32)
    _fused_backward_matches_the_pallas_stream_vjp(scene32)
    _fused_backward_matches_the_pallas_stream_vjp(_scene(64))
    _soft_moments_chain_as_the_pallas_plain_vjp(scene32)
    _rasterize_plain_matches_the_pallas_plain_kernel(scene32)


def _fused_backward_matches_the_pallas_stream_vjp(scene):
    S = scene["size"]
    fz, fnz = jnp.asarray(scene["fz"]), jnp.asarray(scene["fnz"])

    def loss(fvi_, uvs_, fn_):
        _, soft, uv, normal, _, _ = rasterize_fused_v5(fvi_, fz, fnz, uvs_, fn_,
                                                       height=S, width=S)
        return (jnp.sum(soft * scene["w_soft"]) + jnp.sum(uv * scene["w_uv"])
                + jnp.sum(normal * scene["w_n"]))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*_jargs(scene))
    fvi, _, _, uvs, fn = _port_grads(scene, soft_only=False)
    for ours, r, what in zip((fvi, uvs, fn), ref, ("d_fvi", "d_face_uvs", "d_face_normals")):
        _close(ours.grad, r, what)


def _soft_moments_chain_as_the_pallas_plain_vjp(scene32):
    """soft_backward_plain + the coeffs13 chain = the VJP of rasterize_plain_v4
    for a cotangent on soft = 1 - exp(sumlog)."""
    scene = scene32
    S = scene["size"]
    fz, fnz = jnp.asarray(scene["fz"]), jnp.asarray(scene["fnz"])
    w = scene["w_soft"]

    def loss(fvi_):
        _, sumlog, _ = rasterize_plain_v4(fvi_, fz, fnz, height=S, width=S)
        return jnp.sum((1.0 - jnp.exp(sumlog)) * w)

    ref = jax.grad(loss)(jnp.asarray(scene["fvi"]))
    fvi = t(scene["fvi"]).requires_grad_(True)
    px, py = pixel_grid(S, S)
    _, sumlog = rasterize_phase1(px, py, fvi.detach(), t(scene["fz"]), t(scene["fnz"]), 7000.0)
    G = soft_backward_plain(fvi, t(scene["fnz"]), -t(w) * torch.exp(sumlog), 7000.0, S, S)
    assert G.shape == (B, fvi.shape[1], 13) and not G.requires_grad
    (coeffs13(fvi) * G).sum().backward()
    _close(fvi.grad, ref, "d_fvi")


def _rasterize_plain_matches_the_pallas_plain_kernel(scene32):
    """Phase 1 alone (idx, sumlog, dropped) and its VJP against
    rasterize_plain_v4 in interpret mode: idx exact, sumlog within 3e-4 where
    soft is not saturated, d_fvi to 1e-4 of its largest value."""
    scene = scene32
    S = scene["size"]
    fz, fnz = jnp.asarray(scene["fz"]), jnp.asarray(scene["fnz"])
    w = scene["w_soft"]

    def loss(fvi_):
        idx, sumlog, dropped = rasterize_plain_v4(fvi_, fz, fnz, height=S, width=S)
        return jnp.sum((1.0 - jnp.exp(sumlog)) * w), (idx, sumlog, dropped)

    (_, (ref_idx, ref_sumlog, ref_dropped)), ref_grad = jax.value_and_grad(
        loss, has_aux=True)(jnp.asarray(scene["fvi"]))
    fvi, fz_t, fnz_t = (t(scene[k]).requires_grad_(True) for k in ("fvi", "fz", "fnz"))
    idx, sumlog, dropped = rasterize_plain(fvi, fz_t, fnz_t, height=S, width=S)
    assert idx.dtype == torch.int32 and np.array_equal(n(idx), np.asarray(ref_idx))
    assert dropped.dtype == torch.int32 and not dropped.any() and not np.asarray(ref_dropped).any()
    np.testing.assert_allclose(1.0 - np.exp(n(sumlog)), 1.0 - np.exp(np.asarray(ref_sumlog)),
                               atol=3e-4)
    ((1.0 - torch.exp(sumlog)) * t(w)).sum().backward()
    _close(fvi.grad, ref_grad, "d_fvi")
    assert fz_t.grad is None and fnz_t.grad is None


def test_axis_aligned_face_matches_the_pallas_vjp():
    """Beside an axis-aligned edge the edge-line distance ties with the bbox
    distance.  Autodiff of the golden path halves the gradient between the
    two; the Pallas backward gives all of it to the line, and so does the
    port (the totals per axis agree either way)."""
    scene = _hand_built(axis_aligned=True)
    fz, fnz = jnp.asarray(scene["fz"]), jnp.asarray(scene["fnz"])

    def loss(fvi_, uvs_, fn_):
        _, soft, uv, normal, _, _ = rasterize_fused_v5(fvi_, fz, fnz, uvs_, fn_,
                                                       height=32, width=32)
        return (jnp.sum(soft * scene["w_soft"]) + jnp.sum(uv * scene["w_uv"])
                + jnp.sum(normal * scene["w_n"]))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*_jargs(scene))
    for ours, r, what in zip(_hand_built_port_grads(scene), ref,
                             ("d_fvi", "d_face_uvs", "d_face_normals")):
        _close(ours.grad, r, what)
