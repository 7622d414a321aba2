"""Port parity of DiffRender's gradients: d(a fixed random linear functional
of rgba)/d(vertices, textures, lights, azimuths, elevations, distances,
biases) on the CPU (the plain backward paths) against ``jax.grad`` of the same
functional through the JAX DiffRender(backend='xla') golden path, 64^2, B=2.

Tolerance: 1e-4 of each gradient's largest absolute value for the vertices,
the textures and the lights (seen 2e-5), 1e-3 for the four camera parameters
(seen 1.1e-4 for the azimuth: each is a float32 sum over all 642 vertices'
gradients, which largely cancel).

One test function on purpose: under ``pytest -n 6 --dist loadfile`` the files
with the most tests are handed out first, so a slow file with few tests runs
beside the suite's long files and not ahead of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from magicmirror.render.renderer import DiffRender as JDiffRender
from magicmirror_torch.render.renderer import DiffRender
from magicmirror_torch.render.synthetic import bench_attributes, to_torch
from torch_parity import SPHERE, n, t

torch.set_num_threads(1)
S, B = 64, 2
GRAD_KEYS = ("vertices", "textures", "lights", "azimuths", "elevations", "distances", "biases")


def _gradients():
    jdr = JDiffRender(SPHERE, S, backend="xla")
    dr = DiffRender(SPHERE, S, device="cpu")
    att = bench_attributes(np.asarray(jdr.vertices_init), B, S, seed=3)
    w = np.random.RandomState(4).randn(B, S, S, 4).astype(np.float32)

    def loss(wrt):
        full = {k: jnp.asarray(v) for k, v in att.items()}
        full.update(wrt)
        rgba, _ = jdr.render(**full, bg=None)
        return jnp.sum(rgba * w)

    ref = jax.jit(jax.grad(loss))({k: jnp.asarray(att[k]) for k in GRAD_KEYS})
    ours = to_torch(att, "cpu")
    for key in GRAD_KEYS:
        ours[key].requires_grad_(True)
    rgba, _ = dr.render(**ours)
    (rgba * t(w)).sum().backward()
    return ref, ours


def test_render_gradients_match_reference():
    ref, ours = _gradients()
    for key in GRAD_KEYS:
        r = np.asarray(ref[key])
        assert np.abs(r).max() > 0, key
        tol = 1e-4 if key in ("vertices", "textures", "lights") else 1e-3
        assert np.abs(n(ours[key].grad) - r).max() <= tol * np.abs(r).max(), key
