"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both
packages.  Flax variables are drawn directly in numpy from the shapes of
``jax.eval_shape(module.init, ...)``: tracing the init is seconds where
running it on the CPU is minutes, and it lets the BatchNorm running
statistics be random instead of (0, 1).
"""
from __future__ import annotations

import os

import jax
import numpy as np
import torch

REPO = os.path.join(os.path.dirname(__file__), "..")
SPHERE = os.path.join(REPO, "template", "sphere.obj")


def flax_shapes(module, *args, **kwargs):
    """Variable shapes of ``module.init`` without running it."""
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    return jax.eval_shape(lambda: module.init(keys, *args, **kwargs))


def random_variables(shapes, seed: int = 0):
    """numpy Flax variables for ``shapes``: kernels kaiming-normal fan-in,
    biases N(0, 0.1), BatchNorm scale 1 + N(0, 0.1), running mean N(0, 0.1)
    and var U(0.5, 1.5), MMPool mix N(0, 1)."""
    rs = np.random.RandomState(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        shape = s.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = rs.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif leaf == "scale":
            a = 1.0 + 0.1 * rs.randn(*shape)
        elif leaf in ("bias", "mean"):
            a = 0.1 * rs.randn(*shape)
        elif leaf == "var":
            a = rs.uniform(0.5, 1.5, shape)
        elif leaf == "p":
            a = rs.randn(*shape)
        else:
            raise ValueError(f"unexpected leaf {leaf}")
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def as_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def t(a, device="cpu"):
    """numpy / jax array -> float32 torch tensor."""
    return torch.as_tensor(np.array(a), device=device)


def n(x):
    """torch tensor -> numpy."""
    return x.detach().cpu().numpy()


DROP = {"dropout": jax.random.PRNGKey(0)}


def sphere_template():
    """(vertices (V, 3), dense Laplacian (V, V)) of sphere.obj, numpy."""
    from magicmirror_torch.geometry import mesh as mesh_ops
    from magicmirror_torch.geometry.obj_io import load_obj

    mesh = load_obj(SPHERE)
    v = mesh_ops.normalize_template(mesh.vertices)
    return v, mesh_ops.uniform_laplacian(v.shape[0], mesh.faces)


def train_pair(jmodule, tmodule, jargs, seed):
    """Random Flax variables -> (JAX train-mode output, the updated Flax
    batch_stats as a torch-keyed dict, the torch module loaded with the same
    variables, in train mode)."""
    from magicmirror_torch.models.convert import flax_to_state_dict, load_flax_variables

    variables = random_variables(flax_shapes(jmodule, *jargs, train=False), seed)
    # one XLA program: applied eagerly, Flax dispatches (and compiles) op by op
    ref, mutated = jax.jit(lambda v, *a: jmodule.apply(
        v, *a, train=True, rngs=DROP, mutable=["batch_stats"]))(variables, *jargs)
    load_flax_variables(tmodule, variables["params"], variables.get("batch_stats"))
    return ref, flax_to_state_dict({}, jax.device_get(mutated["batch_stats"])), tmodule.train()


def assert_stats(module, ref_stats, tol):
    """Every running statistic within tol of its buffer's largest value."""
    state = module.state_dict()
    assert ref_stats
    for key, ref in ref_stats.items():
        err = np.abs(n(state[key]) - ref).max()
        assert err <= tol * max(np.abs(ref).max(), 1e-6), (key, err)


def assert_close(out, ref, tol):
    """Within tol of the reference's largest absolute value."""
    ref = np.asarray(ref)
    assert n(out).shape == ref.shape
    assert np.abs(n(out) - ref).max() <= tol * np.abs(ref).max()
