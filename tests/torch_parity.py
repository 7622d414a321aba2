"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both
packages.  Flax variables are drawn directly in numpy from the shapes of
``jax.eval_shape(module.init, ...)``: tracing the init is seconds where
running it on the CPU is minutes, and it lets the BatchNorm running
statistics be random instead of (0, 1).
"""
from __future__ import annotations

import glob
import os
import shutil

import jax
import numpy as np
import torch

REPO = os.path.join(os.path.dirname(__file__), "..")
SPHERE = os.path.join(REPO, "template", "sphere.obj")


def drop_checkpoints(root) -> None:
    """Remove the ``ckpts`` folders under ``root`` once a test has read
    them: a checkpoint of the full-width encoders is some hundreds of MB,
    and pytest keeps the temporary folders of its last three runs."""
    for path in glob.glob(os.path.join(str(root), "**", "ckpts"), recursive=True):
        shutil.rmtree(path)


def flax_shapes(module, *args, **kwargs):
    """Variable shapes of ``module.init`` without running it."""
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    return jax.eval_shape(lambda: module.init(keys, *args, **kwargs))


def random_variables(shapes, seed: int = 0):
    """numpy Flax variables for ``shapes``: kernels kaiming-normal fan-in,
    biases N(0, 0.1), BatchNorm scale 1 + N(0, 0.1), running mean N(0, 0.1)
    and var U(0.5, 1.5), MMPool mix N(0, 1), LayerNormAll's gamma U(0.5,
    1.5) and beta N(0, 0.1)."""
    rs = np.random.RandomState(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        shape = s.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            a = rs.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif leaf == "scale":
            a = 1.0 + 0.1 * rs.randn(*shape)
        elif leaf in ("bias", "mean", "beta"):
            a = 0.1 * rs.randn(*shape)
        elif leaf in ("var", "gamma"):
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
    stats = jax.device_get(mutated.get("batch_stats", {}))
    return ref, flax_to_state_dict({}, stats), tmodule.train()


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


DRYRUN = os.path.join(REPO, "template", "sphere_dryrun.obj")
# the tiny model of the eval CLIs' tests: the 80-face sphere at 32^2, batch 2
TINY_FLAGS = ["--imageSize", "32", "--batchSize", "2", "--pretrains", "none",
              "--pretraint", "none", "--template_path", DRYRUN, "--workers", "1"]


def zeros_train_state(*args, **kwargs):
    """``create_train_state``'s structure and shapes, zeros: what a restore
    overwrites, without compiling the model's init."""
    from magicmirror.train.state import create_train_state

    shapes = jax.eval_shape(lambda: create_train_state(*args, **kwargs))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _random_opt_state(shapes, rs):
    """An optimizer state of ``shapes``: mu N(0, 1e-3), nu and nu_max
    positive, count 7."""
    def fill(path, s):
        name = str(getattr(path[-1], "name", path[-1]))
        if name == "count":
            return np.asarray(7, s.dtype)
        a = rs.randn(*s.shape) * 1e-3
        return (a if name == "mu" else a * a).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_run(root, name="clitest", dataroot="", extra=(), seed=0):
    """A finished run of the JAX package in ``root``: ``log/<name>/opts.yaml``
    (the tiny model's flags and ``extra``), and in ``ckpts/`` ``best_ckpt``
    (saved by the JAX package's CheckpointManager) and ``best_mesh.obj``.
    The state has create_train_state's structure with random numbers in it:
    BatchNorm statistics, optimizer moments (count 7), a moved template, a
    SWA average taken by one ``swa_update`` before the live parameters were
    drawn anew -> (the JAX options, the saved state as a numpy tree)."""
    from magicmirror.configs.flags import build_parser, save_options
    from magicmirror.render.renderer import DiffRender as JDiffRender
    from magicmirror.train.checkpoints import CheckpointManager
    from magicmirror.train.optim import make_optimizer_d, make_optimizer_e
    from magicmirror.train.state import swa_update
    from magicmirror.train.trainer import build_models

    cwd = os.getcwd()
    os.chdir(root)
    try:
        opt = build_parser().parse_args(["--name", name, "--dataroot", dataroot,
                                         *TINY_FLAGS, *extra])
        opt.outf = "./log/" + name
        os.makedirs(opt.outf, exist_ok=True)
        save_options(opt)
        H = round(opt.ratio * opt.imageSize)
        dr = JDiffRender(opt.template_path, opt.imageSize, ratio=opt.ratio,
                         init_ellipsoid=opt.ellipsoid)
        netE, netD = build_models(opt, dr)
        # the JAX trainer's optimizers for the run's flags
        opt_e = make_optimizer_e(adamw=opt.adamw, beta1=opt.beta1, wd=opt.wd,
                                 amsgrad=opt.amsgrad)
        opt_d = make_optimizer_d(beta1=opt.beta1, wd=opt.wd, amsgrad=opt.amsgrad)
        shapes = zeros_train_state(jax.random.PRNGKey(0), netE, netD, opt_e, opt_d,
                                   np.zeros((1, H, opt.imageSize, 4), np.float32),
                                   dr.vertices_init, dr.vertices_laplacian_matrix)
        rs = np.random.RandomState(seed)
        enc = [random_variables({"params": shapes.params_e, "batch_stats": shapes.stats_e},
                                seed + i) for i in (1, 2)]
        state = shapes.replace(
            params_e=enc[0]["params"], stats_e=enc[0]["batch_stats"],
            params_d=random_variables({"params": shapes.params_d}, seed + 3)["params"],
            opt_state_e=_random_opt_state(shapes.opt_state_e, rs),
            opt_state_d=_random_opt_state(shapes.opt_state_d, rs),
            template=(np.asarray(dr.vertices_init)
                      + 0.01 * rs.randn(*shapes.template.shape)).astype(np.float32),
            em_step=np.float32(0.0970299), swa_n=np.int32(0), epoch=np.int32(5),
            step=np.int32(123))
        state = swa_update(state)
        state = as_numpy_tree(state.replace(params_e=enc[1]["params"],
                                            stats_e=enc[1]["batch_stats"]))
        mgr = CheckpointManager(os.path.join(opt.outf, "ckpts"))
        mgr.save("best_ckpt", state, epoch=3)
        mgr.save_best_mesh(state.template, np.asarray(dr.faces), dr.uvs)
    finally:
        os.chdir(cwd)
    return opt, state


def export_jax_checkpoint(ckpt_dir, name, out_npz):
    """The JAX package's orbax checkpoint ``ckpt_dir/name`` (restored
    without a target: nested dicts and lists of arrays) -> ``out_npz``, one
    array a leaf under its ``/``-joined tree path (``state/params_e/...``,
    ``state/opt_state_e/0/mu``, ``epoch``), the input of ``python -m
    magicmirror_torch.train.convert_jax``.  Needs jax and orbax."""
    import orbax.checkpoint as ocp

    payload = ocp.StandardCheckpointer().restore(os.path.abspath(os.path.join(ckpt_dir, name)))
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            if node is not None:
                flat["/".join(path)] = np.asarray(node)
            return
        for key, value in items:
            walk(value, path + (str(key),))

    walk(payload, ())
    np.savez(out_npz, **flat)
    return out_npz


def port_run(jax_root, root, name="clitest", ckpt="best_ckpt"):
    """The JAX run ``name`` of ``jax_root`` brought into the port in ``root``:
    its opts.yaml and best_mesh.obj copied, its best_ckpt exported
    (``export_jax_checkpoint``) and converted by ``python -m
    magicmirror_torch.train.convert_jax`` into ``ckpts/<ckpt>`` -> the
    converted checkpoint's path."""
    import shutil

    from magicmirror_torch.train import convert_jax

    jax_root, root = os.path.abspath(jax_root), os.path.abspath(root)
    src, dst = (os.path.join(r, "log", name) for r in (jax_root, root))
    os.makedirs(os.path.join(dst, "ckpts"), exist_ok=True)
    shutil.copy(os.path.join(src, "opts.yaml"), dst)
    shutil.copy(os.path.join(src, "ckpts", "best_mesh.obj"), os.path.join(dst, "ckpts"))
    npz = export_jax_checkpoint(os.path.join(src, "ckpts"), "best_ckpt",
                                os.path.join(root, "jax_payload.npz"))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        path = convert_jax.main(["--npz", npz, "--name", name, "--ckpt", ckpt])
    finally:
        os.chdir(cwd)
    os.remove(npz)
    return os.path.join(root, path)
