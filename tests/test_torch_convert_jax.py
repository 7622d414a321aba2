"""A checkpoint of the JAX package brought into the port
(``magicmirror_torch/train/convert_jax.py``).

The JAX package saves a tiny run through its own CheckpointManager
(``torch_parity.jax_run``: create_train_state's structure with random
weights, BatchNorm statistics and optimizer moments, one ``swa_update``,
then new live weights); ``export_jax_checkpoint`` writes it as an npz and
``python -m magicmirror_torch.train.convert_jax`` converts it; the port's
``train/checkpoints.py`` restores it into a fresh train state.  Every
weight, statistic, SWA weight, the template and the counters must equal
the JAX leaves exactly after the layout transpose, and the Amsgrad moments
of three leaves their cuts of the raveled vectors (cut here by JAX's own
``ravel_pytree``).  The converted state's eval step must agree with the JAX
package's ``make_eval_step`` (random views injected) to
``magicmirror_torch/parity.py``'s slice tolerances.

Two test functions: the file compiles a JAX eval step (tests/ROADMAP rule).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from magicmirror.render.renderer import DiffRender as JDiffRender
from magicmirror.train.optim import make_optimizer_d, make_optimizer_e
from magicmirror.train.trainer import build_models as jbuild_models
from magicmirror.train.trainer import make_eval_step
from magicmirror_torch import kernels, parity
from magicmirror_torch.configs import flags
from magicmirror_torch.models.convert import flax_to_state_dict
from magicmirror_torch.serve import Reconstructor
from magicmirror_torch.train import build_trainer, convert_jax, train_options
from magicmirror_torch.train.checkpoints import CheckpointManager
from test_torch_slice import _photos
from torch_parity import as_numpy_tree, export_jax_checkpoint, jax_run, n, port_run, t

torch.set_num_threads(1)
# (JAX tree path, the optimizer state's tree) of the three leaves checked
NAMED_LEAVES = (("shape_enc", "backbone", "ResBlockHalf_0", "Conv2dBlock_0", "Conv_0", "kernel"),
                ("shape_enc", "conv1", "kernel"), ("light_enc", "Dense_0", "bias"))


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(JAX options, JAX state (numpy), the port's state restored from the
    converted checkpoint, the port's options, the run's directories); the
    directories are removed after the file's tests."""
    jroot, proot = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    opt, state = jax_run(str(jroot))
    path = port_run(str(jroot), str(proot))
    cwd = os.getcwd()
    os.chdir(proot)
    try:
        popt = train_options(flags.load_options(flags.build_parser().parse_args(
            ["--name", "clitest"]), skip=("name",)))
    finally:
        os.chdir(cwd)
    port = build_trainer(popt, device="cpu").state
    payload = CheckpointManager(os.path.dirname(path)).restore("best_ckpt", port)
    assert payload["epoch"] == 3
    yield opt, state, port, popt, (str(jroot), str(proot))
    for root in (jroot, proot):  # two runs' checkpoints, over a GB
        shutil.rmtree(root, ignore_errors=True)


def _equal(module_state, flax_arrays):
    for key, ref in flax_arrays.items():
        assert np.array_equal(n(module_state[key]), ref), key


def test_the_converted_checkpoint_holds_the_jax_leaves(converted):
    opt, state, port, popt, (jroot, proot) = converted
    _equal(port.netE.state_dict(), flax_to_state_dict(state.params_e, state.stats_e))
    _equal(port.netD.state_dict(), flax_to_state_dict(state.params_d))
    _equal(port.swa_netE.state_dict(), flax_to_state_dict(state.swa_params, state.swa_stats))
    assert not np.array_equal(n(port.netE.shape_enc.conv1.weight),
                              n(port.swa_netE.shape_enc.conv1.weight))
    assert np.array_equal(n(port.template), state.template)
    assert (port.step, port.epoch, port.swa_n) == (123, 5, 1)
    assert port.em_step == float(np.float32(0.0970299))

    # the moments of three leaves against JAX's own unravelling of the state
    for optimizer, module, params, opt_state in (
            (port.opt_e, port.netE, state.params_e, state.opt_state_e),
            (port.opt_d, port.netD, state.params_d, state.opt_state_d)):
        amsgrad = opt_state[0]
        _, unravel = ravel_pytree(params)
        trees = {k: as_numpy_tree(unravel(getattr(amsgrad, k))) for k in ("mu", "nu", "nu_max")}
        params_by_name = dict(module.named_parameters())
        leaves = NAMED_LEAVES if module is port.netE else (("Conv_3", "kernel"),)
        for path in leaves:
            for k, tree in trees.items():
                leaf = tree
                for part in path:
                    leaf = leaf[part]
                key, ref = next(iter(flax_to_state_dict(_nest(path, leaf)).items()))
                got = optimizer.state[params_by_name[key]][k]
                assert np.array_equal(n(got), ref), (path, k)
        assert all(g["count"] == int(amsgrad.count) == 7 for g in optimizer.param_groups)
        assert len(optimizer.state) == len(params_by_name)
    assert any(g.get("scale") == 0.05 for g in port.opt_e.param_groups)

    # the orbax tree as restored (lists, not an npz's dicts) converts alike
    import orbax.checkpoint as ocp

    raw = ocp.StandardCheckpointer().restore(
        os.path.join(jroot, "log", "clitest", "ckpts", "best_ckpt"))
    direct = convert_jax.convert(raw, popt)
    assert direct["epoch"] == 3
    key = "shape_enc.conv1.weight"
    assert torch.equal(direct["state"]["netE"][key], port.netE.state_dict()[key])
    assert direct["state"]["opt_e"]["param_groups"][0]["count"] == 7

    # the optimizer layouts the port does not run raise and say so
    tiny = {"shape_enc": {"backbone": {"Conv_0": {"kernel": np.zeros((1, 1, 2, 2))}}},
            "light_enc": {"Dense_0": {"bias": np.zeros(3)}}}
    for layout in (make_optimizer_e(flat=False), make_optimizer_e(wd=0.1),
                   make_optimizer_d(amsgrad=False)):
        with pytest.raises(ValueError, match="unsupported optimizer state layout|raveled"):
            convert_jax.unravel_amsgrad(tiny, as_numpy_tree(layout.init(tiny)), "opt_state_e")
    # the JAX package's own flat layout of the same tree is read
    count, moments = convert_jax.unravel_amsgrad(
        tiny, as_numpy_tree(make_optimizer_e().init(tiny)), "opt_state_e")
    assert count == 0 and set(moments) == {"shape_enc.backbone.Conv_0.weight",
                                           "light_enc.Dense_0.bias"}
    # an npz of the JAX checkpoint beside it: the export helper writes one
    npz = export_jax_checkpoint(os.path.join(jroot, "log", "clitest", "ckpts"), "best_ckpt",
                                os.path.join(proot, "again.npz"))
    with np.load(npz) as z:
        assert {"epoch", "state/opt_state_e/0/mu", "state/swa_n"} <= set(z.files)
        assert z["state/opt_state_e/0/mu"].shape == (sum(
            a.size for a in jax.tree_util.tree_leaves(state.params_e)),)
    os.remove(npz)
    with pytest.raises(FileExistsError):  # the JAX checkpoint's own directory
        cwd = os.getcwd()
        os.chdir(jroot)
        try:
            convert_jax.main(["--npz", "unused.npz", "--name", "clitest"])
        finally:
            os.chdir(cwd)


def _nest(path, leaf):
    for part in reversed(path):
        leaf = {part: leaf}
    return leaf


def test_the_converted_eval_step_matches_the_jax_package(converted):
    opt, state, port, popt, _ = converted
    jdr = JDiffRender(opt.template_path, opt.imageSize, ratio=opt.ratio,
                      init_ellipsoid=opt.ellipsoid, backend="xla")
    jnet, _ = jbuild_models(opt, jdr)
    images = _photos(0)
    rng = jax.random.PRNGKey(0)
    ref = make_eval_step(jnet, jdr, jdr.vertices_laplacian_matrix, opt)(
        state.params_e, state.stats_e, jnp.asarray(state.template), jnp.asarray(images), rng)
    random_az = -jax.random.uniform(rng, (images.shape[0],), minval=-opt.azi_scope / 2,
                                    maxval=opt.azi_scope / 2)
    from magicmirror_torch.render.renderer import DiffRender

    dr = DiffRender(popt.template_path, popt.imageSize, ratio=popt.ratio,
                    init_ellipsoid=popt.ellipsoid, device="cpu")
    launches = dict(kernels.LAUNCHES)
    outs = Reconstructor(port.netE, dr, popt, template=port.template)(
        t(images), random_azimuths=t(random_az))
    assert kernels.LAUNCHES == launches  # CPU tensors never reach a kernel
    stats = parity.slice_stats(as_numpy_tree(ref[:5]), outs[:5], as_numpy_tree(ref[5]), outs[5])
    parity.check_slice(stats)
