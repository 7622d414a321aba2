"""Weights, checkpoints and options of the off-default modules across the
two packages:

  * ``models/convert.py`` on seeded Flax trees of the encoder under
    ``--norm ln`` / ``ibn`` with ``--makeup``, ``--nolpl`` and the landmark
    head of ``--lambda_lc`` (``LayerNormAll``'s gamma and beta, IBN's
    ``IN`` / ``BN``, the head's Dense and BatchNorm), and of the
    multi-scale and spectral-norm critics (the SN conv's raw HWIO kernel):
    strict loads, every leaf equal after the layout transpose;
  * ``train/convert_jax.py`` on checkpoints the JAX package saves for runs
    under those options (the tiny model of tests/torch_parity.py's
    ``jax_run``): an MSD critic with an AdamW encoder (``--adamw`` without
    ``--amsgrad``: optax ``adamw``, the critic's optax ``adam`` after the
    chained decay), and an SN critic with AMSGrad; every weight and statistic
    equal, the moments of three leaves equal to their cuts of the raveled
    vectors, the count kept; an optimizer state of another layout raises;
  * ``serve_options`` / ``train_options``, ``build_models`` and ``build_trainer`` take the
    lifted options and still refuse the rest (the backbones outside the
    port, ``--multigpus``, ``--fp16``), and the critic follows ``--gan_type``
    and ``--sn_dis`` as the JAX trainer picks it.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from magicmirror.configs.flags import build_parser as jbuild_parser
from magicmirror.models import attribute_encoder as jae
from magicmirror.models import discriminators as jd
from magicmirror_torch.configs import flags
from magicmirror_torch.models import attribute_encoder as tae
from magicmirror_torch.models import discriminators as td
from magicmirror_torch.models.convert import flax_to_state_dict, load_flax_variables
from magicmirror_torch.serve import ServeOptions, serve_options
from magicmirror_torch.train import (TrainOptions, build_trainer, convert_jax,
                                     train_options)
from magicmirror_torch.train.checkpoints import CheckpointManager
from torch_parity import (SPHERE, as_numpy_tree, flax_shapes, jax_run, n, port_run,
                          random_variables, sphere_template)

torch.set_num_threads(1)


def _equal(state, arrays):
    for key, ref in arrays.items():
        assert np.array_equal(n(state[key]), ref), key


@pytest.mark.parametrize("norm", ["ln", "ibn"])
def test_encoder_leaves_of_the_options_convert(norm):
    """The whole encoder with its options, the landmark head's variables
    initialised through ``landmark_loss`` as create_train_state does."""
    v, lpl = sphere_template()
    kw = dict(num_vertices=v.shape[0], pretrains="none", pretraint="none", norm=norm,
              makeup=2, nolpl=True, lambda_lc=0.1, num_faces=1280)
    jnet = jae.AttributeEncoder(**kw)
    x = jnp.zeros((2, 32, 32, 4))
    shapes = dict(flax_shapes(jnet, x, jnp.asarray(v), jnp.asarray(lpl), train=False))
    head = flax_shapes(jnet, jnp.zeros((2, 8, 8, 256)), jnp.zeros((2, 1280, 2)),
                       jnp.ones((2, 1280)), jnp.arange(64), method="landmark_loss")
    shapes = {c: {**dict(shapes.get(c, {})), **dict(head.get(c, {}))}
              for c in ("params", "batch_stats")}
    variables = random_variables(shapes, seed=3)
    params, stats = variables["params"], variables["batch_stats"]
    assert "landmark_cls" in params and "feat_enc" in params
    net = load_flax_variables(tae.AttributeEncoder(**kw), params, stats)
    arrays = flax_to_state_dict(params, stats)
    _equal(net.state_dict(), arrays)
    keys = set(arrays)
    if norm == "ln":
        assert any(k.endswith("LayerNormAll_0.gamma") for k in keys)
        assert any(k.endswith("LayerNormAll_0.beta") for k in keys)
    else:
        assert any(k.endswith("IBN_0.IN.weight") for k in keys)
        assert any(k.endswith("IBN_0.BN.running_var") for k in keys)
    assert {"landmark_cls.Dense_0.weight", "landmark_cls.Dense_1.weight",
            "landmark_cls.BatchNorm_0.weight", "landmark_cls.BatchNorm_0.running_mean"} <= keys


def test_critic_leaves_convert():
    x = jnp.zeros((1, 128, 128, 3))
    for jnet, net, probe in ((jd.MSDiscriminator(nc=3, nf=16), td.MSDiscriminator(3, 16),
                              "scale2.Conv_10.bias"),
                             (jd.SNDiscriminator(nc=3, imsize=128),
                              td.SNDiscriminator(3, imsize=128), "SNConv_5.weight")):
        params = random_variables(flax_shapes(jnet, x), seed=4)["params"]
        load_flax_variables(net, params)
        arrays = flax_to_state_dict(params)
        assert probe in arrays
        _equal(net.state_dict(), arrays)
    hwio = np.asarray(params["SNConv_0"]["kernel"])
    assert np.array_equal(n(net.SNConv_0.weight), hwio.transpose(3, 2, 0, 1))


RUNS = {
    "msd_adamw": (["--gan_type", "lsgan", "--adamw", "--amsgrad", "", "--wd", "1e-4",
                   "--norm", "ibn", "--lambda_lc", "0.1", "--makeup", "2", "--nolpl"],
                  td.MSDiscriminator, ("adamw", "adam")),
    "sn_amsgrad": (["--sn_dis", "1", "--norm", "ln", "--makeup", "5"],
                   td.SNDiscriminator, ("amsgrad", "amsgrad")),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_jax_checkpoint_of_the_options_converts(tmp_path, run):
    extra, critic, layouts = RUNS[run]
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jroot.mkdir()
    proot.mkdir()
    opt, state = jax_run(str(jroot), extra=extra)
    path = port_run(str(jroot), str(proot))
    cwd = os.getcwd()
    os.chdir(proot)
    try:
        popt = train_options(flags.load_options(flags.build_parser().parse_args(
            ["--name", "clitest"]), skip=("name",)))
    finally:
        os.chdir(cwd)
    port = build_trainer(popt, device="cpu").state
    assert CheckpointManager(os.path.dirname(path)).restore("best_ckpt", port)["epoch"] == 3
    assert isinstance(port.netD, critic)
    assert tuple(convert_jax.optimizer_layout(o) for o in (port.opt_e, port.opt_d)) == layouts
    _equal(port.netE.state_dict(), flax_to_state_dict(state.params_e, state.stats_e))
    _equal(port.netD.state_dict(), flax_to_state_dict(state.params_d))
    _equal(port.swa_netE.state_dict(), flax_to_state_dict(state.swa_params, state.swa_stats))
    for optimizer, module, params, opt_state in (
            (port.opt_e, port.netE, state.params_e, state.opt_state_e),
            (port.opt_d, port.netD, state.params_d, state.opt_state_d)):
        layout = convert_jax.optimizer_layout(optimizer)
        inner = convert_jax.amsgrad_state(opt_state, "test", layout)
        names = {p: k for k, p in module.named_parameters()}
        by_name = {names[p]: optimizer.state[p] for g in optimizer.param_groups
                   for p in g["params"]}
        _, unravel = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, params))
        for field in inner:
            if field == "count":
                continue
            tree = flax_to_state_dict(as_numpy_tree(unravel(jnp.asarray(inner[field]))))
            for key in sorted(tree)[:3]:
                assert np.array_equal(n(by_name[key][field]), tree[key]), (key, field)
        if layout != "amsgrad":
            assert all(float(s["nu_max"].abs().max()) == 0.0 for s in by_name.values())
        assert all(g["count"] == int(inner["count"]) == 7 for g in optimizer.param_groups)
    # the encoder's adamw state is not an amsgrad one, nor the other way round
    other = "amsgrad" if layouts[0] != "amsgrad" else "adamw"
    with pytest.raises(ValueError, match="unsupported optimizer state layout"):
        convert_jax.amsgrad_state(state.opt_state_e, "opt_state_e", other)
    shutil.rmtree(tmp_path, ignore_errors=True)  # the two runs' checkpoints


LIFTED = (["--norm", "in"], ["--norm", "ibn"], ["--norm", "ln"], ["--norm", "sn"],
          ["--nolpl"], ["--makeup", "1"], ["--makeup", "5"], ["--inv", "0.5"],
          ["--lambda_lc", "0.1"])
TRAIN_LIFTED = (["--gan_type", "lsgan"], ["--sn_dis", "1"], ["--dis1", "0.1"],
                ["--dis2", "0.1"], ["--adamw", "--amsgrad", ""], ["--hmr", "1"])
STILL_OUT = (["--pretrainc", "res18"], ["--pretrains", "res50"], ["--pretraint", "swin"],
             ["--pretrains", "unet"])


def test_options_are_taken_and_the_rest_refused():
    for argv in LIFTED:
        sopt = serve_options(jbuild_parser().parse_args(argv))
        topt = train_options(flags.build_parser().parse_args(argv))
        assert isinstance(sopt, ServeOptions) and isinstance(topt, TrainOptions), argv
    for argv in TRAIN_LIFTED:
        assert isinstance(train_options(flags.build_parser().parse_args(argv)), TrainOptions)
    assert train_options(flags.build_parser().parse_args(["--amsgrad", "x"])).amsgrad is True
    for argv in STILL_OUT + (["--multigpus"], ["--fp16"]):
        with pytest.raises(NotImplementedError):
            train_options(flags.build_parser().parse_args(argv))
    for argv in STILL_OUT:
        with pytest.raises(NotImplementedError):
            serve_options(jbuild_parser().parse_args(argv))


def test_the_critic_follows_gan_type_and_sn_dis():
    base = dict(template_path=SPHERE, imageSize=32, batchSize=2, pretrains="none",
                pretraint="none")
    for change, cls in (({}, td.Discriminator), ({"gan_type": "lsgan"}, td.MSDiscriminator),
                        ({"sn_dis": 1}, td.SNDiscriminator)):
        assert type(build_trainer(TrainOptions(**base, **change), device="cpu").state.netD) \
            is cls
    with pytest.raises(ValueError, match="sn_dis requires"):
        build_trainer(TrainOptions(**base, sn_dis=1, gan_type="lsgan"), device="cpu")
    with pytest.raises(ValueError, match="unknown gan type"):
        build_trainer(TrainOptions(**base, gan_type="hinge"), device="cpu")
    trainer = build_trainer(TrainOptions(**base, inv=0.5), device="cpu")
    _, lpl = sphere_template()
    np.testing.assert_array_equal(n(trainer.state.precond_M),
                                  jae.make_inv_preconditioner(lpl, 0.5))
    assert build_trainer(TrainOptions(**base), device="cpu").state.precond_M is None
