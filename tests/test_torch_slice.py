"""The serving slice end to end at the default configuration, 32^2, B=2:
the JAX package's build_models + make_eval_step (AttributeEncoder and
DiffRender(backend='xla')) vs the port's build_models + Reconstructor, with
the same numpy-drawn weights (random BatchNorm statistics included), the
same photos and the same random-view azimuths.

Tolerances are those of magicmirror_torch/parity.py (check_slice):
attributes 1e-3, azimuth / elevation 1e-2 degrees, textures 1e-3 on 99.5%
of texels and 1e-2 everywhere, alpha and rgb 1e-3 on 99.5% of each image's
pixels and on all but 64 of them, rgb 1e-2 and alpha 0.15 everywhere.
"""
import dataclasses
import importlib
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magicmirror_torch
from magicmirror.configs.flags import build_parser
from magicmirror.render.renderer import DiffRender as JDiffRender
from magicmirror.train.trainer import build_models as jbuild_models
from magicmirror.train.trainer import make_eval_step
from magicmirror_torch import parity
from magicmirror_torch.models.convert import load_flax_variables
from magicmirror_torch.render.renderer import DiffRender
from magicmirror_torch.render.synthetic import smooth_random
from magicmirror_torch.serve import (Reconstructor, ServeOptions, build_models,
                                     estimate_bn_stats)
from torch_parity import REPO, SPHERE, as_numpy_tree, flax_shapes, random_variables, t

torch.set_num_threads(1)
S, B = 32, 2


def _photos(seed):
    """Smooth random RGB with an elliptical mask channel, (B, S, S, 4) in [0, 1]."""
    rgb = smooth_random((B, S, S, 3), seed)
    yy, xx = np.mgrid[0:S, 0:S] / (S - 1) * 2 - 1
    mask = (xx ** 2 / 0.5 + yy ** 2 / 0.8 < 1).astype(np.float32)
    return np.concatenate([rgb, np.broadcast_to(mask[None, ..., None], (B, S, S, 1))], -1)


@pytest.fixture(scope="module")
def slice_runs():
    opt = build_parser().parse_args(["--imageSize", str(S), "--template_path", SPHERE])
    jdr = JDiffRender(opt.template_path, S, ratio=opt.ratio, init_ellipsoid=opt.ellipsoid,
                      backend="xla")
    jnet, _ = jbuild_models(opt, jdr)
    lpl = jdr.vertices_laplacian_matrix
    images = _photos(0)
    variables = random_variables(
        flax_shapes(jnet, jnp.asarray(images), jdr.vertices_init, lpl, train=False), seed=0)
    rng = jax.random.PRNGKey(0)
    ref = make_eval_step(jnet, jdr, lpl, opt)(
        variables["params"], variables["batch_stats"], jdr.vertices_init,
        jnp.asarray(images), rng)
    # the azimuths eval_step drew for its random view, from the same key
    random_az = -jax.random.uniform(rng, (B,), minval=-opt.azi_scope / 2,
                                    maxval=opt.azi_scope / 2)

    sopt = ServeOptions(template_path=SPHERE, imageSize=S)
    dr = DiffRender(sopt.template_path, S, ratio=sopt.ratio, init_ellipsoid=sopt.ellipsoid,
                    device="cpu")
    net = build_models(sopt, dr, "cpu")
    load_flax_variables(net, variables["params"], variables["batch_stats"])
    outs = Reconstructor(net, dr, sopt)(t(images), random_azimuths=t(random_az))
    return as_numpy_tree(ref[:5]), as_numpy_tree(ref[5]), outs


def test_eval_step_matches_reference(slice_runs):
    ref_renders, ref_att, outs = slice_runs
    assert all(r.shape == (B, S, S, 4) for r in outs[:5])
    assert all(0.0 < float(r[..., 3].mean()) < 1.0 for r in outs[:5])
    stats = parity.slice_stats(ref_renders, outs[:5], ref_att, outs[5])
    parity.check_slice(stats)


def test_attribute_dict_has_the_reference_keys(slice_runs):
    _, ref_att, outs = slice_runs
    assert set(outs[5]) == set(ref_att) | {"dropped_faces", "dropped_tex_chunks"}
    for key, value in ref_att.items():
        if value is not None:
            assert tuple(outs[5][key].shape) == value.shape, key


def test_turntable_rerenders_one_image(slice_runs):
    _, _, outs = slice_runs
    sopt = ServeOptions(template_path=SPHERE, imageSize=S)
    dr = DiffRender(sopt.template_path, S, device="cpu")
    rec = Reconstructor(build_models(sopt, dr, "cpu"), dr, sopt)
    az = -torch.arange(0, 360, 90, dtype=torch.float32)
    rgba, normal = rec.turntable(outs[5], az, index=1)
    assert rgba.shape == (4, S, S, 4) and normal.shape == (4, S, S, 3)
    one = {k: (None if v is None else v[1:2]) for k, v in outs[5].items()}
    one["azimuths"] = az[2:3]
    single, _ = dr.render(**one)
    torch.testing.assert_close(rgba[2:3], single, rtol=0, atol=1e-6)


def test_encoder_runs_without_tf32_whatever_the_caller_set(monkeypatch):
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, images, template, lpl):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return {}

    dr = DiffRender(SPHERE, S, device="cpu")
    rec = Reconstructor(Probe(), dr, ServeOptions(template_path=SPHERE, imageSize=S))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    images = torch.zeros(1, S, S, 4)
    rec.encode(images)
    estimate_bn_stats(rec.netE, [images], dr.vertices_init, dr.vertices_laplacian_matrix)
    assert seen == [(False, False)] * 2
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_serve_options_defaults_are_the_flag_defaults():
    opt = build_parser().parse_args([])
    for field in dataclasses.fields(ServeOptions):
        assert getattr(opt, field.name) == field.default, field.name


# the backbones outside the port (the encoder options norm, makeup, nolpl,
# inv and lambda_lc are ported: tests/test_torch_option_convert.py)
@pytest.mark.parametrize("change", [{"pretrainc": "res34"}, {"pretrains": "unet"},
                                   {"pretraint": "res50"}, {"pretrains": "swin"},
                                   {"pretrains": "res50"}, {"pretraint": "swin"},
                                   {"pretrainc": "res18"}])
def test_options_outside_the_port_raise(change):
    dr = DiffRender(SPHERE, S, device="cpu")
    with pytest.raises(NotImplementedError):
        build_models(dataclasses.replace(ServeOptions(), **change), dr, "cpu")


def test_port_imports_without_jax_flax_yaml_or_pil():
    """Every module of the port imports with JAX, Flax, optax, orbax, yaml,
    Pillow, imageio, tqdm, matplotlib, TensorBoard and the JAX package blocked
    (the card's machine has none of them but Pillow and yaml, which the port
    reaches only inside the functions that decode a JPEG, blur a mask or
    read and write opts.yaml; matplotlib only where it draws a histogram)."""
    names = [m.name for m in pkgutil.walk_packages(magicmirror_torch.__path__,
                                                   "magicmirror_torch.")]
    code = ("import sys\n"
            "for blocked in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'yaml', 'PIL',\n"
            "                'imageio', 'tqdm', 'matplotlib', 'tensorboard', 'magicmirror'):\n"
            "    sys.modules[blocked] = None\n"
            "import importlib\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr
    for module in ("serve", "kernels.build", "losses.gan", "losses.mesh_reg", "losses.recon",
                   "models.discriminators", "train", "train.optim", "train.state",
                   "train.train_step", "train.trainer", "train.em_update",
                   "train.checkpoints", "eval.metrics", "eval.images", "eval.reports",
                   "eval.gifs", "eval.inception", "eval.fid", "benchmarks.texture_parts",
                   "benchmarks.timing", "benchmarks.kernel_times", "data", "data.base",
                   "data.cub", "data.loader", "data.market", "data.atr", "data.atr2",
                   "configs", "configs.flags", "configs.recipes", "cli", "cli.train",
                   "cli.train_market", "cli.train_atr", "cli.train_atr2", "train.convert_jax",
                   "data.thuman2", "eval.pck", "cli.test", "cli.single_img", "cli.show_camera",
                   "cli.show_rainbow2", "cli.test_cub30", "cli.test_thu", "cli.test_pck",
                   "cli.generate_market", "cli.template_animation", "cli.tools",
                   "cli.ablation_hmr", "eval.poisson", "eval.convert_fid_weights",
                   "data.prepare", "data.native", "models.convert_torch"):
        assert f"magicmirror_torch.{module}" in names, module
    for name in names:  # and they import here too
        importlib.import_module(name)
