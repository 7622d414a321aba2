"""The two configurations beside the default, each as a slice against the
JAX package on the CPU:

  * ``market``: the human-body recipe's geometry (``MARKET_DEFAULTS``: ratio
    2, ellipsoid 2, ``elev_range -15~15``, ``dist_range 2~6``, ``bias_range
    0.5``) at 64x32 on ``sphere2.obj`` (2,562 vertices, 5,120 faces: dense
    enough for the JAX renderer's v6 route on a TPU, and minutes cheaper to
    compile here than ``smpl_uv.obj``), with the published Market recipe's
    flags (``docs/RECIPES.md``: ``--bg --hard --unmask 2 --L1 --ganw 0
    --lambda_data 2 --lambda_flat 0.02 --lambda_depthR 0.15 --beta1 0.95``)
    and ``--hard_range 30``, so that the hard view's two azimuth ranges
    differ (its draws: tests/test_torch_recipe_step.py);
  * ``exact``: the defaults with ``soft_mode='exact'`` on ``sphere.obj`` at
    32^2.

Per configuration, with the tiny encoders (``pretrains = pretrainc =
pretraint = "none"``), dropout off, the same numpy-drawn variables converted
into the port, and the same photos and draws: ``DiffRender.render`` of
bench.py's attribute distribution against ``DiffRender(backend='xla')``, and
one D-then-G step against ``make_train_step(steps_per_call=1)``.

Tolerances: the render as tests/test_torch_renderer.py holds the default,
except: rgb 1e-4 on all but 2 pixels (see the test); normals 2e-4 on the
denser template; alpha 5e-5 in place of 1e-5: the two camera paths place a
vertex ~1e-7 apart, sigmainv = 7000 multiplies that in every soft term, and a
silhouette pixel of the 5,120-face template sums four times as many terms as
one of sphere.obj (seen 1.5e-5 on 5 of 4,096 pixels).  The step as
tests/test_torch_train_step.py holds it (metrics 1e-3 relative, gradient
norms 1e-2, the worst rgb 3e-2) with the image rule of
``parity.check_train_renders`` (alpha on 99.5% of an image's pixels, rgb on
98%: seen 98.97% at 64x32, where the train-mode texture flow carries the
BatchNorm-over-4-samples noise), for the reasons stated there.  Batch 4 and
the scaled shape head likewise; the market step also holds the running
statistics and the updated parameters as that file does, and shows the
background encoder trained.

One XLA compile of a train step per configuration makes this file slow; it
holds two test functions on purpose (``--dist loadfile`` hands out the files
with the most tests first).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.configs.flags import build_parser
from magicmirror.models.attribute_encoder import AttributeEncoder as JAttributeEncoder
from magicmirror.models.discriminators import Discriminator as JDiscriminator
from magicmirror.render.renderer import DiffRender as JDiffRender
from magicmirror.train.optim import make_optimizer_d, make_optimizer_e
from magicmirror.train.state import TrainState as JTrainState
from magicmirror.train.train_step import make_train_step
from magicmirror_torch import parity
from magicmirror_torch.configs.recipes import recipe_flags
from magicmirror_torch.models.convert import flax_to_state_dict, load_flax_variables
from magicmirror_torch.render.renderer import DiffRender
from magicmirror_torch.render.synthetic import bench_attributes, to_torch
from magicmirror_torch.serve import MARKET_DEFAULTS
from magicmirror_torch.train import METRIC_KEYS, TrainOptions, build_trainer
from test_torch_recipe_step import _hard_draws
from test_torch_train_step import (_draws, _running_statistics_match_reference,
                                   _updated_parameters_match_reference)
from torch_parity import REPO, SPHERE, as_numpy_tree, flax_shapes, n, random_variables, t

torch.set_num_threads(1)
S, B = 32, 4
LR = 1e-4
# the published Market recipe's flags that the step reads (its command line,
# parsed by the Market CLI: tests/test_torch_recipe_cli.py)
RECIPE_STEP_FLAGS = ("bg", "hard", "unmask", "L1", "ganw", "lambda_data", "lambda_flat",
                     "lambda_depthR", "beta1")
CONFIGS = {
    "market": dict(MARKET_DEFAULTS, template_path=f"{REPO}/template/sphere2.obj",
                   hard_range=30, **{k: recipe_flags("recipe_market")[k]
                                     for k in RECIPE_STEP_FLAGS}),
    "exact": dict(soft_mode="exact", template_path=SPHERE),
}


def _flags(config):
    opt = build_parser().parse_args([])
    opt.imageSize, opt.batchSize = S, B
    opt.pretrains = opt.pretrainc = opt.pretraint = "none"
    opt.droprate = "0,0,0"
    for key, value in CONFIGS[config].items():
        setattr(opt, key, value)
    return opt


def _renderers(config):
    opt = _flags(config)
    jdr = JDiffRender(opt.template_path, S, ratio=opt.ratio, init_ellipsoid=opt.ellipsoid,
                      lambda_flat=opt.lambda_flat, backend="xla", soft_mode=opt.soft_mode)
    dr = DiffRender(opt.template_path, S, ratio=opt.ratio, init_ellipsoid=opt.ellipsoid,
                    soft_mode=opt.soft_mode, device="cpu")
    return opt, jdr, dr


@pytest.mark.parametrize("config", list(CONFIGS))
def test_render_matches_reference(config):
    opt, jdr, dr = _renderers(config)
    H, W = round(opt.ratio * S), S
    assert (dr.render_height, dr.render_width) == (jdr.render_height, jdr.render_width) == (H, W)
    assert (dr.num_faces, dr.num_vertices) == (jdr.num_faces, jdr.num_vertices)
    for name in ("vertices_init", "faces", "face_uvs", "vertices_laplacian_matrix",
                 "flip_index", "edges", "edge2faces", "sign_init"):
        assert np.array_equal(n(getattr(dr, name)), np.asarray(getattr(jdr, name))), name
    np.testing.assert_allclose(n(dr.cam_proj), np.asarray(jdr.cam_proj), rtol=1e-7)
    att = bench_attributes(np.asarray(jdr.vertices_init), 2, S, seed=0, height=H)
    att["distances"] = np.asarray([2.5, 5.5], np.float32)
    ref_rgba, ref_att = jdr.render(**{k: jnp.asarray(v) for k, v in att.items()}, bg=None)
    rgba, out = dr.render(**to_torch(att, "cpu"))
    ref_rgba, rgba = np.asarray(ref_rgba), n(rgba)
    assert rgba.shape == ref_rgba.shape == (2, H, W, 4)
    assert 0.02 < ref_rgba[..., 3].mean() < 0.95
    np.testing.assert_allclose(rgba[..., 3], ref_rgba[..., 3], atol=5e-5)
    # a pixel centre on the edge between two faces may go to either: the two
    # packages place the vertices ~1e-7 apart (seen: 1 of 4,096 pixels of the
    # 5,120-face template, 0.09 off under bench.py's per-texel noise)
    off = np.abs(rgba[..., :3] - ref_rgba[..., :3]).max(-1) > 1e-4
    assert off.sum() <= 2, int(off.sum())
    # normals 2e-4 in place of 1e-4: the unit normal of a face a quarter the size
    # is conditioned that much worse in float32 (seen 1.02e-4 on 1 of 30,720)
    for key, atol in (("face_normals", 2e-4), ("faces_image", 1e-5)):
        np.testing.assert_allclose(n(out[key]), np.asarray(ref_att[key]), atol=atol)
    normal_err = np.abs(n(out["imnormal"]) - np.asarray(ref_att["imnormal"])).max(-1)
    assert (normal_err[~off] <= 2e-4).all()
    assert not out["dropped_faces"].any() and not out["dropped_tex_chunks"].any()
    with torch.no_grad():  # served and trained renders are one form
        served, _ = dr.render(**to_torch(att, "cpu"))
    np.testing.assert_allclose(n(served), rgba, atol=1e-5)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_one_train_step_matches_reference(config):
    opt, jdr, _ = _renderers(config)
    H, W = round(opt.ratio * S), S
    rs = np.random.RandomState(0)
    imgs = rs.rand(B, H, W, 4).astype(np.float32)
    imgs[..., 3] = 0.0
    imgs[:, H // 4:3 * H // 4, W // 4:3 * W // 4, 3] = 1.0

    netE = JAttributeEncoder(
        num_vertices=jdr.num_vertices, azi_scope=opt.azi_scope, elev_range=opt.elev_range,
        dist_range=opt.dist_range, nc=4, nk=opt.nk, nf=opt.nf, ratio=opt.ratio,
        pretraint=opt.pretraint, pretrainc=opt.pretrainc, pretrains=opt.pretrains,
        droprate=opt.droprate, norm=opt.norm, bg=opt.bg)
    nc = 4 if opt.unmask == 2 else 3
    netD = JDiscriminator(nc=nc, nf=16)
    lpl = jdr.vertices_laplacian_matrix
    ve = random_variables(flax_shapes(netE, jnp.asarray(imgs), jdr.vertices_init, lpl,
                                      train=False), seed=0)
    ve["params"]["shape_enc"]["linear3"]["kernel"] *= 0.02
    vd = random_variables(flax_shapes(netD, jnp.asarray(imgs[..., :nc])), seed=1)
    opt_e, opt_d = make_optimizer_e(beta1=opt.beta1), make_optimizer_d(beta1=opt.beta1)
    as_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    pe, se, pd = as_jax(ve["params"]), as_jax(ve["batch_stats"]), as_jax(vd["params"])
    state = JTrainState(
        params_e=pe, stats_e=se, params_d=pd, opt_state_e=opt_e.init(pe),
        opt_state_d=opt_d.init(pd), template=jdr.vertices_init, em_step=jnp.asarray(0.1),
        swa_params=pe, swa_stats=se, swa_n=jnp.asarray(0), epoch=jnp.asarray(0),
        step=jnp.asarray(0))
    step = make_train_step(opt, jdr, netE, netD, opt_e, opt_d, lpl, donate=False,
                           steps_per_call=1)
    rng = jax.random.PRNGKey(42)
    state2, ref_metrics, ref_Xer, ref_Xir = step(state, jnp.asarray(imgs), rng, LR, LR, 1.0, 0)
    ref_metrics = as_numpy_tree(ref_metrics)

    topt = TrainOptions(imageSize=S, batchSize=B, pretrains="none", pretraint="none",
                        droprate="0,0,0", coordconv=False, image_weight=0.1,
                        **CONFIGS[config])
    trainer = build_trainer(topt, device="cpu")
    load_flax_variables(trainer.state.netE, ve["params"], ve["batch_stats"])
    load_flax_variables(trainer.state.netD, vd["params"])
    before = {"netE": {k: v.clone() for k, v in trainer.state.netE.state_dict().items()},
              "netD": {k: v.clone() for k, v in trainer.state.netD.state_dict().items()}}
    draws = {**_draws(opt, rng), **(_hard_draws(rng) if opt.hard else {})}
    metrics, Xer, Xir = trainer.step(t(imgs), LR, LR, 1.0, 0, draws=draws)

    assert set(metrics) == set(METRIC_KEYS)
    for key in ref_metrics:
        a, b = float(ref_metrics[key]), float(metrics[key])
        tol = 1e-2 if key in ("gnormE", "gnormD") else 1e-3
        assert np.isfinite(b) and abs(a - b) <= tol * abs(a), (key, a, b)
    assert float(metrics["skipE"]) == float(metrics["skipD"]) == 0.0
    assert float(metrics["dropped_faces"]) == float(metrics["dropped_tex_chunks"]) == 0.0
    assert Xer.shape == Xir.shape == (B, H, W, 4)
    stats = parity.render_stats([np.asarray(ref_Xer), np.asarray(ref_Xir)], [Xer, Xir])
    tol = parity.SLICE_TOL
    assert stats["alpha_within_frac"] >= tol["frac"], stats
    assert stats["alpha_over_pixels"] <= tol["over_pixels"], stats
    assert stats["alpha_max"] <= tol["alpha_max"], stats
    assert stats["rgb_within_frac"] >= parity.TRAIN_RGB_FRAC, stats
    assert stats["rgb_max"] <= 3e-2, stats
    if config != "market":
        return
    # the recipe's step: the running statistics and the updates as
    # tests/test_torch_train_step.py holds them, and the background encoder
    # trained (through the critic: the data term composites both images on
    # white under the photo's mask); its renders show that background
    runs = (dict(netE=flax_to_state_dict(as_numpy_tree(state2.params_e),
                                         as_numpy_tree(state2.stats_e)),
                 netD=flax_to_state_dict(as_numpy_tree(state2.params_d))),
            dict(trainer=trainer, before=before), None)
    _running_statistics_match_reference(runs)
    for net in ("netE", "netD"):
        _updated_parameters_match_reference(runs, net)
    state = trainer.state.netE.state_dict()
    for key in ("bg_enc.Conv2dBlock_0.Conv_0.weight", "bg_enc.Conv2dBlock_1.Conv_0.bias"):
        assert key in runs[0]["netE"]
        assert not torch.equal(state[key], before["netE"][key]), key
    assert (Xer[..., :3][Xer[..., 3] < 1e-6] < 0.999).any()
