"""The training slice as a whole: one D-then-G step of the JAX package's
``make_train_step(steps_per_call=1)`` against the port's ``train_step`` at the
tiny configuration of tests/test_train_step.py (``pretrains = pretrainc =
pretraint = "none"``, 32^2) with dropout off, the same numpy-drawn initial
variables, the same photos, and the step's random draws recomputed here from
its key exactly as train_step.py splits it, then handed to the port.

Batch 4, not 2: in train mode the deepest BatchNorm layers of this
configuration normalise over batch x 1 x 1 samples, and with two samples a
float32 rounding difference is amplified a thousandfold from layer to layer
(1e-7 after the pyramid, 2e-2 in the texture decoder).  The shape head's
last kernel is scaled down so that no sample trips the collapse guard, whose
replacement draw cannot be reproduced across the frameworks.

Tolerances, with what was seen (float32 on both sides):
  * every metric 1e-3 relative (seen 2e-4), the gradient norms 1e-2 (seen
    5e-3 for the encoder, through BatchNorm over 4 samples; 3e-4 for the
    critic);
  * Xer and Xir by the image rule of magicmirror_torch/parity.py, the worst
    rgb value 3e-2 in place of 1e-2 (see the test);
  * the running statistics 5e-3 of each buffer's largest value (seen 1e-3);
  * the updated parameters: this is Adam's first step, whose update is
    lr * g / (|g| + 1e-8), the SIGN of the gradient wherever |g| >> 1e-8.  An
    element whose gradient is rounding noise (the biases in front of a
    BatchNorm, most of the critic at lambda_gan = 1e-4) may step either way in
    either package, so single tensors cannot be held to a fraction of their
    update.  Held instead: every tensor moves that moves in the reference, no
    element moves further than the learning rate allows, the updates of at
    least 90% of all elements agree within a tenth of the learning rate
    (seen 95%), and the median over
    tensors of the cosine between the two update vectors is above 0.95 (seen
    0.986).  The gradients themselves are held elementwise in
    tests/test_torch_encoders_train.py and the optimizer rule in
    tests/test_torch_optim.py.

This file is slow (one XLA compile of the tiny train step) and holds two test
functions on purpose: the suite runs under ``pytest -n 6 --dist loadfile``,
which hands out the files with the most tests first, so a slow file with few
tests runs beside the suite's long files and not ahead of them.
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
from magicmirror_torch.models.convert import flax_to_state_dict, load_flax_variables
from magicmirror_torch.train import METRIC_KEYS, TrainOptions, build_trainer
from torch_parity import SPHERE, as_numpy_tree, flax_shapes, n, random_variables, t

torch.set_num_threads(1)
S, B = 32, 4
LR = 1e-4


def _photos():
    rs = np.random.RandomState(0)
    imgs = rs.rand(B, S, S, 4).astype(np.float32)
    imgs[..., 3] = 0.0
    imgs[:, 8:24, 8:24, 3] = 1.0
    return imgs


def _draws(opt, rng):
    """The draws of train_step.py:164-228 and :304 from the step's key."""
    k_fwd, k_gp = jax.random.split(rng)
    ks = jax.random.split(k_fwd, 13)
    kk = jax.random.split(ks[9], 5)
    k1, k2 = jax.random.split(k_gp)
    elev_min, elev_max = (float(v) for v in opt.elev_range.split("~"))
    dist_min, dist_max = (float(v) for v in opt.dist_range.split("~"))
    u = jax.random.uniform
    return {
        "rand_a": torch.as_tensor(np.array(jax.random.permutation(ks[4], B))).long(),
        "rand_b": torch.as_tensor(np.array(jax.random.permutation(ks[5], B))).long(),
        "repl_u_a": torch.zeros(B), "repl_u_b": torch.zeros(B),  # unused: no sample is bad
        "azimuths": t(-u(ks[8], (B,), minval=-opt.azi_scope / 2, maxval=opt.azi_scope / 2)),
        "elevations": t(u(kk[0], (B,), minval=elev_min, maxval=elev_max)),
        "distances": t(u(kk[1], (B,), minval=dist_min, maxval=dist_max)),
        "biases": t(u(kk[2], (B, 2), minval=-opt.bias_range, maxval=opt.bias_range)),
        "alpha_texture": t(u(kk[3], (B, 1, 1, 1))),
        "alpha_shape": t(u(kk[4], (B, 1, 1))),
        "alpha_light": t(u(kk[4], (B, 1))),
        "gp_alpha1": t(u(k1, (B, 1, 1, 1))),
        "gp_alpha2": t(u(k2, (B, 1, 1, 1))),
    }


def _port_trainer(variables_e, variables_d):
    opt = TrainOptions(template_path=SPHERE, imageSize=S, batchSize=B, pretrains="none",
                       pretraint="none", droprate="0,0,0", coordconv=False, image_weight=0.1)
    trainer = build_trainer(opt, device="cpu")
    load_flax_variables(trainer.state.netE, variables_e["params"], variables_e["batch_stats"])
    load_flax_variables(trainer.state.netD, variables_d["params"])
    return trainer


@pytest.fixture(scope="module")
def runs():
    opt = build_parser().parse_args([])
    opt.imageSize, opt.batchSize = S, B
    opt.pretrains = opt.pretrainc = opt.pretraint = "none"
    opt.droprate = "0,0,0"
    jdr = JDiffRender(SPHERE, S, ratio=opt.ratio, init_ellipsoid=opt.ellipsoid, backend="xla")
    netE = JAttributeEncoder(
        num_vertices=jdr.num_vertices, azi_scope=opt.azi_scope, elev_range=opt.elev_range,
        dist_range=opt.dist_range, nc=4, nk=opt.nk, nf=opt.nf, ratio=opt.ratio,
        pretraint=opt.pretraint, pretrainc=opt.pretrainc, pretrains=opt.pretrains,
        droprate=opt.droprate, norm=opt.norm)
    netD = JDiscriminator(nc=3, nf=16)
    lpl = jdr.vertices_laplacian_matrix
    imgs = _photos()
    ve = random_variables(flax_shapes(netE, jnp.asarray(imgs), jdr.vertices_init, lpl,
                                      train=False), seed=0)
    ve["params"]["shape_enc"]["linear3"]["kernel"] *= 0.02
    vd = random_variables(flax_shapes(netD, jnp.asarray(imgs[..., :3])), seed=1)
    opt_e, opt_d = make_optimizer_e(), make_optimizer_d()
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
    state2, metrics, Xer, Xir = step(state, jnp.asarray(imgs), rng, LR, LR, 1.0, 0)
    ref = dict(metrics=as_numpy_tree(metrics), Xer=np.asarray(Xer), Xir=np.asarray(Xir),
               netE=flax_to_state_dict(as_numpy_tree(state2.params_e),
                                       as_numpy_tree(state2.stats_e)),
               netD=flax_to_state_dict(as_numpy_tree(state2.params_d)))

    trainer = _port_trainer(ve, vd)
    before = {"netE": {k: v.clone() for k, v in trainer.state.netE.state_dict().items()},
              "netD": {k: v.clone() for k, v in trainer.state.netD.state_dict().items()}}
    metrics, Xer, Xir = trainer.step(t(imgs), LR, LR, 1.0, 0, draws=_draws(opt, rng))
    ours = dict(metrics=metrics, Xer=Xer, Xir=Xir, trainer=trainer, before=before)
    return ref, ours, (ve, vd, opt, rng)


def test_one_step_matches_reference(runs):
    """Metrics, renders, running statistics, updated parameters and counters
    of one step, in one test function (see the note on the file's two tests
    below)."""
    _metrics_match_reference(runs)
    _renders_match_reference(runs)
    _running_statistics_match_reference(runs)
    for net in ("netE", "netD"):
        _updated_parameters_match_reference(runs, net)
    _state_counts_the_step(runs)


def test_non_finite_gradients_skip_exactly_one_side(runs):
    _non_finite_critic_gradient_skips_only_the_critic(runs)
    _non_finite_encoder_gradient_skips_only_the_encoder(runs)
    _critic_takes_no_gradient_from_the_encoder_loss(runs)


def _metrics_match_reference(runs):
    ref, ours, _ = runs
    assert set(ours["metrics"]) == set(METRIC_KEYS)
    # the golden XLA path has no capacity to overflow and reports no drops
    assert set(METRIC_KEYS) - set(ref["metrics"]) == {"dropped_faces", "dropped_tex_chunks"}
    assert float(ours["metrics"]["dropped_faces"]) == 0.0
    assert float(ours["metrics"]["dropped_tex_chunks"]) == 0.0
    for key in ref["metrics"]:
        a, b = float(ref["metrics"][key]), float(ours["metrics"][key])
        tol = 1e-2 if key in ("gnormE", "gnormD") else 1e-3
        assert np.isfinite(b) and abs(a - b) <= tol * abs(a), (key, a, b)
    assert float(ours["metrics"]["skipE"]) == float(ours["metrics"]["skipD"]) == 0.0


def _renders_match_reference(runs):
    ref, ours, _ = runs
    assert ours["Xer"].shape == ours["Xir"].shape == (B, S, S, 4)
    assert not ours["Xer"].requires_grad
    stats = parity.render_stats([ref["Xer"], ref["Xir"]], [ours["Xer"], ours["Xir"]])
    tol = parity.SLICE_TOL
    for channel in ("alpha", "rgb"):
        assert stats[f"{channel}_within_frac"] >= tol["frac"], stats
        assert stats[f"{channel}_over_pixels"] <= tol["over_pixels"], stats
    assert stats["alpha_max"] <= tol["alpha_max"], stats
    # the worst rgb: 3e-2 here, where the serving rule caps 1e-2 (seen 1.7e-2 on 4 pixels:
    # the train-mode texture flow carries the BatchNorm-over-4-samples noise, and a 32^2
    # pixel spans 8 texels of a random texture)
    assert stats["rgb_max"] <= 3e-2, stats


def _running_statistics_match_reference(runs):
    ref, ours, _ = runs
    state = ours["trainer"].state.netE.state_dict()
    keys = [k for k in ref["netE"] if "running" in k]
    assert len(keys) > 200
    for key in keys:
        err = np.abs(n(state[key]) - ref["netE"][key]).max()
        assert err <= 5e-3 * np.abs(ref["netE"][key]).max(), (key, err)
        assert not torch.equal(state[key], ours["before"]["netE"][key]), key


def _updated_parameters_match_reference(runs, net):
    ref, ours, _ = runs
    state = getattr(ours["trainer"].state, net).state_dict()
    agree = total = 0
    cosines = []
    for key, r in ref[net].items():
        if "running" in key:
            continue
        start = n(ours["before"][net][key])
        ref_update, update = (r - start).ravel(), (n(state[key]) - start).ravel()
        assert (np.abs(update).max() > 0) == (np.abs(ref_update).max() > 0), key
        assert np.abs(update).max() <= LR * (1 + 1e-3) + np.spacing(np.abs(start).max()), key
        agree += int((np.abs(update - ref_update) <= 0.1 * LR).sum())
        total += update.size
        cosines.append(float(update @ ref_update)
                       / (np.linalg.norm(update) * np.linalg.norm(ref_update) + 1e-30))
    assert agree >= 0.9 * total, agree / total
    assert np.median(cosines) >= 0.95, np.median(cosines)


def _state_counts_the_step(runs):
    _, ours, _ = runs
    state = ours["trainer"].state
    assert state.step == 1
    assert [g["count"] for g in state.opt_e.param_groups] == [1, 1]
    assert state.opt_d.param_groups[0]["count"] == 1
    assert all(p.grad is None or torch.isfinite(p.grad).all() for p in state.netD.parameters())


def _snapshot(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def _same(module, snapshot):
    return all(torch.equal(v, snapshot[k]) for k, v in module.state_dict().items()
               if "num_batches_tracked" not in k)


def _non_finite_critic_gradient_skips_only_the_critic(runs):
    _, _, (ve, vd, opt, rng) = runs
    trainer = _port_trainer(ve, vd)
    e0, d0 = _snapshot(trainer.state.netE), _snapshot(trainer.state.netD)
    draws = _draws(opt, rng)
    draws["gp_alpha1"] = torch.full_like(draws["gp_alpha1"], float("nan"))
    metrics, _, _ = trainer.step(t(_photos()), LR, LR, 1.0, 0, draws=draws)
    assert float(metrics["skipD"]) == 1.0 and float(metrics["skipE"]) == 0.0
    assert not np.isfinite(float(metrics["gnormD"])) and np.isfinite(float(metrics["gnormE"]))
    assert _same(trainer.state.netD, d0) and not trainer.state.opt_d.state
    assert not _same(trainer.state.netE, e0) and trainer.state.opt_e.state


def _non_finite_encoder_gradient_skips_only_the_encoder(runs):
    _, _, (ve, vd, opt, rng) = runs
    trainer = _port_trainer(ve, vd)
    e0, d0 = _snapshot(trainer.state.netE), _snapshot(trainer.state.netD)
    weight = trainer.state.netE.light_enc.Dense_0.weight
    hook = weight.register_hook(lambda g: g * float("nan"))
    metrics, _, _ = trainer.step(t(_photos()), LR, LR, 1.0, 0, draws=_draws(opt, rng))
    hook.remove()
    assert float(metrics["skipE"]) == 1.0 and float(metrics["skipD"]) == 0.0
    # parameters, optimizer state AND the BatchNorm running statistics are as before
    assert _same(trainer.state.netE, e0) and not trainer.state.opt_e.state
    assert not _same(trainer.state.netD, d0) and trainer.state.opt_d.state
    assert all(np.isfinite(float(metrics[k])) for k in METRIC_KEYS if k != "gnormE")
    # and the next step trains again
    metrics, _, _ = trainer.step(t(_photos()), LR, LR, 1.0, 0, draws=_draws(opt, rng))
    assert float(metrics["skipE"]) == 0.0 and not _same(trainer.state.netE, e0)


def _critic_takes_no_gradient_from_the_encoder_loss(runs):
    """After a step the critic's gradients are those of the D loss alone."""
    _, _, (ve, vd, opt, rng) = runs
    trainer = _port_trainer(ve, vd)
    trainer.step(t(_photos()), LR, LR, 1.0, 0, draws=_draws(opt, rng))
    d_grads = [p.grad.clone() for p in trainer.state.netD.parameters()]
    twin = _port_trainer(ve, vd)
    twin.opt.lambda_data = twin.opt.lambda_reg = twin.opt.lambda_flipz = 0.0  # another E loss
    twin.step(t(_photos()), LR, LR, 1.0, 0, draws=_draws(opt, rng))
    for a, b in zip(d_grads, twin.state.netD.parameters()):
        assert torch.equal(a, b.grad)
    assert all(p.requires_grad for p in trainer.state.netD.parameters())
