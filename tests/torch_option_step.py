"""Shared parts of the whole-step parity tests under the off-default
options (tests/test_torch_option_step_a.py, _b.py): one D-then-G step of the
JAX package's ``make_train_step(steps_per_call=1)`` and of the port's
``train_step`` at the tiny configuration of tests/test_torch_train_step.py,
on the same numpy-drawn variables, photos and draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from magicmirror_torch import parity

from magicmirror.configs.flags import build_parser
from magicmirror.render.renderer import DiffRender as JDiffRender
from magicmirror.train.optim import make_optimizer_d, make_optimizer_e
from magicmirror.train.state import TrainState as JTrainState
from magicmirror.train.train_step import make_train_step
from magicmirror.train.trainer import build_models as jbuild_models
from magicmirror_torch.models.attribute_encoder import make_inv_preconditioner
from magicmirror_torch.models.convert import flax_to_state_dict, load_flax_variables
from magicmirror_torch.train import TrainOptions, build_trainer
from test_torch_train_step import B, LR, _draws
from torch_parity import SPHERE, as_numpy_tree, flax_shapes, n, random_variables, t

# The makeup refinement's last conv (kaiming at init) is scaled down so that
# the refined texture stays inside [0, 1]: at its init scale three texels in
# four sit past the clip, the texture map is nearly the photos' flat border
# (the flow saturates), and a float32 difference of the flow flips texels on
# and off the clip and moves the InstanceNorm statistics of the whole map
# (seen: gnormE 10% apart from the JAX package's; the port against itself in
# float64 at b4/128^2, on white-composited photos: 21.5% of the texels 1e-3
# apart).  The refinement's
# gradient with the clip engaged is held by itself in
# tests/test_torch_encoder_options.py.
REFINEMENT_SCALE = 0.02


def option_draws(opt, rng, num_faces):
    """``_draws`` plus the draws of dis2 and lambda_lc, from the step's key."""
    draws = _draws(opt, rng)
    ks = jax.random.split(jax.random.split(rng)[0], 13)
    if opt.dis2 > 0:
        k_er = jax.random.split(ks[11])[0]
        draws["erase_u"] = torch.stack([t(jax.random.uniform(k, (B,)))
                                        for k in jax.random.split(k_er, 4)])
    if opt.lambda_lc > 0:
        draws["lc_idx"] = torch.as_tensor(np.array(jax.random.choice(
            ks[12], num_faces, (64,), replace=False))).long()
    return draws


def photos(size):
    """tests/test_torch_train_step.py's photos at ``size``^2: uniform noise
    RGB, the middle half of the image covered."""
    rs = np.random.RandomState(0)
    imgs = rs.rand(B, size, size, 4).astype(np.float32)
    imgs[..., 3] = 0.0
    imgs[:, size // 4:3 * size // 4, size // 4:3 * size // 4, 3] = 1.0
    return imgs


def jax_variables(opt, jdr, netE, netD, imgs):
    """Random variables of both networks, the landmark head's initialised
    through ``landmark_loss`` as create_train_state does."""
    lpl = jdr.vertices_laplacian_matrix
    shapes = dict(flax_shapes(netE, jnp.asarray(imgs), jdr.vertices_init, lpl, train=False))
    if opt.lambda_lc > 0:
        S = imgs.shape[1]
        head = flax_shapes(netE, jnp.zeros((B, S // 4, S // 4, 256)),
                           jnp.zeros((B, jdr.num_faces, 2)), jnp.ones((B, jdr.num_faces)),
                           jnp.arange(64), method="landmark_loss")
        shapes = {c: {**dict(shapes.get(c, {})), **dict(head.get(c, {}))}
                  for c in ("params", "batch_stats")}
    ve = random_variables(shapes, seed=0)
    ve["params"]["shape_enc"]["linear3"]["kernel"] *= 0.02
    if opt.makeup in (1, 2, 3, 4):  # the refinement's last conv: see refinement_scale
        last = max((k for k in ve["params"]["texture_enc"] if k.startswith("Conv2dBlock_")),
                   key=lambda k: int(k.split("_")[1]))
        for leaf in ("kernel", "bias"):
            ve["params"]["texture_enc"][last]["Conv_0"][leaf] *= REFINEMENT_SCALE
    vd = random_variables(flax_shapes(netD, jnp.asarray(imgs[..., :3])), seed=1)
    return ve, vd


def run_step(options, Va=None, jax_reference=True, S=32):
    """(reference, ours, (variables, opt, rng)) of one step under ``options``
    at S^2; without ``jax_reference`` the port's step alone (reference
    None)."""
    opt = build_parser().parse_args([])
    opt.imageSize, opt.batchSize = S, B
    opt.pretrains = opt.pretrainc = opt.pretraint = "none"
    opt.droprate, opt.coordconv = "0,0,0", False
    for k, v in options.items():
        setattr(opt, k, v)
    jdr = JDiffRender(SPHERE, S, ratio=opt.ratio, init_ellipsoid=opt.ellipsoid, backend="xla")
    netE, netD = jbuild_models(opt, jdr)
    lpl = jdr.vertices_laplacian_matrix
    imgs = photos(S)
    ve, vd = jax_variables(opt, jdr, netE, netD, imgs)
    opt_e = make_optimizer_e(adamw=opt.adamw, beta1=opt.beta1, wd=opt.wd, amsgrad=opt.amsgrad)
    opt_d = make_optimizer_d(beta1=opt.beta1, wd=opt.wd, amsgrad=opt.amsgrad)
    as_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    pe, se, pd = as_jax(ve["params"]), as_jax(ve["batch_stats"]), as_jax(vd["params"])
    state = JTrainState(
        params_e=pe, stats_e=se, params_d=pd, opt_state_e=opt_e.init(pe),
        opt_state_d=opt_d.init(pd), template=jdr.vertices_init, em_step=jnp.asarray(0.1),
        swa_params=pe, swa_stats=se, swa_n=jnp.asarray(0), epoch=jnp.asarray(0),
        step=jnp.asarray(0))
    precond_M = (jnp.asarray(make_inv_preconditioner(np.asarray(lpl), opt.inv))
                 if opt.inv > 0 else None)
    ref = None
    rng = jax.random.PRNGKey(42)
    if jax_reference:
        step = make_train_step(opt, jdr, netE, netD, opt_e, opt_d, lpl, precond_M=precond_M,
                               donate=False, steps_per_call=1)
        jVa = None if Va is None else jnp.asarray(Va)
        state2, metrics, Xer, Xir = step(state, jnp.asarray(imgs), rng, LR, LR, 1.0, 0, jVa)
        ref = dict(metrics=as_numpy_tree(metrics), Xer=np.asarray(Xer), Xir=np.asarray(Xir),
                   netE=flax_to_state_dict(as_numpy_tree(state2.params_e),
                                           as_numpy_tree(state2.stats_e)),
                   netD=flax_to_state_dict(as_numpy_tree(state2.params_d)))

    topt = TrainOptions(template_path=SPHERE, imageSize=S, batchSize=B, pretrains="none",
                        pretraint="none", droprate="0,0,0", coordconv=False,
                        image_weight=0.1, **options)
    trainer = build_trainer(topt, device="cpu")
    load_flax_variables(trainer.state.netE, ve["params"], ve["batch_stats"])
    load_flax_variables(trainer.state.netD, vd["params"])
    before = {"netE": {k: v.clone() for k, v in trainer.state.netE.state_dict().items()},
              "netD": {k: v.clone() for k, v in trainer.state.netD.state_dict().items()}}
    draws = option_draws(opt, rng, jdr.num_faces)
    metrics, Xer, Xir = trainer.step(t(imgs), LR, LR, 1.0, 0, draws=draws,
                                     Va=None if Va is None else t(Va))
    ours = dict(metrics=metrics, Xer=Xer, Xir=Xir, trainer=trainer, before=before)
    return ref, ours, (ve, vd, opt, rng)


def running_statistics_match(runs, tol=5e-3):
    ref, ours, _ = runs
    state = ours["trainer"].state.netE.state_dict()
    keys = [k for k in ref["netE"] if "running" in k]
    assert keys
    for key in keys:
        err = np.abs(n(state[key]) - ref["netE"][key]).max()
        assert err <= tol * np.abs(ref["netE"][key]).max(), (key, err)
    return keys


def noise_gradient_keys(module):
    """The parameters whose gradient is rounding noise: the bias of a conv
    in front of an InstanceNorm or an IBN (each normalises away every
    channel's mean) and of a Dense in front of a BatchNorm (the landmark
    head's, a LinearBlock's).  Their first Adam step is a coin flip in
    either package."""
    keys = set()
    for name, m in module.named_modules():
        if getattr(m, "norm", None) in ("InstanceNorm_0", "IBN_0"):
            keys.add(f"{name}.Conv_0.bias")
        if name.endswith("landmark_cls") or type(m).__name__ == "LinearBlock":
            keys.add(f"{name}.Dense_0.bias")
    return keys


def updated_parameters_match(runs, net, lr, cosine=0.95):
    """tests/test_torch_train_step.py's rule for the updated parameters (each
    tensor moves where the reference's does, no element further than the
    learning rate, 90% of the elements within a tenth of it), with the median
    cosine between the two update vectors (``cosine``) taken over the tensors
    whose gradient is not rounding noise (``noise_gradient_keys``) -> that
    median."""
    ref, ours, _ = runs
    module = getattr(ours["trainer"].state, net)
    state = module.state_dict()
    noise = noise_gradient_keys(module)
    agree = total = 0
    cosines = []
    for key, r in ref[net].items():
        if "running" in key:
            continue
        start = n(ours["before"][net][key])
        ref_update, update = (r - start).ravel(), (n(state[key]) - start).ravel()
        assert (np.abs(update).max() > 0) == (np.abs(ref_update).max() > 0), key
        assert np.abs(update).max() <= lr * (1 + 1e-3) + np.spacing(np.abs(start).max()), key
        agree += int((np.abs(update - ref_update) <= 0.1 * lr).sum())
        total += update.size
        if key not in noise:
            cosines.append(float(update @ ref_update)
                           / (np.linalg.norm(update) * np.linalg.norm(ref_update) + 1e-30))
    assert agree >= 0.9 * total, agree / total
    assert np.median(cosines) >= cosine, np.median(cosines)
    return float(np.median(cosines))


def renders_match(runs):
    """tests/test_torch_train_step.py's rule for Xer and Xir at any size:
    the slice rule of magicmirror_torch/parity.py (99.5% of each image's
    pixels within 1e-3, at most 64 beyond), the worst rgb value 3e-2."""
    ref, ours, _ = runs
    assert ours["Xer"].shape == ours["Xir"].shape == ref["Xer"].shape
    assert not ours["Xer"].requires_grad
    stats = parity.render_stats([ref["Xer"], ref["Xir"]], [ours["Xer"], ours["Xir"]])
    tol = parity.SLICE_TOL
    for channel in ("alpha", "rgb"):
        assert stats[f"{channel}_within_frac"] >= tol["frac"], stats
        assert stats[f"{channel}_over_pixels"] <= tol["over_pixels"], stats
    assert stats["alpha_max"] <= tol["alpha_max"], stats
    assert stats["rgb_max"] <= 3e-2, stats
    return stats
