"""The critic and loss options, the port against the JAX package on the
same numpy-drawn variables and inputs: the multi-scale LSGAN critic
(``--gan_type lsgan``) with its per-scale gradient penalty and losses, the
spectral-norm critic (``--sn_dis``), the landmark-consistency head
(``--lambda_lc``), the random erase of ``--dis2`` given its uniforms, and
AdamW without AMSGrad (``--adamw``) against optax.

Tolerances, with what was seen (float32 on both sides): critic outputs
1e-4 of their largest value; gradients (input and parameters) 1e-4 of each
tensor's largest value (of a thousandth of the module's largest gradient for
the landmark head's bias in front of its BatchNorm, whose gradient is
rounding noise); the penalties and losses 1e-5 relative; the
landmark head's loss 1e-5 relative, its running statistics 1e-5 of each
buffer's largest value; the erased images exactly; AdamW's parameters
after three steps within 1e-6 of the largest update plus one float32 ulp
of the parameter (tests/test_torch_optim.py's rule for Adam).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.losses import gan as jgan
from magicmirror.models import discriminators as jd
from magicmirror.train import optim as joptim
from magicmirror_torch.losses import gan as tgan
from magicmirror_torch.models import discriminators as td
from magicmirror_torch.models.convert import flax_to_state_dict, load_flax_variables
from magicmirror_torch.train import optim
from torch_parity import assert_stats, flax_shapes, n, random_variables, t

# the modules, not the train_step functions the packages export under that name
jstep = importlib.import_module("magicmirror.train.train_step")
tstep = importlib.import_module("magicmirror_torch.train.train_step")
torch.set_num_threads(1)
TOL = 1e-4


def _close(out, ref, tol=TOL, floor=1e-12):
    ref = np.asarray(ref)
    assert n(out).shape == ref.shape, (n(out).shape, ref.shape)
    assert np.abs(n(out) - ref).max() <= tol * max(np.abs(ref).max(), floor)


def _param_grads(module, variables_grad):
    """The port's parameter gradients against the JAX ones, by torch key;
    each tensor to TOL of its largest value, or of a thousandth of the
    module's largest gradient where that is larger (the bias in front of a
    BatchNorm has a gradient of rounding noise, ~1e-9 here)."""
    ref = flax_to_state_dict(jax.device_get(variables_grad))
    # a parameter the loss does not reach (a bias, under a gradient penalty)
    # has no gradient here and a zero one in JAX
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in module.named_parameters()}
    assert set(ref) == set(got), set(ref) ^ set(got)
    floor = 1e-3 * max(np.abs(r).max() for r in ref.values())
    for key, r in ref.items():
        _close(got[key], r, floor=floor)


CRITICS = {
    "msd": (lambda: jd.MSDiscriminator(nc=3, nf=16), lambda: td.MSDiscriminator(nc=3, nf=16),
            32),
    "sn_128": (lambda: jd.SNDiscriminator(nc=3, imsize=128),
               lambda: td.SNDiscriminator(nc=3, imsize=128), 128),
    "sn_32": (lambda: jd.SNDiscriminator(nc=3, ndf=16, imsize=32),
              lambda: td.SNDiscriminator(nc=3, ndf=16, imsize=32), 32),
}


@pytest.mark.parametrize("name", sorted(CRITICS))
def test_critic_forward_and_gradients(name):
    make_j, make_t, size = CRITICS[name]
    rs = np.random.RandomState(len(name))
    x = rs.rand(2, size, size, 3).astype(np.float32)
    jD, D = make_j(), make_t()
    variables = random_variables(flax_shapes(jD, jnp.asarray(x)), seed=len(name))
    load_flax_variables(D, variables["params"])
    ref = jax.jit(jD.apply)(variables, jnp.asarray(x))
    refs = ref if isinstance(ref, list) else [ref]
    cots = [rs.randn(*np.shape(r)).astype(np.float32) for r in refs]

    def f(params, xj):
        out = jD.apply({"params": params}, xj)
        out = out if isinstance(out, list) else [out]
        return sum(jnp.sum(o * c) for o, c in zip(out, cots))

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(variables["params"], jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    out = D(xt)
    outs = out if isinstance(out, list) else [out]
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        _close(o, r)
    sum((o * t(c)).sum() for o, c in zip(outs, cots)).backward()
    _close(xt.grad, gx)
    _param_grads(D, gp)


def test_spectral_sigma_is_the_stateless_power_iteration():
    """Five steps from the fixed start, anew at every call (torch's
    spectral_norm keeps u and steps once), the gradient through u^T W v."""
    w = np.random.RandomState(3).randn(8, 27).astype(np.float32)
    ref, gref = jax.value_and_grad(jd._spectral_sigma)(jnp.asarray(w))
    wt = t(w).requires_grad_(True)
    sigma = td.spectral_sigma(wt)
    assert abs(sigma.item() - float(ref)) <= 1e-5 * float(ref)
    sigma.backward()
    _close(wt.grad, gref, 1e-5)
    assert torch.equal(td.spectral_sigma(wt.detach()), td.spectral_sigma(wt.detach()))


def test_landmark_head_loss_gradients_and_statistics():
    rs = np.random.RandomState(4)
    B, F_, S = 3, 40, 16
    feat = rs.randn(B, 8, 8, 32).astype(np.float32)
    lm = rs.uniform(-1.1, 1.1, (B, F_, 2)).astype(np.float32)
    vis = (rs.rand(B, F_) > 0.3).astype(np.float32)
    sidx = rs.permutation(F_)[:S].astype(np.int32)
    jm = jd.LandmarkConsistency(num_landmarks=F_, dim_feat=32)
    args = (jnp.asarray(feat), jnp.asarray(lm), jnp.asarray(vis), jnp.asarray(sidx))
    variables = random_variables(flax_shapes(jm, *args), seed=5)

    def f(params, fj, lj):
        return jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                        fj, lj, args[2], args[3], mutable=["batch_stats"])

    (ref, mut), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        variables["params"], args[0], args[1])
    module = load_flax_variables(td.LandmarkConsistency(F_, 32), variables["params"],
                                 variables["batch_stats"]).eval()  # the batch's stats anyway
    ft, lt = t(feat).requires_grad_(True), t(lm).requires_grad_(True)
    loss = module(ft, lt, t(vis), torch.as_tensor(sidx).long())
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    loss.backward()
    _param_grads(module, grads[0])
    _close(ft.grad, grads[1])
    _close(lt.grad, grads[2])
    assert_stats(module, flax_to_state_dict({}, jax.device_get(mut["batch_stats"])), 1e-5)
    assert not module.training


def test_lsgan_penalty_and_losses():
    rs = np.random.RandomState(6)
    B = 2
    real, fake = (rs.rand(B, 32, 32, 3).astype(np.float32) for _ in range(2))
    jD = jd.MSDiscriminator(nc=3, nf=16)
    variables = random_variables(flax_shapes(jD, jnp.asarray(real)), seed=7)
    D = load_flax_variables(td.MSDiscriminator(nc=3, nf=16), variables["params"])
    key = jax.random.PRNGKey(8)
    alpha = np.asarray(jax.random.uniform(key, (B, 1, 1, 1)))

    def gp_fn(params):
        return jgan.gradient_penalty_list(lambda x: jD.apply({"params": params}, x),
                                          jnp.asarray(real), jnp.asarray(fake), key)

    ref, gref = jax.jit(jax.value_and_grad(gp_fn))(variables["params"])
    gp = tgan.gradient_penalty_list(D, t(real), t(fake), t(alpha))
    assert abs(float(gp) - float(ref)) <= 1e-5 * abs(float(ref))
    gp.backward()
    _param_grads(D, gref)

    outs = [[rs.randn(B, s, s, 1).astype(np.float32) for s in (4, 2, 1)] for _ in range(3)]
    touts = [[t(o) for o in group] for group in outs]
    ref = jgan.d_loss_lsgan(*outs, 0.3, 1e-4, 2.0, 10.0)
    ours = tgan.d_loss_lsgan(*touts, 0.3, 1e-4, 2.0, 10.0)
    for a, b in zip(ours, ref):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    ref = jgan.g_loss_lsgan(outs[1], outs[2], 1e-4, 2.0)
    assert abs(float(tgan.g_loss_lsgan(touts[1], touts[2], 1e-4, 2.0)) - float(ref)) <= (
        1e-5 * abs(float(ref)))


def test_random_erase_given_its_uniforms():
    x = np.random.RandomState(9).rand(6, 24, 20, 4).astype(np.float32) + 0.1
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jstep._random_erase(key, jnp.asarray(x)))
        u = torch.stack([t(jax.random.uniform(k, (6,))) for k in jax.random.split(key, 4)])
        out = n(tstep._random_erase(t(x), u))
        np.testing.assert_array_equal(out, ref)
        erased = (out == 0).all(-1)
        assert erased.any(axis=(1, 2)).all() and (~erased).any(axis=(1, 2)).all()


def test_adamw_without_amsgrad_follows_optax():
    """flatten_groupscale(optax.adamw) with the backbone's 0.05 group: the
    decoupled decay lr * scale * wd * p from the parameter before the step,
    over three steps with a change of the learning rate."""
    rs = np.random.RandomState(10)
    f = np.float32
    params = {"shape_enc": {"backbone": {"w": rs.randn(4, 3).astype(f)},
                            "head": rs.randn(5).astype(f)},
              "camera_enc": {"w": rs.randn(2, 2).astype(f)}}
    grads = [jax.tree_util.tree_map(lambda p: (s * rs.randn(*p.shape)).astype(f), params)
             for s in (1.0, 0.1, 3.0)]
    lrs = (1e-2, 1e-2, 2.5e-3)
    jopt = joptim.make_optimizer_e(adamw=True, amsgrad=False, wd=0.5)
    state, ref = jopt.init(params), params
    for g, lr in zip(grads, lrs):
        upd, state = jopt.update(g, state, ref)
        ref = joptim.apply_updates_scaled(ref, upd, lr)

    net = torch.nn.Module()
    net.shape_enc = torch.nn.Module()
    net.shape_enc.backbone = torch.nn.Module()
    net.shape_enc.backbone.w = torch.nn.Parameter(t(params["shape_enc"]["backbone"]["w"]))
    net.shape_enc.head = torch.nn.Parameter(t(params["shape_enc"]["head"]))
    net.camera_enc = torch.nn.Module()
    net.camera_enc.w = torch.nn.Parameter(t(params["camera_enc"]["w"]))
    opt = optim.make_optimizer_e(net, wd=0.5, amsgrad=False, adamw=True)
    assert all(g["decoupled"] and not g["amsgrad"] for g in opt.param_groups)
    tensors = {"shape_enc": {"backbone": {"w": net.shape_enc.backbone.w},
                             "head": net.shape_enc.head},
               "camera_enc": {"w": net.camera_enc.w}}
    for g, lr in zip(grads, lrs):
        for p, gp in zip(jax.tree_util.tree_leaves(tensors), jax.tree_util.tree_leaves(g)):
            p.grad = t(gp)
        opt.set_lr(lr)
        opt.step()
    for (path, r), o, s in zip(jax.tree_util.tree_leaves_with_path(ref),
                               jax.tree_util.tree_leaves(tensors),
                               jax.tree_util.tree_leaves(params)):
        scale = np.abs(np.asarray(r) - s).max()
        ulp = np.spacing(np.abs(np.asarray(r))).max()
        assert np.abs(n(o) - np.asarray(r)).max() <= 1e-6 * scale + ulp, path
    with pytest.raises(ValueError, match="amsgrad"):
        optim.Amsgrad(net.parameters(), amsgrad=True, decoupled=True)
