"""Port parity of the optimizers and the learning-rate schedules
(magicmirror_torch/train/optim.py vs magicmirror/train/optim.py).

``Amsgrad`` carries optax's rule; one and three steps of both optimizers
agree with ``make_optimizer_e`` / ``make_optimizer_d`` (tree and flat forms)
to 1e-6 of the largest update plus one float32 ulp of the parameter (an
update of 1e-3 on a parameter of 1 cannot be held closer).
``torch.optim.Adam(amsgrad=True)`` does not:
it keeps the maximum of the uncorrected second moment, and parts from optax
as soon as a gradient shrinks (the test shows 40% at the second step).
"""
import copy

import jax
import numpy as np
import pytest
import torch

from magicmirror.train import optim as joptim
from magicmirror_torch.train import optim
from torch_parity import n, t

torch.set_num_threads(1)
TOL = 1e-6


class _Net(torch.nn.Module):
    """Parameters under the names the encoder's groups are split by."""

    def __init__(self, arrays):
        super().__init__()
        self.shape_enc = torch.nn.Module()
        self.shape_enc.backbone = torch.nn.Module()
        self.shape_enc.backbone.w = torch.nn.Parameter(t(arrays["shape_enc"]["backbone"]["w"]))
        self.shape_enc.head = torch.nn.Parameter(t(arrays["shape_enc"]["head"]))
        self.camera_enc = torch.nn.Module()
        self.camera_enc.w = torch.nn.Parameter(t(arrays["camera_enc"]["w"]))


def _params(rs):
    f = np.float32
    return {"shape_enc": {"backbone": {"w": rs.randn(4, 3).astype(f)},
                          "head": rs.randn(5).astype(f)},
            "camera_enc": {"w": rs.randn(2, 2).astype(f)}}


def _grads(rs, params, scale):
    return jax.tree_util.tree_map(lambda p: (scale * rs.randn(*p.shape)).astype(np.float32),
                                  params)


def _tensors(net):
    return {"shape_enc": {"backbone": {"w": net.shape_enc.backbone.w},
                          "head": net.shape_enc.head},
            "camera_enc": {"w": net.camera_enc.w}}


def _run_reference(jopt, params, grads_per_step, lrs):
    state = jopt.init(params)
    for g, lr in zip(grads_per_step, lrs):
        upd, state = jopt.update(g, state, params)
        params = joptim.apply_updates_scaled(params, upd, lr)
    return params


def _assert_trees_close(ours, ref, start):
    for (path, r), o, s in zip(jax.tree_util.tree_leaves_with_path(ref),
                               jax.tree_util.tree_leaves(ours),
                               jax.tree_util.tree_leaves(start)):
        scale = np.abs(np.asarray(r) - s).max()
        ulp = np.spacing(np.abs(np.asarray(r))).max()  # the parameter itself rounds
        assert np.abs(n(o) - np.asarray(r)).max() <= TOL * scale + ulp, path


# gradients that shrink, then grow: the running maximum matters
_SCALES = (1.0, 0.1, 3.0)
_LRS = (1e-3, 1e-3, 2.5e-4)  # a runtime change of the learning rate


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("flat", [False, True])
def test_encoder_optimizer_matches_optax(steps, flat):
    rs = np.random.RandomState(0)
    params = _params(rs)
    grads = [_grads(rs, params, s) for s in _SCALES[:steps]]
    ref = _run_reference(joptim.make_optimizer_e(flat=flat), params, grads, _LRS)
    net = _Net(params)
    opt = optim.make_optimizer_e(net)
    assert [g["scale"] for g in opt.param_groups] == [1.0, 0.05]
    assert [len(g["params"]) for g in opt.param_groups] == [2, 1]
    for g, lr in zip(grads, _LRS):
        for p, gp in zip(jax.tree_util.tree_leaves(_tensors(net)), jax.tree_util.tree_leaves(g)):
            p.grad = t(gp)
        opt.set_lr(lr)
        opt.step()
    _assert_trees_close(_tensors(net), ref, params)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("flat", [False, True])
def test_critic_optimizer_matches_optax(steps, flat):
    rs = np.random.RandomState(1)
    params = {"Conv_0": {"kernel": rs.randn(3, 3, 2, 4).astype(np.float32)},
              "Conv_1": {"kernel": rs.randn(1, 1, 4, 1).astype(np.float32)}}
    grads = [_grads(rs, params, s) for s in _SCALES[:steps]]
    ref = _run_reference(joptim.make_optimizer_d(flat=flat), params, grads, _LRS)
    net = torch.nn.ParameterList([torch.nn.Parameter(t(a["kernel"])) for a in params.values()])
    opt = optim.make_optimizer_d(net)
    for g, lr in zip(grads, _LRS):
        for p, gp in zip(net, jax.tree_util.tree_leaves(g)):
            p.grad = t(gp)
        opt.set_lr(lr)
        opt.step()
    _assert_trees_close(list(net), ref, params)


def test_a_parameter_without_a_gradient_steps_on_its_momentum():
    """optax steps a stop_gradient'ed leaf with a zero gradient: the first
    moment decays and the parameter keeps moving; so does the port."""
    rs = np.random.RandomState(2)
    params = {"w": rs.randn(6).astype(np.float32)}
    g1 = {"w": rs.randn(6).astype(np.float32)}
    zero = {"w": np.zeros(6, np.float32)}
    ref = _run_reference(joptim.make_optimizer_d(flat=False), params, [g1, zero], (1e-3, 1e-3))
    p = torch.nn.Parameter(t(params["w"]))
    opt = optim.make_optimizer_d(torch.nn.ParameterList([p]))
    p.grad = t(g1["w"])
    opt.set_lr(1e-3)
    opt.step()
    p.grad = None
    opt.step()
    _assert_trees_close([p], ref, params)


def test_torch_adam_amsgrad_is_another_rule():
    """Why the port does not use torch.optim.Adam(amsgrad=True)."""
    rs = np.random.RandomState(3)
    params = {"w": rs.randn(8).astype(np.float32)}
    grads = [{"w": (s * rs.randn(8)).astype(np.float32)} for s in (1.0, 0.1)]
    ref = _run_reference(joptim.make_optimizer_d(flat=False), params, grads, (1e-3, 1e-3))
    p = torch.nn.Parameter(t(params["w"]))
    adam = torch.optim.Adam([p], lr=1e-3, betas=(0.5, 0.999), amsgrad=True)
    for g in grads:
        p.grad = t(g["w"])
        adam.step()
    update = np.abs(np.asarray(ref["w"]) - params["w"]).max()
    assert np.abs(n(p) - np.asarray(ref["w"])).max() > 0.05 * update


def test_optimizer_state_round_trips():
    rs = np.random.RandomState(4)
    net = _Net(_params(rs))
    opt = optim.make_optimizer_e(net)
    for p in net.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    clone = _Net(_params(np.random.RandomState(4)))
    clone.load_state_dict(net.state_dict())
    opt2 = optim.make_optimizer_e(clone)
    opt2.load_state_dict(copy.deepcopy(opt.state_dict()))  # as a checkpoint file would
    for a, b in zip(net.parameters(), clone.parameters()):
        a.grad = torch.ones_like(a)
        b.grad = torch.ones_like(b)
    opt.step()
    opt2.step()
    for a, b in zip(net.parameters(), clone.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scheduler", ["step", "restart", "restart1", "restart2", "exp",
                                       "cosine"])
def test_lr_schedule_is_exact(scheduler):
    for niter in (7, 600):
        for epoch in range(0, niter + 3, max(1, niter // 40)):
            assert optim.lr_schedule(scheduler, epoch, niter, 1e-4, 0.01) == \
                joptim.lr_schedule(scheduler, epoch, niter, 1e-4, 0.01)
