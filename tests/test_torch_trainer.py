"""The port's training entry points without a JAX twin: ``TrainOptions``
against the flag defaults, the options that still raise, the random draws'
distributions, the helpers of the step and the train state's round trip, at
the tiny model.  The CPU smoke of the default model is in
tests/test_torch_trainer_smoke.py.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from magicmirror.configs.flags import build_parser
from magicmirror.train import train_step as jstep
from magicmirror_torch import kernels
from magicmirror_torch.train import METRIC_KEYS, TrainOptions, build_trainer, sample_draws
from magicmirror_torch.train.train_step import _resample_bad, _select_masks
from torch_parity import SPHERE, n, t

torch.set_num_threads(1)
S, B = 32, 2


def _photos(batch=B):
    rs = np.random.RandomState(0)
    imgs = rs.rand(batch, S, S, 4).astype(np.float32)
    imgs[..., 3] = 0.0
    imgs[:, 8:24, 8:24, 3] = 1.0
    return torch.as_tensor(imgs)


def _tiny(**changes):
    fields = dict(template_path=SPHERE, imageSize=S, batchSize=B, pretrains="none",
                  pretraint="none")
    return TrainOptions(**{**fields, **changes})


def test_train_options_defaults_are_the_flag_defaults():
    opt = build_parser().parse_args([])
    for field in dataclasses.fields(TrainOptions):
        assert getattr(opt, field.name) == field.default, field.name


@pytest.mark.parametrize("change", [
    {"bg": True}, {"hard": True}, {"inv": 0.1}, {"dis1": 0.1}, {"dis2": 0.1},
    {"lambda_lc": 0.1}, {"gan_type": "lsgan"}, {"hmr": 1.0}, {"makeup": 1},
    {"soft_mode": "exact"}, {"pretrains": "res50"}, {"sn_dis": 1},
    {"adamw": True, "amsgrad": False}])
def test_options_outside_the_port_raise(change):
    with pytest.raises(NotImplementedError, match=next(iter(change))):
        build_trainer(_tiny(**change), device="cpu")


def test_tpu_workaround_flags_are_accepted_and_ignored():
    trainer = build_trainer(_tiny(steps_per_call=4, donate_state=True, band_capacity=64),
                            device="cpu")
    assert trainer.state.step == 0 and trainer.state.netD.Conv_0.weight.shape[1] == 3
    assert build_trainer(_tiny(unmask=2), device="cpu").state.netD.Conv_0.weight.shape[1] == 4


def test_build_trainer_is_seeded():
    a, b, c = (build_trainer(_tiny(manualSeed=s), device="cpu") for s in (3, 3, 4))
    for net in ("netE", "netD"):
        sa, sb, sc = (getattr(x.state, net).state_dict() for x in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert any(not torch.equal(sa[k], sc[k]) for k in sa)


def test_draws_have_the_reference_distributions():
    opt = _tiny(azi_scope=90.0, elev_range="5~25", dist_range="3~6", bias_range=0.2)
    gen = torch.Generator().manual_seed(0)
    d = sample_draws(opt, 4096, gen, "cpu")
    assert sorted(d["rand_a"].tolist()) == list(range(4096)) != d["rand_a"].tolist()
    assert not torch.equal(d["rand_a"], d["rand_b"])
    for key, lo, hi, shape in (("azimuths", -45, 45, (4096,)), ("elevations", 5, 25, (4096,)),
                               ("distances", 3, 6, (4096,)), ("biases", -0.2, 0.2, (4096, 2)),
                               ("alpha_texture", 0, 1, (4096, 1, 1, 1)),
                               ("alpha_shape", 0, 1, (4096, 1, 1)),
                               ("alpha_light", 0, 1, (4096, 1)),
                               ("gp_alpha1", 0, 1, (4096, 1, 1, 1)),
                               ("gp_alpha2", 0, 1, (4096, 1, 1, 1)),
                               ("repl_u_a", 0, 1, (4096,)), ("repl_u_b", 0, 1, (4096,))):
        x = d[key]
        assert tuple(x.shape) == shape and lo <= float(x.min()) and float(x.max()) <= hi, key
        assert abs(float(x.mean()) - (lo + hi) / 2) < 0.03 * (hi - lo), key
        assert abs(float(x.std()) - (hi - lo) / 12 ** 0.5) < 0.03 * (hi - lo), key
    again = sample_draws(opt, 4096, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(d[k], again[k]) for k in d)


def test_beta_draws_couple_texture_and_shape():
    d = sample_draws(_tiny(beta=0.5), 4096, torch.Generator().manual_seed(1), "cpu")
    torch.testing.assert_close(d["alpha_shape"].reshape(-1), 1.0 - d["alpha_texture"].reshape(-1))
    a = d["alpha_texture"].reshape(-1)
    assert abs(float(a.mean()) - 0.5) < 0.02
    assert abs(float(a.var()) - 0.125) < 0.01  # Beta(.5, .5): 1 / (4 (2 * .5 + 1))


def test_resample_bad_points_only_at_good_samples():
    perm = torch.tensor([3, 2, 1, 0, 4])
    bad = torch.tensor([False, True, False, True, False])
    u = torch.tensor([0.0, 0.99, 0.5, 0.34, 0.7])
    out = _resample_bad(u, perm, bad)
    # entries 0 and 2 point at the bad samples 3 and 1: replaced by the
    # floor(u * 3)-th of the good samples (0, 2, 4); the others stay
    assert out.tolist() == [0, 2, 2, 0, 4]
    for bad in (torch.zeros(5, dtype=torch.bool), torch.ones(5, dtype=torch.bool)):
        assert _resample_bad(u, perm, bad).tolist() == perm.tolist()


@pytest.mark.parametrize("unmask", [0, 1, 2])
def test_select_masks_match_reference(unmask):
    rs = np.random.RandomState(unmask)
    xs = [rs.rand(2, 4, 4, 4).astype(np.float32) for _ in range(3)]
    for ours, ref in zip(_select_masks(unmask, *map(t, xs)),
                         jstep._select_masks(unmask, *xs)):
        np.testing.assert_allclose(n(ours), np.asarray(ref), atol=1e-7)
    with pytest.raises(ValueError):
        _select_masks(3, *map(t, xs))


@pytest.fixture(scope="module")
def tiny_run():
    trainer = build_trainer(_tiny(), device="cpu")
    before = copy.deepcopy(trainer.state.state_dict())
    launches = dict(kernels.LAUNCHES)
    history = [trainer.step(_photos(), 3e-4, 3e-4, warm_up=w, train_shape=ts)[0]
               for w, ts in ((0.5, 0), (1.0, 2))]
    assert kernels.LAUNCHES == launches  # CPU tensors never reach a kernel
    return trainer, before, history


def test_tiny_steps_are_finite_and_move_both_networks(tiny_run):
    trainer, before, history = tiny_run
    for metrics in history:
        assert set(metrics) == set(METRIC_KEYS)
        assert all(np.isfinite(float(v)) and v.dim() == 0 and not v.requires_grad
                   for v in metrics.values())
        assert float(metrics["skipE"]) == float(metrics["skipD"]) == 0.0
    for net in ("netE", "netD"):
        now = getattr(trainer.state, net).state_dict()
        assert any(not torch.equal(now[k], before[net][k]) for k in now)
    assert trainer.state.step == 2


def test_a_frozen_branch_still_learns_from_the_re_encoding(tiny_run):
    """train_shape 2 freezes the camera encoder on the photos only: the
    re-encoding of the interpolated view always runs at train_shape 0 (as in
    the JAX step), so the interpolated-cycle loss still reaches it."""
    trainer, _, _ = tiny_run
    grads = [p.grad for p in trainer.state.netE.camera_enc.parameters()]
    assert all(g is not None for g in grads) and any(g.abs().max() > 0 for g in grads)


def test_train_state_round_trips(tiny_run):
    trainer, _, _ = tiny_run
    saved = copy.deepcopy(trainer.state.state_dict())
    twin = build_trainer(_tiny(manualSeed=9), device="cpu")
    twin.state.load_state_dict(saved)
    assert twin.state.step == 2
    draws = sample_draws(trainer.opt, B, torch.Generator().manual_seed(5), "cpu")
    for x in (trainer, twin):
        x.state.netE.set_dropout_generator(torch.Generator().manual_seed(6))
    a = trainer.step(_photos(), 1e-4, 1e-4, draws=draws)[0]
    b = twin.step(_photos(), 1e-4, 1e-4, draws=draws)[0]
    assert all(float(a[k]) == float(b[k]) for k in METRIC_KEYS)
    for net in ("netE", "netD"):
        sa, sb = (getattr(x.state, net).state_dict() for x in (trainer, twin))
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
