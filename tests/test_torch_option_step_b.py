"""One D-then-G step under the second set of options, the JAX package's
``make_train_step(steps_per_call=1)`` against the port's ``train_step`` at
the tiny configuration of tests/test_torch_train_step.py (32^2, batch 4,
dropout off), the same numpy-drawn variables, photos and draws: ``--norm ln
--makeup 5 --sn_dis 1 --adamw`` without ``--amsgrad`` (``--wd 1e-4``) and
``--hmr 1`` with a body mesh for each photo (the sphere's vertices under a
seeded jitter).  The critic is the spectral-norm one under the WGAN losses,
the encoder's optimizer optax ``adamw``, the critic's ``adam`` after the
chained weight decay.

The rules of tests/test_torch_train_step.py (its helpers), with what was
seen here: every metric 1e-3 relative (seen 1.1e-4), the gradient norms
1e-2 (seen 1.7e-6); the renders by its image rule (seen every pixel within
1e-3, the worst rgb 5.3e-4); the updated parameters by agreement share and
cosine (Adam's first step is a sign, AdamW's decay adds lr * wd * p; the
median cosine 1.0 for the encoder, 0.9999 for the critic); the running
statistics 5e-3 of each buffer's largest value (seen 3.8e-6).  One XLA
compile, shared by the file's two test functions through a module fixture.
"""
import numpy as np
import pytest
import torch

from magicmirror_torch.models.discriminators import SNDiscriminator
from test_torch_train_step import LR, B, _metrics_match_reference, _renders_match_reference
from torch_option_step import run_step, running_statistics_match, updated_parameters_match
from torch_parity import sphere_template

torch.set_num_threads(1)
OPTIONS = dict(norm="ln", makeup=5, sn_dis=1, adamw=True, amsgrad=False, wd=1e-4, hmr=1.0)


def body_meshes():
    v, _ = sphere_template()
    rs = np.random.RandomState(5)
    return (v[None] * rs.uniform(0.9, 1.1, (B, 1, 3))
            + 0.02 * rs.randn(B, *v.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    return run_step(OPTIONS, Va=body_meshes())


def test_step_under_the_norm_critic_and_optimizer_options(runs):
    ref, ours, _ = runs
    trainer = ours["trainer"]
    assert isinstance(trainer.state.netD, SNDiscriminator)
    assert all(g["decoupled"] for g in trainer.state.opt_e.param_groups)
    assert not any(g["amsgrad"] or g["decoupled"] for g in trainer.state.opt_d.param_groups)
    _metrics_match_reference(runs)
    _renders_match_reference(runs)
    running_statistics_match(runs)
    for net in ("netE", "netD"):
        updated_parameters_match(runs, net, LR)


def test_the_body_mesh_enters_the_reconstruction_loss(runs):
    """The chamfer to the body meshes is part of lossR_data: the same step
    without them reports less."""
    ref, ours, (ve, vd, opt, rng) = runs
    plain_ref, plain, _ = run_step(dict(OPTIONS, hmr=0.0), jax_reference=False)
    assert float(ours["metrics"]["lossR_data"]) > float(plain["metrics"]["lossR_data"])
    assert plain_ref is None
