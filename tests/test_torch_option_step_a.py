"""One D-then-G step under the encoder and critic options, the JAX
package's ``make_train_step(steps_per_call=1)`` against the port's
``train_step`` at the tiny configuration of tests/test_torch_train_step.py
at 64^2 (batch 4, ``pretrains = pretraint = pretrainc = "none"``, dropout
off), the same numpy-drawn variables (the landmark head's among them),
photos and draws: ``--norm ibn --makeup 2 --nolpl --inv 0.5 --gan_type
lsgan --dis1 0.1 --dis2 0.1 --lambda_lc 0.1``.  The step's new draws are
recomputed here from its key as train_step.py splits it and handed to the
port: the erase's four uniforms (``split(split(ks[11])[0], 4)``) and the 64
faces of the landmark subset (``choice(ks[12], ..., replace=False)``, which
torch cannot reproduce).  With ``inv`` no collapsed sample is resampled.

At 64^2, not 32^2: IBN's InstanceNorm half normalises each channel over
the map, which the 'none' backbones bring down to 2 x 2 at 32^2, where a
float32 difference is amplified as BatchNorm's over a handful of samples
(at 32^2 the median cosine of the parameters' updates was 0.917; at 64^2
0.987).

The rules of tests/test_torch_train_step.py (its helpers), with what was
seen here: every metric 1e-3 relative (seen 2.2e-4, lossR_IC), the gradient
norms 1e-2 (seen 2.8e-4; IBN's BatchNorm halves and the landmark head's
BatchNorm normalise over 4 samples and 4 x 64 rows); the renders by its
image rule (tests/torch_option_step.py::renders_match; seen 99.8% of the pixels within 1e-3, the worst rgb 3.3e-3);
the running statistics (the landmark head's, moved twice a step, among
them) 5e-3 of each buffer's largest value (seen 1.6e-4); the updated
parameters by agreement share and cosine (Adam's first step is a sign),
the median cosine (seen 0.987) taken over the tensors whose gradient is
not rounding noise: under IBN and the refinement's InstanceNorm every conv
bias has such a gradient (tests/torch_option_step.py::noise_gradient_keys).
The makeup refinement's last conv is scaled down (tests/torch_option_step.py
says why).

One XLA compile of the step, shared by the file's two test functions
through a module fixture (tests/ROADMAP rule for slow files); the helpers
are tests/torch_option_step.py's.
"""
import importlib

import pytest
import torch

from magicmirror_torch.models.discriminators import MSDiscriminator
from test_torch_train_step import LR, B, _metrics_match_reference
from torch_option_step import (option_draws, renders_match, run_step,
                               running_statistics_match, updated_parameters_match)

torch.set_num_threads(1)
OPTIONS = dict(norm="ibn", makeup=2, nolpl=True, inv=0.5, gan_type="lsgan", dis1=0.1,
               dis2=0.1, lambda_lc=0.1)


@pytest.fixture(scope="module")
def runs():
    return run_step(OPTIONS, S=64)


def test_step_under_the_encoder_and_critic_options(runs):
    ref, ours, _ = runs
    trainer = ours["trainer"]
    assert isinstance(trainer.state.netD, MSDiscriminator)
    assert trainer.state.precond_M is not None
    for key in ("lossR_dis", "lossR_LC", "lossD_gp"):
        assert float(ref["metrics"][key]) > 0.0, key
    _metrics_match_reference(runs)
    renders_match(runs)
    keys = running_statistics_match(runs)
    assert any(k.startswith("landmark_cls.BatchNorm_0") for k in keys)
    assert any(".IBN_0.BN." in k for k in keys)
    for net in ("netE", "netD"):
        updated_parameters_match(runs, net, LR)


def test_landmark_head_and_preconditioner_take_their_gradients(runs):
    """The landmark head trains (its own loss only), and the step's draws
    are the ones the port would have sampled itself in kind."""
    _, ours, (ve, vd, opt, rng) = runs
    trainer = ours["trainer"]
    head = trainer.state.netE.landmark_cls
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0
               for p in head.parameters())
    tstep = importlib.import_module("magicmirror_torch.train.train_step")
    draws = tstep.sample_draws(trainer.opt, B, torch.Generator().manual_seed(0), "cpu",
                               trainer.diff_render.num_faces)
    ref = option_draws(opt, rng, trainer.diff_render.num_faces)
    assert draws["erase_u"].shape == ref["erase_u"].shape == (4, B)
    assert draws["lc_idx"].shape == (64,) and len(set(draws["lc_idx"].tolist())) == 64
    assert int(draws["lc_idx"].max()) < trainer.diff_render.num_faces
