"""The hard view of the published Market recipe's step (``docs/RECIPES.md``:
``--bg --hard ...`` over ``MARKET_DEFAULTS``) against the JAX package: its
draws.  The step itself, with the recipe's flags against
``make_train_step(steps_per_call=1)``, is the ``market`` case of
tests/test_torch_renderer_configs.py (one XLA compile of the step serves
both).

The JAX step draws the hard view's azimuths from its key
(train_step.py:171-179): one coin for the whole batch picks -U(hard_range,
180 - hard_range) or -U(0, 180), both maps of one uniform drawn from one key,
times a random sign per image.  The draws recomputed here from the key and
handed to the port's ``hard_azimuths`` give the JAX step's azimuths within
1e-5 degrees (float32 of the same uniform, mapped twice), over keys that
take both branches, at ``--hard_range 30`` so that the two ranges differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from magicmirror.cli.train_market import MARKET_DEFAULTS as JMARKET_DEFAULTS
from magicmirror.configs import flags as jflags
from magicmirror_torch.configs import flags
from magicmirror_torch.configs.recipes import MARKET_DEFAULTS, RECIPES
from magicmirror_torch.train import sample_draws, train_options
from magicmirror_torch.train.train_step import hard_azimuths
from torch_parity import t

B = 4


def _hard_draws(rng):
    """The hard view's draws of train_step.py:171-179, from the step's key."""
    ks = jax.random.split(jax.random.split(rng)[0], 13)
    return {"hard_branch": torch.as_tensor(np.array(jax.random.bernoulli(ks[1]))),
            "hard_u": t(jax.random.uniform(ks[2], (B,))),
            "hard_sign": t(jnp.where(jax.random.uniform(ks[3], (B,)) < 0.5, -1.0, 1.0))}


def _reference_hard_azimuths(opt, rng):
    """The JAX step's Ae90 azimuths, as train_step.py computes them."""
    ks = jax.random.split(jax.random.split(rng)[0], 13)
    branch = jax.random.bernoulli(ks[1])
    az1 = -jax.random.uniform(ks[2], (B,), minval=opt.hard_range,
                              maxval=180.0 - opt.hard_range)
    az2 = -jax.random.uniform(ks[2], (B,), minval=0.0, maxval=180.0)
    sign = jnp.where(jax.random.uniform(ks[3], (B,)) < 0.5, -1.0, 1.0)
    return bool(branch), np.asarray(jnp.where(branch, az1, az2) * sign)


def _recipe_options():
    """The Market recipe's options at ``--hard_range 30``, parsed as both
    packages parse them."""
    argv = RECIPES["recipe_market"][1] + ["--hard_range", "30"]
    ns = flags.build_parser(MARKET_DEFAULTS).parse_args(argv)
    assert vars(ns) == vars(jflags.build_parser(JMARKET_DEFAULTS).parse_args(argv))
    opt = train_options(ns)
    assert opt.bg and opt.hard and opt.hard_range == 30
    return opt


def test_hard_view_draws_are_the_jax_packages():
    """The hard view's azimuths from draws derived from the JAX key equal the
    JAX step's, over keys that take both branches."""
    opt = _recipe_options()
    branches = set()
    for seed in range(8):
        rng = jax.random.PRNGKey(seed)
        branch, ref = _reference_hard_azimuths(opt, rng)
        draws = _hard_draws(rng)
        assert bool(draws["hard_branch"]) == branch
        np.testing.assert_allclose(hard_azimuths(opt, draws).numpy(), ref, rtol=0, atol=1e-5)
        branches.add(branch)
    assert branches == {True, False}


def test_sample_draws_make_the_hard_views_draws():
    """``sample_draws`` makes the same kinds of draws as the JAX step, in
    their ranges, and none without ``hard``."""
    opt = _recipe_options()
    draws = sample_draws(opt, B, torch.Generator().manual_seed(0), "cpu")
    assert draws["hard_branch"].shape == () and draws["hard_branch"].dtype == torch.bool
    assert ((draws["hard_u"] >= 0) & (draws["hard_u"] < 1)).all()
    assert set(draws["hard_sign"].tolist()) <= {-1.0, 1.0}
    az = hard_azimuths(opt, draws).abs()
    lo = opt.hard_range if bool(draws["hard_branch"]) else 0.0
    assert ((az >= lo) & (az <= 180.0 - lo)).all()
    opt.hard = False
    assert not any(k.startswith("hard") for k in sample_draws(opt, B, None, "cpu"))
