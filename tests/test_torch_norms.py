"""The encoder's norms off the default (``--norm in / ibn / ln / sn``):
``InstanceNorm``, ``IBN``, ``LayerNormAll`` and ``Conv2dBlock`` under each,
the port (magicmirror_torch/models/blocks.py) against the JAX package's
blocks, on the same numpy-drawn variables and inputs, in train mode (IBN's
BatchNorm normalises with the batch and moves its running statistics).

Tolerances, with what was seen (float32 on both sides): outputs and input
gradients 1e-5 of the reference's largest value (seen under 1e-6); IBN's
running statistics 1e-5 of each buffer's largest value; the LayerNorm over
a whole sample divides by the POPULATION std (``jnp.std``), and torch's
default (Bessel's) std would be off by 1.1e-2 on these inputs, past the
tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.models import blocks as jb
from magicmirror_torch.models import blocks as tb
from magicmirror_torch.models.convert import init_from_seed, load_flax_variables
from torch_parity import DROP, assert_stats, flax_shapes, n, random_variables, t, train_pair

torch.set_num_threads(1)
TOL = 1e-5


def _input(shape, seed):
    return (np.random.RandomState(seed).randn(*shape) * 2.0 + 0.5).astype(np.float32)


def _check(ref, jgrad, module, x, cot):
    """Output (NHWC) and the input gradient of <output, cot>."""
    xt = t(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = module(xt).permute(0, 2, 3, 1)
    (out * t(cot)).sum().backward()
    ref = np.asarray(ref)
    assert np.abs(n(out) - ref).max() <= TOL * np.abs(ref).max()
    g, jg = n(xt.grad.permute(0, 2, 3, 1)), np.asarray(jgrad)
    assert np.abs(g - jg).max() <= TOL * np.abs(jg).max()


def _jax_pair(jmodule, variables, x, cot, train):
    """The JAX output in train mode (or the module's only mode), its
    updated statistics, and the gradient of <output, cot> with respect to
    the input."""
    kw = {"train": True} if train else {}

    def f(xj):
        out, mut = jmodule.apply(variables, xj, mutable=["batch_stats"], rngs=DROP, **kw)
        return jnp.sum(out * cot), (out, mut)

    (_, (out, mut)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(x))
    return out, mut, g


# name -> (JAX module, port module, input shape, has a train flag)
NORMS = {
    "instance_norm": (lambda: jb.InstanceNorm(), lambda: tb.InstanceNorm(), False),
    "instance_norm_affine": (lambda: jb.InstanceNorm(affine=True),
                             lambda: tb.InstanceNorm(6, affine=True), False),
    "ibn": (lambda: jb.IBN(6), lambda: tb.IBN(6), True),
    "layer_norm_all": (lambda: jb.LayerNormAll(6), lambda: tb.LayerNormAll(6), False),
}


@pytest.mark.parametrize("name", sorted(NORMS))
def test_norm_forward_and_input_gradient(name):
    make_j, make_t, has_train = NORMS[name]
    x = _input((4, 5, 7, 6), len(name))
    cot = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    jmodule, module = make_j(), make_t()
    kw = {"train": False} if has_train else {}
    variables = random_variables(flax_shapes(jmodule, jnp.asarray(x), **kw), seed=len(name))
    ref, mut, jgrad = _jax_pair(jmodule, variables, x, cot, has_train)
    load_flax_variables(module, variables.get("params", {}), variables.get("batch_stats"))
    _check(ref, jgrad, module.train(), x, cot)
    if has_train:  # IBN's BatchNorm half moved its running statistics as Flax's did
        from magicmirror_torch.models.convert import flax_to_state_dict
        assert_stats(module, flax_to_state_dict({}, jax.device_get(mut["batch_stats"])), TOL)


def test_layer_norm_uses_the_population_std():
    x = _input((2, 3, 4, 6), 7)
    module = tb.LayerNormAll(6)
    flat = x.reshape(2, -1)
    ref = (x - flat.mean(1)[:, None, None, None]) / (flat.std(1)[:, None, None, None] + 1e-5)
    with torch.no_grad():
        out = n(module(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm", ["in", "ibn", "ln", "sn"])
def test_conv2d_block_under_each_norm(norm):
    """Conv2dBlock: the conv's bias (all but 'bn'), the norm, the
    activation; and a ResBlock, whose second conv under 'ibn' is 'bn'."""
    x = _input((4, 8, 8, 6), 11)
    ref, stats, module = train_pair(jb.Conv2dBlock(8, 3, 1, 1, norm=norm),
                                    tb.Conv2dBlock(6, 8, 3, 1, 1, norm=norm),
                                    (jnp.asarray(x),), seed=12)
    assert module.Conv_0.bias is not None
    out = module(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ref = np.asarray(ref)
    assert np.abs(n(out) - ref).max() <= 1e-4 * np.abs(ref).max()
    if norm == "ibn":
        assert_stats(module, stats, 1e-4)
    xb = _input((4, 8, 8, 8), 14)
    ref, stats, module = train_pair(jb.ResBlock(8, norm=norm), tb.ResBlock(8, norm=norm),
                                    (jnp.asarray(xb),), seed=13)
    assert module.Conv2dBlock_1.norm == {"in": "InstanceNorm_0", "ibn": "BatchNorm_0",
                                         "ln": "LayerNormAll_0", "sn": None}[norm]
    out = module(t(xb).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ref = np.asarray(ref)
    assert np.abs(n(out) - ref).max() <= 1e-4 * np.abs(ref).max()
    if norm == "ibn":
        assert_stats(module, stats, 1e-4)


def test_norm_init_laws():
    block = init_from_seed(tb.Conv2dBlock(3, 64, 3, norm="ln"), 0)
    gamma = block.LayerNormAll_0.gamma.detach()
    assert 0.0 <= float(gamma.min()) and float(gamma.max()) < 1.0 and 0.4 < float(gamma.mean()) < 0.6
    assert float(block.LayerNormAll_0.beta.detach().abs().max()) == 0.0
    ibn = init_from_seed(tb.IBN(64), 0)
    w = ibn.IN.weight.detach()
    assert abs(float(w.mean()) - 1.0) < 0.01 and 0.01 < float(w.std()) < 0.03
    assert float(ibn.IN.bias.detach().abs().max()) == 0.0
    with pytest.raises(ValueError, match="normalization"):
        tb.Conv2dBlock(3, 4, 3, norm="group")
