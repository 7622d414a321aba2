"""Port parity of what training adds to the models: the WGAN critic, the
train mode of the blocks (BatchNorm batch statistics and their running
updates, dropout) and the ``train_shape`` freezing policy
(magicmirror_torch/models vs magicmirror/models).  The encoders' train mode
is in tests/test_torch_encoders_train.py, which shares this file's helpers.

Flax variables are drawn in numpy and converted by ``load_flax_variables``.
Train-mode outputs: 1e-3 of the output's largest absolute value (float32
through a batch normalisation over few samples, which divides by a batch
deviation that can be small; seen 2e-5 .. 4e-4).  Running statistics after
one train-mode call: 1e-4 of each buffer's largest absolute value for the
single blocks, 2e-3 for the deep encoders (seen 1e-6 and 3e-4).  Flax keeps
the BIASED batch variance as its running variance; ``blocks.BatchNorm`` does
too, where ``torch.nn.BatchNorm2d`` would store the unbiased one
(``test_running_variance_is_the_biased_one`` shows the difference).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicmirror.models import attribute_encoder as jae
from magicmirror.models import blocks as jb
from magicmirror.models.discriminators import Discriminator as JDiscriminator
from magicmirror_torch.models import attribute_encoder as tae
from magicmirror_torch.models import blocks as tb
from magicmirror_torch.models.convert import init_from_seed, load_flax_variables
from magicmirror_torch.models.discriminators import Discriminator
from torch_parity import (assert_close, assert_stats, flax_shapes, n, random_variables,
                          sphere_template, t, train_pair)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def template():
    return sphere_template()


# ------------------------------------------------------------------ the critic
def test_critic_matches_reference():
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    jD = JDiscriminator(nc=3, nf=16)
    variables = random_variables(flax_shapes(jD, jnp.asarray(x)), seed=1)
    D = load_flax_variables(Discriminator(nc=3, nf=16), variables["params"])
    ref = np.asarray(jD.apply(variables, jnp.asarray(x)))
    out = n(D(t(x)))
    assert out.shape == ref.shape == (2, 1)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)
    assert len(list(D.parameters())) == 15 and all(p.dim() == 4 for p in D.parameters())


def test_critic_converter_is_strict():
    jD = JDiscriminator(nc=3, nf=16)
    variables = random_variables(flax_shapes(jD, jnp.zeros((1, 32, 32, 3))), seed=1)
    params = dict(variables["params"])
    del params["Conv_3"]
    with pytest.raises(ValueError, match="Conv_3.weight"):
        load_flax_variables(Discriminator(nc=3, nf=16), params)
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(Discriminator(nc=4, nf=16), variables["params"])


def test_critic_init_follows_the_jax_laws():
    D = init_from_seed(Discriminator(nc=3, nf=16), 5)
    w = D.Conv_7.weight.detach()
    std = (2.0 / w[0].numel()) ** 0.5
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(D.Conv_14.weight.detach().abs().max()) < 1e-4  # the head: N(0, 1e-5)
    assert all(getattr(D, f"Conv_{i}").bias is None for i in range(15))


# ------------------------------------------------------- BatchNorm in train mode
def test_conv_block_train_mode_and_running_statistics():
    x = np.random.RandomState(1).rand(3, 8, 8, 5).astype(np.float32)
    ref, stats, module = train_pair(jb.Conv2dBlock(8, 3, 1, 1, norm="bn"),
                                     tb.Conv2dBlock(5, 8, 3, 1, 1, norm="bn"),
                                     (jnp.asarray(x),), seed=1)
    out = module(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(out, ref, 1e-4)
    assert_stats(module, stats, 1e-4)


def test_linear_block_train_mode_and_running_statistics():
    x = np.random.RandomState(2).randn(6, 12).astype(np.float32)
    ref, stats, module = train_pair(jb.LinearBlock(10), tb.LinearBlock(12, 10),
                                     (jnp.asarray(x),), seed=2)
    assert_close(module(t(x)), ref, 1e-4)
    assert_stats(module, stats, 1e-4)


def test_running_variance_is_the_biased_one():
    x = torch.randn(4, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    ours, theirs = tb.BatchNorm(3).train(), torch.nn.BatchNorm2d(3).train()
    out = ours(x)
    torch.testing.assert_close(out, theirs(x))
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var, 0.9 * torch.ones(3) + 0.1 * biased)
    torch.testing.assert_close(theirs.running_var, 0.9 * torch.ones(3) + 0.1 * biased * 16 / 15)
    torch.testing.assert_close(ours.running_mean, theirs.running_mean)
    out.sum().backward  # the graph is intact after the in-place correction


def test_frozen_batchnorm_normalises_with_the_batch_and_keeps_its_statistics():
    x = torch.randn(4, 3, 2, 2, generator=torch.Generator().manual_seed(1))
    bn = tb.BatchNorm(3).train()
    bn.update_stats = False
    out = bn(x)
    torch.testing.assert_close(out, torch.nn.BatchNorm2d(3).train()(x))
    assert torch.equal(bn.running_mean, torch.zeros(3)) and torch.equal(bn.running_var,
                                                                       torch.ones(3))


def test_cumulative_average_of_update_bn_stays_biased():
    bn = tb.BatchNorm(2).train()
    bn.momentum = None
    xs = [torch.randn(5, 2, generator=torch.Generator().manual_seed(s)) for s in (0, 1)]
    for x in xs:
        bn(x)
    torch.testing.assert_close(bn.running_var,
                               torch.stack([x.var(0, unbiased=False) for x in xs]).mean(0))


# ------------------------------------------------------------------- dropout
def test_dropout_rate_scaling_and_generator():
    drop = tb.Dropout(0.2).train()
    drop.generator = torch.Generator().manual_seed(0)
    out = drop(torch.ones(200, 500))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.005
    assert torch.allclose(out[kept], torch.tensor(1.25))
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(torch.ones(200, 500)), out)
    assert torch.equal(drop.eval()(torch.ones(4, 4)), torch.ones(4, 4))
    assert torch.equal(tb.Dropout(0.0).train()(torch.ones(4, 4)), torch.ones(4, 4))


def test_dropout_takes_an_injected_mask():
    drop = tb.Dropout(0.5).train()
    drop.mask = torch.tensor([[True, False], [False, True]])
    assert torch.equal(drop(torch.ones(2, 2)), torch.tensor([[2.0, 0.0], [0.0, 2.0]]))


def _tiny_encoder(droprate):
    net = tae.AttributeEncoder(pretrains="none", pretraint="none", pretrainc="none",
                               droprate=droprate, coordconv=True)
    return init_from_seed(net, 0)


def test_dropout_layers_sit_where_the_reference_has_them():
    net = _tiny_encoder("0.2,0.3,0.4")
    rates = {name: m.rate for name, m in net.named_modules() if isinstance(m, tb.Dropout)}
    assert rates == {"camera_enc.dist_drop": 0.2, "camera_enc.azim_drop": 0.2,
                     "camera_enc.bias_drop": 0.2, "shape_enc.drop1": 0.3,
                     "light_enc.drop": 0.2, "texture_enc.TextureBiFPN_0.drop": 0.2}
    assert tae.parse_droprate(0.5) == (0.2, 0.2, 0.2)


def test_encoder_dropout_follows_its_generator(template):
    v, lpl = template
    x = t(np.random.RandomState(3).rand(2, 32, 32, 4).astype(np.float32))
    net = _tiny_encoder("0.2,0.2,0.2").train()
    outs = []
    for seed in (0, 0, 1):
        net.set_dropout_generator(torch.Generator().manual_seed(seed))
        with torch.no_grad():
            outs.append(net(x, t(v), t(lpl))["lights"])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


# --------------------------------------------------------------- train_shape
def test_freezing_constants_are_the_reference_ones():
    assert (tae.SHAPE_FROZEN, tae.CAMERA_FROZEN, tae.TEXTURE_FROZEN) == (
        jae.SHAPE_FROZEN, jae.CAMERA_FROZEN, jae.TEXTURE_FROZEN)


@pytest.mark.parametrize("train_shape", range(6))
def test_train_shape_freezes_gradients_and_statistics(template, train_shape):
    v, lpl = template
    x = t(np.random.RandomState(4).rand(2, 32, 32, 4).astype(np.float32))
    net = _tiny_encoder("0,0,0").train()
    before = {k: b.clone() for k, b in net.named_buffers() if "running" in k}
    att = net(x, t(v), t(lpl), train_shape=train_shape)
    live = [att[k] for k in ("azimuths", "elevations", "distances", "biases", "delta_vertices",
                             "textures", "lights") if att[k].requires_grad]
    gen = torch.Generator().manual_seed(0)  # a plain sum of the centred deltas is 0
    if live:
        sum((a * torch.randn(a.shape, generator=gen)).sum() for a in live).backward()
    frozen = {"shape_enc": train_shape in jae.SHAPE_FROZEN,
              "camera_enc": train_shape in jae.CAMERA_FROZEN,
              "texture_enc": train_shape in jae.TEXTURE_FROZEN,
              "light_enc": train_shape in jae.TEXTURE_FROZEN}
    for branch, is_frozen in frozen.items():
        grads = [p.grad for p in getattr(net, branch).parameters()]
        moved = [not torch.equal(b, before[k]) for k, b in net.named_buffers()
                 if "running" in k and k.startswith(branch)]
        if is_frozen:
            assert all(g is None for g in grads) and not any(moved), branch
        else:
            assert any(g is not None and g.abs().max() > 0 for g in grads) and all(moved), branch
    assert att["vertices"].requires_grad == (not frozen["shape_enc"])
