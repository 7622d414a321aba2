"""The port's converters of torch checkpoints against the JAX package's, on
the CPU, over state dicts drawn from a seed under torchvision's
(``resnet34``) and timm's (``hrnet_w18_small_v2``) and pytorch-fid's names
(no such checkpoint is in the repository: the names are made here from the
port's modules by the inverse of the converters' maps, with the heads and
counters the real files carry).

  * ``convert_resnet`` / ``convert_hrnet_w18sv2``: every tensor equal to the
    JAX conversion's, leaf for leaf, through ``flax_to_state_dict``, and
    nothing else (no ChannelAttention gate, no BatchNorm counters); it loads
    strictly into the backbone ``make_backbone`` builds through
    ``load_backbone``, which keeps the module's own gate and counters; its
    forward equal to the JAX backbone's on the JAX
    conversion, within 1e-4 (ResNet-34) and 1e-3 (HRNet, as
    tests/test_torch_models.py holds it) of the output's max abs: the
    checkpoint's random BatchNorm statistics are not its activations', so
    these grow to 1e2-1e5 through the layers (seen: 1.5e-6 and 8.6e-5 of
    it apart);
    ``graft_backbone`` puts both into an ``AttributeEncoder`` and leaves its
    gate and counters as they were;
  * ``convert_fid_weights``: the npz equal key for key and array for array,
    and it loads back into the port's Inception as the checkpoint's values.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from magicmirror.eval import convert_fid_weights as jfid
from magicmirror.models import backbones as jbb
from magicmirror.models import backbones_zoo as jzoo
from magicmirror.models import convert_torch as jconv
from magicmirror_torch.eval import convert_fid_weights as pfid
from magicmirror_torch.eval.inception import InceptionV3FID, load_fid_weights
from magicmirror_torch.models import convert_torch as pconv
from magicmirror_torch.models.attribute_encoder import AttributeEncoder
from magicmirror_torch.models.backbones import make_backbone
from magicmirror_torch.models.convert import flax_to_state_dict
from torch_parity import n

torch.set_num_threads(1)


def _resnet_name(key):
    """The port's Resnet4C key -> torchvision's resnet34 key."""
    m = re.fullmatch(r"(layer\d)_(\d)\.(Conv|BatchNorm)_(\d)\.(\w+)", key)
    if not m:
        return key
    k = int(m[4])
    if k == 2:
        return f"{m[1]}.{m[2]}.downsample.{0 if m[3] == 'Conv' else 1}.{m[5]}"
    return f"{m[1]}.{m[2]}.{'conv' if m[3] == 'Conv' else 'bn'}{k + 1}.{m[5]}"


def _hrnet_name(key):
    """The port's HRNetW18SmallV2_4C key -> timm's hrnet_w18_small_v2 key."""
    mod, leaf = key.rsplit(".", 1)

    def ds(s):
        return s.replace("ds_conv", "downsample.0").replace("ds_bn", "downsample.1")

    def cb(s):
        return "0" if s == "conv" else "1"

    if m := re.fullmatch(r"layer1_(\d)\.(\w+)", mod):
        mod = f"layer1.{m[1]}.{ds(m[2])}"
    elif m := re.fullmatch(r"transition(\d)_(\d)_(conv|bn)", mod):
        mod = f"transition{m[1]}.{m[2]}." + ("" if m[2] == "0" else "0.") + cb(m[3])
    elif m := re.fullmatch(r"stage(\d)_m(\d)\.branch(\d)_block(\d)\.(\w+)", mod):
        mod = f"stage{m[1]}.{m[2]}.branches.{m[3]}.{m[4]}.{m[5]}"
    elif m := re.fullmatch(r"stage(\d)_m(\d)\.fuse(\d)_(\d)_(conv|bn)(\d?)", mod):
        mod = (f"stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}."
               + (f"{m[6]}." if m[6] else "") + cb(m[5]))
    elif m := re.fullmatch(r"incre(\d)\.(\w+)", mod):
        mod = f"incre_modules.{m[1]}.0.{ds(m[2])}"
    elif m := re.fullmatch(r"downsamp(\d)_(conv|bn)", mod):
        mod = f"downsamp_modules.{m[1]}.{cb(m[2])}"
    elif m := re.fullmatch(r"final_(conv|bn)", mod):
        mod = f"final_layer.{cb(m[1])}"
    return f"{mod}.{leaf}"


def _checkpoint(module, rename, seed, heads):
    """A seeded state dict of ``module``'s tensors under the original
    names (a 3-channel stem, no ``ca.`` gate) plus ``heads``."""
    rs = np.random.RandomState(seed)
    sd = {}
    for key, value in module.state_dict().items():
        if key.startswith("ca."):
            continue
        shape = tuple(value.shape)
        if key == "conv1.weight":
            shape = (shape[0], 3) + shape[2:]
        leaf = key.rsplit(".", 1)[1]
        if leaf == "num_batches_tracked":
            a = np.asarray(rs.randint(1, 1000))
        elif leaf == "running_var":
            a = rs.uniform(0.5, 1.5, shape)
        elif leaf == "weight" and len(shape) == 1:
            a = 1.0 + 0.1 * rs.randn(*shape)
        elif leaf == "weight":
            a = rs.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        else:
            a = 0.1 * rs.randn(*shape)
        sd[rename(key)] = torch.as_tensor(a.astype(np.int64 if a.ndim == 0 else np.float32))
    for key, shape in heads.items():
        sd[key] = torch.as_tensor(rs.randn(*shape).astype(np.float32))
    return sd


def _to_flax(state, prefix):
    """The port's tensors under ``prefix`` -> a Flax params tree."""
    tree = {}
    for key, value in state.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split(".")
        a = n(value)
        if leaf == "weight":
            leaf, a = "kernel", a.transpose(2, 3, 1, 0)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _check_against_jax(ours, jtree, pretrain, jmodule, x):
    """Leaf for leaf, a strict load, and the forward."""
    ref = flax_to_state_dict(jtree["params"], jtree["batch_stats"])
    assert sorted(ours) == sorted(ref)
    for key, a in ref.items():
        assert np.array_equal(n(ours[key]), a), key
    stem = n(ours["conv1.weight"])
    assert np.allclose(stem[:, 3], stem[:, :3].mean(1), atol=1e-7)  # the mask channel
    module = make_backbone(pretrain, 4, 5, "bn", False)[0]
    own = {k: v.clone() for k, v in module.state_dict().items() if k not in ours}
    pconv.load_backbone(module, ours)
    state = module.state_dict()
    for key, value in {**own, **ours}.items():
        assert torch.equal(state[key], value), key
    gate = _to_flax(own, "ca.")
    variables = {"params": dict(jtree["params"], **({"ca": gate} if gate else {})),
                 "batch_stats": jtree["batch_stats"]}
    want = np.asarray(jax.jit(lambda v, a: jmodule.apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = n(module.eval()(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    assert got.shape == want.shape
    return got, want


def test_backbone_converters_match_reference():
    x = np.random.RandomState(3).rand(2, 64, 64, 4).astype(np.float32)
    sd = _checkpoint(make_backbone("res34", 4, 5, "bn", False)[0], _resnet_name, 1,
                     {"fc.weight": (1000, 512), "fc.bias": (1000,)})
    ours = pconv.convert_resnet(sd)
    got, want = _check_against_jax(ours, jconv.convert_resnet(sd, arch="res34"), "res34",
                                   jbb.Resnet4C(arch="res34"), x[:, :32, :32])
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()

    hr_sd = _checkpoint(make_backbone("hr18sv2", 4, 5, "bn", False)[0], _hrnet_name, 2,
                        {"classifier.weight": (1000, 2048), "classifier.bias": (1000,)})
    hr = pconv.convert_hrnet_w18sv2(hr_sd)
    assert not any(k.startswith("ca.") for k in hr)
    got, want = _check_against_jax(hr, jconv.convert_hrnet_w18sv2(hr_sd), "hr18sv2",
                                   jzoo.HRNetW18SmallV2_4C(), x)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()

    netE = AttributeEncoder(num_vertices=42)
    before = {k: v.clone() for k, v in netE.state_dict().items()}
    pconv.graft_backbone(netE, ours, "texture")
    pconv.graft_backbone(netE, hr, "shape")
    grafted = {f"texture_enc.Resnet4C_0.{k}": v for k, v in ours.items()}
    grafted.update({f"shape_enc.backbone.{k}": v for k, v in hr.items()})
    assert any(k.startswith("shape_enc.backbone.ca.") for k in before)
    for key, value in netE.state_dict().items():
        # the checkpoints' tensors, and every other tensor (the shape
        # backbone's ChannelAttention gate too) as the encoder had it
        assert torch.equal(value, grafted.get(key, before[key])), key


def test_fid_weight_converter_matches_reference(tmp_path):
    rs = np.random.RandomState(4)
    sd = {}
    for key, value in InceptionV3FID().state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(7)
        elif key.endswith("running_var"):
            sd[key] = torch.as_tensor(rs.uniform(0.5, 1.5, value.shape).astype(np.float32))
        else:
            sd[key] = torch.as_tensor(rs.randn(*value.shape).astype(np.float32))
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    ref, ours = jfid.convert(sd), pfid.convert(sd)
    assert sorted(ref) == sorted(ours) and len(ours) == 94 * 5
    for key in ref:
        assert np.array_equal(ref[key], ours[key]), key
    pth, npz = str(tmp_path / "pt_inception.pth"), str(tmp_path / "fid_weights.npz")
    torch.save(sd, pth)
    assert pfid.main([pth], out=npz) == npz
    with np.load(npz) as z:
        assert sorted(z.files) == sorted(ref)
    state = load_fid_weights(npz).state_dict()
    for key, value in sd.items():
        if key in state and not key.endswith("num_batches_tracked"):
            assert torch.equal(state[key], value), key
    for path in (pth, npz):  # 90 MB each
        os.remove(path)
