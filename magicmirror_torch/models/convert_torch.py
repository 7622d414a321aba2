"""ImageNet weights into the port's backbones: torchvision's ResNet-34 and
timm's HRNet-w18-small-v2 state dicts into the state dicts of the port's
``Resnet4C`` and ``HRNetW18SmallV2_4C``, with the 4-channel stem surgery
(the mask channel's weights the mean of the RGB ones).  The reference starts
both from ImageNet by default (reference network/model_res.py:688-734,
775-805); no checkpoint can be fetched offline, so a user converts one that
is on disk, with torch alone:

    from magicmirror_torch.models.convert_torch import convert_resnet, graft_backbone
    sd = convert_resnet(torch.load("resnet34-b627a593.pth"))
    graft_backbone(netE, sd, "texture")

A converted dict holds only what the checkpoint has: BatchNorm's counters
and HRNet's ChannelAttention gate (which the reference adds untrained) keep
the target module's own values when it is loaded (``load_backbone``).

The name and layout maps are those of ``magicmirror/models/convert_torch.py``
(copied: ``resnet_flax``, ``hrnet_w18sv2_flax`` give its Flax trees), and
the trees become the port's names through ``models/convert.py``.  The
DenseNet and SwinV2 converters wait for their backbones.
"""
from __future__ import annotations

import numpy as np
import torch

from .backbones import Resnet4C
from .backbones_zoo import HRNetW18SmallV2_4C
from .convert import flax_to_state_dict

# the backbone of each encoder subtree that starts from ImageNet
GRAFT_PATHS = {"texture": ("texture_enc", "Resnet4C_0"), "shape": ("shape_enc", "backbone")}
# keys of the port's backbones that no ImageNet checkpoint holds
_UNTRAINED = ("ca.",)


def _conv(w):
    return np.asarray(w).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _four_channel_stem(w):
    """4-channel conv1 surgery (reference model_res.py:712-715): RGB weights
    kept, the mask channel initialized to the RGB mean."""
    w = np.asarray(w)
    out = np.zeros((w.shape[0], 4, w.shape[2], w.shape[3]), w.dtype)
    out[:, :3] = w
    out[:, 3] = w.mean(axis=1)
    return _conv(out)


def _numpy(state_dict):
    return {k: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
            for k, v in state_dict.items()}


def _put(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


class _FlaxTree:
    """The params / batch_stats trees that a conversion fills."""

    def __init__(self, state_dict):
        self.sd = _numpy(state_dict)
        self.params: dict = {}
        self.stats: dict = {}

    def conv(self, prefix, path, bias=False, kernel=None):
        _put(self.params, path + ("kernel",),
             _conv(self.sd[prefix + ".weight"]) if kernel is None else kernel)
        if bias:
            _put(self.params, path + ("bias",), self.sd[prefix + ".bias"])

    def bn(self, prefix, path):
        _put(self.params, path + ("scale",), self.sd[prefix + ".weight"])
        _put(self.params, path + ("bias",), self.sd[prefix + ".bias"])
        _put(self.stats, path + ("mean",), self.sd[prefix + ".running_mean"])
        _put(self.stats, path + ("var",), self.sd[prefix + ".running_var"])

    def variables(self):
        return {"params": self.params, "batch_stats": self.stats}


def resnet_flax(state_dict: dict) -> dict:
    """torchvision ResNet-34 state_dict -> nested Flax params/batch_stats
    dicts of ``Resnet4C`` (the JAX package's ``convert_resnet`` at res34)."""
    t = _FlaxTree(state_dict)
    t.conv("conv1", ("conv1",), kernel=_four_channel_stem(t.sd["conv1.weight"]))
    t.bn("bn1", ("bn1",))
    for li, n_blocks in enumerate((3, 4, 6, 3)):
        for bi in range(n_blocks):
            tprefix = f"layer{li + 1}.{bi}"
            fname = f"layer{li + 1}_{bi}"
            # the BasicBlock names its convs Conv_0, Conv_1 and BN BatchNorm_0,
            # BatchNorm_1 in declaration order, the downsample's last
            for ci in range(2):
                t.conv(f"{tprefix}.conv{ci + 1}", (fname, f"Conv_{ci}"))
                t.bn(f"{tprefix}.bn{ci + 1}", (fname, f"BatchNorm_{ci}"))
            if f"{tprefix}.downsample.0.weight" in t.sd:
                t.conv(f"{tprefix}.downsample.0", (fname, "Conv_2"))
                t.bn(f"{tprefix}.downsample.1", (fname, "BatchNorm_2"))
    return t.variables()


def hrnet_w18sv2_flax(state_dict: dict) -> dict:
    """timm ``hrnet_w18_small_v2`` state_dict -> HRNetW18SmallV2_4C variables
    (4-channel 3x3 conv1 surgery, reference model_res.py:791-794; the
    reference's freshly-initialized ChannelAttention gate is not in it),
    the JAX package's ``convert_hrnet_w18sv2``."""
    t = _FlaxTree(state_dict)

    def block(tprefix, fname, n_convs):
        for ci in range(1, n_convs + 1):
            t.conv(f"{tprefix}.conv{ci}", fname + (f"conv{ci}",))
            t.bn(f"{tprefix}.bn{ci}", fname + (f"bn{ci}",))
        if f"{tprefix}.downsample.0.weight" in t.sd:
            t.conv(f"{tprefix}.downsample.0", fname + ("ds_conv",))
            t.bn(f"{tprefix}.downsample.1", fname + ("ds_bn",))

    t.conv("conv1", ("conv1",), kernel=_four_channel_stem(t.sd["conv1.weight"]))
    t.bn("bn1", ("bn1",))
    t.conv("conv2", ("conv2",))
    t.bn("bn2", ("bn2",))
    for i in range(2):
        block(f"layer1.{i}", (f"layer1_{i}",), 3)
    # transitions: existing-branch 3x3 is Sequential(conv,bn,relu); new-branch
    # downsample path is nested one deeper (Sequential of Sequentials)
    t.conv("transition1.0.0", ("transition1_0_conv",))
    t.bn("transition1.0.1", ("transition1_0_bn",))
    t.conv("transition1.1.0.0", ("transition1_1_conv",))
    t.bn("transition1.1.0.1", ("transition1_1_bn",))
    t.conv("transition2.2.0.0", ("transition2_2_conv",))
    t.bn("transition2.2.0.1", ("transition2_2_bn",))
    t.conv("transition3.3.0.0", ("transition3_3_conv",))
    t.bn("transition3.3.0.1", ("transition3_3_bn",))

    stages = {"stage2": (1, 2), "stage3": (3, 3), "stage4": (2, 4)}
    for sname, (n_mod, n_br) in stages.items():
        for m in range(n_mod):
            mod = f"{sname}_m{m}"
            for b in range(n_br):
                for k in range(2):
                    block(f"{sname}.{m}.branches.{b}.{k}", (mod, f"branch{b}_block{k}"), 2)
            for i in range(n_br):
                for j in range(n_br):
                    if i == j:
                        continue
                    f = f"{sname}.{m}.fuse_layers.{i}.{j}"
                    if j > i:
                        t.conv(f + ".0", (mod, f"fuse{i}_{j}_conv"))
                        t.bn(f + ".1", (mod, f"fuse{i}_{j}_bn"))
                    else:
                        for k in range(i - j):
                            t.conv(f"{f}.{k}.0", (mod, f"fuse{i}_{j}_conv{k}"))
                            t.bn(f"{f}.{k}.1", (mod, f"fuse{i}_{j}_bn{k}"))
    for i in range(4):
        block(f"incre_modules.{i}.0", (f"incre{i}",), 3)
    for i in range(3):
        t.conv(f"downsamp_modules.{i}.0", (f"downsamp{i}_conv",), bias=True)
        t.bn(f"downsamp_modules.{i}.1", (f"downsamp{i}_bn",))
    t.conv("final_layer.0", ("final_conv",), bias=True)
    t.bn("final_layer.1", ("final_bn",))
    return t.variables()


def _untrained(key: str) -> bool:
    return key.endswith("num_batches_tracked") or key.startswith(_UNTRAINED)


def _converted(module: torch.nn.Module, tree: dict) -> dict:
    """The tensors of the Flax ``tree`` under ``module``'s names, checked
    against ``module``: every key but BatchNorm's counters and the untrained
    gate is there, with its shape, and no other key."""
    arrays = flax_to_state_dict(tree["params"], tree.get("batch_stats"))
    own = module.state_dict()
    unexpected = sorted(arrays.keys() - own.keys())
    missing = sorted(k for k in own.keys() - arrays.keys() if not _untrained(k))
    if missing or unexpected:
        raise ValueError(f"checkpoint does not match {type(module).__name__}: "
                         f"missing {missing}, unexpected {unexpected}")
    out = {}
    for key, a in arrays.items():
        if tuple(a.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: {a.shape} vs {tuple(own[key].shape)}")
        out[key] = torch.as_tensor(np.ascontiguousarray(a), dtype=own[key].dtype)
    return out


def convert_resnet(state_dict: dict) -> dict:
    """torchvision ResNet-34 state_dict -> the tensors of the port's
    ``Resnet4C`` (``fc`` dropped); load it with :func:`load_backbone`."""
    return _converted(Resnet4C(arch="res34"), resnet_flax(state_dict))


def convert_hrnet_w18sv2(state_dict: dict) -> dict:
    """timm ``hrnet_w18_small_v2`` state_dict -> the tensors of the port's
    ``HRNetW18SmallV2_4C`` (no ChannelAttention gate, which the reference
    adds untrained); load it with :func:`load_backbone`."""
    return _converted(HRNetW18SmallV2_4C(), hrnet_w18sv2_flax(state_dict))


def load_backbone(module: torch.nn.Module, converted: dict) -> None:
    """Load a converted backbone into ``module`` strictly; the keys that no
    checkpoint holds (BatchNorm's counters, the untrained gate) keep the
    module's own values."""
    state = {k: v for k, v in module.state_dict().items() if _untrained(k)}
    module.load_state_dict({**state, **converted}, strict=True)


def graft_backbone(netE: torch.nn.Module, converted: dict, subtree: str) -> None:
    """Load a converted backbone into an ``AttributeEncoder``'s ``subtree``
    ("texture": the texture encoder's ResNet-34, "shape": the shape
    encoder's backbone); the rest of netE is left as it is."""
    module = netE
    for name in GRAFT_PATHS[subtree]:
        module = getattr(module, name)
    load_backbone(module, converted)
