"""4-channel backbones, the port of the serving-path half of
``magicmirror/models/backbones.py`` (NCHW in, NCHW out)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .blocks import BatchNorm, Conv, Conv2dBlock, FlaxNamed, ResBlockHalf, ResBlocks

IMAGENET_MEAN_4C = (0.485, 0.456, 0.406, 0.5)
IMAGENET_STD_4C = (0.229, 0.224, 0.225, 1.0)


def normalize_batch_4c(x):
    """ImageNet normalisation of NHWC RGBA (the mask centred to [-0.5, 0.5])."""
    mean = torch.tensor(IMAGENET_MEAN_4C, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD_4C, dtype=x.dtype, device=x.device)
    return (x - mean) / std


class Base4C(FlaxNamed):
    """The 'none' backbone: 12 residual blocks, x4 + x5 at 1/16, 288 ch."""

    def __init__(self, nc: int = 4, nk: int = 5, norm: str = "bn", coordconv: bool = True):
        super().__init__()
        self.child(Conv2dBlock(nc, 36, nk, 2, nk // 2, coordconv=coordconv))
        self.child(ResBlockHalf(36, norm=norm))
        self.child(ResBlocks(1, 72, norm=norm))
        self.child(ResBlockHalf(72, norm=norm))
        self.child(ResBlocks(3, 144, norm=norm))
        self.child(ResBlockHalf(144, norm=norm))
        self.child(ResBlocks(3, 288, norm=norm))
        self.child(ResBlocks(3, 288, norm=norm))

    def forward(self, x):
        x = self.Conv2dBlock_0(x)
        x = self.ResBlocks_0(self.ResBlockHalf_0(x))
        x = self.ResBlocks_1(self.ResBlockHalf_1(x))
        x4 = self.ResBlocks_2(self.ResBlockHalf_2(x))
        return x4 + self.ResBlocks_3(x4)


class BasicBlock(FlaxNamed):
    """torchvision-style ResNet basic block."""

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.downsample = downsample
        self.child(Conv(cin, features, 3, stride=stride, padding=1, bias=False))
        self.child(BatchNorm(features))
        self.child(Conv(features, features, 3, padding=1, bias=False))
        self.child(BatchNorm(features))
        if downsample:
            self.child(Conv(cin, features, 1, stride=stride, bias=False))
            self.child(BatchNorm(features))

    def forward(self, x):
        h = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        h = self.BatchNorm_1(self.Conv_1(h))
        identity = self.BatchNorm_2(self.Conv_2(x)) if self.downsample else x
        return F.relu(h + identity)


_RESNET_LAYERS = {"res34": (3, 4, 6, 3)}


class Resnet4C(FlaxNamed):
    """ResNet-34 with a 4-channel stem and a configurable layer-4 stride;
    ``return_pyramid`` gives (x1, layer1..layer4) for the texture encoder."""

    def __init__(self, arch: str = "res34", stride: int = 1, return_pyramid: bool = False):
        super().__init__()
        if arch not in _RESNET_LAYERS:
            raise NotImplementedError(f"Resnet4C arch={arch!r}: only res34 is ported")
        self.return_pyramid = return_pyramid
        self.child(Conv(4, 64, 7, stride=2, padding=3, bias=False), "conv1")
        self.child(BatchNorm(64), "bn1")
        self.names = []
        cin = 64
        for li, (n_blocks, width) in enumerate(zip(_RESNET_LAYERS[arch],
                                                   (64, 128, 256, 512))):
            first_stride = 1 if li == 0 or (li == 3 and stride == 1) else 2
            layer = []
            for bi in range(n_blocks):
                s = first_stride if bi == 0 else 1
                need_ds = bi == 0 and (s != 1 or li > 0)
                name = f"layer{li + 1}_{bi}"
                self.child(BasicBlock(cin, width, stride=s, downsample=need_ds), name)
                layer.append(name)
                cin = width
            self.names.append(layer)

    def forward(self, x):
        x1 = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(x1, 3, stride=2, padding=1)
        feats = []
        for layer in self.names:
            for name in layer:
                h = getattr(self, name)(h)
            feats.append(h)
        if self.return_pyramid:
            return (x1, *feats)
        return feats[-1]


def make_backbone(pretrain: str, nc: int, nk: int, norm: str, coordconv: bool):
    """-> (backbone, output channels) for the ported backbones."""
    if pretrain == "none":
        return Base4C(nc=nc, nk=nk, norm=norm, coordconv=coordconv), 288
    if pretrain == "res34":
        return Resnet4C(arch="res34"), 512
    if pretrain == "hr18sv2":
        from .backbones_zoo import HRNetW18SmallV2_4C

        return HRNetW18SmallV2_4C(), 2048
    raise NotImplementedError(
        f"backbone {pretrain!r}: only 'none', 'res34' and 'hr18sv2' are ported")
