"""HRNet-w18-small-v2 with a 4-channel stem and the reference's
channel-attention head gate, the port of the HRNet half of
``magicmirror/models/backbones_zoo.py`` (NCHW).  Module names follow the JAX
package's explicit names, which follow timm's layout."""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F

from .blocks import BatchNorm, ChannelAttention, Conv, FlaxNamed


class HRBasic(FlaxNamed):
    """timm / torchvision BasicBlock."""

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.downsample = downsample
        self.child(Conv(cin, features, 3, stride=stride, padding=1, bias=False), "conv1")
        self.child(BatchNorm(features), "bn1")
        self.child(Conv(features, features, 3, padding=1, bias=False), "conv2")
        self.child(BatchNorm(features), "bn2")
        if downsample:
            self.child(Conv(cin, features, 1, stride=stride, bias=False), "ds_conv")
            self.child(BatchNorm(features), "ds_bn")

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(h + identity)


class HRBottleneck(FlaxNamed):
    """Bottleneck with 4x expansion (``features`` = planes)."""

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.downsample = downsample
        out = features * 4
        self.child(Conv(cin, features, 1, bias=False), "conv1")
        self.child(BatchNorm(features), "bn1")
        self.child(Conv(features, features, 3, stride=stride, padding=1, bias=False), "conv2")
        self.child(BatchNorm(features), "bn2")
        self.child(Conv(features, out, 1, bias=False), "conv3")
        self.child(BatchNorm(out), "bn3")
        if downsample:
            self.child(Conv(cin, out, 1, stride=stride, bias=False), "ds_conv")
            self.child(BatchNorm(out), "ds_bn")

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(h + identity)


def _upsample_nearest(x, factor: int):
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class HRModule(FlaxNamed):
    """One HighResolutionModule: per-branch blocks, then the full fuse."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 2):
        super().__init__()
        self.channels = tuple(channels)
        self.num_blocks = num_blocks
        for i, c in enumerate(self.channels):
            for b in range(num_blocks):
                self.child(HRBasic(c, c), f"branch{i}_block{b}")
        for i, ci in enumerate(self.channels):
            for j, cj in enumerate(self.channels):
                if j > i:
                    self.child(Conv(cj, ci, 1, bias=False), f"fuse{i}_{j}_conv")
                    self.child(BatchNorm(ci), f"fuse{i}_{j}_bn")
                elif j < i:
                    for k in range(i - j):
                        cout = ci if k == i - j - 1 else cj
                        self.child(Conv(cj, cout, 3, stride=2, padding=1, bias=False),
                                   f"fuse{i}_{j}_conv{k}")
                        self.child(BatchNorm(cout), f"fuse{i}_{j}_bn{k}")

    def forward(self, xs):
        ys = []
        for i in range(len(self.channels)):
            h = xs[i]
            for b in range(self.num_blocks):
                h = getattr(self, f"branch{i}_block{b}")(h)
            ys.append(h)
        outs = []
        for i in range(len(self.channels)):
            acc = ys[i]
            for j in range(len(self.channels)):
                if j > i:
                    h = getattr(self, f"fuse{i}_{j}_bn")(getattr(self, f"fuse{i}_{j}_conv")(ys[j]))
                    h = _upsample_nearest(h, 2 ** (j - i))
                elif j < i:
                    h = ys[j]
                    for k in range(i - j):
                        h = getattr(self, f"fuse{i}_{j}_bn{k}")(
                            getattr(self, f"fuse{i}_{j}_conv{k}")(h))
                        if k != i - j - 1:
                            h = F.relu(h)
                else:
                    continue
                acc = acc + h
            outs.append(F.relu(acc))
        return outs


class HRNetW18SmallV2_4C(FlaxNamed):
    """timm ``hrnet_w18_small_v2`` with a 4-channel 3x3 stem and the
    ChannelAttention head gate; (B, 4, H, W) -> (B, 2048, H/32, W/32)."""

    WIDTHS = (18, 36, 72, 144)
    HEAD_PLANES = (32, 64, 128, 256)

    def __init__(self, with_ca: bool = True):
        super().__init__()
        w = self.WIDTHS
        self.with_ca = with_ca
        self.child(Conv(4, 64, 3, stride=2, padding=1, bias=False), "conv1")
        self.child(BatchNorm(64), "bn1")
        self.child(Conv(64, 64, 3, stride=2, padding=1, bias=False), "conv2")
        self.child(BatchNorm(64), "bn2")
        self.child(HRBottleneck(64, 64, downsample=True), "layer1_0")
        self.child(HRBottleneck(256, 64), "layer1_1")
        self.child(Conv(256, w[0], 3, padding=1, bias=False), "transition1_0_conv")
        self.child(BatchNorm(w[0]), "transition1_0_bn")
        self.child(Conv(256, w[1], 3, stride=2, padding=1, bias=False), "transition1_1_conv")
        self.child(BatchNorm(w[1]), "transition1_1_bn")
        self.child(HRModule(w[:2]), "stage2_m0")
        self.child(Conv(w[1], w[2], 3, stride=2, padding=1, bias=False), "transition2_2_conv")
        self.child(BatchNorm(w[2]), "transition2_2_bn")
        for m in range(3):
            self.child(HRModule(w[:3]), f"stage3_m{m}")
        self.child(Conv(w[2], w[3], 3, stride=2, padding=1, bias=False), "transition3_3_conv")
        self.child(BatchNorm(w[3]), "transition3_3_bn")
        for m in range(2):
            self.child(HRModule(w), f"stage4_m{m}")
        hp = self.HEAD_PLANES
        for i in range(4):
            self.child(HRBottleneck(w[i], hp[i], downsample=True), f"incre{i}")
        for i in range(3):
            self.child(Conv(hp[i] * 4, hp[i + 1] * 4, 3, stride=2, padding=1),
                       f"downsamp{i}_conv")
            self.child(BatchNorm(hp[i + 1] * 4), f"downsamp{i}_bn")
        self.child(Conv(hp[3] * 4, 2048, 1), "final_conv")
        self.child(BatchNorm(2048), "final_bn")
        if with_ca:
            self.child(ChannelAttention(2048), "ca")

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.layer1_1(self.layer1_0(h))
        xs = [F.relu(self.transition1_0_bn(self.transition1_0_conv(h))),
              F.relu(self.transition1_1_bn(self.transition1_1_conv(h)))]
        xs = self.stage2_m0(xs)
        xs = xs + [F.relu(self.transition2_2_bn(self.transition2_2_conv(xs[-1])))]
        for m in range(3):
            xs = getattr(self, f"stage3_m{m}")(xs)
        xs = xs + [F.relu(self.transition3_3_bn(self.transition3_3_conv(xs[-1])))]
        for m in range(2):
            xs = getattr(self, f"stage4_m{m}")(xs)
        y = self.incre0(xs[0])
        for i in range(3):
            yi = getattr(self, f"incre{i + 1}")(xs[i + 1])
            d = getattr(self, f"downsamp{i}_bn")(getattr(self, f"downsamp{i}_conv")(y))
            y = yi + F.relu(d)
        y = F.relu(self.final_bn(self.final_conv(y)))
        if self.with_ca:
            y = y * self.ca(y)
        return y
