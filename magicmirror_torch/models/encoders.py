"""The encoders, the port of ``magicmirror/models/encoders.py``.

Each encoder takes NHWC RGBA images in [0, 1] (the JAX layout) and runs its
convolutions NCHW.  The dropout layers (``blocks.Dropout``) sit where the
JAX modules have theirs and are the identity in eval mode.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops import clip01
from ..ops.sampling import grid_sample
from .backbones import Resnet4C, make_backbone, normalize_batch_4c
from .blocks import (ASPP, BatchNorm, Conv2dBlock, Dense, Dropout, FlaxNamed, LinearBlock,
                     MMPool, ResBlock, ResBlockHalf, ResBlocks, leaky_relu, upsample2x)


def _sample_at_template(feat, template_xy, align_corners: bool):
    """Bilinear-sample NCHW features at the template's (x, y) -> (B, C, V, 1)."""
    B, V = feat.shape[0], template_xy.shape[0]
    grid = template_xy[None, :, None, :].expand(B, V, 1, 2)
    return F.grid_sample(feat, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=align_corners)


def clip01_signed(x):
    """Hardtanh: clip to [-1, 1] with the gradient of ``jnp.clip`` (1/2 at
    exactly +-1, where ``torch.clamp`` passes 1)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(-1.0)), x.new_ones(()))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class CameraEncoder(FlaxNamed):
    """Camera heads: distance and elevation via range-squashed sigmoids,
    azimuth via the angle of a 2-vector, xy bias via tanh; conditioned on the
    pooled backbone features and, unless ``nolpl``, the features pooled at
    the template's vertices."""

    def __init__(self, nc: int = 4, nk: int = 5, azi_scope: float = 360.0,
                 elev_range: str = "0~30", dist_range: str = "2~7",
                 coordconv: bool = False, norm: str = "bn", pretrain: str = "none",
                 droprate: float = 0.0, nolpl: bool = False):
        super().__init__()
        backbone, dim = make_backbone(pretrain, nc, nk, norm, coordconv)
        self.nolpl = nolpl
        self.child(backbone, "backbone")
        self.child(MMPool((2, 2)), "avgpool1")
        if not nolpl:
            self.child(MMPool((2, 2)), "avgpool2")
        self.azi_scope = azi_scope
        self.elev_min, self.elev_max = (float(v) for v in elev_range.split("~"))
        self.dist_min, self.dist_max = (float(v) for v in dist_range.split("~"))
        for head in ("dist", "azim", "bias"):
            self.child(LinearBlock(dim * 4 * (1 if nolpl else 2), 128, relu=False),
                       f"{head}_lb")
            self.child(Dropout(droprate), f"{head}_drop")
            self.child(Dense(128, 2, classifier=True), f"{head}_out")

    @staticmethod
    def atan2_deg(y, x):
        """sign(y) * acos(x / r) in degrees, the reference's atan2."""
        r = torch.sqrt(x ** 2 + y ** 2 + 1e-12) + 1e-6
        u = torch.clamp(x / r, -1.0 + 1e-6, 1.0 - 1e-6)
        return torch.sign(y) * torch.arccos(u) * 180.0 / math.pi

    def forward(self, x, template):
        x = self.backbone(_nchw(normalize_batch_4c(x)))
        if self.nolpl:
            x = self.avgpool1(x)
        else:
            local = _sample_at_template(x, template[:, :2], align_corners=False)
            x = torch.cat([self.avgpool1(x), self.avgpool2(local)], dim=1)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten H, W, C

        def head(name):
            h = getattr(self, f"{name}_drop")(getattr(self, f"{name}_lb")(x))
            return getattr(self, f"{name}_out")(h)

        dist_out, azim_out, bias_out = head("dist"), head("azim"), head("bias")
        distances = self.dist_min + torch.sigmoid(dist_out[:, 0]) * (
            self.dist_max - self.dist_min)
        elevations = self.elev_min + torch.sigmoid(dist_out[:, 1]) * (
            self.elev_max - self.elev_min)
        azimuths = -self.atan2_deg(azim_out[:, 1], azim_out[:, 0]) / 360.0 * self.azi_scope
        biases = torch.tanh(bias_out)
        return azimuths, elevations, distances, biases


class ShapeEncoder(FlaxNamed):
    """Per-vertex deformation head: template-local, global and Laplacian
    neighbour features per vertex, a per-vertex MLP, a full (3V, 3V) linear;
    with ``nolpl`` the pooled features through BatchNorm and a (C, 3V)
    linear; offsets bounded by 0.5 * tanh and zero-meaned."""

    def __init__(self, nc: int = 4, nk: int = 5, num_vertices: int = 642,
                 pretrain: str = "hr18sv2", coordconv: bool = False, norm: str = "bn",
                 droprate: float = 0.0, nolpl: bool = False):
        super().__init__()
        self.num_vertices = num_vertices
        self.nolpl = nolpl
        backbone, dim = make_backbone(pretrain, nc, nk, norm, coordconv)
        self.child(backbone, "backbone")
        self.child(MMPool((1, 1)), "mmpool")
        if nolpl:
            self.child(BatchNorm(dim), "bn")
            self.child(Dense(dim, num_vertices * 3, classifier=True), "linear3")
            return
        self.child(Dense(3 * dim + 3, 256), "conv1")
        self.child(BatchNorm(256), "bn1")
        self.child(Dropout(droprate), "drop1")
        self.child(Dense(256, 3), "conv2")
        self.child(BatchNorm(3), "bn2")
        self.child(Dense(num_vertices * 3, num_vertices * 3, classifier=True), "linear3")

    def forward(self, x, template, lpl):
        B, V = x.shape[0], self.num_vertices
        x = self.backbone(_nchw(normalize_batch_4c(x)))
        if self.nolpl:
            delta = 0.5 * torch.tanh(self.linear3(self.bn(self.mmpool(x).reshape(B, -1))))
            delta = delta.reshape(B, V, 3)
            return delta - delta.mean(dim=1, keepdim=True)
        local = _sample_at_template(x, template[:, :2], align_corners=True)
        local = local[..., 0].permute(0, 2, 1)  # (B, V, C)
        glob = self.mmpool(x).reshape(B, 1, -1).expand(B, V, -1)
        neighbor_diff = torch.einsum("bvc,vw->bwc", local, lpl)
        pos = template[None].expand(B, V, 3)
        h = torch.cat([local, glob, neighbor_diff, pos], dim=-1)
        # a 1x1 Conv1d over vertices is a Dense on channels; BN1d normalises
        # each channel over (batch, vertices)
        h = leaky_relu(self.bn1(self.conv1(h).reshape(B * V, -1)).reshape(B, V, -1))
        h = self.drop1(h)
        h = self.bn2(self.conv2(h).reshape(B * V, 3))
        delta = 0.5 * torch.tanh(self.linear3(h.reshape(B, V * 3)))
        delta = delta.reshape(B, V, 3)
        return delta - delta.mean(dim=1, keepdim=True)


class LightEncoder(FlaxNamed):
    """9-coefficient SH light head, ambient coefficient biased to 3."""

    WIDTHS = (32, 64, 96, 192, 96)

    def __init__(self, nc: int = 4, nk: int = 5, coordconv: bool = False, norm: str = "bn",
                 droprate: float = 0.0):
        super().__init__()
        cin = nc
        for i, w in enumerate(self.WIDTHS):
            self.child(Conv2dBlock(cin, w, nk, 2, nk // 2, norm=norm,
                                   coordconv=coordconv and i < 2))
            cin = w
        self.child(MMPool((1, 1)))
        self.child(LinearBlock(cin, 48, relu=False))
        self.child(Dropout(droprate), "drop")
        self.child(Dense(48, 9, classifier=True))

    def forward(self, x):
        B = x.shape[0]
        x = _nchw(normalize_batch_4c(x))
        for i in range(len(self.WIDTHS)):
            x = getattr(self, f"Conv2dBlock_{i}")(x)
        x = self.drop(self.LinearBlock_0(self.MMPool_0(x).reshape(B, -1)))
        lightparam = torch.tanh(self.Dense_0(x))
        scale = torch.tensor([[0.5] + [0.1] * 8], dtype=x.dtype, device=x.device)
        bias = torch.tensor([[3.0] + [0.0] * 8], dtype=x.dtype, device=x.device)
        return lightparam * scale + bias


class BackgroundEncoder(FlaxNamed):
    """Masked-background inpainting head: a stride-2 conv on the photo's
    background (``img * (1 - mask)``), three residual blocks without norm, a
    nearest 2x upsample, dropout at half the rate, a conv and a sigmoid ->
    (B, H, W, 3) NHWC in (0, 1)."""

    def __init__(self, droprate: float = 0.0):
        super().__init__()
        self.child(Conv2dBlock(3, 32, 3, 2, 1, norm="none", activation="none"))
        self.child(ResBlocks(3, 32, norm="none"))
        self.child(Dropout(droprate / 2), "drop")
        self.child(Conv2dBlock(32, 3, 3, 1, 1, norm="none", activation="none"))

    def forward(self, x):
        bg = _nchw(x[..., :3] * (1.0 - x[..., 3:4]))
        h = upsample2x(self.ResBlocks_0(self.Conv2dBlock_0(bg)))
        h = self.Conv2dBlock_1(self.drop(h))
        return torch.sigmoid(h).permute(0, 2, 3, 1)


class BiFPN(FlaxNamed):
    """Bidirectional FPN over a 4-level pyramid (x5, x4, x3, x2) with
    channels (d, d/2, d/4, d/8)."""

    def __init__(self, outdim: int, norm: str = "bn", down: bool = True):
        super().__init__()
        d = outdim
        self.down = down
        # (cin, cout, stride): the top-down convs, then the bottom-up ones
        convs = [(d, d // 2, 1), (d // 2, d // 4, 1), (d // 4, d // 8, 1)]
        if down:
            convs += [(d // 8, d // 8, 1), (d // 8, d // 4, 2), (d // 4, d // 2, 2),
                      (d // 2, d, 2)]
        for cin, cout, stride in convs:
            self.child(Conv2dBlock(cin, cout, 3, stride, 1, norm=norm))

    def forward(self, inputs):
        x5, x4, x3, x2 = inputs
        t4 = upsample2x(self.Conv2dBlock_0(x5)) + 0.2 * x4
        t3 = upsample2x(self.Conv2dBlock_1(t4)) + 0.2 * x3
        t2 = upsample2x(self.Conv2dBlock_2(t3)) + 0.2 * x2
        if not self.down:
            return t2
        b2 = x2 + 0.2 * self.Conv2dBlock_3(t2)
        b3 = x3 + 0.2 * t3 + 0.2 * self.Conv2dBlock_4(b2)
        b4 = x4 + 0.2 * t4 + 0.2 * self.Conv2dBlock_5(b3)
        b5 = x5 + 0.2 * self.Conv2dBlock_6(b4)
        return [b5, b4, b3, b2]


class TextureBiFPN(FlaxNamed):
    """3x BiFPN decoder -> 2-channel texture flow at 4x the x2 resolution,
    clipped to [-1, 1] with ``final_tanh``."""

    def __init__(self, outdim: int, norm: str = "bn", droprate: float = 0.0,
                 final_tanh: bool = True):
        super().__init__()
        d = outdim
        self.final_tanh = final_tanh
        self.child(Dropout(droprate / 2), "drop")
        self.child(BiFPN(d, norm=norm, down=True))
        self.child(BiFPN(d, norm=norm, down=True))
        self.child(BiFPN(d, norm=norm, down=False))
        self.child(Conv2dBlock(d // 8, d // 16, 3, 1, 1, norm=norm))
        self.child(ASPP(d // 16))
        self.child(Conv2dBlock(d // 16, d // 32, 3, 1, 1, norm=norm))
        self.child(ASPP(d // 32))
        self.child(Conv2dBlock(d // 32, 2, 5, 1, 2, norm="none", activation="none",
                               padding_mode="reflect"))

    def forward(self, x5, x4, x3, x2):
        p = self.BiFPN_1(self.BiFPN_0([x5, x4, x3, x2]))
        h = self.Conv2dBlock_0(self.BiFPN_2(p))
        h = upsample2x(self.ASPP_0(h))
        h = self.drop(upsample2x(self.ASPP_1(self.Conv2dBlock_1(h))))
        h = self.Conv2dBlock_2(h)
        return clip01_signed(h) if self.final_tanh else h  # Hardtanh


class TextureEncoder(FlaxNamed):
    """Texture flow: a pyramid (ResNet-34, or the 'none' residual pyramid) ->
    TextureBiFPN -> 2-channel flow -> bicubic sample of the input image ->
    with ``makeup`` 1-4 a refinement of the sampled map beside its mirror
    image (InstanceNorm blocks, added and clipped to [0, 1]; at 5 the flow
    is not clipped) -> vertical concat with the flipped map -> (B, 2H, W, 3)."""

    def __init__(self, pretrain: str = "res34", norm: str = "bn", nk: int = 5,
                 coordconv: bool = False, droprate: float = 0.0, makeup: int = 0):
        super().__init__()
        self.pretrain = pretrain
        self.makeup = makeup
        if pretrain == "res34":
            self.child(Resnet4C(arch="res34", stride=2, return_pyramid=True))
        elif pretrain == "none":
            self.child(Conv2dBlock(4, 32, nk, 2, 2, norm="bn", coordconv=coordconv))
            for width, blocks in ((32, 1), (64, 3), (128, 3), (256, 2)):
                self.child(ResBlockHalf(width, norm=norm))
                self.child(ResBlocks(blocks, 2 * width, norm=norm))
        else:
            raise NotImplementedError(
                f"texture backbone {pretrain!r}: only 'res34' and 'none' are ported")
        self.child(TextureBiFPN(512, norm=norm, droprate=droprate, final_tanh=makeup != 5))
        self.refine = []  # the names of the refinement's layers, in order
        if makeup in (1, 2, 3, 4):
            layers = [Conv2dBlock(6, 32, 5, 1, 2, norm="in")]
            if makeup in (1, 2):
                layers += [ResBlock(32, norm="in"), ResBlock(32, norm="in")]
            if makeup != 1:
                layers.append(Dropout(droprate))
            layers.append(Conv2dBlock(32, 3, 3, 1, 1, norm="none", activation="none"))
            for layer in layers:
                self.child(layer)
                self.refine.append(next(reversed(self._modules)))

    def pyramid(self, x):
        if self.pretrain == "res34":
            return self.Resnet4C_0(x)[1:]
        h = self.Conv2dBlock_0(x)
        feats = []
        for i in range(4):
            h = getattr(self, f"ResBlocks_{i}")(getattr(self, f"ResBlockHalf_{i}")(h))
            feats.append(h)
        return feats

    def forward(self, x):
        img = x[..., :3]
        x2, x3, x4, x5 = self.pyramid(_nchw(normalize_batch_4c(x)))
        flow = self.TextureBiFPN_0(x5, x4, x3, x2).permute(0, 2, 3, 1)
        textures = grid_sample(img, flow, mode="bicubic", align_corners=True)
        if self.refine:
            h = _nchw(torch.cat([textures, textures.flip(2)], dim=-1))
            for name in self.refine:
                h = getattr(self, name)(h)
            textures = clip01(textures + h.permute(0, 2, 3, 1))
        return torch.cat([textures, textures.flip(1)], dim=1)


class FeatureEncoder(FlaxNamed):
    """Per-pixel features for the landmark-consistency head: NHWC RGBA ->
    (B, H/4, W/4, 256) NHWC."""

    def __init__(self, nc: int = 4, nk: int = 5, norm: str = "bn"):
        super().__init__()
        self.child(Conv2dBlock(nc, 64, nk, 2, nk // 2, norm=norm))
        self.child(Conv2dBlock(64, 128, nk, 2, nk // 2, norm=norm))
        self.child(Conv2dBlock(128, 256, 3, 1, 1, norm=norm))

    def forward(self, x):
        x = _nchw(normalize_batch_4c(x))
        x = self.Conv2dBlock_2(self.Conv2dBlock_1(self.Conv2dBlock_0(x)))
        return x.permute(0, 2, 3, 1)
