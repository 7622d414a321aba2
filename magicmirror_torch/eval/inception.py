"""InceptionV3 for FID (pool3 features), the port of
``magicmirror/eval/inception.py``: pytorch-fid's network with its three FID
tweaks (average pools that do not count the padding, a max pool in the last
block), in plain torch with the checkpoint's tensor names.

Pretrained weights cannot be fetched offline.  ``load_fid_weights`` reads
the flat ``.npz`` that ``python -m magicmirror_torch.eval.convert_fid_weights
CHECKPOINT.pth`` writes (Flax names and layouts, as the JAX package's
converter writes it) from ``fid_weights.npz`` beside this module, or the
path ``MAGICMIRROR_FID_WEIGHTS`` names; without it the network takes
Flax's default init from a fixed seed, as the JAX package's fallback does,
and says loudly that FID values are then self-consistent but not comparable
to pytorch-fid's.
"""
from __future__ import annotations

import math
import os
import warnings

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "fid_weights.npz")
INIT_SEED = 2015


class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, bias=False, **kw)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg(x):  # the FID tweak: count_include_pad=False
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class FIDInceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(cin, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg(x))
        return torch.cat([b1, b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        return torch.cat([self.branch3x3(x),
                          self.branch3x3dbl_3(self.branch3x3dbl_2(
                              self.branch3x3dbl_1(x))),
                          F.max_pool2d(x, 3, stride=2)], 1)


class FIDInceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7),
                                       padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1),
                                       padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1),
                                          padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7),
                                          padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1),
                                          padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7),
                                          padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_5(self.branch7x7dbl_4(self.branch7x7dbl_3(
            self.branch7x7dbl_2(self.branch7x7dbl_1(x)))))
        bp = self.branch_pool(_avg(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7),
                                         padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1),
                                         padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(
            self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class FIDInceptionE(nn.Module):
    def __init__(self, cin, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(cin, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3),
                                        padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1),
                                        padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3),
                                           padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1),
                                           padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, kernel_size=1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.pool == "max":  # FIDInceptionE_2
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:                   # FIDInceptionE_1
            bp = _avg(x)
        bp = self.branch_pool(bp)
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3FID(nn.Module):
    """pytorch-fid's pool3 (2048-d) extractor: NCHW input in [0, 1] of any
    size, resized to 299^2 and scaled to [-1, 1]; eval mode.  Attribute
    names are the pt_inception-2015-12-05 checkpoint's (torchvision naming),
    so that checkpoint's state_dict loads as it is."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = FIDInceptionA(192, 32)
        self.Mixed_5c = FIDInceptionA(256, 64)
        self.Mixed_5d = FIDInceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = FIDInceptionC(768, 128)
        self.Mixed_6c = FIDInceptionC(768, 160)
        self.Mixed_6d = FIDInceptionC(768, 160)
        self.Mixed_6e = FIDInceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = FIDInceptionE(1280, "avg")
        self.Mixed_7c = FIDInceptionE(2048, "max")

    def forward(self, x, resize=True):
        if resize:
            x = F.interpolate(x, size=(299, 299), mode="bilinear",
                              align_corners=False)
        x = 2.0 * x - 1.0
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def _weights_path(path: str | None) -> str:
    return path or os.environ.get("MAGICMIRROR_FID_WEIGHTS", DEFAULT_WEIGHTS)


def fid_weights_available(path: str | None = None) -> bool:
    """True when converted pytorch-fid weights are on disk: a caller that
    decides on FID (the best checkpoint) must check this."""
    return os.path.isfile(_weights_path(path))


def flax_to_torch_fid(flat: dict) -> dict:
    """The converter's flat ``params/<block>/.../conv/kernel`` (HWIO) and
    ``.../bn/{scale,bias}``, ``batch_stats/.../bn/{mean,var}`` arrays -> a
    state_dict of :class:`InceptionV3FID`."""
    out = {}
    leaves = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
    for key, value in flat.items():
        parts = key.split("/")
        value = np.asarray(value)
        if parts[-1] == "kernel":
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[".".join(parts[1:-1] + [leaves[parts[-1]]])] = torch.as_tensor(value)
    return out


def flax_default_init(model: nn.Module, seed: int = INIT_SEED) -> nn.Module:
    """The init the JAX package's fallback network gets (Flax's defaults),
    drawn from a seeded ``torch.Generator``: convolution kernels
    lecun-normal (a normal truncated at two standard deviations, of variance
    1 / fan_in), BatchNorm scale 1 and bias 0 with statistics (0, 1).
    torch's own init (kaiming-uniform with a = sqrt(5)) shrinks the
    activations to 1e-7 over the network's depth; Flax's keeps them near
    1e-3."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                u = lo + (hi - lo) * torch.rand(m.weight.shape, generator=g, dtype=torch.float64)
                x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
                # the truncated normal's unit variance: 0.8796... is its std
                std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
                m.weight.copy_(x * std)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def load_fid_weights(path: str | None = None, device="cpu") -> InceptionV3FID:
    """The FID network in eval mode on ``device``: with the converted
    weights when they are on disk, else with :func:`flax_default_init` from
    a fixed seed and a warning."""
    model = InceptionV3FID()
    path = _weights_path(path)
    if os.path.isfile(path):
        with np.load(path) as flat:
            state = flax_to_torch_fid(dict(flat))
        missing, unexpected = model.load_state_dict(state, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError(f"{path}: missing {missing}, unexpected {unexpected}")
    else:
        flax_default_init(model)
        warnings.warn(
            "FID inception weights not found at %s: using fixed-seed random features. "
            "FID values will be self-consistent but NOT comparable to pytorch-fid numbers. "
            "Convert the reference weights with "
            "python -m magicmirror_torch.eval.convert_fid_weights CHECKPOINT.pth."
            % path)
    return model.to(device).eval()
