"""Building blocks, the port of ``magicmirror/models/blocks.py`` (NCHW).

Submodules carry the names Flax gives them (``Conv_0``, ``BatchNorm_0``,
``ResBlock_2`` ...), so a Flax variable path maps one to one onto a torch
state-dict key (``models/convert.py``).  ``FlaxNamed.child`` reproduces
Flax's auto-naming: the class name and a per-class counter, in creation
order.  The port's classes therefore share the Flax classes' names.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm


class FlaxNamed(nn.Module):
    """A module whose children are named as Flax auto-names them."""

    def __init__(self):
        super().__init__()
        self._flax_counts: dict[str, int] = {}

    def child(self, module: nn.Module, name: str | None = None) -> nn.Module:
        if name is None:
            cls = type(module).__name__
            k = self._flax_counts.get(cls, 0)
            self._flax_counts[cls] = k + 1
            name = f"{cls}_{k}"
        self.add_module(name, module)
        return module


class Conv(nn.Conv2d):
    """Flax ``nn.Conv`` (zero padding, bias by default); ``classifier``
    heads take the N(0, 1e-5) init."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True,
                 classifier: bool = False):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding,
                         dilation=dilation, bias=bias)
        self.classifier = classifier


class Dense(nn.Linear):
    """Flax ``nn.Dense``; ``classifier`` heads take the N(0, 1e-5) init."""

    def __init__(self, cin: int, cout: int, classifier: bool = False):
        super().__init__(cin, cout)
        self.classifier = classifier


class BatchNorm(_BatchNorm):
    """BatchNorm over dim 1 of (N, C) or (N, C, H, W) input with eps 1e-5
    and momentum 0.1, as the JAX ``BatchNorm`` (``momentum`` 0.01 is Flax's
    own ``nn.BatchNorm``, whose running averages keep 0.99).

    In train mode the running variance follows the BIASED batch variance, as
    Flax's ``nn.BatchNorm`` keeps it (torch's own modules store the unbiased
    one).  With ``update_stats`` False a train-mode call normalises with the
    batch statistics and leaves the running ones alone: a frozen branch of
    the encoder must not advance them."""

    def __init__(self, num_features: int, momentum: float = 0.1):
        super().__init__(num_features, eps=1e-5, momentum=momentum)
        self.update_stats = True

    def _check_input_dim(self, input):
        if input.dim() not in (2, 4):
            raise ValueError(f"expected 2D or 4D input (got {input.dim()}D input)")

    def forward(self, x):
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        if not self.update_stats:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        self.num_batches_tracked += 1
        factor = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                  else self.momentum)
        n = x.numel() // x.shape[1]
        var_before = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                           True, factor, self.eps)
        # F.batch_norm stored (1 - f) * old + f * unbiased; biased = unbiased * (n - 1) / n.
        # Through .data, as F.batch_norm itself writes the statistics: autograd
        # saved the buffer for the backward and must not see a new version.
        self.running_var.data.mul_((n - 1) / n).add_(var_before, alpha=(1.0 - factor) / n)
        return out


class Dropout(nn.Module):
    """Flax ``nn.Dropout``: in train mode an element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate).  The keep mask is drawn
    from ``generator`` (None: torch's default generator of the input's
    device), or is ``mask`` when a caller has set one (a test injecting its
    own draw); rate 0 and eval mode are the identity."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None
        self.mask = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = self.mask
        if keep is None:
            keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.rate
        return x * keep / (1.0 - self.rate)


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=0.2)


_ACTS = {"relu": F.relu, "lrelu": leaky_relu, "tanh": torch.tanh, "none": None}


def _reflect_index(n: int, pad: int) -> list[int]:
    """numpy 'reflect' indices of a length-n axis padded by ``pad`` on each
    side; valid for pad >= n too (repeated reflection)."""
    period = 2 * (n - 1)
    out = []
    for i in range(-pad, n + pad):
        j = abs(i) % period if period else 0
        out.append(period - j if j >= n else j)
    return out


def pad_2d(x, pad: int, mode: str):
    """Pad H and W of an NCHW tensor with zeros or numpy-style reflection."""
    if pad == 0:
        return x
    if mode == "reflect":
        H, W = x.shape[2], x.shape[3]
        iy = torch.tensor(_reflect_index(H, pad), device=x.device)
        ix = torch.tensor(_reflect_index(W, pad), device=x.device)
        return x.index_select(2, iy).index_select(3, ix)
    return F.pad(x, (pad, pad, pad, pad))


def add_coords_2d(x):
    """CoordConv: append [yy, xx] ramps in [-1, 1] after the input channels."""
    B, _, H, W = x.shape
    ys = torch.linspace(-1.0, 1.0, H, dtype=x.dtype, device=x.device)
    xs = torch.linspace(-1.0, 1.0, W, dtype=x.dtype, device=x.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    grids = torch.stack([yy, xx], dim=0)[None].expand(B, 2, H, W)
    return torch.cat([x, grids], dim=1)


def adaptive_pool(x, out_shape, kind: str):
    """Adaptive max / avg pool of NCHW -> (B, C, oh, ow); bins are
    [floor(i*H/oh), ceil((i+1)*H/oh)), torch's and the JAX package's."""
    if kind == "max":
        return F.adaptive_max_pool2d(x, out_shape)
    return F.adaptive_avg_pool2d(x, out_shape)


def upsample2x(x):
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class InstanceNorm(nn.Module):
    """InstanceNorm2d of NCHW input: each sample's channel over H, W with
    the biased variance, eps 1e-5; with ``affine`` a per-channel ``weight``
    (Flax's ``scale``) and ``bias``."""

    def __init__(self, features: int = 0, affine: bool = False):
        super().__init__()
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        if self.affine:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y


class IBN(FlaxNamed):
    """Half instance-, half batch-norm: the first ``features // 2`` channels
    through an affine InstanceNorm (``IN``), the rest through BatchNorm
    (``BN``)."""

    def __init__(self, features: int):
        super().__init__()
        self.half = features // 2
        self.child(InstanceNorm(self.half, affine=True), "IN")
        self.child(BatchNorm(features - self.half), "BN")

    def forward(self, x):
        return torch.cat([self.IN(x[:, :self.half]), self.BN(x[:, self.half:])], dim=1)


class LayerNormAll(nn.Module):
    """Per-sample LayerNorm over every non-batch dim, ``(x - mean) / (std +
    eps)`` with the population std, then a per-channel ``gamma`` and
    ``beta``."""

    def __init__(self, features: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        flat = x.reshape(x.shape[0], -1)
        std, mean = torch.std_mean(flat, dim=1, correction=0)
        shape = (-1,) + (1,) * (x.dim() - 1)
        y = (x - mean.reshape(shape)) / (std.reshape(shape) + 1e-5)
        return y * self.gamma[:, None, None] + self.beta[:, None, None]


NORMS = ("bn", "in", "ibn", "ln", "sn", "none")


class Conv2dBlock(FlaxNamed):
    """[coords] -> explicit pad -> VALID conv -> norm -> activation.  The norms:
    'bn' BatchNorm, 'in' InstanceNorm, 'ibn' IBN, 'ln' LayerNormAll, and
    'sn' or 'none' no norm; the conv has a bias unless the norm is 'bn'."""

    def __init__(self, cin: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, norm: str = "none", activation: str = "lrelu",
                 padding_mode: str = "zeros", dilation: int = 1,
                 coordconv: bool = False):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"Unsupported normalization: {norm}")
        self.padding = padding
        self.padding_mode = padding_mode
        self.coordconv = coordconv
        self.act = _ACTS[activation]
        self.child(Conv(cin + 2 if coordconv else cin, features, kernel_size,
                        stride=stride, dilation=dilation, bias=norm != "bn"))
        make = {"bn": lambda: BatchNorm(features), "in": InstanceNorm,
                "ibn": lambda: IBN(features), "ln": lambda: LayerNormAll(features)}.get(norm)
        self.norm = None if make is None else self.child(make())._get_name() + "_0"

    def forward(self, x):
        if self.coordconv:
            x = add_coords_2d(x)
        x = self.Conv_0(pad_2d(x, self.padding, self.padding_mode))
        if self.norm is not None:
            x = getattr(self, self.norm)(x)
        return x if self.act is None else self.act(x)


class ChannelAttention(FlaxNamed):
    """Squeeze-excite gate."""

    def __init__(self, features: int):
        super().__init__()
        mid = max(features // 16, 1)
        self.child(Conv(features, mid, 1))
        self.child(Conv(mid, features, 1))

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(s))))


def _second_norm(norm: str) -> str:
    """The norm of a residual block's second conv: IBN's blocks end in
    BatchNorm."""
    return "bn" if norm == "ibn" else norm


class ResBlock(FlaxNamed):
    """0.2-residual block."""

    def __init__(self, features: int, norm: str = "bn", activation: str = "lrelu",
                 padding_mode: str = "zeros"):
        super().__init__()
        self.child(Conv2dBlock(features, features // 2, 3, 1, 1, norm=norm,
                               activation=activation, padding_mode=padding_mode))
        self.child(Conv2dBlock(features // 2, features, 3, 1, 1, norm=_second_norm(norm),
                               activation="none", padding_mode=padding_mode))

    def forward(self, x):
        return 0.2 * x + self.Conv2dBlock_1(self.Conv2dBlock_0(x))


class ResBlockHalf(FlaxNamed):
    """Stride-2 block concatenated with an avg-pooled residual: 2x channels."""

    def __init__(self, features: int, norm: str = "bn", activation: str = "lrelu",
                 padding_mode: str = "zeros"):
        super().__init__()
        self.child(Conv2dBlock(features, features, 3, 2, 1, norm=norm,
                               activation=activation, padding_mode=padding_mode))
        self.child(Conv2dBlock(features, features, 3, 1, 1, norm=_second_norm(norm),
                               activation="none", padding_mode=padding_mode))

    def forward(self, x):
        h = self.Conv2dBlock_1(self.Conv2dBlock_0(x))
        residual = F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)
        return torch.cat([h, residual], dim=1)


class ResBlocks(FlaxNamed):
    """``num`` ResBlocks with a channel-attention residual gate."""

    def __init__(self, num: int, features: int, norm: str = "bn"):
        super().__init__()
        self.num = num
        for _ in range(num):
            self.child(ResBlock(features, norm=norm))
        self.child(ChannelAttention(features))

    def forward(self, x):
        out = x
        for i in range(self.num):
            out = getattr(self, f"ResBlock_{i}")(out)
        return x + self.ChannelAttention_0(out) * out


class ASPP(FlaxNamed):
    """Atrous pyramid (dilations 1, 2, 4, 8) with reflect padding and a
    channel-attention gate."""

    DILATIONS = (1, 2, 4, 8)

    def __init__(self, features: int):
        super().__init__()
        q = features // 4
        for i, d in enumerate(self.DILATIONS):
            self.child(Conv(features, q if i < 3 else features - 3 * q, 3, dilation=d))
        self.child(ChannelAttention(features))

    def forward(self, x):
        f = torch.cat([getattr(self, f"Conv_{i}")(pad_2d(x, d, "reflect"))
                       for i, d in enumerate(self.DILATIONS)], dim=1)
        return x + f * self.ChannelAttention_0(f)


class MMPool(nn.Module):
    """Learnable sigmoid mix of adaptive max and avg pooling."""

    def __init__(self, shape=(1, 1), p_init: float = 0.0):
        super().__init__()
        self.shape = tuple(shape)
        self.p = nn.Parameter(torch.full((1,), float(p_init)))

    def forward(self, x):
        w = torch.sigmoid(self.p[0])
        return adaptive_pool(x, self.shape, "max") * w + adaptive_pool(
            x, self.shape, "avg") * (1.0 - w)


class LinearBlock(FlaxNamed):
    """Linear + BN1d (+ ReLU)."""

    def __init__(self, cin: int, features: int, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.child(Dense(cin, features))
        self.child(BatchNorm(features))

    def forward(self, x):
        x = self.BatchNorm_0(self.Dense_0(x))
        return F.relu(x) if self.relu else x
