"""The critics and the landmark head, the port of
``magicmirror/models/discriminators.py``.

``Discriminator`` is the 15-conv norm-free WGAN critic; ``MSDiscriminator``
the three-scale LSGAN critic (``--gan_type lsgan``); ``SNDiscriminator`` the
spectral-norm DCGAN critic (``--sn_dis``).  All take NHWC images and use
LeakyReLU(0.2).  ``LandmarkConsistency`` is the face-identity head of
``--lambda_lc``, part of the encoder.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm, Conv, Dense, FlaxNamed, leaky_relu


class Discriminator(FlaxNamed):
    """NHWC images (B, H, W, nc) -> (B, 1): a near-zero-init 1x1 head, the
    mean over the patch map."""

    def __init__(self, nc: int = 3, nf: int = 16, use_bias: bool = False):
        super().__init__()
        # (features, kernel, stride)
        spec = [(nf, 1, 1), (nf, 3, 1), (nf * 2, 3, 2), (nf * 2, 3, 1), (nf * 3, 3, 2),
                (nf * 3, 3, 1), (nf * 4, 3, 2), (nf * 4, 3, 1), (nf * 4, 3, 2),
                (nf * 4, 3, 1), (nf * 4, 3, 2), (nf * 4, 3, 1), (nf * 3, 3, 2),
                (nf * 2, 1, 1)]
        self.depth = _conv_stack(self, nc, spec, use_bias)

    def forward(self, x):
        x = _run_stack(self, x.permute(0, 3, 1, 2))
        return x.mean(dim=(2, 3))


def _conv_stack(module, cin, spec, use_bias) -> int:
    """Conv_0 .. Conv_{n-1} of ``spec`` (features, kernel, stride), padded by
    kernel // 2, then the 1x1 classifier head Conv_n -> n."""
    for features, k, stride in spec:
        module.child(Conv(cin, features, k, stride=stride, padding=k // 2, bias=use_bias))
        cin = features
    module.child(Conv(cin, 1, 1, bias=use_bias, classifier=True))
    return len(spec)


def _run_stack(module, x):
    for i in range(module.depth):
        x = leaky_relu(getattr(module, f"Conv_{i}")(x))
    return getattr(module, f"Conv_{module.depth}")(x)


class _ScaleCritic(FlaxNamed):
    """One scale of the LSGAN critic: NCHW -> the (B, 1, h, w) patch map."""

    def __init__(self, nc: int = 4, nf: int = 32, use_bias: bool = True):
        super().__init__()
        spec = [(nf // 2, 1, 1), (nf // 2, 3, 1), (nf, 3, 2), (nf, 3, 1), (nf, 3, 2),
                (nf, 3, 1), (nf * 2, 3, 2), (nf * 2, 3, 1), (nf * 2, 3, 2), (nf * 2, 1, 1)]
        self.depth = _conv_stack(self, nc, spec, use_bias)

    def forward(self, x):
        return _run_stack(self, x)


class MSDiscriminator(FlaxNamed):
    """The three-scale LSGAN critic: NHWC images -> a list of (B, h, w, 1)
    patch maps, the image average-pooled (3x3, stride 2, padding not
    counted) between scales."""

    def __init__(self, nc: int = 4, nf: int = 32, use_bias: bool = True,
                 num_scales: int = 3):
        super().__init__()
        self.num_scales = num_scales
        for i in range(num_scales):
            self.child(_ScaleCritic(nc, nf, use_bias), f"scale{i}")

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        outputs = []
        for i in range(self.num_scales):
            outputs.append(getattr(self, f"scale{i}")(x).permute(0, 2, 3, 1))
            if i < self.num_scales - 1:
                x = F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)
        return outputs


class LandmarkConsistency(FlaxNamed):
    """Per-face identity classifier: image features sampled at the faces'
    projected centres, a 1024-wide Dense, BatchNorm on the batch's own
    statistics (Flax's ``nn.BatchNorm``: running averages at 0.99, scale 1
    at init), ReLU, a Dense over the faces; the cross entropy of each face's
    own index, averaged over the visible ones."""

    def __init__(self, num_landmarks: int = 1280, dim_feat: int = 256):
        super().__init__()
        self.child(Dense(dim_feat, 1024))
        bn = self.child(BatchNorm(1024, momentum=0.01), "BatchNorm_0")
        bn.unit_scale = True  # init_from_seed: scale 1, as Flax's nn.BatchNorm
        self.child(Dense(1024, num_landmarks, classifier=True))

    def forward(self, img_feat, landmark_2d, visible, sample_idx):
        """img_feat (B, H, W, C) NHWC; landmark_2d (B, F, 2) in [-1, 1]
        (x right, y down); visible (B, F); sample_idx (S,) -> the loss."""
        B = landmark_2d.shape[0]
        feat = F.grid_sample(img_feat.permute(0, 3, 1, 2), landmark_2d[:, None],
                             mode="bilinear", padding_mode="zeros", align_corners=False)
        feat = feat[:, :, 0].permute(0, 2, 1)[:, sample_idx]  # (B, S, C)
        bn = self.BatchNorm_0
        was_training = bn.training
        bn.train()  # the batch's statistics, whatever the encoder's mode
        try:
            h = bn(self.Dense_0(feat).reshape(-1, 1024)).reshape(B, -1, 1024)
        finally:
            bn.train(was_training)
        logp = F.log_softmax(self.Dense_1(F.relu(h)), dim=-1)
        labels = sample_idx[None].expand(B, -1)
        ce = -logp.gather(-1, labels[..., None])[..., 0]
        vis = visible[:, sample_idx].to(torch.float32)
        return (ce * vis).sum() / (vis.sum() + 1e-8)


def spectral_sigma(w2d, n_iter: int = 5, eps: float = 1e-12):
    """The largest singular value of ``w2d`` by ``n_iter`` steps of power
    iteration from the fixed start 1 / sqrt(rows), anew at every call: u and
    v carry no gradient, sigma = u^T W v does.  (``torch.nn.utils.
    spectral_norm`` keeps u across calls and steps once per call.)"""
    with torch.no_grad():
        u = torch.full((w2d.shape[0],), 1.0 / math.sqrt(w2d.shape[0]), dtype=w2d.dtype,
                       device=w2d.device)
        for _ in range(n_iter):
            v = w2d.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = w2d @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
    return u @ (w2d @ v)


class SNConv(nn.Module):
    """A bias-free conv whose weight is divided by its spectral norm
    (:func:`spectral_sigma` of the (cout, cin * kh * kw) matrix)."""

    def __init__(self, cin: int, features: int, kernel: int = 4, stride: int = 2,
                 pad: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel))
        self.stride, self.pad = stride, pad

    def forward(self, x):
        w = self.weight / spectral_sigma(self.weight.reshape(self.weight.shape[0], -1))
        return F.conv2d(x, w, stride=self.stride, padding=self.pad)


def _instance_norm(x, eps: float = 1e-5):
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


class SNDiscriminator(FlaxNamed):
    """The spectral-norm DCGAN critic: 4x4 stride-2 SN convs with
    InstanceNorm and LeakyReLU(0.2) for images 32, 64 or 128 wide, a 4x4
    SN head, the mean over the patch map -> (B, 1)."""

    def __init__(self, nc: int = 3, ndf: int = 64, imsize: int = 128):
        super().__init__()
        if imsize not in (32, 64, 128):
            raise ValueError("imsize must be 32/64/128")
        self.nc = nc
        widths = {128: [ndf // 2, ndf, ndf * 2], 64: [ndf, ndf * 2], 32: [ndf * 2]}[imsize]
        widths += [ndf * 4, ndf * 8]
        # the first layer of the 128 and 64 stacks has no InstanceNorm
        self.normed = [i > 0 or imsize == 32 for i in range(len(widths))]
        cin = nc
        for w in widths:
            self.child(SNConv(cin, w))
            cin = w
        self.child(SNConv(cin, 1, kernel=4, stride=1, pad=0))
        self.depth = len(widths)

    def forward(self, x):
        x = x[..., :self.nc].permute(0, 3, 1, 2)
        for i, normed in enumerate(self.normed):
            x = getattr(self, f"SNConv_{i}")(x)
            x = leaky_relu(_instance_norm(x) if normed else x)
        return getattr(self, f"SNConv_{self.depth}")(x).mean(dim=(2, 3))
