"""Grid sampling and UV texture mapping, NHWC at the public interface.

The port of ``magicmirror/ops/sampling.py`` (``grid_sample`` and the eager
``texture_mapping``).  ``texture_render`` (``TextureRender``) is the
differentiable wrapper of the CUDA masked texture kernels
(``csrc/texture_fwd.cu``, ``csrc/texture_bwd.cu``); their plain versions are
``texture_render_plain`` = ``texture_mapping(uv) * mask`` and
``texture_backward_plain``, its autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from . import clip01
from ..kernels import build


def grid_sample(image, grid, mode: str = "bilinear", padding_mode: str = "zeros",
                align_corners: bool = False):
    """Sample ``image`` (N, H, W, C) at ``grid`` (N, Hg, Wg, 2) -> (N, Hg, Wg, C).

    ``grid[..., 0]`` is x (width), ``grid[..., 1]`` is y (height), in [-1, 1]:
    torch's ``grid_sample`` semantics in the NHWC layout.
    """
    out = F.grid_sample(image.permute(0, 3, 1, 2), grid, mode=mode,
                        padding_mode=padding_mode, align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def texture_mapping(texture_coordinates, texture_maps):
    """Bilinear UV sampling with kaolin ``texture_mapping`` semantics: uv
    clipped to [0, 1], v = 0 at the bottom of the texture, zeros padding.

    texture_coordinates (B, H, W, 2); texture_maps (B, Ht, Wt, C) -> (B, H, W, C).
    """
    uv = clip01(texture_coordinates)
    grid_x = uv[..., 0] * 2.0 - 1.0
    grid_y = -(uv[..., 1] * 2.0 - 1.0)  # reversed v-coordinate
    N, Ht, Wt, C = texture_maps.shape
    Hg, Wg = uv.shape[1], uv.shape[2]
    x = ((grid_x.reshape(N, -1) + 1.0) * Wt - 1.0) * 0.5
    y = ((grid_y.reshape(N, -1) + 1.0) * Ht - 1.0) * 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    # a one-texel zero ring makes every 2x2 tap window of x0 in [-1, Wt-1]
    # in bounds: out-of-range taps read zeros ('zeros' padding)
    tp = F.pad(texture_maps, (0, 0, 1, 1, 1, 1))
    flat = tp.reshape(N, (Ht + 2) * (Wt + 2), C)
    x0c = x0.long().clamp(-1, Wt - 1) + 1
    y0c = y0.long().clamp(-1, Ht - 1) + 1

    def tap(dy, dx):
        i = (y0c + dy) * (Wt + 2) + (x0c + dx)
        return torch.gather(flat, 1, i[..., None].expand(-1, -1, C))

    out = (tap(0, 0) * (1 - wx) * (1 - wy)
           + tap(0, 1) * wx * (1 - wy)
           + tap(1, 0) * (1 - wx) * wy
           + tap(1, 1) * wx * wy)
    return out.reshape(N, Hg, Wg, C)


def texture_render_plain(texcoord, textures, texmask):
    """Plain version of the texture kernel: ``texture_mapping(uv) * mask``.

    texcoord (B, H, W, 2); textures (B, Ht, Wt, 3); texmask (B, H, W) hard
    coverage in {0, 1}.  Returns (B, H, W, 3).
    """
    return texture_mapping(texcoord, textures) * texmask[..., None]


def texture_fwd(texcoord, textures, texmask):
    """Launch ``csrc/texture_fwd.cu``: masked bilinear UV sampling, exactly 0
    where texmask <= 0.5.  fp32, contiguous NHWC inputs."""
    B, H, W = texmask.shape
    Ht, Wt = textures.shape[1], textures.shape[2]
    build.check(texcoord, "texcoord", torch.float32, (B, H, W, 2))
    build.check(texmask, "texmask", torch.float32, (B, H, W))
    build.check(textures, "textures", torch.float32, (B, Ht, Wt, 3))
    out = torch.empty((B, H, W, 3), dtype=torch.float32, device=texmask.device)
    build.launch("texture_fwd", texcoord.data_ptr(), texmask.data_ptr(),
                 textures.data_ptr(), B, H, W, Ht, Wt, out.data_ptr())
    kernels.LAUNCHES["texture_fwd"] += 1
    return out


def texture_backward_plain(g, texcoord, textures, texmask):
    """Plain version of the backward kernel: autograd of
    :func:`texture_render_plain`.  g (B, H, W, 3) -> (d_texcoord (B, H, W, 2),
    d_textures (B, Ht, Wt, 3)); the mask gets no gradient."""
    with torch.enable_grad():
        uv = texcoord.detach().requires_grad_(True)
        tex = textures.detach().requires_grad_(True)
        out = texture_render_plain(uv, tex, texmask.detach())
        d_uv, d_tex = torch.autograd.grad(out, (uv, tex), g)
    return d_uv, d_tex


def texture_bwd(g, texcoord, textures, texmask):
    """Launch ``csrc/texture_bwd.cu``; same outputs as
    :func:`texture_backward_plain`.  fp32, contiguous NHWC inputs."""
    B, H, W = texmask.shape
    Ht, Wt = textures.shape[1], textures.shape[2]
    build.check(g, "g", torch.float32, (B, H, W, 3))
    build.check(texcoord, "texcoord", torch.float32, (B, H, W, 2))
    build.check(texmask, "texmask", torch.float32, (B, H, W))
    build.check(textures, "textures", torch.float32, (B, Ht, Wt, 3))
    d_tex = torch.zeros_like(textures)
    d_uv = torch.empty_like(texcoord)
    build.launch("texture_bwd", g.data_ptr(), texcoord.data_ptr(), texmask.data_ptr(),
                 textures.data_ptr(), B, H, W, Ht, Wt, d_tex.data_ptr(), d_uv.data_ptr())
    kernels.LAUNCHES["texture_bwd"] += 1
    return d_uv, d_tex


class TextureRender(torch.autograd.Function):
    """Differentiable masked texture sampling: the plain paths for CPU
    tensors, the CUDA kernels for CUDA tensors (or an error; there is no
    fallback).  Gradients go to texcoord and textures; the mask gets none
    (every caller's mask is the rasterizer's hard coverage, whose cotangent
    the rasterizer drops)."""

    @staticmethod
    def forward(ctx, texcoord, textures, texmask):
        texcoord, textures, texmask = (texcoord.contiguous(), textures.contiguous(),
                                       texmask.contiguous())
        ctx.save_for_backward(texcoord, textures, texmask)
        if texcoord.is_cuda:
            return texture_fwd(texcoord, textures, texmask)
        return texture_render_plain(texcoord, textures, texmask)

    @staticmethod
    def backward(ctx, g):
        texcoord, textures, texmask = ctx.saved_tensors
        if texcoord.is_cuda:
            d_uv, d_tex = texture_bwd(g.contiguous(), texcoord, textures, texmask)
        else:
            d_uv, d_tex = texture_backward_plain(g, texcoord, textures, texmask)
        return d_uv, d_tex, None


def texture_render(texcoord, textures, texmask):
    """Masked texture sampling with gradients to texcoord and textures: see
    :class:`TextureRender`.  Same contract as :func:`texture_render_plain`."""
    return TextureRender.apply(texcoord, textures, texmask)
