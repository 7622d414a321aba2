"""WGAN-GP objectives, the port of the WGAN half of
``magicmirror/losses/gan.py``.  The critic is a callable ``d_fn(x) -> (B, 1)``
on NHWC images."""
from __future__ import annotations

import torch


def gradient_penalty(d_fn, real, fake, alpha):
    """WGAN-GP penalty at the interpolates alpha * real + (1 - alpha) * fake,
    alpha (B, 1, 1, 1) in [0, 1] drawn by the caller.  The result stays
    differentiable with respect to the critic's parameters (a double
    backward through the critic)."""
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_fn(interp).sum(), interp, create_graph=True)
    grads = grads.reshape(grads.shape[0], -1)
    gnorm = torch.sqrt((grads * grads).sum(dim=1) + 1e-12)
    return ((gnorm - 1.0) ** 2).mean()


def d_loss_wgan(out_real, out_fake1, out_fake2, gp, lambda_gan, ganw, gan_reg):
    """Critic loss -> (loss, real, fake, gp terms)."""
    lossD_real = lambda_gan * out_real.mean()
    lossD_fake = lambda_gan * (out_fake1.mean() + ganw * out_fake2.mean()) / (1.0 + ganw)
    lossD_gp = gan_reg * lambda_gan * gp
    return lossD_fake - lossD_real + lossD_gp, lossD_real, lossD_fake, lossD_gp


def g_loss_wgan(out_fake1, out_fake2, lambda_gan, ganw):
    """Generator loss."""
    return lambda_gan * (-out_fake1.mean() - ganw * out_fake2.mean()) / (1.0 + ganw)
