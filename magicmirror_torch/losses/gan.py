"""GAN objectives, the port of ``magicmirror/losses/gan.py``: WGAN-GP, and
the multi-scale LSGAN loss with its gradient penalty a scale.  The critic is
a callable ``d_fn(x)`` on NHWC images -> (B, 1), or a list of per-scale
patch maps for the multi-scale critic."""
from __future__ import annotations

import torch


def _penalty(grads):
    grads = grads.reshape(grads.shape[0], -1)
    gnorm = torch.sqrt((grads * grads).sum(dim=1) + 1e-12)
    return ((gnorm - 1.0) ** 2).mean()


def gradient_penalty(d_fn, real, fake, alpha):
    """WGAN-GP penalty at the interpolates alpha * real + (1 - alpha) * fake,
    alpha (B, 1, 1, 1) in [0, 1] drawn by the caller.  The result stays
    differentiable with respect to the critic's parameters (a double
    backward through the critic)."""
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_fn(interp).sum(), interp, create_graph=True)
    return _penalty(grads)


def gradient_penalty_list(d_fn, real, fake, alpha):
    """The multi-scale critic's penalty: the sum over its scales of each
    scale's WGAN-GP penalty at the same interpolates (one double backward a
    scale, through one forward of the critic)."""
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_(True)
    outs = d_fn(interp)
    total = 0.0
    for out in outs:  # create_graph keeps the forward for the next scale
        (grads,) = torch.autograd.grad(out.sum(), interp, create_graph=True)
        total = total + _penalty(grads)
    return total


def d_loss_wgan(out_real, out_fake1, out_fake2, gp, lambda_gan, ganw, gan_reg):
    """Critic loss -> (loss, real, fake, gp terms)."""
    lossD_real = lambda_gan * out_real.mean()
    lossD_fake = lambda_gan * (out_fake1.mean() + ganw * out_fake2.mean()) / (1.0 + ganw)
    lossD_gp = gan_reg * lambda_gan * gp
    return lossD_fake - lossD_real + lossD_gp, lossD_real, lossD_fake, lossD_gp


def d_loss_lsgan(outs_real, outs_fake1, outs_fake2, gp, lambda_gan, ganw, gan_reg):
    """The multi-scale LSGAN critic loss: real maps to 1, fakes to 0, summed
    over the scales -> (loss, real, fake, gp terms)."""
    lossD_real = lossD_fake = 0.0
    for o_r, o_f1, o_f2 in zip(outs_real, outs_fake1, outs_fake2):
        lossD_real = lossD_real + lambda_gan * ((o_r - 1.0) ** 2).mean()
        lossD_fake = lossD_fake + lambda_gan * (
            (o_f1 ** 2).mean() + ganw * (o_f2 ** 2).mean()) / (1.0 + ganw)
    lossD_gp = gan_reg * lambda_gan * gp
    return lossD_fake + lossD_real + lossD_gp, lossD_real, lossD_fake, lossD_gp


def g_loss_wgan(out_fake1, out_fake2, lambda_gan, ganw):
    """Generator loss."""
    return lambda_gan * (-out_fake1.mean() - ganw * out_fake2.mean()) / (1.0 + ganw)


def g_loss_lsgan(outs_fake1, outs_fake2, lambda_gan, ganw):
    """The generator's multi-scale LSGAN loss: the fakes' maps to 1."""
    loss = 0.0
    for o1, o2 in zip(outs_fake1, outs_fake2):
        loss = loss + lambda_gan * (((o1 - 1.0) ** 2).mean()
                                    + ganw * ((o2 - 1.0) ** 2).mean()) / (1.0 + ganw)
    return loss
