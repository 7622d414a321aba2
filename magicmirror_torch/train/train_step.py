"""The alternating-GAN train step, the port of
``magicmirror/train/train_step.py``.

One call performs
  D step: encode -> render (Xer, Xir; Xer90 = Xer) -> critic on the detached
          images -> WGAN-GP loss -> update of D;
  G step: the updated critic on the SAME rendered images -> reconstruction +
          mesh regularizers + interpolated cycle -> update of E.
The encoder and the renders run once with their graph kept; the D loss reads
detached copies, and the G loss backpropagates through the saved forward.
Every random draw of the step is an argument (``draws``), sampled by
``sample_draws`` when the caller passes none.  The learning rates and the
warm-up factor are per-call scalars.

The JAX step also renders the re-encoded attributes ``Aire``; nothing reads
that render (XLA removes it), so it is not launched here: a step renders
twice.
"""
from __future__ import annotations

import torch

from ..losses import gan as gan_losses
from ..render.renderer import deep_copy
from ..serve import _no_tf32

METRIC_KEYS = ("lossD", "lossD_real", "lossD_fake", "lossD_gp", "gnormE", "gnormD",
               "skipE", "skipD", "lossR", "lossR_fake", "lossR_reg", "lossR_flip",
               "lossR_data", "lossR_IC", "lossR_dis", "lossR_LC", "dropped_faces",
               "dropped_tex_chunks")


def _white_composite(x):
    """img * mask + white * (1 - mask) on an NHWC RGBA batch."""
    img, m = x[..., :3], x[..., 3:4]
    return img * m + (1.0 - m)


def _select_masks(unmask, Xa, Xer90, Xir):
    """What the critic sees of the photo and the two renders."""
    if unmask == 1:
        return Xa[..., :3], Xer90[..., :3], Xir[..., :3]
    if unmask == 0:
        return _white_composite(Xa), _white_composite(Xer90), _white_composite(Xir)
    if unmask == 2:
        return Xa, Xer90, Xir
    raise ValueError("unmask must be 0/1/2")


def _resample_bad(u, perm, bad):
    """Replace the entries of ``perm`` that point at collapsed samples by
    random good indices: entry i takes the floor(u[i] * n_good)-th good
    sample, u (B,) uniform in [0, 1).  No change when no sample is good."""
    n_good = (~bad).sum()
    good_first = torch.argsort(bad.to(torch.int8), stable=True)
    pick = (u * n_good).long().clamp(min=0)
    repl = good_first[torch.minimum(pick, (n_good - 1).clamp(min=0))]
    return torch.where(bad[perm] & (n_good > 0), repl, perm)


def sample_draws(opt, batch: int, generator: torch.Generator | None, device) -> dict:
    """The random draws of one step, from ``generator`` on ``device``: two
    batch permutations and the uniforms of their replacements, the camera of
    the interpolated view, the three interpolation weights and the two
    gradient-penalty weights."""
    def uniform(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)

    elev_min, elev_max = (float(v) for v in opt.elev_range.split("~"))
    dist_min, dist_max = (float(v) for v in opt.dist_range.split("~"))
    B = batch
    draws = {
        "rand_a": torch.randperm(B, generator=generator, device=device),
        "rand_b": torch.randperm(B, generator=generator, device=device),
        "repl_u_a": uniform((B,)),
        "repl_u_b": uniform((B,)),
        "azimuths": -uniform((B,), -opt.azi_scope / 2, opt.azi_scope / 2),
        "elevations": uniform((B,), elev_min, elev_max),
        "distances": uniform((B,), dist_min, dist_max),
        "biases": uniform((B, 2), -opt.bias_range, opt.bias_range),
        "alpha_light": uniform((B, 1)),
        "gp_alpha1": uniform((B, 1, 1, 1)),
        "gp_alpha2": uniform((B, 1, 1, 1)),
    }
    if opt.beta > 0:
        conc = torch.full((2, B), min(1.0, opt.beta), device=device)
        g1, g2 = torch._standard_gamma(conc, generator=generator)
        alpha = g1 / (g1 + g2)  # Beta(beta, beta)
        draws["alpha_texture"] = alpha.reshape(B, 1, 1, 1)
        draws["alpha_shape"] = (1.0 - alpha).reshape(B, 1, 1)
    else:
        draws["alpha_texture"] = uniform((B, 1, 1, 1))
        draws["alpha_shape"] = uniform((B, 1, 1))
    return draws


def regularization(diffRender, Ae, Ai, Aire, opt):
    """The mesh, flip and interpolated-cycle regularizers."""
    lossR_reg = opt.lambda_reg * (
        diffRender.calc_reg_loss(Ae) + diffRender.calc_reg_loss(Ai)) / 2.0
    lossR_flip = opt.lambda_flipz * (
        diffRender.recon_flip(Ae, L1=opt.flipL1)
        + diffRender.recon_flip(Ai, L1=opt.flipL1)
        + diffRender.recon_flip(Aire, L1=opt.flipL1)) / 3.0
    if opt.lambda_edge > 0:
        lossR_reg = lossR_reg + opt.lambda_edge * (
            diffRender.calc_reg_edge(Ae["vertices"])
            + diffRender.calc_reg_edge(Ai["vertices"])) / 2.0
    if opt.lambda_depth > 0:
        lossR_reg = lossR_reg + opt.lambda_depth * (
            diffRender.calc_reg_depth(Ae["vertices"])
            + diffRender.calc_reg_depth(Ai["vertices"])) / 2.0
    if opt.lambda_depthR > 0:
        lossR_reg = lossR_reg + opt.lambda_depthR * (
            diffRender.calc_reg_depthR(Ae["vertices"], temp=opt.temp)
            + diffRender.calc_reg_depthR(Ai["vertices"], temp=opt.temp)) / 2.0
    if opt.lambda_depthC > 0:
        lossR_reg = lossR_reg + opt.lambda_depthC * (
            diffRender.calc_reg_depthC(Ae["vertices"])
            + diffRender.calc_reg_depthC(Ai["vertices"])) / 2.0
    if opt.lambda_deform > 0:
        lossR_reg = lossR_reg + opt.lambda_deform * (
            diffRender.calc_reg_deform(Ae["delta_vertices"])
            + diffRender.calc_reg_deform(Ai["delta_vertices"])) / 2.0

    loss_cam, loss_shape, loss_texture, loss_light, loss_bias = diffRender.recon_att(
        Aire, deep_copy(Ai, detach=True), L1=opt.L1, chamfer=opt.chamfer, azim=opt.azim)
    lossR_IC = opt.lambda_ic * (loss_cam + loss_shape + loss_texture + loss_light + loss_bias)
    return lossR_reg, lossR_flip, lossR_IC


def e_outputs(state, diffRender, opt, Xa, draws, train_shape):
    """Everything downstream of the encoder's parameters, in one forward
    with its graph kept: the reconstruction, the interpolated view and the
    re-encoding of that view."""
    netE, template = state.netE, state.template
    lpl = diffRender.vertices_laplacian_matrix
    Ae = netE(Xa, template, lpl, train_shape=train_shape)
    Xer, Ae = diffRender.render(**Ae)

    # collapse guard and interpolation partners
    bad = Ae["delta_vertices"].abs()[:, -1].mean(dim=1) > 0.4
    rand_a = _resample_bad(draws["repl_u_a"], draws["rand_a"], bad)
    rand_b = _resample_bad(draws["repl_u_b"], draws["rand_b"], bad)
    Aa = deep_copy(Ae, rand_a)
    Ab = deep_copy(Ae, rand_b)

    if opt.lambda_ic > 0.0:
        a_shape, a_tex, a_light = (draws["alpha_shape"], draws["alpha_texture"],
                                   draws["alpha_light"])
        Ai = {
            "azimuths": draws["azimuths"], "elevations": draws["elevations"],
            "distances": draws["distances"], "biases": draws["biases"],
            "vertices": a_shape * Aa["vertices"] + (1 - a_shape) * Ab["vertices"],
            "delta_vertices": (a_shape * Aa["delta_vertices"]
                               + (1 - a_shape) * Ab["delta_vertices"]),
            "textures": a_tex * Aa["textures"] + (1.0 - a_tex) * Ab["textures"],
            "lights": a_light * Aa["lights"] + (1.0 - a_light) * Ab["lights"],
            "bg": None,
        }
        Xir, Ai = diffRender.render(**Ai)
    else:
        Xir, Ai = Xer, Ae
    Xer90 = Xer  # the hard-negative view is not ported

    Aire = netE(Xir.detach(), template, lpl, train_shape=0)
    Ma, Mer90, Mir = _select_masks(opt.unmask, Xa, Xer90, Xir)
    return {"Xer": Xer, "Xir": Xir, "Xer90": Xer90, "Ma": Ma, "Mer90": Mer90, "Mir": Mir,
            "Ae": Ae, "Ai": Ai, "Aire": Aire}


def d_loss_fn(netD, outs, opt, draws, warm_up):
    """The critic's WGAN-GP loss on the detached images ->
    (lossD * warm_up, (real, fake, gp terms))."""
    Ma, Mer90, Mir = outs["Ma"].detach(), outs["Mer90"].detach(), outs["Mir"].detach()
    o0, o1, o2 = netD(torch.cat([Ma, Mer90, Mir], dim=0)).chunk(3, dim=0)
    gp = (gan_losses.gradient_penalty(netD, Ma, Mer90, draws["gp_alpha1"])
          + opt.ganw * gan_losses.gradient_penalty(netD, Ma, Mir, draws["gp_alpha2"])
          ) / (1.0 + opt.ganw)
    lossD, lD_r, lD_f, lD_gp = gan_losses.d_loss_wgan(o0, o1, o2, gp, opt.lambda_gan,
                                                       opt.ganw, opt.gan_reg)
    return lossD * warm_up, (lD_r, lD_f, lD_gp)


def e_loss_fn(outs, netD, diffRender, opt, Xa, warm_up):
    """The encoder's loss through the live forward -> (lossR * warm_up,
    metrics).  The critic is a fixed function here: its parameters take no
    gradient."""
    o1, o2 = netD(torch.cat([outs["Mer90"], outs["Mir"]], dim=0)).chunk(2, dim=0)
    lossR_fake = gan_losses.g_loss_wgan(o1, o2, opt.lambda_gan, opt.ganw)
    lossR_data = opt.lambda_data * diffRender.recon_data(
        outs["Xer"], Xa, no_mask=opt.bg, contour=opt.lambda_contour)
    lossR_reg, lossR_flip, lossR_IC = regularization(
        diffRender, outs["Ae"], outs["Ai"], outs["Aire"], opt)
    zero = lossR_data.new_zeros(())
    lossR = (lossR_fake + lossR_reg + lossR_flip + lossR_data + lossR_IC) * warm_up
    metrics = {"lossR": lossR, "lossR_fake": lossR_fake, "lossR_reg": lossR_reg,
               "lossR_flip": lossR_flip, "lossR_data": lossR_data, "lossR_IC": lossR_IC,
               "lossR_dis": zero, "lossR_LC": zero,
               # the port's kernels have no capacity: nothing is ever dropped
               "dropped_faces": zero, "dropped_tex_chunks": zero}
    return lossR, metrics


def _gnorm(tensors):
    """Global L2 norm of a list of tensors (float32, 0-dim)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def update_d(state, outs, opt, draws, lr_d, warm_up):
    """The D update on the detached images of ``outs``: loss, backward and,
    when the gradient is finite, the optimizer step -> metrics."""
    netD = state.netD
    lossD, d_aux = d_loss_fn(netD, outs, opt, draws, warm_up)
    state.opt_d.zero_grad(set_to_none=True)
    lossD.backward()
    gnormD = _gnorm([p.grad for p in netD.parameters()])
    finD = bool(torch.isfinite(gnormD))
    if finD:
        state.opt_d.set_lr(lr_d)
        state.opt_d.step()
    return {"lossD": lossD, "lossD_real": d_aux[0], "lossD_fake": d_aux[1],
            "lossD_gp": d_aux[2], "gnormD": gnormD,
            "skipD": gnormD.new_tensor(0.0 if finD else 1.0)}


def update_e(state, diffRender, opt, outs, Xa, lr_e, warm_up, stats_before):
    """The G update through the saved forward of ``outs``, against the
    critic as it stands: loss, backward and, when the gradient and the
    running statistics are finite, the optimizer step; else the statistics go
    back to ``stats_before`` (:func:`running_statistics`) -> metrics."""
    netE, netD = state.netE, state.netD
    d_params = list(netD.parameters())
    for p in d_params:
        p.requires_grad_(False)
    try:
        lossR, metrics = e_loss_fn(outs, netD, diffRender, opt, Xa, warm_up)
        state.opt_e.zero_grad(set_to_none=True)
        lossR.backward()
    finally:
        for p in d_params:
            p.requires_grad_(True)
    gnormE = _gnorm([p.grad for p in netE.parameters() if p.grad is not None])
    stats = running_statistics(netE)
    finE = bool(torch.isfinite(gnormE) & torch.isfinite(_gnorm(stats)))
    if finE:
        state.opt_e.set_lr(lr_e)
        state.opt_e.step()
    else:
        torch._foreach_copy_(stats, stats_before)
    return {"gnormE": gnormE, "skipE": gnormE.new_tensor(0.0 if finE else 1.0), **metrics}


def running_statistics(netE):
    """The encoder's BatchNorm running means and variances."""
    return [b for b in netE.buffers() if b.is_floating_point()]


@_no_tf32()
def train_step(state, diffRender, opt, Xa, lr_e, lr_d, warm_up=1.0, train_shape=0,
               draws=None, generator=None):
    """One D-then-G step on the RGBA photos ``Xa`` (B, H, W, 4), in float32
    without TF32.  Updates ``state`` in place and returns
    (metrics, Xer, Xir): the metrics are detached 0-dim tensors under
    ``METRIC_KEYS``.

    A side whose gradient is not finite is skipped (``skipD`` / ``skipE``
    1.0): its parameters and optimizer state stay as they were, and a skipped
    E side also restores the encoder's BatchNorm running statistics.  A side
    counts as non-finite when the norm of its gradient (for E: or of the
    running statistics) is, which also skips a finite gradient whose squares
    overflow float32."""
    state.netE.train()
    state.netD.train()
    if draws is None:
        draws = sample_draws(opt, Xa.shape[0], generator, Xa.device)
    stats_before = [b.clone() for b in running_statistics(state.netE)]

    # one forward of the encoder and the renders, graph kept; the D update on
    # the detached images; the G update through the saved forward, against
    # the updated critic
    outs = e_outputs(state, diffRender, opt, Xa, draws, train_shape)
    metrics = update_d(state, outs, opt, draws, lr_d, warm_up)
    metrics.update(update_e(state, diffRender, opt, outs, Xa, lr_e, warm_up, stats_before))
    state.step += 1
    metrics = {k: metrics[k].detach() for k in METRIC_KEYS}
    return metrics, outs["Xer"].detach(), outs["Xir"].detach()
