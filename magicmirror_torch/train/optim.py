"""Optimizers and learning-rate schedules, the port of
``magicmirror/train/optim.py``.

``Amsgrad`` is Adam / AMSGrad in optax's formulation, which the JAX package
trains with: the running maximum is taken over the BIAS-CORRECTED second
moment, and eps is added to its root.  ``torch.optim.Adam(amsgrad=True)``
keeps the maximum of the raw second moment and corrects it by the current
step's bias afterwards; the two rules part whenever the second moment falls
(beyond 1e-6 from the second step on), so the port carries the rule itself.
The encoder's ``shape_enc.backbone`` parameters form a group at 0.05x the
learning rate.  ``--adamw`` without ``--amsgrad`` is optax ``adamw``: Adam
with the decay decoupled from the gradient.
"""
from __future__ import annotations

import math

import torch


class Amsgrad(torch.optim.Optimizer):
    """optax ``amsgrad`` (or ``adam`` with ``amsgrad=False``), with L2 weight
    decay added to the gradient first as ``optax.add_decayed_weights`` does.

        mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2
        nu_max = max(nu_max, nu / (1 - b2^t))
        p -= lr * scale * (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)

    With ``decoupled`` (and ``amsgrad`` off) the decay is optax ``adamw``'s,
    taken from the parameter before the step and not from the gradient:

        p -= lr * scale * ((mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p)

    ``lr`` and ``scale`` are per group; :meth:`set_lr` sets every group's lr."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.5, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, amsgrad: bool = True, decoupled: bool = False):
        if decoupled and amsgrad:
            raise ValueError("the decoupled decay is adamw's, which has no amsgrad")
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, scale=1.0,
                                      weight_decay=weight_decay, amsgrad=amsgrad,
                                      decoupled=decoupled))

    def set_lr(self, lr: float) -> None:
        for group in self.param_groups:
            group["lr"] = float(lr)

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            # a parameter without a gradient (a frozen branch) is stepped with
            # a zero gradient, as optax steps a stop_gradient'ed leaf
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p].update(mu=torch.zeros_like(p), nu=torch.zeros_like(p),
                                         nu_max=torch.zeros_like(p))
            group["count"] = count = group.get("count", 0) + 1
            b1, b2 = group["betas"]
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            nu_maxs = [self.state[p]["nu_max"] for p in params]
            decay = group["weight_decay"] if group.get("decoupled") else 0.0
            if group["weight_decay"] > 0 and not decay:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            torch._foreach_lerp_(mus, grads, 1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            nu_hat = torch._foreach_div(nus, 1.0 - b2 ** count)
            if group["amsgrad"]:
                torch._foreach_maximum_(nu_maxs, nu_hat)
                nu_hat = nu_maxs
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, group["eps"])
            if decay:  # optax adamw's order: the update, plus wd * p, scaled, then lr
                upd = torch._foreach_div(mus, 1.0 - b1 ** count)
                torch._foreach_div_(upd, denom)
                torch._foreach_add_(upd, params, alpha=decay)
                torch._foreach_mul_(upd, -group["scale"])
                torch._foreach_mul_(upd, group["lr"])
                torch._foreach_add_(params, upd)
                continue
            step_size = group["lr"] * group["scale"] / (1.0 - b1 ** count)
            torch._foreach_addcdiv_(params, mus, denom, value=-step_size)


def make_optimizer_e(netE, beta1: float = 0.5, wd: float = 0.0, amsgrad: bool = True,
                     backbone_scale: float = 0.05, adamw: bool = False) -> Amsgrad:
    """The encoder's optimizer: the ``shape_enc.backbone`` parameters run at
    ``backbone_scale`` times the learning rate; ``adamw`` without
    ``amsgrad`` decouples the decay (with amsgrad it is the L2 term, as the
    JAX package chains it)."""
    backbone = [p for n, p in netE.named_parameters() if n.startswith("shape_enc.backbone.")]
    main = [p for n, p in netE.named_parameters() if not n.startswith("shape_enc.backbone.")]
    return Amsgrad([{"params": main}, {"params": backbone, "scale": backbone_scale}],
                   betas=(beta1, 0.999), weight_decay=wd, amsgrad=amsgrad,
                   decoupled=adamw and not amsgrad)


def make_optimizer_d(netD, beta1: float = 0.5, wd: float = 0.0,
                     amsgrad: bool = True) -> Amsgrad:
    """The critic's optimizer."""
    return Amsgrad(netD.parameters(), betas=(beta1, 0.999), weight_decay=wd, amsgrad=amsgrad)


def lr_schedule(scheduler: str, epoch: int, niter: int, lr: float, gamma: float) -> float:
    """The learning rate of ``epoch`` (the schedules step per epoch)."""
    if scheduler == "step":
        return lr * (gamma if epoch >= round(0.8 * niter) else 1.0)
    if scheduler in ("restart", "restart2", "restart1"):
        if scheduler == "restart":
            T0, tmult = niter // (1 + 2 + 4) + 1, 2
        elif scheduler == "restart2":
            T0, tmult = niter // (1 + 2) + 1, 2
        else:
            T0, tmult = int(niter / 2) + 1, 1
        eta_min = gamma * lr
        # position within the current restart cycle
        t, T = epoch, T0
        while t >= T:
            t -= T
            T *= tmult
        return eta_min + (lr - eta_min) * (1 + math.cos(math.pi * t / T)) / 2
    if scheduler == "exp":
        return lr * (0.997 ** epoch)
    # cosine (default)
    eta_min = gamma * lr
    return eta_min + (lr - eta_min) * (1 + math.cos(math.pi * min(epoch, niter) / niter)) / 2
