"""Training: the D-then-G step of ``magicmirror/train``, at the
configurations the port covers.

    opt = TrainOptions()
    trainer = build_trainer(opt)                  # on the card
    metrics, Xer, Xir = trainer.step(photos, lr_e=1e-4, lr_d=1e-4, warm_up=1.0)

``TrainOptions`` holds the flags the step reads with the defaults of
``magicmirror/configs/flags.py``; an option outside the port raises
``NotImplementedError``.  ``steps_per_call``, ``donate_state`` and
``band_capacity`` answer to limits of the TPU runtime; they are accepted and
ignored.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..models.convert import init_from_seed
from ..models.discriminators import Discriminator
from ..render.renderer import DiffRender
from ..serve import ServeOptions, build_models, unported_options
from .optim import lr_schedule, make_optimizer_d, make_optimizer_e
from .state import TrainState
from .train_step import METRIC_KEYS, sample_draws, train_step

__all__ = ["METRIC_KEYS", "TrainOptions", "Trainer", "build_trainer", "lr_schedule",
           "sample_draws", "train_step"]


@dataclasses.dataclass
class TrainOptions(ServeOptions):
    """``ServeOptions`` plus the flags the train step reads."""

    batchSize: int = 32
    manualSeed: int = 0
    gan_type: str = "wgan"
    sn_dis: int = 0
    beta1: float = 0.5
    wd: float = 0
    amsgrad: bool = True
    adamw: bool = False
    chamfer: bool = True
    azim: float = 1.0
    beta: float = 0
    hard: bool = False
    L1: bool = False
    flipL1: bool = False
    unmask: int = 0
    bias_range: float = 0.3
    hmr: float = 0.0
    dis1: float = 0
    dis2: float = 0
    image_weight: float = 1
    lambda_gan: float = 0.0001
    ganw: float = 1
    gan_reg: float = 10.0
    lambda_data: float = 1.0
    lambda_ic: float = 1
    lambda_reg: float = 0.1
    lambda_lpl: float = 0.1
    lambda_flat: float = 0.001
    lambda_edge: float = 0.001
    lambda_depth: float = 0
    lambda_depthR: float = 0
    lambda_depthC: float = 0
    lambda_deform: float = 0.1
    lambda_flipz: float = 0.1
    lambda_contour: float = 0
    temp: float = 2
    steps_per_call: int = 16
    donate_state: bool = False
    band_capacity: int = 0


def unported_train_options(opt: TrainOptions) -> list[str]:
    """The settings of ``opt`` that the port's train step does not cover."""
    unported = unported_options(opt)
    if opt.hard:
        unported.append("hard")
    if opt.gan_type != "wgan":
        unported.append(f"gan_type={opt.gan_type}")
    if opt.sn_dis:
        unported.append(f"sn_dis={opt.sn_dis}")
    if opt.adamw and not opt.amsgrad:
        unported.append("adamw without amsgrad")
    for flag in ("inv", "dis1", "dis2", "hmr"):
        if getattr(opt, flag) > 0:
            unported.append(f"{flag}={getattr(opt, flag)}")
    return unported


class Trainer:
    """The train state of one configuration with its renderer; ``step`` is
    :func:`train_step` on them.  Dropout masks and, when the caller passes no
    ``draws``, the step's random draws come from ``generator``."""

    def __init__(self, opt: TrainOptions, diff_render: DiffRender, state: TrainState,
                 generator: torch.Generator | None = None):
        self.opt = opt
        self.diff_render = diff_render
        self.state = state
        self.generator = generator
        state.netE.set_dropout_generator(generator)

    def step(self, Xa, lr_e, lr_d, warm_up=1.0, train_shape=0, draws=None):
        return train_step(self.state, self.diff_render, self.opt, Xa, lr_e, lr_d,
                          warm_up=warm_up, train_shape=train_shape, draws=draws,
                          generator=self.generator)


def build_trainer(opt: TrainOptions, device="cuda") -> Trainer:
    """The renderer, both networks (weights drawn from ``opt.manualSeed`` by
    the JAX package's init laws) and their optimizers, on the card unless
    ``device`` names another device."""
    device = resolve_device(device)
    unported = unported_train_options(opt)
    if unported:
        raise NotImplementedError(f"options outside the port: {', '.join(unported)}")
    diff_render = DiffRender(opt.template_path, opt.imageSize, ratio=opt.ratio,
                             init_ellipsoid=opt.ellipsoid, image_weight=opt.image_weight,
                             lambda_lpl=opt.lambda_lpl, lambda_flat=opt.lambda_flat,
                             soft_mode=opt.soft_mode, device=device)
    netE = init_from_seed(build_models(opt, diff_render, "cpu"), opt.manualSeed).to(device)
    netD = init_from_seed(Discriminator(nc=4 if opt.unmask == 2 else 3, nf=16),
                          opt.manualSeed + 1).to(device)
    state = TrainState(
        netE=netE, netD=netD,
        opt_e=make_optimizer_e(netE, beta1=opt.beta1, wd=opt.wd, amsgrad=opt.amsgrad),
        opt_d=make_optimizer_d(netD, beta1=opt.beta1, wd=opt.wd, amsgrad=opt.amsgrad),
        template=diff_render.vertices_init.clone())
    generator = torch.Generator(device=device).manual_seed(opt.manualSeed)
    return Trainer(opt, diff_render, state, generator)
