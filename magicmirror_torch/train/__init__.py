"""Training: the D-then-G step of ``magicmirror/train``, at the
configurations the port covers.

    opt = TrainOptions()
    trainer = build_trainer(opt)                  # on the card
    metrics, Xer, Xir = trainer.step(photos, lr_e=1e-4, lr_d=1e-4, warm_up=1.0)

``preset_options(TrainOptions, name)`` gives the configurations beside the
default (``serve.PRESETS``: ``market_smpl``, ``cub_exact`` and the three
published recipes).  ``TrainOptions``
holds the flags the step reads with the defaults of
``magicmirror/configs/flags.py``; an option outside the port raises
``NotImplementedError`` (``multigpus``, ``fp16`` and the backbones outside
``serve._BACKBONES``).  The critic follows ``gan_type`` and ``sn_dis`` as
the JAX trainer's ``build_models`` picks it.
``steps_per_call``, ``donate_state`` and ``band_capacity`` answer to limits
of the TPU runtime; they are accepted and ignored: one step per batch, the
JAX package's ``steps_per_call = 1``.  The epochs around the step are
``train.trainer.trainer``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..models.attribute_encoder import make_inv_preconditioner
from ..models.convert import init_from_seed
from ..models.discriminators import Discriminator, MSDiscriminator, SNDiscriminator
from ..render.renderer import DiffRender
from ..serve import PRESETS, ServeOptions, build_models, preset_options, unported_options
from .optim import lr_schedule, make_optimizer_d, make_optimizer_e
from .state import TrainState
from .train_step import METRIC_KEYS, sample_draws, train_step

__all__ = ["METRIC_KEYS", "PRESETS", "TrainOptions", "Trainer", "build_trainer",
           "lr_schedule", "preset_options", "sample_draws", "train_options", "train_step"]


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
    hard_range: int = 0
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
    # the trainer's flags (``train.trainer.trainer``)
    niter: int = 600
    lr: float = 0.0001
    scheduler: str = "cosine"
    gamma: float = 0.01
    warm_epoch: int = 40
    update_shape: int = 1
    resume: bool = False
    swa: bool = True
    swa_start: int = 500
    swa_interval: int = 1
    em: float = 1.0
    em_gap: int = 1
    em_step: float = 0.1
    update_bn: bool = False
    white: bool = True
    smooth: float = 0.5
    clip: float = 0.05
    cross: bool = False
    eps: float = 0.2
    topK: float = 0.01
    multigpus: bool = False
    fp16: bool = False


def unported_train_options(opt: TrainOptions) -> list[str]:
    """The settings of ``opt`` that the port's train step does not cover."""
    unported = unported_options(opt)
    for flag in ("multigpus", "fp16"):
        if getattr(opt, flag):
            unported.append(flag)
    return unported


def build_discriminator(opt: TrainOptions):
    """The critic of ``opt``, as the JAX trainer's ``build_models`` picks
    it: with ``sn_dis`` the spectral-norm critic (WGAN losses only), else
    the WGAN critic or, for ``gan_type lsgan``, the multi-scale one."""
    nc = 4 if opt.unmask == 2 else 3
    if opt.sn_dis:
        if opt.gan_type != "wgan":
            raise ValueError("--sn_dis requires --gan_type wgan")
        return SNDiscriminator(nc=nc, imsize=opt.imageSize)
    if opt.gan_type == "wgan":
        return Discriminator(nc=nc, nf=16)
    if opt.gan_type == "lsgan":
        return MSDiscriminator(nc=nc, nf=16)
    raise ValueError("unknown gan type. Only lsgan or wgan is accepted.")


# the flags of ``configs.flags.build_parser`` that are not TrainOptions: the
# CLI's own (the data, the loaders, the run's directory and process), read
# by the train CLIs; and those that the JAX package's step reads nowhere or
# that answer to the TPU runtime, accepted and ignored
CLI_FLAGS = ("name", "dataroot", "workers", "prefetch_factor", "threshold", "clean_threshold",
             "outf", "process_index", "process_count")
IGNORED_FLAGS = ("configs_yml", "category", "cuda", "start_epoch", "romp", "swa_lr",
                 "raster_backend")


def train_options(namespace) -> TrainOptions:
    """``TrainOptions`` from the parsed flags (``configs.flags``): its own
    fields taken as they are, the CLI's flags and the ignored ones left out;
    a flag of no such kind, or a setting outside the port
    (:func:`unported_train_options`), raises."""
    values = vars(namespace)
    fields = {f.name for f in dataclasses.fields(TrainOptions)}
    unknown = sorted(set(values) - fields - set(CLI_FLAGS) - set(IGNORED_FLAGS))
    if unknown:
        raise ValueError(f"flags the port does not know: {', '.join(unknown)}")
    opt = TrainOptions(**{k: v for k, v in values.items() if k in fields})
    unported = unported_train_options(opt)
    if unported:
        raise NotImplementedError(f"options outside the port: {', '.join(unported)}")
    return opt


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

    def step(self, Xa, lr_e, lr_d, warm_up=1.0, train_shape=0, draws=None, Va=None):
        return train_step(self.state, self.diff_render, self.opt, Xa, lr_e, lr_d,
                          warm_up=warm_up, train_shape=train_shape, draws=draws,
                          generator=self.generator, Va=Va)


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
    netD = init_from_seed(build_discriminator(opt), opt.manualSeed + 1).to(device)
    lpl = diff_render.vertices_laplacian_matrix
    precond_M = (torch.as_tensor(make_inv_preconditioner(lpl.cpu().numpy(), opt.inv),
                                 device=device) if opt.inv > 0 else None)
    state = TrainState(
        netE=netE, netD=netD,
        opt_e=make_optimizer_e(netE, beta1=opt.beta1, wd=opt.wd, amsgrad=opt.amsgrad,
                               adamw=opt.adamw),
        opt_d=make_optimizer_d(netD, beta1=opt.beta1, wd=opt.wd, amsgrad=opt.amsgrad),
        template=diff_render.vertices_init.clone(),
        em_step=float(np.float32(opt.em_step)),  # a float32 scalar, as in the JAX state
        precond_M=precond_M)
    generator = torch.Generator(device=device).manual_seed(opt.manualSeed)
    return Trainer(opt, diff_render, state, generator)
