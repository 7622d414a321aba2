"""The serving path: encode RGBA photos into attributes and re-render them.

The port of ``build_models`` and ``make_eval_step``
(``magicmirror/train/trainer.py:40-103``) and of the re-posed renders of
``magicmirror/cli/single_img.py:64-99``, at the configurations the port
covers: ``ServeOptions`` defaults are those of
``magicmirror/configs/flags.py``, and an option outside the port raises
``NotImplementedError``.

    opt = ServeOptions()
    dr = DiffRender(opt.template_path, opt.imageSize, ratio=opt.ratio,
                    init_ellipsoid=opt.ellipsoid, soft_mode=opt.soft_mode)
    netE = build_models(opt, dr)                    # then load weights
    rec = Reconstructor(netE, dr, opt)
    out = rec(images, generator=torch.Generator("cuda").manual_seed(0))

``update_bn`` and ``Reconstructor`` run the encoder and the renders in
float32 without TF32, whatever the caller's ``torch.backends`` flags say
(cuDNN allows TF32 convolutions by default): the port is held to the
float32 JAX reference at that precision, and its timings are taken so.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from . import resolve_device
from .models.attribute_encoder import AttributeEncoder
from .render.renderer import DiffRender, deep_copy

# the backbones the port has, per flag
_BACKBONES = {"pretrainc": ("none",), "pretrains": ("hr18sv2", "none"),
              "pretraint": ("res34", "none")}


@dataclasses.dataclass
class ServeOptions:
    """The flags the serving path reads, with the defaults of
    ``magicmirror/configs/flags.py``."""

    template_path: str = "./template/sphere.obj"
    imageSize: int = 128
    ratio: float = 1
    ellipsoid: float = 1
    azi_scope: float = 360
    elev_range: str = "0~30"
    dist_range: str = "2~7"
    nk: int = 5
    nf: int = 32
    makeup: int = 0
    bg: bool = False
    pretraint: str = "res34"
    pretrainc: str = "none"
    pretrains: str = "hr18sv2"
    droprate: str = "0.2,0.2,0.2"
    coordconv: bool = True
    norm: str = "bn"
    nolpl: bool = False
    inv: float = 0
    lambda_lc: float = 0
    soft_mode: str = "line"


def unported_options(opt) -> list[str]:
    """The settings of ``opt`` that the port's encoder does not cover."""
    unported = []
    if opt.bg:
        unported.append("bg")
    if opt.makeup != 0:
        unported.append(f"makeup={opt.makeup}")
    if opt.lambda_lc > 0:
        unported.append(f"lambda_lc={opt.lambda_lc}")
    if opt.nolpl:
        unported.append("nolpl")
    if opt.soft_mode != "line":
        unported.append(f"soft_mode={opt.soft_mode}")
    if opt.norm != "bn":
        unported.append(f"norm={opt.norm}")
    for flag, ported in _BACKBONES.items():
        if getattr(opt, flag) not in ported:
            unported.append(f"{flag}={getattr(opt, flag)}")
    return unported


def build_models(opt, diff_render: DiffRender, device="cuda") -> AttributeEncoder:
    """netE for ``opt`` (``ServeOptions`` or ``TrainOptions``) with its weights
    at their init, in eval mode, on the card unless ``device`` names another
    device."""
    device = resolve_device(device)
    unported = unported_options(opt)
    if unported:
        raise NotImplementedError(f"options outside the port: {', '.join(unported)}")
    netE = AttributeEncoder(
        num_vertices=diff_render.num_vertices, azi_scope=opt.azi_scope,
        elev_range=opt.elev_range, dist_range=opt.dist_range, nc=4, nk=opt.nk,
        pretraint=opt.pretraint, pretrainc=opt.pretrainc, pretrains=opt.pretrains,
        droprate=opt.droprate, coordconv=opt.coordconv, norm=opt.norm)
    return netE.to(device).eval()


@contextlib.contextmanager
def _no_tf32():
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls, then restore
    the caller's flags."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@_no_tf32()
@torch.no_grad()
def update_bn(netE: AttributeEncoder, batches, template, lpl) -> None:
    """Re-estimate the BatchNorm running statistics from ``batches`` of
    images, as ``torch.optim.swa_utils.update_bn`` does: reset, then a
    cumulative average over the batches with the BatchNorm layers (and only
    they: dropout stays off) in train mode.  The counterpart of
    ``make_update_bn`` (``magicmirror/train/state.py:101``)."""
    bns = [m for m in netE.modules() if isinstance(m, _BatchNorm)]
    momenta = [m.momentum for m in bns]
    was_training = netE.training
    netE.eval()
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
        m.train()
    for images in batches:
        netE(images, template, lpl)
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
    netE.train(was_training)


class Reconstructor:
    """The eval step: encode, render the reconstruction, a random-azimuth
    view and its +90 degree twin, and the reconstruction at +-90 degrees."""

    def __init__(self, netE: AttributeEncoder, diff_render: DiffRender, opt: ServeOptions):
        self.netE = netE.eval()
        self.diff_render = diff_render
        self.azi_scope = opt.azi_scope
        self.template = diff_render.vertices_init
        self.lpl = diff_render.vertices_laplacian_matrix

    @_no_tf32()
    @torch.inference_mode()
    def encode(self, images):
        """(B, H, W, 4) RGBA in [0, 1] -> the attribute dict."""
        return self.netE(images, self.template, self.lpl)

    @_no_tf32()
    @torch.inference_mode()
    def __call__(self, images, random_azimuths=None, generator=None):
        """-> (Xer, Xir, Xir2, Xer90, Xer270, Ae) as ``make_eval_step``.

        ``random_azimuths`` (B,) are the azimuths of the random view; when
        None they are -U(-azi_scope/2, azi_scope/2) from ``generator``.
        """
        att = self.encode(images)
        render = self.diff_render.render
        Xer, Ae = render(**att)
        B = images.shape[0]
        if random_azimuths is None:
            u = torch.rand((B,), generator=generator, device=images.device)
            random_azimuths = -(u * self.azi_scope - self.azi_scope / 2)
        Xir, Xir2, Xer90, Xer270 = (render(**a)[0] for a in self.reposed(Ae, random_azimuths))
        return Xer, Xir, Xir2, Xer90, Xer270, Ae

    @staticmethod
    def reposed(Ae, random_azimuths):
        """The attribute dicts of the four re-posed views of the eval step:
        (Ai, Ai2, Ae90, Ae270), at ``random_azimuths``, its +90 degree twin
        (wrapped into (-180, 180]) and the reconstruction's azimuths +-90."""
        Ai = deep_copy(Ae)
        Ai["azimuths"] = random_azimuths
        az2 = random_azimuths + 90.0
        Ai2 = deep_copy(Ae)
        Ai2["azimuths"] = torch.where(az2 > 180.0, az2 - 360.0, az2)
        Ae90 = deep_copy(Ae)
        Ae90["azimuths"] = Ae["azimuths"] + 90.0
        Ae270 = deep_copy(Ae)
        Ae270["azimuths"] = Ae["azimuths"] - 90.0
        return Ai, Ai2, Ae90, Ae270

    @_no_tf32()
    @torch.inference_mode()
    def turntable(self, att, azimuths, index: int = 0):
        """Re-render image ``index`` of ``att`` at each of ``azimuths`` (N,)
        in one batch -> (rgba (N, H, W, 4), imnormal (N, H, W, 3))."""
        N = azimuths.shape[0]
        one = deep_copy(att, index=slice(index, index + 1))
        views = {k: (None if v is None else v.expand(N, *v.shape[1:]))
                 for k, v in one.items()}
        views["azimuths"] = azimuths
        rgba, out = self.diff_render.render(**views)
        return rgba, out["imnormal"]
