"""AttributeEncoder: the four encoders composed, the port of
``magicmirror/models/attribute_encoder.py``.

The template (``vertices_init``) is passed per call, not stored: the EM
update rewrites it.  ``train_shape`` (0..5) is the per-iteration freezing
policy: a frozen branch's outputs are detached, and in train mode its
BatchNorm layers normalise with the batch statistics without advancing their
running ones (the JAX train step reverts them, train_step.py:142-157).
With ``bg`` a fifth head, the background encoder, is never frozen.  With
``inv > 0`` the shape offsets pass through :class:`Precondition`, the
identity whose backward multiplies by ``make_inv_preconditioner``'s M.  With
``lambda_lc > 0`` the encoder carries the landmark-consistency parts: the
feature encoder (``img_feats``, computed in train mode: serving reads
nothing of it) and the head of :meth:`AttributeEncoder.landmark_loss`.
"""
from __future__ import annotations

import numpy as np
import torch

from .blocks import BatchNorm, Dropout, FlaxNamed
from .discriminators import LandmarkConsistency
from .encoders import (BackgroundEncoder, CameraEncoder, FeatureEncoder, LightEncoder,
                       ShapeEncoder, TextureEncoder)


class Precondition(torch.autograd.Function):
    """The identity on the shape offsets (B, V, 3) whose backward maps the
    cotangent g to einsum('bwc,wv->bvc', g, M): the inverse-Laplacian
    preconditioner of ``--inv``."""

    @staticmethod
    def forward(ctx, delta, M):
        ctx.save_for_backward(M)
        return delta.view_as(delta)

    @staticmethod
    def backward(ctx, g):
        (M,) = ctx.saved_tensors
        return torch.einsum("bwc,wv->bvc", g, M), None


def make_inv_preconditioner(laplacian, inv: float) -> np.ndarray:
    """M = inv(I + inv * L) squared elementwise, inverted in float64 and
    returned in float32."""
    L = np.asarray(laplacian, np.float64)
    M = np.linalg.inv(np.eye(L.shape[0]) + inv * L)
    return (M * M).astype(np.float32)

SHAPE_FROZEN = (1, 4, 5)
CAMERA_FROZEN = (2, 3, 4)
TEXTURE_FROZEN = (3, 5)


def parse_droprate(droprate) -> tuple[float, float, float]:
    """'camera,shape,texture' rates; anything but a string gives 0.2 each,
    as the JAX encoder reads it."""
    if isinstance(droprate, str):
        dc, ds, dt = (float(v) for v in droprate.split(",")[:3])
        return dc, ds, dt
    return 0.2, 0.2, 0.2


class AttributeEncoder(FlaxNamed):
    """netE: NHWC RGBA images, the live template (V, 3) and the dense
    Laplacian (V, V) -> the attribute dict."""

    def __init__(self, num_vertices: int = 642, azi_scope: float = 360.0,
                 elev_range: str = "0~30", dist_range: str = "2~6", nc: int = 4,
                 nk: int = 5, pretraint: str = "res34", pretrainc: str = "none",
                 pretrains: str = "hr18sv2", droprate="0.2,0.2,0.2",
                 coordconv: bool = False, norm: str = "bn", bg: bool = False,
                 makeup: int = 0, nolpl: bool = False, inv: float = 0.0,
                 lambda_lc: float = 0.0, num_faces: int = 1280):
        super().__init__()
        dc, ds, dt = parse_droprate(droprate)
        self.child(ShapeEncoder(nc=nc, nk=nk, num_vertices=num_vertices, pretrain=pretrains,
                                coordconv=coordconv, norm=norm, droprate=ds, nolpl=nolpl),
                   "shape_enc")
        self.child(CameraEncoder(nc=nc, nk=nk, azi_scope=azi_scope, elev_range=elev_range,
                                 dist_range=dist_range, coordconv=coordconv, norm=norm,
                                 pretrain=pretrainc, droprate=dc, nolpl=nolpl), "camera_enc")
        self.child(TextureEncoder(pretrain=pretraint, norm=norm, nk=nk, coordconv=coordconv,
                                  droprate=dt, makeup=makeup), "texture_enc")
        self.child(LightEncoder(nc=nc, nk=nk, coordconv=coordconv, norm=norm, droprate=dc),
                   "light_enc")
        self.bg = bg
        if bg:  # its dropout is the texture rate's half
            self.child(BackgroundEncoder(droprate=dt), "bg_enc")
        self.inv = inv
        self.lambda_lc = lambda_lc
        if lambda_lc > 0:
            self.child(FeatureEncoder(nc=nc, norm=norm), "feat_enc")
            self.child(LandmarkConsistency(num_landmarks=num_faces, dim_feat=256),
                       "landmark_cls")
        self._batchnorms = {
            name: [m for m in branch.modules() if isinstance(m, BatchNorm)]
            for name, branch in self.named_children()}

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """Every dropout layer draws its keep mask from ``generator``."""
        for module in self.modules():
            if isinstance(module, Dropout):
                module.generator = generator

    def _branch(self, name: str, frozen: bool, *args):
        """Run one branch; a frozen one builds no graph and keeps its
        BatchNorm running statistics."""
        for module in self._batchnorms[name]:
            module.update_stats = not frozen
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            return getattr(self, name)(*args)

    def forward(self, input_img, template, lpl, train_shape: int = 0, precond_M=None):
        """``precond_M``: with ``inv > 0``, the preconditioner of the shape
        offsets' gradient (none when the shape branch is frozen)."""
        shape_frozen = train_shape in SHAPE_FROZEN
        delta_vertices = self._branch("shape_enc", shape_frozen, input_img, template, lpl)
        if self.inv > 0 and precond_M is not None and not shape_frozen:
            delta_vertices = Precondition.apply(delta_vertices, precond_M)
        cameras = self._branch("camera_enc", train_shape in CAMERA_FROZEN,
                               input_img, template)
        textures = self._branch("texture_enc", train_shape in TEXTURE_FROZEN, input_img)
        lights = self._branch("light_enc", train_shape in TEXTURE_FROZEN, input_img)
        background = self._branch("bg_enc", False, input_img) if self.bg else None
        img_feats = (self._branch("feat_enc", False, input_img)
                     if self.lambda_lc > 0 and self.training else None)
        azimuths, elevations, distances, biases = cameras
        return {
            "azimuths": azimuths,
            "elevations": elevations,
            "distances": distances,
            "biases": biases,
            "vertices": template[None] + delta_vertices,
            "delta_vertices": delta_vertices,
            "textures": textures,
            "lights": lights,
            "img_feats": img_feats,
            "bg": background,
        }

    def landmark_loss(self, img_feats, landmark_2d, visible, sample_idx):
        """The face-identity cross entropy at the faces' projected centres
        (``landmark_2d`` in grid_sample's convention: x right, y down)."""
        return self.landmark_cls(img_feats, landmark_2d, visible, sample_idx)
