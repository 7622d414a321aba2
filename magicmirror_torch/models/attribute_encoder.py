"""AttributeEncoder: the four encoders composed, the port of
``magicmirror/models/attribute_encoder.py``.

The template (``vertices_init``) is passed per call, not stored: the EM
update rewrites it.  ``train_shape`` (0..5) is the per-iteration freezing
policy: a frozen branch's outputs are detached, and in train mode its
BatchNorm layers normalise with the batch statistics without advancing their
running ones (the JAX train step reverts them, train_step.py:142-157).  The
``_precondition`` gradient of ``inv > 0`` is not ported.
"""
from __future__ import annotations

import torch

from .blocks import BatchNorm, Dropout, FlaxNamed
from .encoders import CameraEncoder, LightEncoder, ShapeEncoder, TextureEncoder

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
                 coordconv: bool = False, norm: str = "bn"):
        super().__init__()
        dc, ds, dt = parse_droprate(droprate)
        self.child(ShapeEncoder(nc=nc, nk=nk, num_vertices=num_vertices, pretrain=pretrains,
                                coordconv=coordconv, norm=norm, droprate=ds), "shape_enc")
        self.child(CameraEncoder(nc=nc, nk=nk, azi_scope=azi_scope, elev_range=elev_range,
                                 dist_range=dist_range, coordconv=coordconv, norm=norm,
                                 pretrain=pretrainc, droprate=dc), "camera_enc")
        self.child(TextureEncoder(pretrain=pretraint, norm=norm, nk=nk, coordconv=coordconv,
                                  droprate=dt), "texture_enc")
        self.child(LightEncoder(nc=nc, nk=nk, coordconv=coordconv, norm=norm, droprate=dc),
                   "light_enc")
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

    def forward(self, input_img, template, lpl, train_shape: int = 0):
        delta_vertices = self._branch("shape_enc", train_shape in SHAPE_FROZEN,
                                      input_img, template, lpl)
        cameras = self._branch("camera_enc", train_shape in CAMERA_FROZEN,
                               input_img, template)
        textures = self._branch("texture_enc", train_shape in TEXTURE_FROZEN, input_img)
        lights = self._branch("light_enc", train_shape in TEXTURE_FROZEN, input_img)
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
            "img_feats": None,
            "bg": None,
        }
