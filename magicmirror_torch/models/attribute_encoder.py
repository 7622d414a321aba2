"""AttributeEncoder: the four serving-path encoders composed, the port of the
eval forward of ``magicmirror/models/attribute_encoder.py``.

The template (``vertices_init``) is passed per call, not stored: the EM
update rewrites it.  The train-time parts (``train_shape`` freezing, the
``_precondition`` gradient) wait for the training port.
"""
from __future__ import annotations

from .blocks import FlaxNamed
from .encoders import CameraEncoder, LightEncoder, ShapeEncoder, TextureEncoder


class AttributeEncoder(FlaxNamed):
    """netE: NHWC RGBA images, the live template (V, 3) and the dense
    Laplacian (V, V) -> the attribute dict."""

    def __init__(self, num_vertices: int = 642, azi_scope: float = 360.0,
                 elev_range: str = "0~30", dist_range: str = "2~6", nc: int = 4,
                 nk: int = 5, pretraint: str = "res34", pretrainc: str = "none",
                 pretrains: str = "hr18sv2", coordconv: bool = False, norm: str = "bn"):
        super().__init__()
        self.child(ShapeEncoder(nc=nc, nk=nk, num_vertices=num_vertices, pretrain=pretrains,
                                coordconv=coordconv, norm=norm), "shape_enc")
        self.child(CameraEncoder(nc=nc, nk=nk, azi_scope=azi_scope, elev_range=elev_range,
                                 dist_range=dist_range, coordconv=coordconv, norm=norm,
                                 pretrain=pretrainc), "camera_enc")
        self.child(TextureEncoder(pretrain=pretraint, norm=norm), "texture_enc")
        self.child(LightEncoder(nc=nc, nk=nk, coordconv=coordconv, norm=norm), "light_enc")

    def forward(self, input_img, template, lpl):
        delta_vertices = self.shape_enc(input_img, template, lpl)
        azimuths, elevations, distances, biases = self.camera_enc(input_img, template)
        return {
            "azimuths": azimuths,
            "elevations": elevations,
            "distances": distances,
            "biases": biases,
            "vertices": template[None] + delta_vertices,
            "delta_vertices": delta_vertices,
            "textures": self.texture_enc(input_img),
            "lights": self.light_enc(input_img),
            "img_feats": None,
            "bg": None,
        }
