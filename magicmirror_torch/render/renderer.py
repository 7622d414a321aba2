"""DiffRender, the port of ``magicmirror/render/renderer.py``: the
differentiable render and the loss suite (delegated to ``..losses``).

camera -> rasterize -> texture -> SH light -> compose, in two branches as in
the JAX renderer.  ``soft_mode='line'`` (the default): the fused rasterizer
(``raster_fwd`` / ``raster_bwd`` kernels on CUDA, under their dense counters
for a template of at least 2,048 faces) and the masked texture sampler
(``texture_fwd`` / ``texture_bwd``).  ``soft_mode='exact'`` (kaolin's
segment distance): the 'exact' rasterizer and then the unmasked
``texture_mapping`` times the coverage; the rasterizer is the fused form in
this mode too, served and trained alike (one kernel with the winner's uv and
normal; its backward interpolates at the saved winner and differentiates
the plain phase 1 by face chunks).
Any ``ratio`` (render height = round(ratio * image_size)) and any template of
``template/``.  Layouts are the
JAX package's: images NHWC in [0, 1], textures (B, 2H, W, 3), the attribute
dict with the reference's keys.  The template (``vertices_init``) is not
stored per call: callers pass predicted ``vertices`` in the attribute dict.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry import camera as cam
from ..geometry import mesh as mesh_ops
from .. import resolve_device
from ..geometry.obj_io import load_obj
from ..losses import attributes as att_losses
from ..losses import mesh_reg, recon
from ..ops.rasterize import SOFT_MODES, rasterize_fused
from ..ops.sampling import texture_mapping, texture_render
from ..ops.shading import spherical_harmonic_lighting


class DiffRender:
    def __init__(self, mesh_name: str, image_size: int, ratio: float = 1.0,
                 init_ellipsoid: float = 1.0, image_weight: float = 0.1,
                 lambda_lpl: float = 0.1, lambda_flat: float = 0.001,
                 sigmainv: float = 7000.0, soft_mode: str = "line", device="cuda"):
        """Builds on the card unless ``device`` names another device."""
        device = resolve_device(device)
        if soft_mode not in SOFT_MODES:
            raise ValueError(f"soft_mode must be one of {SOFT_MODES}, got {soft_mode!r}")
        self.soft_mode = soft_mode
        self.image_size = int(image_size)
        self.ratio = ratio
        self.render_height = round(ratio * image_size)
        self.render_width = int(image_size)
        self.image_weight = image_weight
        self.lambda_lpl = lambda_lpl
        self.lambda_flat = lambda_flat
        self.sigmainv = sigmainv

        camera_fovy = math.atan(1.0 / 2.5) * 2
        self.cam_proj = cam.perspective_projection(camera_fovy, ratio=1.0 / ratio,
                                                   device=device)

        mesh = load_obj(mesh_name, with_materials=True)
        vertices_init = mesh_ops.normalize_template(mesh.vertices, init_ellipsoid)
        faces = mesh.faces.astype(np.int64)
        self.num_faces = faces.shape[0]
        self.num_vertices = vertices_init.shape[0]

        def dev(a):
            return torch.as_tensor(a, device=device)

        self.vertices_laplacian_matrix = dev(
            mesh_ops.uniform_laplacian(self.num_vertices, faces))
        self.vertices_init = dev(vertices_init)  # (V, 3) initial template
        self.sign_init = torch.sign(self.vertices_init[:, 2])
        self.flip_index = dev(mesh_ops.flip_index(vertices_init))
        edges, e2f = mesh_ops.edge2faces(faces)
        self.edges = dev(edges)
        self.edge2faces = dev(e2f)
        self.faces = dev(faces)
        self.uvs = mesh.uvs  # (T, 2) numpy, for the OBJ files the trainer writes
        self.face_uvs = dev(mesh.uvs[mesh.face_uvs_idx])  # (F, 3, 2)

    def project(self, attributes):
        """Camera placement and projection of the attributes' vertices ->
        (face_vertices_camera (B, F, 3, 3), face_vertices_image (B, F, 3, 2),
        unit face_normals (B, F, 3))."""
        biases = attributes["biases"]
        B = biases.shape[0]
        object_pos = torch.cat([biases, torch.zeros_like(biases[:, :1])], dim=1)
        camera_up = torch.tensor([0.0, 1.0, 0.0], device=biases.device).expand(B, 3)
        camera_pos = cam.camera_position_from_spherical_angles(
            attributes["distances"], attributes["elevations"], attributes["azimuths"],
            degrees=True)
        cam_transform = cam.generate_transformation_matrix(camera_pos, object_pos,
                                                           camera_up)
        return cam.prepare_vertices(attributes["vertices"], self.faces, self.cam_proj,
                                    cam_transform)

    def render(self, no_mask: bool = False, **attributes):
        """Render -> (rgba (B, H, W, 4), attributes), the attributes extended
        with 'face_normals', 'imnormal', 'faces_image', 'visiable_faces' and
        the (always zero) drop counters.  Differentiable with respect to the
        vertices, the camera, the textures and the lights, and with
        ``no_mask`` the background: the uncovered pixels take ``bg`` (B, H,
        W, 3) in place of white, lit by the SH coefficient as the covered
        ones are."""
        if no_mask and attributes.get("bg") is None:
            raise ValueError("no_mask renders over the attributes' bg, which is None")
        B = attributes["azimuths"].shape[0]
        textures = attributes["textures"]
        face_vertices_camera, face_vertices_image, face_normals = self.project(attributes)
        H, W = self.render_height, self.render_width
        _, soft_mask, texcoord, imnormal, hard = rasterize_fused(
            face_vertices_image, face_vertices_camera[..., 2], face_normals[..., 2],
            self.face_uvs, face_normals, sigmainv=self.sigmainv, height=H, width=W,
            soft_mode=self.soft_mode)
        texmask = hard[..., None]
        if self.soft_mode == "exact":
            masked_tex = texture_mapping(texcoord, textures) * texmask
        else:
            masked_tex = texture_render(texcoord, textures, hard)
        coef = spherical_harmonic_lighting(imnormal, attributes["lights"])
        if no_mask:
            image = (masked_tex + attributes["bg"] * (1.0 - texmask)) * coef[..., None]
        else:
            image = masked_tex * coef[..., None] + (1.0 - texmask)
        rgbs = torch.cat([image.clamp(0.0, 1.0), soft_mask[..., None]], dim=-1)

        attributes = dict(attributes)
        attributes["face_normals"] = face_normals
        attributes["imnormal"] = imnormal
        zeros = torch.zeros((B,), dtype=torch.int32, device=textures.device)
        attributes["dropped_faces"] = zeros
        attributes["dropped_tex_chunks"] = zeros
        attributes.update(_landmarks(face_vertices_image, face_normals))
        return rgbs, attributes

    def landmarks(self, attributes):
        """The landmark-consistency inputs of the attributes without a
        render: {'faces_image': each face's projected centre (B, F, 2),
        'visiable_faces': 1 where it faces the camera (B, F)}."""
        _, face_vertices_image, face_normals = self.project(attributes)
        return _landmarks(face_vertices_image, face_normals)


    # ------------------------------------------------------------------ losses
    def recon_att(self, pred_att, target_att, L1=False, chamfer=False, azim=1.0):
        return att_losses.recon_att(pred_att, target_att, L1=L1, chamfer=chamfer, azim=azim)

    def recon_data(self, pred_data, gt_data, no_mask=False, contour=0.0):
        return recon.recon_data(pred_data, gt_data, image_weight=self.image_weight,
                                no_mask=no_mask, contour=contour)

    def recon_flip(self, att, L1=False):
        return mesh_reg.flip_loss(att["delta_vertices"], self.flip_index, self.sign_init,
                                  L1=L1)

    def calc_reg_loss(self, att):
        return mesh_reg.laplacian_flat_loss(
            att["delta_vertices"], att["face_normals"], self.vertices_laplacian_matrix,
            self.edge2faces, lambda_lpl=self.lambda_lpl, lambda_flat=self.lambda_flat)

    def calc_reg_edge(self, vertices):
        return mesh_reg.edge_loss(vertices, self.edges)

    def calc_reg_depth(self, vertices):
        return mesh_reg.depth_loss(vertices)

    def calc_reg_depthR(self, vertices, temp=2.0, eps=0.001):
        return mesh_reg.depth_loss_R(vertices, self.sign_init, ratio=self.ratio, temp=temp,
                                     eps=eps)

    def calc_reg_depthC(self, vertices, eps=0.001):
        return mesh_reg.depth_loss_C(vertices, self.sign_init, ratio=self.ratio, eps=eps)

    def calc_reg_deform(self, delta_vertices):
        return mesh_reg.deform_loss(delta_vertices)


def _landmarks(face_vertices_image, face_normals):
    return {"faces_image": face_vertices_image.mean(dim=2),
            "visiable_faces": (face_normals[..., 2] > 0).to(torch.float32)}


def deep_copy(att: dict, index=None, detach: bool = False) -> dict:
    """Select / clone the renderable subset of an attribute dict
    (reference networks.py:146-161); ``detach`` cuts it from the graph."""
    copy_keys = ["azimuths", "bg", "biases", "elevations", "distances",
                 "vertices", "delta_vertices", "textures", "lights"]
    out = {}
    for key in copy_keys:
        if key not in att:
            continue
        value = att[key]
        if value is None:
            out[key] = None
            continue
        if index is not None:
            value = value[index]
        out[key] = value.detach().clone() if detach else value.clone()
    return out
