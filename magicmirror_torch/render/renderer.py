"""DiffRender forward, the port of ``magicmirror/render/renderer.py``.

camera -> rasterize (the ``raster_fwd`` kernel on CUDA) -> masked texture
(the ``texture_fwd`` kernel on CUDA) -> SH light -> compose.  Layouts are the
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
from ..geometry.obj_io import load_obj
from ..ops.rasterize import rasterize_fused
from ..ops.sampling import texture_render
from ..ops.shading import spherical_harmonic_lighting


class DiffRender:
    def __init__(self, mesh_name: str, image_size: int, ratio: float = 1.0,
                 init_ellipsoid: float = 1.0, sigmainv: float = 7000.0,
                 soft_mode: str = "line", device=None):
        if soft_mode != "line":
            raise NotImplementedError(
                f"soft_mode={soft_mode!r}: only 'line' is ported (the 'exact' "
                "mode needs the K8 kernels)")
        self.soft_mode = soft_mode
        self.image_size = int(image_size)
        self.ratio = ratio
        self.render_height = round(ratio * image_size)
        self.render_width = int(image_size)
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
        self.faces = dev(faces)
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

    @torch.no_grad()
    def render(self, **attributes):
        """Forward render -> (rgba (B, H, W, 4), attributes), the attributes
        extended with 'face_normals', 'imnormal', 'faces_image',
        'visiable_faces' and the (always zero) drop counters.  Forward only:
        the kernels' backward passes are not ported yet."""
        B = attributes["azimuths"].shape[0]
        textures = attributes["textures"]
        face_vertices_camera, face_vertices_image, face_normals = self.project(attributes)
        H, W = self.render_height, self.render_width
        _, soft_mask, texcoord, imnormal, hard = rasterize_fused(
            face_vertices_image, face_vertices_camera[..., 2], face_normals[..., 2],
            self.face_uvs, face_normals, sigmainv=self.sigmainv, height=H, width=W)
        texmask = hard[..., None]
        masked_tex = texture_render(texcoord, textures, hard)
        coef = spherical_harmonic_lighting(imnormal, attributes["lights"])
        image = masked_tex * coef[..., None] + (1.0 - texmask)
        rgbs = torch.cat([image.clamp(0.0, 1.0), soft_mask[..., None]], dim=-1)

        attributes = dict(attributes)
        attributes["face_normals"] = face_normals
        attributes["imnormal"] = imnormal
        zeros = torch.zeros((B,), dtype=torch.int32, device=textures.device)
        attributes["dropped_faces"] = zeros
        attributes["dropped_tex_chunks"] = zeros
        attributes["faces_image"] = face_vertices_image.mean(dim=2)
        attributes["visiable_faces"] = (face_normals[..., 2] > 0).to(torch.float32)
        return rgbs, attributes


def deep_copy(att: dict, index=None) -> dict:
    """Select / clone the renderable subset of an attribute dict
    (reference networks.py:146-161)."""
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
        out[key] = value.clone()
    return out
