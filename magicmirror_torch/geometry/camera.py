"""Camera math on tensors: spherical placement, look-at, projection.

The port of ``magicmirror/geometry/camera.py``.  Conventions: right-handed,
the camera looks down its -z axis, up is +y; NDC x, y in [-1, 1] with +y up
(image row 0 maps to y = +1).
"""
from __future__ import annotations

import math

import torch


def camera_position_from_spherical_angles(dist, elev, azim, degrees: bool = True):
    """Camera xyz (N, 3) from distance, elevation and azimuth."""
    if degrees:
        elev = math.pi / 180.0 * elev
        azim = math.pi / 180.0 * azim
    x = dist * torch.cos(elev) * torch.sin(azim)
    y = dist * torch.sin(elev)
    z = dist * torch.cos(elev) * torch.cos(azim)
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


def generate_transformation_matrix(camera_position, look_at, camera_up_direction):
    """Look-at world-to-camera transform (B, 4, 3): P_cam = [P_world, 1] @ T."""
    z_axis = camera_position - look_at
    z_axis = z_axis / torch.linalg.norm(z_axis, dim=1, keepdim=True)
    x_axis = torch.linalg.cross(camera_up_direction, z_axis, dim=1)
    x_axis = x_axis / torch.linalg.norm(x_axis, dim=1, keepdim=True)
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=1)
    rot_part = torch.stack([x_axis, y_axis, z_axis], dim=2)  # (B, 3, 3)
    trans_part = -camera_position[:, None, :] @ rot_part  # (B, 1, 3)
    return torch.cat([rot_part, trans_part], dim=1)


def perspective_projection(fovy: float, ratio: float = 1.0, device=None) -> torch.Tensor:
    """Focal factors [fx, fy] (kaolin ``generate_perspective_projection``;
    ``ratio`` is width / height)."""
    tanfov = math.tan(fovy / 2.0)
    return torch.tensor([1.0 / (ratio * tanfov), 1.0 / tanfov],
                        dtype=torch.float32, device=device)


def transform_vertices(vertices, camera_transform):
    """(B, V, 3) world vertices through the (B, 4, 3) look-at transform."""
    return vertices @ camera_transform[:, :3, :] + camera_transform[:, 3:4, :]


def project_vertices(vertices_camera, cam_proj):
    """(B, V, 3) camera space to (B, V, 2) NDC: x_img = fx * x / (-z)."""
    z = vertices_camera[..., 2:3]
    return vertices_camera[..., :2] * cam_proj / (-z)


def prepare_vertices(vertices, faces, camera_proj, camera_transform):
    """Transform, project and gather per-face data.

    faces is a (F, 3) int64 tensor.  Returns face_vertices_camera
    (B, F, 3, 3), face_vertices_image (B, F, 3, 2) and unit face_normals
    (B, F, 3) in camera space.  The gather is a plain index (the JAX
    package's one-hot matmul is a TPU workaround).
    """
    vertices_camera = transform_vertices(vertices, camera_transform)
    vertices_image = project_vertices(vertices_camera, camera_proj)
    B, F = vertices.shape[0], faces.shape[0]
    flat = faces.reshape(-1)
    face_vertices_camera = vertices_camera[:, flat].reshape(B, F, 3, 3)
    face_vertices_image = vertices_image[:, flat].reshape(B, F, 3, 2)
    face_normals = face_normals_from_vertices(face_vertices_camera, unit=True)
    return face_vertices_camera, face_vertices_image, face_normals


def face_normals_from_vertices(face_vertices, unit: bool = False):
    """Per-face normals from (..., F, 3, 3) face vertices (CCW winding)."""
    v0 = face_vertices[..., 0, :]
    v1 = face_vertices[..., 1, :]
    v2 = face_vertices[..., 2, :]
    n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    if unit:
        n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)
    return n
