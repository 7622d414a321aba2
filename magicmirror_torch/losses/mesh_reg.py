"""Mesh regularizers, the port of ``magicmirror/losses/mesh_reg.py``: plain
tensor code over attribute arrays and the static topology that ``DiffRender``
holds."""
from __future__ import annotations

import torch


def laplacian_flat_loss(delta_vertices, face_normals, laplacian, edge2faces,
                        lambda_lpl: float = 0.1, lambda_flat: float = 0.001):
    """Laplacian smoothness + dihedral flatness."""
    nb_vertices = delta_vertices.shape[1]
    lap = torch.einsum("vw,bwc->bvc", laplacian, delta_vertices)
    loss_laplacian = (lap ** 2).mean() * nb_vertices * 3

    n1 = face_normals[:, edge2faces[:, 0]]
    n2 = face_normals[:, edge2faces[:, 1]]
    faces_cos = (n1 * n2).sum(dim=2)
    loss_flat = ((faces_cos - 1.0) ** 2).mean() * edge2faces.shape[0]
    return lambda_lpl * loss_laplacian + lambda_flat * loss_flat


def _safe_norm(x, dim, eps=1e-12):
    """sqrt(sum(x^2) + eps): a norm whose gradient at 0 is 0, not NaN
    (deltas start near zero early in training)."""
    return torch.sqrt((x * x).sum(dim=dim) + eps)


def edge_loss(vertices, edges, edge_weight: float = 0.1):
    """Edge-length uniformity."""
    e = vertices[:, edges[:, 0]] - vertices[:, edges[:, 1]]
    edge_length = _safe_norm(e, 2)
    bias_length = edge_length - edge_length.mean(dim=1, keepdim=True)
    return edge_weight * _safe_norm(bias_length, 1).mean()


def depth_loss(vertices):
    """z^2 regularizer."""
    return (vertices[:, :, 2] ** 2).mean()


def _signed_depth(vertices, sign_init, r, eps):
    z = vertices[:, :, 2]
    pos = (sign_init >= 0).to(z.dtype)
    neg = (sign_init < 0).to(z.dtype)
    return (pos * (z - eps) ** 2 * r + neg * (z + eps) ** 2 * r).mean()


def depth_loss_R(vertices, sign_init, ratio: float = 1.0, temp: float = 2.0,
                 eps: float = 0.001):
    """z^2 * exp(temp * (x^2 + (y / ratio)^2)) with sign keeping; x and y
    carry no gradient."""
    x = vertices[:, :, 0].detach()
    y = vertices[:, :, 1].detach()
    return _signed_depth(vertices, sign_init, torch.exp(temp * (x ** 2 + (y / ratio) ** 2)),
                         eps)


def depth_loss_C(vertices, sign_init, ratio: float = 1.0, eps: float = 0.001):
    """The circle variant: z^2 * (x^2 + (y / ratio)^2)."""
    x = vertices[:, :, 0].detach()
    y = vertices[:, :, 1].detach()
    return _signed_depth(vertices, sign_init, x ** 2 + (y / ratio) ** 2, eps)


def deform_loss(delta_vertices):
    """Mean per-vertex offset norm."""
    return _safe_norm(delta_vertices, 2).mean()


def flip_loss(delta_vertices, flip_index, sign_init, L1: bool = False):
    """z-mirror symmetry of the delta vertices, masked to the vertices whose
    mirror partner keeps the template's z sign."""
    Na = delta_vertices
    Nf = Na[:, flip_index] * Na.new_tensor([1.0, 1.0, -1.0])
    mask_a = torch.relu(torch.sign(Na[:, :, 2]) * sign_init)
    mask_f = mask_a[:, flip_index].detach()
    if L1:
        return ((Na - Nf).abs() * mask_f[..., None]).mean()
    return (_safe_norm(Na - Nf, 2) * mask_f).mean()
