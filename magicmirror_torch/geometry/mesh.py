"""Mesh topology precompute (numpy, one-time setup) and the faces' signed
areas (torch), the port of ``magicmirror/geometry/mesh.py``."""
from __future__ import annotations

import numpy as np
import torch


def normalize_template(vertices: np.ndarray, init_ellipsoid: float = 1.0) -> np.ndarray:
    """Normalize to [-1, 1], squash depth to an ellipsoid, shrink by 0.9."""
    v = np.asarray(vertices, dtype=np.float32)
    v_max = v.max(axis=0, keepdims=True)
    v_min = v.min(axis=0, keepdims=True)
    v = (v - v_min) / (v_max - v_min)
    v = v * 2.0 - 1.0
    if init_ellipsoid != -1:
        v[:, 2] = v[:, 2] / 2.0
        if init_ellipsoid != 1:
            v[:, 0] = v[:, 0] / init_ellipsoid
            v[:, 2] = v[:, 2] / init_ellipsoid
    v *= 0.9
    return v


def flip_index(vertices: np.ndarray) -> np.ndarray:
    """Index of each vertex's nearest z-mirrored partner: the argmin of the
    pairwise distance to the z-negated vertices."""
    v = np.asarray(vertices, dtype=np.float32)
    v_flip = v.copy()
    v_flip[:, 2] *= -1
    out = np.empty(v.shape[0], dtype=np.int64)
    rows = 1024  # a (rows, V, 3) block at a time: 85 MB at V = 6,890
    for base in range(0, v.shape[0], rows):
        d2 = ((v[base:base + rows, None, :] - v_flip[None, :, :]) ** 2).sum(-1)
        out[base:base + rows] = np.argmin(d2, axis=1)
    return out


def unique_edges(faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted unique undirected edges (E, 2) and the inverse map (3F,) of the
    per-face edge list [v0v1, v1v2, v2v0] stacked per corner."""
    faces = np.asarray(faces)
    edges = np.concatenate([faces[:, 0:2], faces[:, 1:3], faces[:, [2, 0]]], axis=0)
    edges = np.sort(edges, axis=1)
    uniq, inverse = np.unique(edges, axis=0, return_inverse=True)
    return uniq.astype(np.int32), inverse.astype(np.int64)


def edge2faces(faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(edges (E, 2), edge2faces (E, 2)): for each unique edge its (up to
    two) incident face ids, first occurrence in slot 0.  A boundary edge
    holds its single face in both slots, so its flat-loss cosine is 1."""
    faces = np.asarray(faces)
    uniq, inverse = unique_edges(faces)
    face_ids = np.tile(np.arange(faces.shape[0], dtype=np.int64), 3)
    e2f = np.zeros((uniq.shape[0], 2), dtype=np.int64)
    slot = np.zeros(uniq.shape[0], dtype=np.int64)
    for k in np.argsort(inverse, kind="stable"):
        e = inverse[k]
        e2f[e, min(slot[e], 1)] = face_ids[k]
        slot[e] += 1
    boundary = slot == 1
    e2f[boundary, 1] = e2f[boundary, 0]
    return uniq.astype(np.int64), e2f


def uniform_laplacian(num_vertices: int, faces: np.ndarray) -> np.ndarray:
    """Dense uniform graph Laplacian (V, V): 1/deg(i) for neighbours, -1 on
    the diagonal, zero rows for isolated vertices."""
    edges, _ = unique_edges(np.asarray(faces))
    adj = np.zeros((num_vertices, num_vertices), dtype=np.float32)
    adj[edges[:, 0], edges[:, 1]] = 1.0
    adj[edges[:, 1], edges[:, 0]] = 1.0
    deg = adj.sum(axis=1)
    L = adj / np.maximum(deg, 1.0)[:, None]
    L -= np.eye(num_vertices, dtype=np.float32)
    L[deg == 0] = 0.0
    return L


def face_clocks(vertices, faces):
    """Signed (clockwise-ness) areas of the faces, reference
    smr_utils.py:20-53: vertices (B, V, 3) or (B, V, 2) (then z = 0),
    faces (F, 3) -> (B, F).  The same products, summed in the same order,
    as the JAX function."""
    if vertices.shape[-1] == 2:
        vertices = torch.cat([vertices, torch.zeros_like(vertices[..., :1])], dim=-1)
    faces = torch.as_tensor(np.asarray(faces), dtype=torch.long, device=vertices.device)
    fv = vertices[:, faces.reshape(-1), :].reshape(vertices.shape[0], -1, 3, 3)
    d0 = fv[:, :, 0] - fv[:, :, 1]
    d1 = fv[:, :, 1] - fv[:, :, 2]
    x1, x2, x3 = d0.unbind(-1)
    y1, y2, y3 = d1.unbind(-1)
    return 0.5 * ((x2 * y3 - x3 * y2) + (x3 * y1 - x1 * y3) + (x1 * y2 - x2 * y1))
