"""Wavefront OBJ reader and writer (numpy), the port of
``magicmirror/geometry/obj_io.py``.

It returns the same arrays, with the same dtypes, as the JAX package's
``load_obj``.  Pure numpy: mesh I/O is a one-time setup cost.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    """``vertices`` (V, 3) float32, ``faces`` (F, 3) int32 0-based, ``uvs``
    (T, 2) float32, ``face_uvs_idx`` (F, 3) int32 0-based (all zero if the
    file has no ``vt`` records)."""

    vertices: np.ndarray
    faces: np.ndarray
    uvs: np.ndarray
    face_uvs_idx: np.ndarray
    materials: list | None = None


def load_obj(path: str, with_materials: bool = False) -> Mesh:
    """Parse ``v``, ``vt`` and triangular ``f`` records (``f v``, ``f v/vt``
    or ``f v/vt/vn``; 1-based indices, no negative indices)."""
    vertices: list[list[float]] = []
    uvs: list[list[float]] = []
    faces: list[list[int]] = []
    face_uvs_idx: list[list[int]] = []
    materials: list[str] = []

    with open(path, "r") as fp:
        for line in fp:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif tag == "f":
                if len(parts) != 4:
                    raise ValueError(
                        f"{path}: only triangular faces are supported, got {line!r}")
                vi, ti = [], []
                for tok in parts[1:4]:
                    comps = tok.split("/")
                    vi.append(int(comps[0]) - 1)
                    if len(comps) > 1 and comps[1]:
                        ti.append(int(comps[1]) - 1)
                faces.append(vi)
                face_uvs_idx.append(ti if len(ti) == 3 else [0, 0, 0])
            elif tag in ("mtllib", "usemtl") and with_materials:
                materials.append(line.strip())

    return Mesh(
        vertices=np.asarray(vertices, dtype=np.float32),
        faces=np.asarray(faces, dtype=np.int32),
        uvs=np.asarray(uvs, dtype=np.float32).reshape(-1, 2),
        face_uvs_idx=np.asarray(face_uvs_idx, dtype=np.int32),
        materials=materials if with_materials else None,
    )


def save_mesh(obj_mesh_name: str, v, faces, vt=None) -> None:
    """Write an OBJ file as the JAX package's ``save_mesh`` writes it: ``%f``
    vertices (and ``vt`` records when given), 1-based vertex-only faces."""
    v = np.asarray(v)
    faces = np.asarray(faces)
    with open(obj_mesh_name, "w") as fp:
        for i in range(v.shape[0]):
            fp.write("v %f %f %f\n" % (v[i, 0], v[i, 1], v[i, 2]))
        if vt is not None:
            vt = np.asarray(vt)
            for i in range(vt.shape[0]):
                fp.write("vt %f %f\n" % (vt[i, 0], vt[i, 1]))
        for f in faces:  # faces are 1-based in OBJ
            fp.write("f %d %d %d\n" % (f[0] + 1, f[1] + 1, f[2] + 1))
