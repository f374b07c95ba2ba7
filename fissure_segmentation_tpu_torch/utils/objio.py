"""Minimal Wavefront OBJ triangle-mesh IO (host side).

The reference stores ground-truth fissure/lobe meshes as ``.obj`` files in
``{case}_mesh_{sequence}/`` directories (data.py:699-716 `load_meshes` via
Open3D). This is a dependency-free reader/writer for the same files.

A copy of the JAX package's utils/objio.py (the port imports nothing of
that package); tests/test_torch_repairs.py holds it equal to the original.
"""
from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Read an OBJ file -> (verts (V, 3) float32, faces (F, 3) int32).

    Polygonal faces are fan-triangulated; `v`/`f` records only (normals,
    texcoords and negative indices in `f` entries are handled/ignored).
    """
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3))


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as fh:
        for v in np.asarray(verts):
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in np.asarray(faces):
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def mesh_to_triangle_soup(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(V, 3) + (F, 3) -> (F, 3, 3) triangle soup (the framework's native
    fixed-budget mesh representation, see postprocess/surface_fitting.py)."""
    return np.asarray(verts, np.float32)[np.asarray(faces, np.int64)]
