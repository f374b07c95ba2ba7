"""Native host runtime (C++ via ctypes): connected components, component
statistics, triangle voxelization and binary dilation for the host half of
the surface fit (postprocess/surface_fitting.py).

src/fseg_native.cpp is a copy of the JAX package's native/src/fseg_native.cpp.
At first use it is compiled with g++ into _build/ (the library name carries a
hash of the source and flags, so an edited source is never served from a
stale build) and loaded with ctypes. There is no fallback: if g++ is missing,
refuses the source, or the library does not load, `load` raises
NativeBuildError.

Public API (all NumPy in / NumPy out):
    cc_label_3d(grid)           -> (labels int32 zyx, n_components)
    cc_stats(labels, n)         -> (sizes int64, x_sums float64) per label
    point_mesh_distance(verts, tris, queries) -> (nq,) float32
    voxelize_triangles(tris, valid, shape, label, out=None) -> uint8 zyx
    binary_dilate_3d(grid, iters) -> uint8 zyx
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "fseg_native.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fno-math-errno")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """g++ is missing, refused the source, or the library did not load."""


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libfseg_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the source unless a build of exactly this source exists;
    return the library path."""
    path = _lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, _SRC, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        os.unlink(tmp)
        raise NativeBuildError(f"g++ failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builds race safely
    return path


def load() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise NativeBuildError(f"cannot load {path}: {e}") from e
            i64, i32 = ctypes.c_int64, ctypes.c_int32
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.fseg_cc_label_3d.restype = i32
            lib.fseg_cc_label_3d.argtypes = [u8p, i64, i64, i64, i32p]
            lib.fseg_cc_stats.restype = None
            lib.fseg_cc_stats.argtypes = [i32p, i64, i64, i64, i32,
                                          ctypes.POINTER(ctypes.c_int64),
                                          ctypes.POINTER(ctypes.c_double)]
            lib.fseg_point_mesh_dist.restype = None
            lib.fseg_point_mesh_dist.argtypes = [f32p, i64, i32p, i64, f32p,
                                                 i64, f32p]
            lib.fseg_voxelize_tris.restype = None
            lib.fseg_voxelize_tris.argtypes = [f32p, u8p, i64, i64, i64, i64,
                                               ctypes.c_uint8, u8p]
            lib.fseg_binary_dilate_3d.restype = None
            lib.fseg_binary_dilate_3d.argtypes = [u8p, i64, i64, i64, i32,
                                                  u8p]
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def cc_label_3d(grid: np.ndarray):
    """26-connected components of a boolean/uint8 zyx grid.

    :return: (labels int32, n) — labels 0 = background, 1..n components.
    """
    grid = np.ascontiguousarray(grid.astype(np.uint8, copy=False))
    lib = load()
    labels = np.empty(grid.shape, np.int32)
    nz, ny, nx = grid.shape
    n = lib.fseg_cc_label_3d(_ptr(grid, ctypes.c_uint8), nz, ny, nx,
                             _ptr(labels, ctypes.c_int32))
    return labels, int(n)


def cc_stats(labels: np.ndarray, n: int):
    """Per-component (voxel count, x-sum) of a `cc_label_3d` labeling.

    :return: (sizes (n,) int64, xsum (n,) float64)
    """
    labels = np.ascontiguousarray(labels, np.int32)
    lib = load()
    sizes = np.zeros(max(n, 0), np.int64)
    xsum = np.zeros(max(n, 0), np.float64)
    if n <= 0:
        return sizes, xsum
    nz, ny, nx = labels.shape
    lib.fseg_cc_stats(_ptr(labels, ctypes.c_int32), nz, ny, nx, n,
                      _ptr(sizes, ctypes.c_int64),
                      _ptr(xsum, ctypes.c_double))
    return sizes, xsum


def point_mesh_distance(verts: np.ndarray, tris: np.ndarray,
                        queries: np.ndarray) -> np.ndarray:
    """Unsigned distance from each query point to a triangle mesh (exact,
    through a bounding-volume hierarchy); inf for a mesh without faces.

    :param verts: (V, 3) float; :param tris: (T, 3) int faces;
    :param queries: (Q, 3) float
    :return: (Q,) float32
    """
    verts = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    tris = np.ascontiguousarray(tris, np.int32).reshape(-1, 3)
    queries = np.ascontiguousarray(queries, np.float32).reshape(-1, 3)
    if tris.size and (tris.min() < 0 or tris.max() >= len(verts)):
        raise ValueError("point_mesh_distance: a face indexes no vertex")
    lib = load()
    out = np.empty(queries.shape[0], np.float32)
    lib.fseg_point_mesh_dist(
        _ptr(verts, ctypes.c_float), verts.shape[0],
        _ptr(tris, ctypes.c_int32), tris.shape[0],
        _ptr(queries, ctypes.c_float), queries.shape[0],
        _ptr(out, ctypes.c_float))
    return out


def voxelize_triangles(tris: np.ndarray, valid: np.ndarray | None, shape,
                       label: int, out: np.ndarray | None = None) -> np.ndarray:
    """Exact conservative rasterization of a triangle soup into a zyx grid:
    marks every voxel cube [i, i+1)^3 that overlaps a triangle.

    :param tris: (T, 3, 3) float xyz *voxel* coordinates
    :param valid: optional (T,) bool
    :param out: optional existing uint8 labelmap to write into
    """
    tris = np.ascontiguousarray(tris, np.float32)
    if out is None:
        out = np.zeros(shape, np.uint8)
    lib = load()
    v = None if valid is None else \
        np.ascontiguousarray(np.asarray(valid, np.uint8))
    nz, ny, nx = shape
    lib.fseg_voxelize_tris(
        _ptr(tris, ctypes.c_float),
        None if v is None else _ptr(v, ctypes.c_uint8),
        tris.shape[0], nz, ny, nx, label, _ptr(out, ctypes.c_uint8))
    return out


def binary_dilate_3d(grid: np.ndarray, iters: int = 1) -> np.ndarray:
    """Iterated 6-connected dilation (scipy binary_dilation default)."""
    grid = np.ascontiguousarray(grid.astype(np.uint8, copy=False))
    if iters <= 0:
        return grid.copy()
    lib = load()
    out = np.empty(grid.shape, np.uint8)
    nz, ny, nx = grid.shape
    lib.fseg_binary_dilate_3d(_ptr(grid, ctypes.c_uint8), nz, ny, nx, iters,
                              _ptr(out, ctypes.c_uint8))
    return out
