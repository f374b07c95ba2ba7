"""Coordinate conventions for keypoint clouds (copy of utils/coords.py).

Points live in PyTorch-style normalized grid coordinates in [-1, 1], **xyz**
order, with ``align_corners=False`` semantics. Every dataset/model in the
framework depends on this convention (reference: utils/general_utils.py:16,
kpts_to_grid:105, kpts_to_world:133).

Volume shapes are given as ``(D, H, W)`` (zyx, like the stored arrays); point
coordinates are ``(..., 3)`` in xyz order, i.e. ``points[..., 0]`` indexes W.
The transforms take numpy arrays or torch tensors (on any device) and do the
same float32 operations in the same order as the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

# Global convention: align_corners=False everywhere.
ALIGN_CORNERS = False


def _whd(shape, like):
    """(D, H, W) volume shape -> float32 (W, H, D) vector matching xyz
    points, as a tensor on `like`'s device when `like` is a tensor."""
    d, h, w = shape
    size = np.asarray([w, h, d], dtype=np.float32)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(size).to(like.device, non_blocking=True)
    return size


def kpts_to_grid(kpts_world, shape, align_corners: bool | None = None):
    """World (voxel-index) xyz points -> normalized grid coords in [-1, 1].

    Parity with reference utils/general_utils.py:105-130.

    :param kpts_world: (..., 3) xyz voxel coordinates in a (D, H, W) volume.
    :param shape: volume shape (D, H, W).
    :param align_corners: grid_sample-style corner alignment (default False).
    :return: (..., 3) normalized coordinates.
    """
    size = _whd(shape, kpts_world)
    kpts_pt = kpts_world / (size - 1) * 2 - 1
    if not (ALIGN_CORNERS if align_corners is None else align_corners):
        kpts_pt = kpts_pt * ((size - 1) / size)
    return kpts_pt


def kpts_to_world(kpts_pt, shape, align_corners: bool | None = None):
    """Normalized grid coords in [-1, 1] -> world (voxel-index) xyz points.

    Parity with reference utils/general_utils.py:133-148.
    """
    size = _whd(shape, kpts_pt)
    if not (ALIGN_CORNERS if align_corners is None else align_corners):
        kpts_pt = kpts_pt / ((size - 1) / size)
    return (kpts_pt + 1) / 2 * (size - 1)


def grid_to_index_coords(kpts_pt, shape, align_corners: bool | None = None):
    """Normalized xyz grid coords -> zyx floating-point array indices.

    Convenience for `jax.scipy.ndimage.map_coordinates`-style sampling of
    (D, H, W) volumes.
    """
    world = kpts_to_world(kpts_pt, shape, align_corners)  # xyz
    return world[..., ::-1] if isinstance(world, np.ndarray) \
        else world.flip(-1)  # zyx


def np_grid_coords(world_xyz: np.ndarray, shape) -> np.ndarray:
    """Pure-numpy kpts_to_grid for host-side generation/IO paths."""
    return np.asarray(kpts_to_grid(np.asarray(world_xyz, np.float32), shape))
