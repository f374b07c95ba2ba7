"""Plane-based fissure regularization (counterpart of
postprocess/plane_fitting.py): a closed-form total-least-squares plane
(SVD) refined by Adam on the Huber point-to-plane distance, on the points'
device, and the fitted plane rasterized into a triangle soup on the host.

The smallest singular vector's sign is not fixed across LAPACK builds, so
a plane (n, d) and (-n, -d) are the same fit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def plane_from_points_lstsq(pts: torch.Tensor,
                            valid: torch.Tensor | None = None):
    """Closed-form total-least-squares plane: (unit normal (3,), offset d)
    with n . p = d; the smallest-singular-vector of the centered cloud."""
    if valid is None:
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    w = valid.to(pts.dtype)[:, None]
    center = (pts * w).sum(0) / torch.clamp(w.sum(), min=1e-9)
    centered = (pts - center) * w
    _, _, vt = torch.linalg.svd(centered, full_matrices=False)
    n = vt[-1]
    return n, torch.dot(n, center)


def fit_plane_to_fissure(pts: torch.Tensor,
                         valid: torch.Tensor | None = None,
                         steps: int = 200, lr: float = 1e-2,
                         huber_delta: float = 1.0):
    """Robust plane fit: least-squares init, then Adam on the Huber
    point-to-plane distance.

    :param pts: (N, 3) fissure points (any consistent coordinate frame)
    :return: (unit normal (3,), offset d), on the points' device
    """
    if valid is None:
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    n0, d0 = plane_from_points_lstsq(pts, valid)
    n = n0.detach().clone().requires_grad_(True)
    d = d0.detach().clone().requires_grad_(True)
    w = valid.to(pts.dtype)
    opt = torch.optim.Adam([n, d], lr=lr)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        unit = n / torch.clamp(torch.linalg.norm(n), min=1e-9)
        dist = pts @ unit - d
        h = F.huber_loss(dist, torch.zeros_like(dist), reduction="none",
                         delta=huber_delta)
        loss = (h * w).sum() / torch.clamp(w.sum(), min=1e-9)
        loss.backward()
        opt.step()
    with torch.no_grad():
        return n / torch.clamp(torch.linalg.norm(n), min=1e-9), d.detach()


def plane_to_mesh(normal, offset, shape, mask: np.ndarray | None = None,
                  grid_n: int = 48):
    """Rasterize the fitted plane into a triangle soup inside the volume
    (optionally clipped to a mask).

    :param shape: (D, H, W) volume shape; plane coords are world xyz voxels
    :return: (tris (T, 3, 3) world xyz, valid (T,))
    """
    normal = np.asarray(normal)
    offset = float(offset)
    d, h, w = shape
    # parameterize over the two axes least aligned with the normal
    drop = int(np.argmax(np.abs(normal)))
    axes = [a for a in range(3) if a != drop]
    extent = [w, h, d]
    u = np.linspace(0, extent[axes[0]] - 1, grid_n)
    v = np.linspace(0, extent[axes[1]] - 1, grid_n)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = np.zeros((grid_n, grid_n, 3), np.float32)
    verts[..., axes[0]] = uu
    verts[..., axes[1]] = vv
    verts[..., drop] = (offset - normal[axes[0]] * uu
                        - normal[axes[1]] * vv) / normal[drop]

    inside = (verts[..., drop] >= 0) & (verts[..., drop] <= extent[drop] - 1)
    if mask is not None:
        idx = np.clip(np.round(verts[..., ::-1]).astype(int), 0,
                      np.asarray(shape) - 1)  # xyz -> zyx
        inside &= mask[idx[..., 0], idx[..., 1], idx[..., 2]]

    tris, valid = [], []
    for i in range(grid_n - 1):
        for j in range(grid_n - 1):
            q = verts[i:i + 2, j:j + 2].reshape(4, 3)
            ok = inside[i:i + 2, j:j + 2].all()
            tris.extend([[q[0], q[1], q[2]], [q[1], q[3], q[2]]])
            valid.extend([ok, ok])
    return np.asarray(tris, np.float32), np.asarray(valid, bool)
