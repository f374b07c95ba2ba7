"""Point-cloud normal estimation by kNN-PCA (counterpart of ops/normals.py).

The covariance of each point's k-neighborhood (kNN through K1) is built with
one batched matmul, its smallest eigenvector is computed in closed form, and
normals are oriented against the dominant-plane normal of the whole cloud.
"""
from __future__ import annotations

import torch

from ..keypoints.hessian import eigvalsh3
from ..utils.device import host_to
from .edge import gather_neighbors
from .knn import knn


def _smallest_eigvec3(a00, a11, a22, a01, a02, a12):
    """Unit eigenvector of the smallest eigenvalue of symmetric 3x3 fields:
    the cross product of the two most independent rows of (A - lambda I)."""
    e1, e2, e3 = eigvalsh3(a00, a11, a22, a01, a02, a12)
    lam = torch.minimum(torch.minimum(e1, e2), e3)
    r0 = torch.stack([a00 - lam, a01, a02], -1)
    r1 = torch.stack([a01, a11 - lam, a12], -1)
    r2 = torch.stack([a02, a12, a22 - lam], -1)
    cands = torch.stack([torch.linalg.cross(r0, r1),
                         torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], -2)      # (..., 3, 3)
    best = torch.argmax((cands ** 2).sum(-1), dim=-1)         # first max
    v = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    # degenerate (isotropic) neighborhoods: fall back to +z
    fallback = host_to([0.0, 0.0, 1.0], v.device, v.dtype)
    return torch.where(norm > 1e-12, v / torch.clamp(norm, min=1e-12),
                       fallback.expand_as(v))


def _sym_eigvec(cov):
    return _smallest_eigvec3(cov[..., 0, 0], cov[..., 1, 1], cov[..., 2, 2],
                             cov[..., 0, 1], cov[..., 0, 2], cov[..., 1, 2])


def estimate_pointcloud_normals(points: torch.Tensor, k: int = 30,
                                mask: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Per-point unit normals from k-neighborhood PCA.

    :param points: (B, N, 3) or (N, 3)
    :param mask: optional (B, N) validity — invalid points are pushed to
        1e6 so they never enter a valid point's neighborhood (their own
        normals are arbitrary)
    :return: normals of the same shape, globally oriented
    """
    if points.ndim == 2:
        return estimate_pointcloud_normals(
            points[None], k, None if mask is None else mask[None])[0]
    pts = points
    far = pts if mask is None else torch.where(mask[..., None], pts, 1e6)
    idx = knn(far, k, self_loop=True)
    d = gather_neighbors(pts, idx)
    d = d - d.mean(dim=-2, keepdim=True)
    cov = torch.einsum("...ki,...kj->...ij", d, d) / k
    n = _sym_eigvec(cov)

    # global orientation: reference = smallest PCA axis of the full cloud
    if mask is not None:
        w = mask[..., None].to(pts.dtype)
        mu = (pts * w).sum(-2, keepdim=True) / torch.clamp(
            w.sum(-2, keepdim=True), min=1)
        dc = (pts - mu) * w
    else:
        dc = pts - pts.mean(-2, keepdim=True)
    ref = _sym_eigvec(torch.einsum("...ni,...nj->...ij", dc, dc))
    # deterministic sign for the reference itself
    ref = ref * torch.where(ref[..., 2:3] + 1e-12 * ref[..., 0:1] >= 0,
                            1.0, -1.0)
    flip = (n * ref[..., None, :]).sum(-1, keepdim=True) < 0
    return torch.where(flip, -n, n)
