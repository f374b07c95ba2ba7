"""Batched point-cloud neighborhood ops: kNN query, query-and-group,
inverse-distance interpolation (counterpart of ops/pointops.py).

The JAX package computes these in XLA, not Pallas, so they stay plain
torch here and compute the same function: distances by the expanded formula
|q|^2 - 2 q.s + |s|^2 (ops/knn.py:pairwise_sqdist with both arguments, so
the diagonal is not zeroed), neighbors in ascending distance with ties to
the lower index (lax.top_k's order; a stable sort here — `torch.topk` fixes
no tie order on CUDA), gathers along the point axis.
"""
from __future__ import annotations

import torch

from .knn import pairwise_sqdist


def _gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, M, k) -> (B, M, k, C)."""
    b, m, k = idx.shape
    flat = idx.reshape(b, m * k, 1).to(torch.int64)
    return torch.gather(x, 1, flat.expand(b, m * k, x.shape[-1])) \
        .reshape(b, m, k, x.shape[-1])


def knn_query(support_xyz: torch.Tensor, query_xyz: torch.Tensor, k: int):
    """k nearest support points of each query point (self included when the
    query coincides with a support point — pointops KNNQuery semantics).
    With k > N the list is padded with repeats of the nearest neighbor.

    :param support_xyz: (B, N, 3); :param query_xyz: (B, M, 3)
    :return: (idx (B, M, k) int32, dist (B, M, k) *euclidean* distances)
    """
    n = support_xyz.shape[-2]
    d = pairwise_sqdist(query_xyz, support_xyz)               # (B, M, N)
    d, idx = torch.sort(d, dim=-1, stable=True)
    d, idx = d[..., :min(k, n)], idx[..., :min(k, n)]
    if k > n:
        pad = k - n
        idx = torch.cat([idx, idx[..., :1].expand(*idx.shape[:-1], pad)], -1)
        d = torch.cat([d, d[..., :1].expand(*d.shape[:-1], pad)], -1)
    return idx.to(torch.int32), torch.sqrt(torch.clamp(d, min=0.0))


def query_and_group(support_xyz: torch.Tensor, query_xyz: torch.Tensor,
                    feat: torch.Tensor, nsample: int, idx=None,
                    use_xyz: bool = True):
    """Group features of the nsample nearest support points per query.

    :param feat: (B, N, C) support features
    :return: ((B, M, nsample, 3 + C) if use_xyz (relative xyz first) else
        (B, M, nsample, C), idx)
    """
    if idx is None:
        idx, _ = knn_query(support_xyz, query_xyz, nsample)
    grouped_feat = _gather_points(feat, idx)
    if not use_xyz:
        return grouped_feat, idx
    grouped_xyz = _gather_points(support_xyz, idx) - query_xyz[..., None, :]
    return torch.cat([grouped_xyz, grouped_feat], dim=-1), idx


def interpolate(coarse_xyz: torch.Tensor, fine_xyz: torch.Tensor,
                coarse_feat: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Inverse-distance weighted k-NN interpolation from a coarse onto a
    fine point set.

    :return: (B, N_fine, C)
    """
    idx, dist = knn_query(coarse_xyz, fine_xyz, k)
    w = 1.0 / (dist + 1e-8)
    w = w / w.sum(dim=-1, keepdim=True)
    neigh = _gather_points(coarse_feat, idx)
    return (neigh * w[..., None]).sum(dim=-2)
