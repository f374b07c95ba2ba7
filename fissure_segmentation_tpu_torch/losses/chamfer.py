"""Chamfer distance between point clouds (counterpart of losses/chamfer.py).

Squared euclidean nearest-neighbour distances from one `pairwise_sqdist`
(|x|^2 - 2 x.y + |y|^2, a plain matmul, as the JAX package computes it
outside any Pallas kernel) clamped at 0, the mean over the points in each
direction (or over the valid points, with masks), both directions summed,
the mean over the batch. Channel-last (B, N, 3) clouds.
"""
from __future__ import annotations

import torch

from ..ops.knn import pairwise_sqdist


def chamfer_distance(x: torch.Tensor, y: torch.Tensor,
                     x_mask: torch.Tensor | None = None,
                     y_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Symmetric squared-distance Chamfer, (B, N, 3) x (B, M, 3) -> scalar.

    :param x_mask: optional (B, N) bool; masked points take part in no
        minimum and no mean (the same for `y_mask`, (B, M))
    """
    d = torch.clamp(pairwise_sqdist(x, y), min=0.0)        # (B, N, M)
    if y_mask is not None:
        d = torch.where(y_mask[..., None, :], d, torch.inf)
    if x_mask is not None:
        d = torch.where(x_mask[..., None], d, torch.inf)
    min_xy = d.amin(-1)                                     # (B, N)
    min_yx = d.amin(-2)                                     # (B, M)

    def mean(m, mask):
        if mask is None:
            return m.mean(-1)
        return torch.where(mask, m, 0.0).sum(-1) / torch.clamp(
            mask.sum(-1), min=1)
    return (mean(min_xy, x_mask) + mean(min_yx, y_mask)).mean()


def chamfer_loss(prediction: torch.Tensor, target: torch.Tensor):
    loss = chamfer_distance(prediction, target)
    return loss, {"Chamfer": loss}
