"""Farthest point sampling (counterpart of ops/fps.py).

Every call goes to K5 (kernels/fps.py), which launches the CUDA kernel for a
CUDA tensor and runs its plain PyTorch version for a CPU tensor; the JAX
package's scan over m - 1 steps is that plain version.
"""
from __future__ import annotations

import torch

from ..kernels.fps import fps_cuda


def farthest_point_sampling(points: torch.Tensor, m: int,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Select m points maximizing the minimum pairwise distance.

    :param points: (B, N, C) (or (N, C)) float32, C <= 8
    :param mask: optional (B, N) (or (N,)) validity; invalid points are
        never selected (if fewer than m valid points exist, selections
        repeat)
    :return: (B, m) (or (m,)) int32 indices; the first is the first valid
        point (0 when no mask is given, or no point is valid)
    """
    if points.ndim == 2:
        return farthest_point_sampling(
            points[None], m, None if mask is None else mask[None])[0]
    valid = None if mask is None else mask.to(torch.bool).contiguous()
    return fps_cuda(points.contiguous(), m, valid)
