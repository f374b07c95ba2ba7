"""Förstner interest-point detector on CT volumes (counterpart of
keypoints/foerstner.py): 5-tap central-difference gradients, smoothed
6-channel structure tensor, trace-of-inverse distinctiveness, max-pool NMS,
6-neighborhood mask erosion, and a fixed-size exact top-k extraction.

With `scores` or a `generator`, a uniform random subset of the detected
points is kept instead of the most distinctive ones (the JAX package's
`rng`: uniform + 1 where a point is detected, then the top-k); jax.random
cannot be replayed in torch, so the tests inject JAX's draw as `scores`.
`approx_top_k=True` selects with the approximate top-k instead
(ops/approx_topk.py, `lax.approx_max_k`'s default recall target 0.95: the
bin kernel on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.approx_topk import approx_top_k as approx_max_k
from ..ops.topk import masked_top_k
from ..utils.filters import filter_1d, max_pool_same, smooth

# 5-tap central difference (keypoints/foerstner.py:26)
_GRAD_FILTER = np.array([1.0, -8.0, 0.0, 8.0, -1.0], np.float32) / 12.0


def gradients(img: torch.Tensor) -> torch.Tensor:
    """(..., D, H, W) -> (..., 3, D, H, W) gradients along D, H, W."""
    return torch.stack([filter_1d(img, _GRAD_FILTER, dim) for dim in range(3)],
                       dim=-4)


def structure_tensor(grad: torch.Tensor, sigma: float) -> torch.Tensor:
    """(..., 3, D, H, W) -> (..., 6, D, H, W) smoothed structure tensor,
    channel order (xx, xy, xz, yy, yz, zz)."""
    chans = []
    for i in range(3):
        for j in range(i, 3):
            chans.append(smooth(grad[..., i, :, :, :] * grad[..., j, :, :, :],
                                sigma))
    return torch.stack(chans, dim=-4)


def trace_of_inverse(struct: torch.Tensor) -> torch.Tensor:
    """Trace of the inverse of the symmetric 3x3 tensor field."""
    a, b, c, e, f, i = (struct[..., k, :, :, :] for k in range(6))
    A = e * i - f * f
    E = a * i - c * c
    I = a * e - b * b
    B = -b * i + c * f
    C = b * f - c * e
    det = a * A + b * B + c * C
    return (A + E + I) / det


def distinctiveness(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Förstner distinctiveness D = 1 / tr(S^-1)."""
    return 1.0 / trace_of_inverse(structure_tensor(gradients(img), sigma))


def erode_mask(mask: torch.Tensor) -> torch.Tensor:
    """6-neighborhood binary erosion."""
    m = 1.0 - mask.to(torch.float32)
    s = torch.zeros_like(m)
    kernel = np.array([1.0, 0.0, 1.0], np.float32)
    for dim in range(3):
        s = s + filter_1d(m, kernel, dim, padding_mode="constant")
    return (1.0 - s.clamp(0.0, 1.0)) >= 0.5


def foerstner_keypoints(img: torch.Tensor, mask: torch.Tensor,
                        sigma: float = 1.4, d: int = 9, thresh: float = 1e-8,
                        max_kpts: int = 20000,
                        generator: torch.Generator | None = None,
                        scores: torch.Tensor | None = None,
                        approx_top_k: bool = False):
    """Detect keypoints in a (D, H, W) volume within a boolean mask.

    :param generator: draws the uniform scores of a random subset (see
        extraction.uniform_scores)
    :param scores: optional (D * H * W,) uniform draws instead
    :param approx_top_k: select with the approximate top-k at recall
        target 0.95 (`lax.approx_max_k`'s default) instead of the exact one

    :return: (kpts (max_kpts, 3) int32 zyx voxel indices, valid (max_kpts,)
        bool, n_candidates () — how many voxels passed the detector)
    """
    dist = distinctiveness(img, sigma)
    maxfeat = max_pool_same(dist, d)
    is_kpt = erode_mask(mask) & (maxfeat == dist) & (dist >= thresh)
    if scores is None and generator is not None:
        from .extraction import uniform_scores
        scores = uniform_scores(dist.numel(), generator, dist.device)
    if scores is not None:
        rand = scores.reshape(dist.shape).to(dist.device,
                                             non_blocking=True) + 1.0
        score = torch.where(is_kpt, rand, torch.full_like(dist, -float("inf")))
    else:
        score = torch.where(is_kpt, dist, torch.full_like(dist, -float("inf")))
    if approx_top_k:
        top, idx = approx_max_k(score.reshape(-1), max_kpts)
    else:
        top, idx = masked_top_k(score, max_kpts)
    valid = torch.isfinite(top)
    _, h, w = img.shape[-3:]
    kpts = torch.stack([idx // (h * w), (idx // w) % h, idx % w], dim=-1)
    return kpts.to(torch.int32), valid, is_kpt.sum()
