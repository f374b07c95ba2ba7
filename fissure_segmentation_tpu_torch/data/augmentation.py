"""Point-cloud augmentation on the device (counterpart of
data/augmentation.py:27-139).

A random similarity transform in grid coordinates: rotation by the fixed
angle ``rotation_amount * pi`` around a random axis, uniform scale in
``[1 - scale_amount, 1]`` and translation in
``[-translation_amount, translation_amount]``. Transforms are ``(R, s, t)``
with the row-vector convention ``p' = (p @ R) * s + t``. Draws come from an
explicit `torch.Generator` on the points' device; a drawn transform can be
passed in instead (jax.random cannot be replayed in torch, so the parity
tests inject the JAX draw).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SimilarityTransform(NamedTuple):
    rotation: torch.Tensor     # (..., 3, 3)
    scaling: torch.Tensor      # (..., 1) or (..., 3)
    translation: torch.Tensor  # (..., 3)


def so3_exp_map(log_rot: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula; (..., 3) axis-angle -> (..., 3, 3) rotation."""
    norm = torch.linalg.norm(log_rot, dim=-1, keepdim=True)
    theta = norm[..., None]                                  # (..., 1, 1)
    safe = torch.clamp(theta, min=1e-8)
    axis = log_rot / torch.clamp(norm, min=1e-8)
    zeros = torch.zeros_like(axis[..., 0])
    k = torch.stack([
        torch.stack([zeros, -axis[..., 2], axis[..., 1]], dim=-1),
        torch.stack([axis[..., 2], zeros, -axis[..., 0]], dim=-1),
        torch.stack([-axis[..., 1], axis[..., 0], zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=log_rot.dtype,
                    device=log_rot.device).expand(k.shape)
    r = eye + torch.sin(safe) * k + (1 - torch.cos(safe)) * (k @ k)
    return torch.where(theta > 1e-8, r, eye)


def compose_transform(log_rotation: torch.Tensor, translation: torch.Tensor,
                      scaling: torch.Tensor) -> SimilarityTransform:
    return SimilarityTransform(so3_exp_map(log_rotation), scaling, translation)


def transform_points(points: torch.Tensor,
                     t: SimilarityTransform) -> torch.Tensor:
    """p' = (p @ R) * s + t for points (..., N, 3)."""
    rotated = points @ t.rotation
    return rotated * t.scaling[..., None, :] + t.translation[..., None, :]


def random_transform(generator: torch.Generator, batch_shape=(),
                     rotation_amount: float = 0.1,
                     translation_amount: float = 0.1,
                     scale_amount: float = 0.1,
                     device=None) -> SimilarityTransform:
    """Draw a random similarity transform per batch element from
    `generator` (on `device`, default the generator's)."""
    device = generator.device if device is None else device

    def uniform(*shape):
        return torch.rand((*batch_shape, *shape), generator=generator,
                          device=device)

    v = uniform(3) * 2 - 1
    axis = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-8)
    log_rot = axis * (math.pi * rotation_amount)
    translation = (uniform(3) * 2 - 1) * translation_amount
    scaling = 1.0 - uniform(1) * scale_amount
    return compose_transform(log_rot, translation, scaling)


def point_augmentation(point_clouds: torch.Tensor,
                       generator: torch.Generator | None = None,
                       rotation_amount: float = 0.1,
                       translation_amount: float = 0.1,
                       scale_amount: float = 0.1,
                       transform: SimilarityTransform | None = None):
    """Random similarity augmentation of (B, N, 3) clouds.

    :param transform: use this transform instead of drawing one
    :return: (augmented clouds, the transform)
    """
    if transform is None:
        transform = random_transform(generator, point_clouds.shape[:-2],
                                     rotation_amount, translation_amount,
                                     scale_amount, device=point_clouds.device)
    return transform_points(point_clouds, transform), transform
