"""Point-cloud augmentation on the device and the similarity-transform
algebra (counterpart of data/augmentation.py:27-139).

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


def so3_log_map(r: torch.Tensor) -> torch.Tensor:
    """The inverse of `so3_exp_map`: (..., 3, 3) rotation -> (..., 3)
    axis-angle; the angle from the trace (its cosine clipped to
    [-1 + 1e-7, 1 - 1e-7]), the axis from the skew part, and below an
    angle of 1e-6 the skew vector itself."""
    cos = (r.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    theta = torch.arccos(torch.clamp(cos, -1 + 1e-7, 1 - 1e-7))[..., None]
    w = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                     r[..., 0, 2] - r[..., 2, 0],
                     r[..., 1, 0] - r[..., 0, 1]], dim=-1) / 2
    axis = w / torch.clamp(torch.sin(theta), min=1e-8)
    return torch.where(theta > 1e-6, axis * theta, w)


def invert_transform(t: SimilarityTransform) -> SimilarityTransform:
    """The inverse of p' = (p @ R) * s + t: p = ((p' - t) / s) @ R^T."""
    r_inv = t.rotation.transpose(-1, -2)
    s_inv = 1.0 / t.scaling
    t_inv = -((t.translation * s_inv)[..., None, :] @ r_inv)[..., 0, :]
    return SimilarityTransform(r_inv, s_inv, t_inv)


def chain_transforms(a: SimilarityTransform,
                     b: SimilarityTransform) -> SimilarityTransform:
    """The transform that applies `a`, then `b` (isotropic scalings):
    p @ (Ra Rb) * (sa sb) + (ta @ Rb) * sb + tb."""
    rot = a.rotation @ b.rotation
    trans = (a.translation[..., None, :] @ b.rotation)[..., 0, :] \
        * b.scaling + b.translation
    return SimilarityTransform(rot, a.scaling * b.scaling, trans)


def transform_matrix(t: SimilarityTransform) -> torch.Tensor:
    """(..., 4, 4) homogeneous matrix, row-vector convention ([p 1] @ M)."""
    rs = t.rotation * (t.scaling[..., None, :] if t.scaling.shape[-1] == 3
                       else t.scaling[..., None])
    m = torch.zeros((*rs.shape[:-2], 4, 4), dtype=rs.dtype, device=rs.device)
    m[..., :3, :3] = rs
    m[..., 3, :3] = t.translation
    m[..., 3, 3] = 1.0
    return m


def decompose_similarity_transform(t: SimilarityTransform):
    """(log_rotation (..., 3), translation (..., 3), scaling (..., 1)): the
    7 degrees of freedom of a similarity transform."""
    scale = t.scaling if t.scaling.shape[-1] == 1 else t.scaling[..., :1]
    return so3_log_map(t.rotation), t.translation, scale


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
