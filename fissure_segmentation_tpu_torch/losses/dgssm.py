"""DG-SSM's loss (counterpart of losses/dgssm.py): Chamfer distance of the
points, MSE of the mode coefficients and MSE of the 9 affine parameters.
The target shape is moved into the augmented space with the target affine
parameters before the point term."""
from __future__ import annotations

import torch

from ..data.augmentation import compose_transform, transform_points
from .chamfer import chamfer_distance

DEFAULT_W_POINT = 1.0
DEFAULT_W_COEFFICIENTS = 0.5
DEFAULT_W_AFFINE = 0.5


def corresponding_point_distance(prediction: torch.Tensor,
                                 target: torch.Tensor) -> torch.Tensor:
    """Euclidean distance of each corresponding point, (..., P)."""
    return torch.sqrt(((prediction - target) ** 2).sum(-1))


def make_dgssm_loss(w_point: float = DEFAULT_W_POINT,
                    w_coefficients: float = DEFAULT_W_COEFFICIENTS,
                    w_affine: float = DEFAULT_W_AFFINE):
    """``loss((shape, weights, affine), (target shape, target weights,
    target affine)) -> (total, components)``."""
    def loss(prediction, target):
        pred_shape, pred_weights, pred_affine = prediction
        targ_shape, targ_weights, targ_affine = target
        targ_moving = transform_points(targ_shape, compose_transform(
            targ_affine[:, :3], targ_affine[:, 3:6], targ_affine[:, 6:9]))

        point_loss = chamfer_distance(pred_shape, targ_moving)
        coeff_loss = ((pred_weights - targ_weights) ** 2).mean()
        total = w_point * point_loss + w_coefficients * coeff_loss
        comps = {"Point-Loss": point_loss, "Coefficients": coeff_loss}
        if w_affine:
            affine_loss = ((pred_affine - targ_affine) ** 2).mean()
            comps["Affine-Params"] = affine_loss
            total = total + w_affine * affine_loss
        return total, comps

    return loss
