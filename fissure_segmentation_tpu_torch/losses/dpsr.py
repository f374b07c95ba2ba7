"""DPSR-Net's training loss (counterpart of losses/dpsr.py): segmentation
(CE + GDL) plus, from an epoch fraction on, a masked Chamfer distance
between the predicted surface samples and the ground-truth surface
samples."""
from __future__ import annotations

import torch

from .chamfer import chamfer_distance
from .segmentation import nnu_loss

DEFAULT_W_SEG = 0.5
DEFAULT_W_CHAMFER = 0.5
DEFAULT_EPOCH_START_CHAMFER = 0.1


def make_dpsr_loss(class_weights=None, w_seg: float = DEFAULT_W_SEG,
                   w_mesh: float = DEFAULT_W_CHAMFER,
                   epoch_start_mesh_loss: float = DEFAULT_EPOCH_START_CHAMFER):
    """``loss((seg_logits, surface_pts, valid), (labels, target_pts[,
    target_valid]), current_epoch_fraction) -> (total, components)``.
    Before `epoch_start_mesh_loss` the total is the segmentation loss alone
    and the Chamfer component 0."""
    def loss(prediction, target, current_epoch_fraction: float = 1.0):
        pred_seg, pred_surface_pts, pred_valid = prediction
        targ_seg, targ_surface_pts = target[0], target[1]
        targ_valid = target[2] if len(target) > 2 else None

        seg, _ = nnu_loss(pred_seg, targ_seg, class_weights)
        if current_epoch_fraction >= epoch_start_mesh_loss and w_mesh > 0:
            cham = chamfer_distance(pred_surface_pts, targ_surface_pts,
                                    x_mask=pred_valid, y_mask=targ_valid)
            total = w_seg * seg + w_mesh * cham
        else:
            cham = torch.zeros((), device=seg.device)
            total = seg
        return total, {"Segmentation": seg, "Chamfer": cham}

    return loss
