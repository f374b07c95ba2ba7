"""Point segmentation losses: CE, generalized Dice, nnU-Net combo, recall
(counterpart of losses/segmentation.py).

All take channel-last logits (B, ..., C) and integer targets (B, ...) and
return ``(scalar, components_dict)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _onehot(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(targets.to(torch.int64), num_classes).to(torch.float32)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  class_weights: torch.Tensor | None = None):
    """torch.nn.CrossEntropyLoss semantics: weighted mean normalized by
    sum(w_y); all-zero weights give 0 instead of 0/0."""
    logp = torch.log_softmax(logits, dim=-1)
    t = targets.to(torch.int64)
    nll = -torch.gather(logp, -1, t[..., None])[..., 0]
    if class_weights is None:
        ce = nll.mean()
    else:
        w = class_weights[t]
        ce = (w * nll).sum() / torch.clamp(w.sum(), min=1e-12)
    return ce, {"CE": ce}


def generalized_dice_loss(logits: torch.Tensor, targets: torch.Tensor,
                          batch_dice: bool = True, smooth: float = 1.0,
                          apply_softmax: bool = True):
    """GDL: 1/V-weighted soft dice, returns -dice."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1) if apply_softmax else logits
    y = _onehot(targets, num_classes)
    axes = tuple(range(probs.ndim - 1)) if batch_dice \
        else tuple(range(1, probs.ndim - 1))
    tp = (probs * y).sum(axes)
    fp = (probs * (1 - y)).sum(axes)
    fn = ((1 - probs) * y).sum(axes)
    volumes = y.sum(axes) + 1e-6
    tp, fp, fn = tp / volumes, fp / volumes, fn / volumes
    sum_axis = 0 if batch_dice else 1
    tp, fp, fn = tp.sum(sum_axis), fp.sum(sum_axis), fn.sum(sum_axis)
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth)
    gdl = -dc.mean()
    return gdl, {"GDL": gdl}


def nnu_loss(logits: torch.Tensor, targets: torch.Tensor,
             class_weights: torch.Tensor | None = None,
             w_dice: float = 1.0, w_ce: float = 1.0):
    """nnU-Net loss: w_ce * CE + w_dice * GDL."""
    ce, _ = cross_entropy(logits, targets, class_weights)
    gdl, _ = generalized_dice_loss(logits, targets)
    return w_ce * ce + w_dice * gdl, {"CE": ce, "GDL": gdl}


def batch_recall_loss(logits: torch.Tensor, targets: torch.Tensor):
    """CE weighted by the per-class false-negative rate of the current batch,
    computed per batch item, averaged, and taken without gradient."""
    num_classes = logits.shape[-1]
    pred_1h = _onehot(logits.argmax(dim=-1), num_classes)
    targ_1h = _onehot(targets, num_classes)
    axes = tuple(range(1, targets.ndim))
    tp = (pred_1h * targ_1h).sum(axes)                    # (B, C)
    fn = ((1 - pred_1h) * targ_1h).sum(axes)
    recall = (tp + 1e-4) / (tp + fn + 1e-4)
    weight = (1.0 - recall.mean(0)).detach()              # (C,)
    loss, _ = cross_entropy(logits, targets, weight)
    return loss, {"Recall-CE": loss}
