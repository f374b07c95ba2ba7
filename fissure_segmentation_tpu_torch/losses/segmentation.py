"""Point segmentation losses: CE, generalized Dice, nnU-Net combo, recall
(counterpart of losses/segmentation.py).

All take channel-last logits (B, ..., C) and integer targets (B, ...) and
return ``(scalar, components_dict)``.

`group`: a torch.distributed process group over which the batch is split
(data-parallel training, ops/collectives.py). Each rank passes its rows,
the ranks' shards of one size; the sums that the loss takes over the batch
are summed over the group (its means averaged), so every rank returns the
loss of the global batch, and the gradients the backward leaves on the
ranks add up to its single-device gradient. On a group of one rank the
operations are the single path's. None: the batch is whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.collectives import group_size, sum_replicated


def _onehot(targets: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(targets.to(torch.int64), num_classes).to(torch.float32)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  class_weights: torch.Tensor | None = None, group=None):
    """torch.nn.CrossEntropyLoss semantics: weighted mean normalized by
    sum(w_y); all-zero weights give 0 instead of 0/0."""
    logp = torch.log_softmax(logits, dim=-1)
    t = targets.to(torch.int64)
    nll = -torch.gather(logp, -1, t[..., None])[..., 0]
    if class_weights is None:
        ce = nll.mean()
        if group is not None:
            ce = sum_replicated(ce, group) / group_size(group)
    else:
        w = class_weights[t]
        num, den = (w * nll).sum(), w.sum()
        if group is not None:
            num, den = sum_replicated(torch.stack([num, den]), group)
        ce = num / torch.clamp(den, min=1e-12)
    return ce, {"CE": ce}


def generalized_dice_loss(logits: torch.Tensor, targets: torch.Tensor,
                          batch_dice: bool = True, smooth: float = 1.0,
                          apply_softmax: bool = True, group=None):
    """GDL: 1/V-weighted soft dice, returns -dice. Under a `group` the
    batch Dice takes tp, fp, fn and the volumes over the global batch."""
    num_classes = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1) if apply_softmax else logits
    y = _onehot(targets, num_classes)
    axes = tuple(range(probs.ndim - 1)) if batch_dice \
        else tuple(range(1, probs.ndim - 1))
    tp = (probs * y).sum(axes)
    fp = (probs * (1 - y)).sum(axes)
    fn = ((1 - probs) * y).sum(axes)
    volumes = y.sum(axes)
    if group is not None:
        if not batch_dice:
            raise NotImplementedError("generalized_dice_loss: a group "
                                      "needs batch_dice")
        tp, fp, fn, volumes = sum_replicated(
            torch.stack([tp, fp, fn, volumes]), group)
    volumes = volumes + 1e-6
    tp, fp, fn = tp / volumes, fp / volumes, fn / volumes
    sum_axis = 0 if batch_dice else 1
    tp, fp, fn = tp.sum(sum_axis), fp.sum(sum_axis), fn.sum(sum_axis)
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth)
    gdl = -dc.mean()
    return gdl, {"GDL": gdl}


def nnu_loss(logits: torch.Tensor, targets: torch.Tensor,
             class_weights: torch.Tensor | None = None,
             w_dice: float = 1.0, w_ce: float = 1.0, group=None):
    """nnU-Net loss: w_ce * CE + w_dice * GDL."""
    ce, _ = cross_entropy(logits, targets, class_weights, group=group)
    gdl, _ = generalized_dice_loss(logits, targets, group=group)
    return w_ce * ce + w_dice * gdl, {"CE": ce, "GDL": gdl}


def batch_recall_loss(logits: torch.Tensor, targets: torch.Tensor,
                      group=None):
    """CE weighted by the per-class false-negative rate of the current batch,
    computed per batch item, averaged, and taken without gradient (under a
    `group`, averaged over the global batch)."""
    num_classes = logits.shape[-1]
    pred_1h = _onehot(logits.argmax(dim=-1), num_classes)
    targ_1h = _onehot(targets, num_classes)
    axes = tuple(range(1, targets.ndim))
    tp = (pred_1h * targ_1h).sum(axes)                    # (B, C)
    fn = ((1 - pred_1h) * targ_1h).sum(axes)
    recall = (tp + 1e-4) / (tp + fn + 1e-4)
    mean_recall = recall.mean(0)
    if group is not None:
        mean_recall = sum_replicated(mean_recall, group) / group_size(group)
    weight = (1.0 - mean_recall).detach()                 # (C,)
    loss, _ = cross_entropy(logits, targets, weight, group=group)
    return loss, {"Recall-CE": loss}
