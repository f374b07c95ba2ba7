"""Loss registry (counterpart of losses/registry.py): `get_loss_fn` returns
``loss(prediction, target) -> (scalar, components_dict)``.

Ported: nnunet, ce, recall. The others raise NotImplementedError naming the
module still to port.
"""
from __future__ import annotations

import functools
from typing import Sequence

from .segmentation import batch_recall_loss, cross_entropy, nnu_loss

LOSSES = ("nnunet", "ce", "recall", "ssm", "chamfer", "mesh", "dpsr")
_UNPORTED = {"ssm": "losses/dgssm.py", "chamfer": "losses/chamfer.py",
             "mesh": "losses/mesh.py", "dpsr": "losses/dpsr.py"}


def get_loss_fn(loss: str, class_weights=None,
                term_weights: Sequence[float] | None = None):
    if loss == "nnunet":
        return functools.partial(nnu_loss, class_weights=class_weights)
    if loss == "ce":
        return functools.partial(cross_entropy, class_weights=class_weights)
    if loss == "recall":
        return batch_recall_loss
    if loss in _UNPORTED:
        raise NotImplementedError(f'loss "{loss}" is not ported yet '
                                  f"({_UNPORTED[loss]})")
    raise ValueError(f'No loss function named "{loss}". Choose one of '
                     f"{list(LOSSES)}.")
