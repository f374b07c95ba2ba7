"""Loss registry (counterpart of losses/registry.py): `get_loss_fn` returns
``loss(prediction, target) -> (scalar, components_dict)``.

Every loss of the JAX registry is ported: nnunet, ce, recall, chamfer,
mesh (4 `term_weights`: chamfer, edge length, normal consistency,
Laplacian), ssm (3: point, coefficients, affine) and dpsr (3: segmentation,
Chamfer, the epoch fraction that switches the Chamfer term on).
"""
from __future__ import annotations

import enum
import functools
from typing import Sequence

from .chamfer import chamfer_loss
from .segmentation import batch_recall_loss, cross_entropy, nnu_loss

class Losses(enum.Enum):
    NNUNET = "nnunet"
    CE = "ce"
    RECALL = "recall"
    SSM = "ssm"
    CHAMFER = "chamfer"
    MESH = "mesh"
    DPSR = "dpsr"

    @classmethod
    def list(cls):
        return [c.value for c in cls]


LOSSES = tuple(Losses.list())


def get_loss_fn(loss, class_weights=None,
                term_weights: Sequence[float] | None = None):
    """`loss`: a name of `LOSSES` or a `Losses` member."""
    if isinstance(loss, Losses):
        loss = loss.value
    if loss == "nnunet":
        return functools.partial(nnu_loss, class_weights=class_weights)
    if loss == "ce":
        return functools.partial(cross_entropy, class_weights=class_weights)
    if loss == "recall":
        return batch_recall_loss
    if loss == "chamfer":
        return chamfer_loss
    if loss == "mesh":
        from .mesh import make_regularized_mesh_loss
        if term_weights is not None:
            assert len(term_weights) == 4
            return make_regularized_mesh_loss(
                w_chamfer=term_weights[0], w_edge_length=term_weights[1],
                w_normal_consistency=term_weights[2],
                w_laplacian=term_weights[3])
        return make_regularized_mesh_loss()
    if loss == "ssm":
        from .dgssm import make_dgssm_loss
        if term_weights is not None:
            assert len(term_weights) == 3
            return make_dgssm_loss(w_point=term_weights[0],
                                   w_coefficients=term_weights[1],
                                   w_affine=term_weights[2])
        return make_dgssm_loss()
    if loss == "dpsr":
        from .dpsr import make_dpsr_loss
        if term_weights is not None:
            assert len(term_weights) == 3
            return make_dpsr_loss(class_weights, w_seg=term_weights[0],
                                  w_mesh=term_weights[1],
                                  epoch_start_mesh_loss=term_weights[2])
        return make_dpsr_loss(class_weights)
    raise ValueError(f'No loss function named "{loss}". Choose one of '
                     f"{list(LOSSES)}.")
