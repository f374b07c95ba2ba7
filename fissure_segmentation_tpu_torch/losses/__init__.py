from .chamfer import chamfer_distance, chamfer_loss  # noqa: F401
from .registry import get_loss_fn  # noqa: F401
from .segmentation import (batch_recall_loss, cross_entropy,  # noqa: F401
                           generalized_dice_loss, nnu_loss)
