"""The port's device default: a CUDA card unless the caller asks for
another device; without a card and without a device, raise."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device, what: str) -> torch.device:
    """`device` as a torch.device; None means the first CUDA card, and
    raises (naming `what`) when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA card found; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def as_device_tensor(x, device, what: str) -> torch.Tensor:
    """`x` as a tensor: a tensor stays where it lies unless `device` is
    given; numpy goes to `device` (`resolve_device`'s default)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=resolve_device(device, what))
