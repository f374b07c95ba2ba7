"""The port's device default: a CUDA card unless the caller asks for
another device; without a card and without a device, raise."""
from __future__ import annotations

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
