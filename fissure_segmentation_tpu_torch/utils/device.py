"""The port's device default: a CUDA card unless the caller asks for
another device; without a card and without a device, raise. `host_to`
moves host data to a device."""
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


def host_to(x, device, dtype=None) -> torch.Tensor:
    """Host data (an array, a list or a CPU tensor) as a tensor on `device`
    (`non_blocking`). From pageable memory CUDA stages the bytes through
    its own pinned buffers before the call returns, so `x` may change or
    go at once; a copy larger than those buffers holds the host until its
    chunks have gone through the stream. From pinned memory the call
    returns at once."""
    return torch.as_tensor(x, dtype=dtype).to(device, non_blocking=True)
