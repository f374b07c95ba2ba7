"""Separable 1-D filtering, Gaussian smoothing and max-pool NMS on volumes
(counterpart of utils/filters.py).

Volumes are ``(..., D, H, W)``; ``dim`` indexes the last three axes. The
1-D filter is the JAX package's unrolled shifted-slice sum in tap order
(utils/filters.py:97-107), not a conv3d: a convolution sums in another order,
and the Förstner detector tests `maxfeat == dist` for equality, so the two
packages must round identically.
"""
from __future__ import annotations

import numpy as np
import torch


def smoothing_kernel_1d(sigma: float) -> np.ndarray:
    """The kernel used by `smooth` (utils/filters.py:smoothing_kernel_1d)."""
    n = int(np.ceil(sigma * 3.0 / 2.0)) * 2 + 1
    x = np.linspace(-(n // 2), n // 2, n)
    w = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (w / w.sum()).astype(np.float32)


def _pad_axis(img: torch.Tensor, axis: int, lo: int, hi: int,
              mode: str) -> torch.Tensor:
    length = img.shape[axis]
    if mode == "replicate":
        first = img.narrow(axis, 0, 1)
        last = img.narrow(axis, length - 1, 1)
    elif mode == "constant":
        first = last = torch.zeros_like(img.narrow(axis, 0, 1))
    else:
        raise ValueError(f"unsupported padding mode {mode}")
    reps = [1] * img.ndim
    parts = []
    if lo:
        reps[axis] = lo
        parts.append(first.repeat(*reps))
    parts.append(img)
    if hi:
        reps[axis] = hi
        parts.append(last.repeat(*reps))
    return torch.cat(parts, dim=axis)


def filter_1d(img: torch.Tensor, weight, dim: int,
              padding_mode: str = "replicate") -> torch.Tensor:
    """1-D correlation along spatial axis `dim` of a (..., D, H, W) volume,
    symmetric N//2 padding: out = sum_t w[t] * x[..., t:t+L] in tap order."""
    weight = torch.as_tensor(np.asarray(weight, np.float32), device=img.device)
    n = weight.shape[0]
    axis = img.ndim - 3 + dim
    length = img.shape[axis]
    padded = _pad_axis(img, axis, n // 2, n // 2, padding_mode)
    out = None
    for t in range(n):
        term = padded.narrow(axis, t, length) * weight[t]
        out = term if out is None else out + term
    return out


def smooth(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian smoothing (utils/filters.py:smooth)."""
    w = smoothing_kernel_1d(sigma)
    for dim in range(3):
        img = filter_1d(img, w, dim)
    return img


def max_pool_same(data: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Stride-1 max-pool with replicate padding over the last 3 axes
    (utils/filters.py:max_pool_same): separable, asymmetric for even
    kernels — (k-1-k//2) low, k//2 high on each axis."""
    pad1 = kernel_size // 2
    pad2 = kernel_size - pad1 - 1
    for axis in (data.ndim - 3, data.ndim - 2, data.ndim - 1):
        length = data.shape[axis]
        padded = _pad_axis(data, axis, pad2, pad1, "replicate")
        out = padded.narrow(axis, 0, length)
        for t in range(1, kernel_size):
            out = torch.maximum(out, padded.narrow(axis, t, length))
        data = out
    return data
