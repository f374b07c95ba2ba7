"""Separable 1-D filtering, Gaussian smoothing, Gaussian-derivative kernels
and max-pool NMS on volumes (counterpart of utils/filters.py).

Volumes are ``(..., D, H, W)``; ``dim`` indexes the last three axes. The
1-D filter is the JAX package's unrolled shifted-slice sum in tap order
(utils/filters.py:97-107), not a conv3d: a convolution sums in another order,
and the Förstner detector tests `maxfeat == dist` for equality, so the two
packages must round identically.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import host_to


def _np_gaussian_kernel1d(sigma: float, order: int, radius: int) -> np.ndarray:
    """A Gaussian (or its `order`-th derivative) on [-radius, radius],
    normalised like scipy's `_gaussian_kernel1d`: the order-0 kernel sums
    to 1, derivatives are polynomial multiples of it, and the kernel is not
    reversed (applied by correlation, order 1 gives the negative gradient).
    A copy of utils/filters.py:_np_gaussian_kernel1d."""
    if order < 0:
        raise ValueError("order must be non-negative")
    sigma2 = sigma * sigma
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi_x = np.exp(-0.5 / sigma2 * x ** 2)
    phi_x = phi_x / phi_x.sum()
    if order == 0:
        return phi_x
    # q_{n+1}(x) = q_n'(x) - x / sigma^2 q_n(x), with f = q * phi
    exponent_range = np.arange(order + 1)
    q = np.zeros(order + 1)
    q[0] = 1
    D = np.diag(exponent_range[1:], 1)          # D @ q(x) = q'(x)
    P = np.diag(np.ones(order) / -sigma2, -1)   # P @ q(x) = q(x) * x / -sigma2
    Q_deriv = D + P
    for _ in range(order):
        q = Q_deriv.dot(q)
    q = (x[:, None] ** exponent_range).dot(q)
    return q * phi_x


def gaussian_kernel_1d(sigma: float, order: int = 0,
                       truncate: float = 4.0) -> np.ndarray:
    """Gaussian (derivative) kernel, float32 (utils/filters.py:
    gaussian_kernel_1d)."""
    sigma = float(sigma)
    radius = int(truncate * sigma + 0.5)
    return _np_gaussian_kernel1d(sigma, order, radius).astype(np.float32)


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
    weight = host_to(np.asarray(weight, np.float32), img.device)
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


def gaussian_differentiation(img: torch.Tensor, sigma: float, order: int,
                             dim: int, padding_mode: str = "replicate",
                             truncate: float = 4.0) -> torch.Tensor:
    """Gaussian-derivative filtering along one axis
    (utils/filters.py:gaussian_differentiation)."""
    return filter_1d(img, gaussian_kernel_1d(sigma, order, truncate), dim,
                     padding_mode)


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
