"""Brute-force k-nearest-neighbor graphs (counterpart of ops/knn.py).

Dispatch follows the JAX package (ops/knn.py:96-99): coordinate-like clouds
(C <= 8, kk <= 128) go to K1 (kernels/knn.py), which launches the CUDA
kernel for a CUDA tensor and runs its plain PyTorch version for a CPU
tensor; wider graphs keep a plain torch path, where the JAX package uses
XLA. Semantics: squared euclidean distances, `self_loop=True` keeps the
point itself as its first neighbor, `self_loop=False` computes k+1 and drops
the first column.

Not ported yet: `query_chunk` and the approximate `recall_target` path.
"""
from __future__ import annotations

import torch

from ..kernels.knn import MAX_C, MAX_KK, knn_cuda


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Squared euclidean distance matrix |x|^2 - 2 x.y + |y|^2.

    :param x: (..., N, C); :param y: (..., M, C), defaults to x (the
        diagonal is then zeroed, like ops/knn.py:pairwise_sqdist)
    :return: (..., N, M)
    """
    self_dist = y is None
    if y is None:
        y = x
    xx = (x * x).sum(-1, keepdim=True)
    yy = (y * y).sum(-1, keepdim=True)
    d = xx - 2.0 * torch.matmul(x, y.transpose(-1, -2)) + yy.transpose(-1, -2)
    if self_dist:
        d.diagonal(dim1=-2, dim2=-1).zero_()
    return d


def knn(x: torch.Tensor, k: int, self_loop: bool = False,
        return_dist: bool = False, recall_target: float | None = None):
    """k nearest neighbors of every point within its own cloud.

    :param x: (..., N, C) float32 point clouds, channel-last
    :return: (..., N, k) int32 indices [, (..., N, k) squared distances]
    """
    if recall_target is not None:
        raise NotImplementedError("approximate kNN (recall_target) is not "
                                  "ported yet")
    n, c = x.shape[-2:]
    kk = k if self_loop else k + 1
    lead = x.shape[:-2]
    x3 = x.reshape(-1, n, c)
    if c <= MAX_C and kk <= MAX_KK and kk <= n:
        idx, dist = knn_cuda(x3.contiguous(), k, self_loop)
    else:
        dist, idx = torch.sort(pairwise_sqdist(x3), dim=-1, stable=True)
        idx, dist = idx[..., :kk].to(torch.int32), dist[..., :kk]
        if not self_loop:
            idx, dist = idx[..., 1:], dist[..., 1:]
    idx = idx.reshape(*lead, n, k)
    if return_dist:
        return idx, dist.reshape(*lead, n, k)
    return idx
