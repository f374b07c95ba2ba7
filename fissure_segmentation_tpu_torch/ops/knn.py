"""Brute-force k-nearest-neighbor graphs (counterpart of ops/knn.py).

Dispatch follows the JAX package (ops/knn.py:96-99): coordinate-like clouds
(C <= 8, kk <= 128) go to K1 (kernels/knn.py), which launches the CUDA
kernel for a CUDA tensor and runs its plain PyTorch version for a CPU
tensor. Wider clouds (DGCNN's feature-space graph, C = 64) take the JAX
package's XLA formula, where it also leaves Pallas: |x|^2 - 2 x.y + |y|^2
with the diagonal zeroed, in the input's dtype (bf16 features give a bf16
graph, as in JAX), one `torch.matmul` and a stable ascending sort (ties to
the lower index, what `lax.top_k(-d, kk)` selects). In bf16 the terms
round as the jitted JAX graph rounds them (its optimized HLO on the CPU):
each squared norm is the float32 sum of the exact float32 squares of the
bf16 values, rounded once to bf16 (XLA fuses the convert into the
product, so the squares are never rounded to bf16); the product and the
combination round to bf16 operation by operation, and the sort compares
bf16 keys. That path builds the
graph on a detached input: the indices carry no gradient, and the (B, N, N)
distances and the sort's indices are freed at once instead of living until
the backward. Semantics: squared euclidean distances, `self_loop=True`
keeps the point itself as its first neighbor, `self_loop=False` computes
k+1 and drops the first column.

The approximate graph (`recall_target`, ops/knn.py:79-95 of the JAX
package) skips K1 for every width: the distance matrix is materialized by
the same formula (bf16 norms rounded as above), the diagonal is pinned to
-1 under `self_loop` (self is then always found, in slot 0) or to +inf
without it, and `ops/approx_topk.py` selects the k smallest with the bin
kernel on the card; negative distances (self's -1) are clamped to 0.

Not ported yet: `query_chunk`.
"""
from __future__ import annotations

import torch

from ..kernels.knn import MAX_C, MAX_KK, knn_cuda
from .approx_topk import approx_top_k


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 over the last axis, (..., N, 1): the float32 sum of the exact
    float32 squares, rounded once to x's dtype (the jitted JAX graph's
    rounding in bf16; for float32 the same operations as x * x summed)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return (xf * xf).sum(-1, keepdim=True).to(x.dtype)


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
    xx, yy = _sqnorm(x), _sqnorm(y)
    d = xx - 2.0 * torch.matmul(x, y.transpose(-1, -2)) + yy.transpose(-1, -2)
    if self_dist:
        d.diagonal(dim1=-2, dim2=-1).zero_()
    return d


def feature_knn(x: torch.Tensor, kk: int):
    """The kk nearest points of each point by the JAX formula, ascending,
    ties to the lower index, in x's dtype, without autograd.

    :param x: (B, N, C)
    :return: (idx (B, N, kk) int32, dist (B, N, kk) in x's dtype)
    """
    if kk > x.shape[-2]:
        raise ValueError(f"knn: kk={kk} exceeds N={x.shape[-2]}")
    # the profiler's "feature_graph" range (train/profile_step.py)
    with torch.no_grad(), torch.profiler.record_function("feature_graph"):
        dist, idx = torch.sort(pairwise_sqdist(x.detach()), dim=-1,
                               stable=True)
        return idx[..., :kk].to(torch.int32), dist[..., :kk]


def approx_knn(x: torch.Tensor, k: int, self_loop: bool,
               recall_target: float):
    """The approximate graph of `knn(recall_target=...)`, without autograd.

    :param x: (B, N, C) float32 or bfloat16
    :return: (idx (B, N, k) int32, dist (B, N, k) in x's dtype)
    """
    with torch.no_grad(), torch.profiler.record_function("approx_graph"):
        x = x.detach()
        d = pairwise_sqdist(x, x)
        d.diagonal(dim1=-2, dim2=-1).fill_(-1.0 if self_loop else torch.inf)
        dist, idx = approx_top_k(d, k, recall_target, largest=False)
        if self_loop:
            dist = dist.clamp(min=0.0)
        return idx.to(torch.int32), dist


def knn(x: torch.Tensor, k: int, self_loop: bool = False,
        return_dist: bool = False, recall_target: float | None = None):
    """k nearest neighbors of every point within its own cloud.

    :param x: (..., N, C) point clouds, channel-last; float32 for the K1
        route (C <= 8), float32 or bfloat16 for the feature route and the
        approximate one
    :param recall_target: build the approximate graph at this recall
        (`approx_knn`) instead of the exact one
    :return: (..., N, k) int32 indices [, (..., N, k) squared distances]
    """
    n, c = x.shape[-2:]
    kk = k if self_loop else k + 1
    lead = x.shape[:-2]
    x3 = x.reshape(-1, n, c)
    if recall_target is not None:
        idx, dist = approx_knn(x3, k, self_loop, recall_target)
    elif c <= MAX_C and kk <= MAX_KK:      # K1 raises for kk > N
        idx, dist = knn_cuda(x3.contiguous(), k, self_loop)
    else:
        idx, dist = feature_knn(x3, kk)
        if not self_loop:
            idx, dist = idx[..., 1:], dist[..., 1:]
    idx = idx.reshape(*lead, n, k)
    if return_dist:
        return idx, dist.reshape(*lead, n, k)
    return idx
