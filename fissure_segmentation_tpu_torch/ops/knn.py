"""Brute-force k-nearest-neighbor graphs (counterpart of ops/knn.py).

Dispatch follows the JAX package (ops/knn.py:96-99): coordinate-like clouds
(C <= 8, kk <= 128) go to K1 (kernels/knn.py), which launches the CUDA
kernel for a CUDA tensor and runs its plain PyTorch version for a CPU
tensor. Wider clouds (DGCNN's feature-space graph, C = 64) take the JAX
package's XLA formula, where it also leaves Pallas: |x|^2 - 2 x.y + |y|^2
with the diagonal zeroed, in the input's dtype (bf16 features give a bf16
graph, as in JAX), one `torch.matmul` and the kk smallest in ascending
order, ties to the lower index (what `lax.top_k(-d, kk)` selects): on the
card the approximate top-k's fused row selection at one element a bin,
which is exact (kernels/approx_topk.py:select_rows, kk <= 128), on the
CPU a stable sort. In bf16 the terms
round as the jitted JAX graph rounds them (its optimized HLO on the CPU):
each squared norm is the float32 sum of the exact float32 squares of the
bf16 values, rounded once to bf16 (XLA fuses the convert into the
product, so the squares are never rounded to bf16); the product and the
combination round to bf16 operation by operation, and the selection
compares bf16 keys. That path builds the
graph on a detached input: the indices carry no gradient, and the (B, N, N)
distances and the selection's indices are freed at once instead of living until
the backward. Semantics: squared euclidean distances, `self_loop=True`
keeps the point itself as its first neighbor, `self_loop=False` computes
k+1 and drops the first column.

The approximate graph (`recall_target`, ops/knn.py:79-95 of the JAX
package) skips K1 for every width: the distance matrix is materialized by
the same formula (bf16 norms rounded as above), the diagonal is pinned to
-1 under `self_loop` (self is then always found, in slot 0) or to +inf
without it, and `ops/approx_topk.py` selects the k smallest (on the card
with the fused row selection, k <= 128); negative distances (self's -1)
are clamped to 0.

`query_chunk` (ops/knn.py:50, 114-125 of the JAX package) bounds the
distance matrix to (..., query_chunk, N); it must divide N, as in the JAX
package. The feature route then builds each block of rows by the same
formula (the block's squared norms, its rows of the product, the
diagonal zeroed at the block's offset) and selects in each row as the
whole matrix does, so it picks the same neighbours, ties included, on
the card and on the CPU. K1 keeps no distance matrix on the card and
ignores the chunk there; its plain version on the CPU sorts one block of
rows at a time (kernels/knn.py:knn_plain), with K1's order. The
approximate graph materializes the whole matrix, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..kernels.approx_topk import DTYPES, MAX_K, select_rows
from ..kernels.knn import MAX_C, MAX_KK, knn_cuda
from ..utils.profiling import span
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


def feature_route(d: torch.Tensor, kk: int) -> str:
    """How `feature_knn` selects the kk smallest of the distances d:
    "fused" (the fused row selection at one element a bin) for a CUDA
    tensor of float32 or bfloat16 and kk <= MAX_K, else "sort"."""
    return ("fused" if d.is_cuda and d.dtype in DTYPES and kk <= MAX_K
            else "sort")


def _select(d: torch.Tensor, kk: int):
    """The kk smallest of each row of d, ascending, ties to the lower
    index: (idx int32, dist)."""
    n = d.shape[-1]
    if feature_route(d, kk) == "fused":
        dist, idx = select_rows(d.reshape(-1, n), n, 1, kk,
                                largest=False, index_dtype=torch.int32)
        return (idx.reshape(*d.shape[:-1], kk),
                dist.reshape(*d.shape[:-1], kk))
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return idx[..., :kk].to(torch.int32), dist[..., :kk]


def feature_knn(x: torch.Tensor, kk: int, query_chunk: int | None = None):
    """The kk nearest points of each point by the JAX formula, ascending,
    ties to the lower index, in x's dtype, without autograd: on the card
    (float32 or bfloat16, kk <= 128) the fused row selection with one
    element a bin, elsewhere a stable sort; the two agree bit for bit.
    `query_chunk`: the distances are built and selected in blocks of that
    many rows (see the module's docstring).

    :param x: (B, N, C)
    :return: (idx (B, N, kk) int32, dist (B, N, kk) in x's dtype)
    """
    n = x.shape[-2]
    if kk > n:
        raise ValueError(f"knn: kk={kk} exceeds N={n}")
    # the span "feature_graph" (a range in train/profile_step.py's profile)
    with torch.no_grad(), span("feature_graph"):
        x = x.detach()
        if query_chunk is None or query_chunk >= n:
            return _select(pairwise_sqdist(x), kk)
        yy = _sqnorm(x).transpose(-1, -2)
        parts = []
        for start in range(0, n, query_chunk):
            q = x[..., start:start + query_chunk, :]
            d = _sqnorm(q) - 2.0 * torch.matmul(q, x.transpose(-1, -2)) + yy
            d.diagonal(offset=start, dim1=-2, dim2=-1).zero_()
            parts.append(_select(d, kk))
        return (torch.cat([p[0] for p in parts], -2),
                torch.cat([p[1] for p in parts], -2))


def approx_knn(x: torch.Tensor, k: int, self_loop: bool,
               recall_target: float):
    """The approximate graph of `knn(recall_target=...)`, without autograd.

    :param x: (B, N, C) float32 or bfloat16
    :return: (idx (B, N, k) int32, dist (B, N, k) in x's dtype)
    """
    with torch.no_grad(), span("approx_graph"):
        x = x.detach()
        d = pairwise_sqdist(x, x)
        d.diagonal(dim1=-2, dim2=-1).fill_(-1.0 if self_loop else torch.inf)
        dist, idx = approx_top_k(d, k, recall_target, largest=False)
        if self_loop:
            dist = dist.clamp(min=0.0)
        return idx.to(torch.int32), dist


def knn(x: torch.Tensor, k: int, self_loop: bool = False,
        return_dist: bool = False, recall_target: float | None = None,
        query_chunk: int | None = None):
    """k nearest neighbors of every point within its own cloud.

    :param x: (..., N, C) point clouds, channel-last; float32 for the K1
        route (C <= 8), float32 or bfloat16 for the feature route and the
        approximate one
    :param recall_target: build the approximate graph at this recall
        (`approx_knn`) instead of the exact one
    :param query_chunk: bound the distance matrix to (..., query_chunk, N);
        must divide N (see the module's docstring)
    :return: (..., N, k) int32 indices [, (..., N, k) squared distances]
    """
    n, c = x.shape[-2:]
    kk = k if self_loop else k + 1
    if query_chunk is not None and query_chunk < n and n % query_chunk:
        raise ValueError(f"query_chunk {query_chunk} must divide N={n}")
    lead = x.shape[:-2]
    x3 = x.reshape(-1, n, c)
    if recall_target is not None:
        idx, dist = approx_knn(x3, k, self_loop, recall_target)
    elif c <= MAX_C and kk <= MAX_KK:      # K1 raises for kk > N
        idx, dist = knn_cuda(x3.contiguous(), k, self_loop, query_chunk)
    else:
        # unchunked, the (x, kk) call that wrappers of feature_knn expect
        idx, dist = (feature_knn(x3, kk) if query_chunk is None
                     else feature_knn(x3, kk, query_chunk))
        if not self_loop:
            idx, dist = idx[..., 1:], dist[..., 1:]
    idx = idx.reshape(*lead, n, k)
    if return_dist:
        return idx, dist.reshape(*lead, n, k)
    return idx
