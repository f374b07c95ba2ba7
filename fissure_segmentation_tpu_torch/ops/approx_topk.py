"""Approximate top-k along the last axis (counterpart of `lax.approx_max_k`
and `lax.approx_min_k`, which the JAX package calls in keypoints/foerstner.py,
keypoints/extraction.py and ops/knn.py).

The algorithm is the one XLA runs on the TPU (its ApproxTopK, a
PartialReduce): each row of n scores is split into L bins, element i into
bin i mod L, every bin keeps its extremum (the bin pass, kernels/
approx_topk.py: the hand-written kernel on the card), and the exact top-k
of the L winners is the result. L and the reduction 2^r come from XLA's
formula (`reduction_output_size`, a copy of XLA's
ApproxTopKReductionOutputSize in approx_topk_shape.cc): the smallest number
of bins that keeps the expected share of the true top-k found at
`recall_target`, rounded to the TPU's tiling (1024 for a rank-1 operand,
128 otherwise). A
true top-k element is lost only when a larger one shares its bin. At r = 0
every bin holds one element and the result is `masked_top_k`'s exactly.

The aggregation is exact and keyed on (value, original index): values in
descending order (ascending for the minimum), ties to the lower original
index, as `lax.top_k` orders them. The winners come in bin order, not
index order, so they are first put in index order and then sorted by value
with a stable sort. Masked entries (-inf for the maximum, +inf for the
minimum) come out with non-finite values; callers read validity from
`isfinite`. Off the TPU, JAX computes approx_max_k / approx_min_k exactly,
so the JAX package's CPU path is the r = 0 result here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.approx_topk import bin_extrema, bin_extrema_plain

TPU_LANE_TILING = 128     # the reduced axis of a rank >= 2 operand
TPU_CHUNK_TILING = 1024   # a rank-1 operand's


def _log2_floor(v: int) -> int:
    return v.bit_length() - 1 if v > 0 else 0


def _log2_ceil(v: int) -> int:
    return (v - 1).bit_length() if v > 0 else 0


def reduction_output_size(n: int, rank: int, k: int,
                          recall_target: float) -> tuple[int, int]:
    """(L, r): the bins and the log2 of the elements a bin holds, XLA's
    ApproxTopKReductionOutputSize(n, rank, k, recall_target,
    aggregate_to_topk=False) with no input-size override."""
    tiling = TPU_CHUNK_TILING if rank == 1 else TPU_LANE_TILING
    if n <= tiling:
        return n, 0
    if k == 1:
        r = _log2_ceil(-(-n // tiling))
        return -(-(-(-n // tiling)) // (1 << r)) * tiling, r
    recall = float(np.float32(recall_target))   # a float attribute in XLA
    if recall == 1.0:
        return n, 0
    if not 0.0 < recall <= 1.0:
        raise ValueError("recall_target should range in (0, 1]")
    m = min(max(int((1.0 - k) / math.log(recall)), tiling), n)
    r = _log2_floor(n // m)
    if r == 0:
        return n, 0
    r = min(r, _log2_ceil(n // tiling))
    return -(-(-(-n // tiling)) // (1 << r)) * tiling, r


def _aggregate(vals: torch.Tensor, idx: torch.Tensor, k: int,
               largest: bool):
    """The exact top-k of the winners keyed on (value, index)."""
    if k > vals.shape[-1]:
        raise ValueError(f"approx_top_k: k={k} exceeds the {vals.shape[-1]} "
                         "bins")
    order = torch.argsort(idx, dim=-1)
    vals, idx = vals.gather(-1, order), idx.gather(-1, order)
    top, pos = torch.sort(vals, dim=-1, descending=largest, stable=True)
    return top[..., :k], idx.gather(-1, pos[..., :k]).to(torch.int64)


def _select(x: torch.Tensor, k: int, recall_target: float, largest: bool,
            bins):
    n = x.shape[-1]
    if k > n:
        raise ValueError(f"approx_top_k: k={k} exceeds {n} scores")
    n_bins, r = reduction_output_size(n, x.ndim, k, recall_target)
    lead = x.shape[:-1]
    vals, idx = bins(x.reshape(-1, n).contiguous(), n_bins, 1 << r, largest)
    top, at = _aggregate(vals, idx, k, largest)
    return top.reshape(*lead, k), at.reshape(*lead, k)


def approx_top_k(x: torch.Tensor, k: int, recall_target: float = 0.95,
                 largest: bool = True):
    """The approximate k largest (or smallest) entries of each row.

    :param x: (..., n) float32 or bfloat16 scores without NaN; its rank
        sets the tiling, as the operand's does in XLA
    :param recall_target: `lax.approx_max_k`'s (0.95 by default)
    :return: (values (..., k) in x's dtype, indices (..., k) int64 along
        the last axis), ordered as `lax.top_k` orders
    """
    return _select(x, k, recall_target, largest, bin_extrema)


def approx_top_k_plain(x: torch.Tensor, k: int, recall_target: float = 0.95,
                       largest: bool = True):
    """`approx_top_k` with the bin pass's plain version on any device (the
    kernel's oracle on the card)."""
    return _select(x, k, recall_target, largest, bin_extrema_plain)
