"""Exact top-k over a large flat score array (counterpart of ops/topk.py).

The JAX package tiles the scores into rows and certifies a two-stage
selection so that every finite slot equals `lax.top_k`'s: descending
values, lowest index first among equal values. Here one stable descending
sort gives that order directly, on either device, without a host sync.
"""
from __future__ import annotations

import torch


def masked_top_k(scores: torch.Tensor, k: int):
    """The k largest entries of `scores` (masked-out entries are -inf).

    :param scores: float tensor, flattened
    :return: (values (k,), flat indices (k,) int64), descending, ties to the
        lowest index — `lax.top_k` order
    """
    flat = scores.reshape(-1)
    if k > flat.shape[0]:
        raise ValueError(f"k={k} exceeds {flat.shape[0]} scores")
    vals, idx = torch.sort(flat, descending=True, stable=True)
    return vals[:k], idx[:k]
