"""Neighbor gathering and the EdgeConv first-layer fission (counterpart of
ops/edge.py, forward only).

Layout is channel-last: features (..., N, C), neighbor indices (..., N, k),
gathered neighbors (..., N, k, C).
"""
from __future__ import annotations

import torch


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(..., N, C) features, (..., N, k) indices -> (..., N, k, C), issued
    as one flat row gather into the (B*N, C) matrix."""
    n, c = x.shape[-2:]
    k = idx.shape[-1]
    lead = x.shape[:-2]
    xf = x.reshape(-1, n, c)
    idxf = idx.reshape(-1, n, k).to(torch.int64)
    offs = (torch.arange(xf.shape[0], device=x.device) * n)[:, None, None]
    flat = (idxf + offs).reshape(-1)
    out = xf.reshape(-1, c).index_select(0, flat)
    return out.reshape(*lead, n, k, c)


def edge_mlp_pre_gather(x: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """``concat([x_j - x_i, x_i]) @ w`` with the matmul moved before the
    gather: ``(x @ w_d)[idx] + x @ (w_c - w_d)`` (ops/edge.py:142-169).

    :param w: (2C, F) edge kernel — rows [:C] act on x_j - x_i, rows [C:]
        on x_i
    :return: (..., N, k, F) pre-activation edge responses
    """
    c = x.shape[-1]
    if w.shape[0] != 2 * c:
        raise ValueError(f"kernel rows {w.shape[0]} != 2*C ({2 * c})")
    a = x @ w[:c]
    center = x @ (w[c:] - w[:c])
    return gather_neighbors(a, idx) + center[..., :, None, :]
