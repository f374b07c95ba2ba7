"""Neighbor gathering and the EdgeConv first-layer fission (counterpart of
ops/edge.py).

Layout is channel-last: features (..., N, C), neighbor indices (..., N, k),
gathered neighbors (..., N, k, C). The gather is an autograd Function
(`_GatherRows`, the counterpart of `_gather_rows`): its backward is the
scatter-add K2 (kernels/scatter.py:scatter_rows), which launches the CUDA
kernel for CUDA tensors and runs its plain version for CPU tensors.

Out-of-range indices: the gather reads row `flat_rows(idx, N)` of the flat
(B*N, C) matrix — b*N + idx, plus B*N once if negative, clamped into
[0, B*N) — as the JAX package's flat gather normalises and clamps it
(kernels/gather_reduce.py, whose kernel reads the same rows). The backward
drops the targets K2 finds out of range, as JAX's scatter does. A caller
that gathers over one graph several times may pass the graph's transpose
(`kernels/scatter.py:transpose` of the (B, N * k) indices), which K2 then
walks instead of building its own.
"""
from __future__ import annotations

import torch

from ..kernels.gather_reduce import flat_rows
from ..kernels.scatter import scatter_rows
from ..utils.profiling import span


def _flat_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, N, k) -> (B, N, k, C) as one flat row gather into the
    (B*N, C) matrix (rows normalised and clamped like JAX's)."""
    b, n, c = x.shape
    k = idx.shape[-1]
    flat = flat_rows(idx, n).reshape(-1)
    return x.reshape(b * n, c).index_select(0, flat).reshape(b, n, k, c)


class _GatherRows(torch.autograd.Function):
    """Flat neighbour gather; backward = K2 with float32 accumulation, cast
    back to the payload dtype (ops/edge.py:64-104). idx gets no gradient."""

    @staticmethod
    def forward(ctx, x, idx, transposed):
        ctx.save_for_backward(idx)
        ctx.transposed = transposed
        return _flat_gather(x, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        b, n, k, c = ct.shape
        with span("edgeconv.kernels"):
            dx = scatter_rows(
                idx.reshape(b, n * k).to(torch.int32).contiguous(),
                ct.reshape(b, n * k, c).contiguous(), n, ctx.transposed)
        return dx.to(ct.dtype), None, None


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor,
                     transposed=None) -> torch.Tensor:
    """(..., N, C) features, (..., N, k) indices -> (..., N, k, C).
    `transposed`: the transpose of idx as (B, N * k), for the backward."""
    n, c = x.shape[-2:]
    k = idx.shape[-1]
    lead = x.shape[:-2]
    out = _GatherRows.apply(x.reshape(-1, n, c), idx.reshape(-1, n, k),
                            transposed)
    return out.reshape(*lead, n, k, c)


def edge_features(x: torch.Tensor, idx: torch.Tensor,
                  transposed=None) -> torch.Tensor:
    """DGCNN edge features ``concat([x_j - x_i, x_i])`` (the JAX package's
    `edge_features`).

    :param x: (..., N, C) per-point features
    :param idx: (..., N, k) neighbor indices
    :return: (..., N, k, 2C) edge features
    """
    neigh = gather_neighbors(x, idx, transposed)
    center = x[..., :, None, :].expand_as(neigh)
    return torch.cat([neigh - center, center], dim=-1)


def edge_mlp_pre_gather(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                        transposed=None) -> torch.Tensor:
    """``concat([x_j - x_i, x_i]) @ w`` with the matmul moved before the
    gather: ``(x @ w_d)[idx] + x @ (w_c - w_d)`` (ops/edge.py:142-169).

    :param w: (2C, F) edge kernel — rows [:C] act on x_j - x_i, rows [C:]
        on x_i
    :param transposed: the graph's transpose, for the gather's backward
    :return: (..., N, k, F) pre-activation edge responses
    """
    c = x.shape[-1]
    if w.shape[0] != 2 * c:
        raise ValueError(f"kernel rows {w.shape[0]} != 2*C ({2 * c})")
    a = x @ w[:c]
    center = x @ (w[c:] - w[:c])
    return gather_neighbors(a, idx, transposed) + center[..., :, None, :]
