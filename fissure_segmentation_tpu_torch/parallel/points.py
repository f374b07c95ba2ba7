"""Point-axis sharding: the ring kNN graph and the ring neighbour gather
(counterpart of parallel/points.py).

The N points of one cloud are split over the ranks. Instead of gathering
the whole cloud on every rank, the candidate block travels round the ring
(`ppermute`, as in ring attention): at each of the `size` steps a rank
takes the (n_loc, n_loc) distance tile of its queries against the visiting
block (ops/knn.py:pairwise_sqdist, the cross-set form) and merges it into
its running kk best, so a rank holds O(n_loc * (kk + n_loc)) at a time.

The merge is the exact top-kk of the (n_loc, kk + n_loc) candidate rows,
the carried bests first and then the block in global order, ties to the
lower column (what `lax.top_k(-d)` takes in the JAX function): the fused
row selection at one element a bin (kernels/approx_topk.py:select_rows,
kk <= 128), which on a CPU tensor is its plain version. The self distance
is pinned at -1 so the point itself is always its first candidate, the
initial bests are +inf, and `self_loop=False` drops column 0; distances
are clamped at 0 on return.
"""
from __future__ import annotations

import torch

from ..kernels.approx_topk import MAX_K, select_rows
from ..ops.knn import pairwise_sqdist
from .mesh import Mesh, ppermute


def _ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def sharded_knn(coords: torch.Tensor, k: int, mesh: Mesh,
                self_loop: bool = False, return_dist: bool = False):
    """kNN over a cloud whose points axis is split over the mesh's ranks.

    :param coords: (n_loc, C) this rank's points (rank r holds global rows
        r * n_loc ... (r + 1) * n_loc - 1)
    :param k: neighbours a point
    :return: (n_loc, k) int64 global neighbour indices [, (n_loc, k)
        squared distances], this rank's rows
    """
    n_loc = coords.shape[0]
    n = n_loc * mesh.size
    kk = k if self_loop else k + 1
    if kk > n:
        raise ValueError(f"k={k} too large for N={n}")
    if kk > MAX_K:
        raise ValueError(f"sharded_knn: kk={kk} above the row selection's "
                         f"{MAX_K}")
    dev = coords.device
    ar = torch.arange(n_loc, device=dev)
    my_gidx = mesh.rank * n_loc + ar
    block = coords
    best_d = torch.full((n_loc, kk), torch.inf, dtype=torch.float32,
                        device=dev)
    best_i = torch.zeros((n_loc, kk), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for step in range(mesh.size):
            owner = (mesh.rank - step) % mesh.size
            gidx = owner * n_loc + ar
            d = pairwise_sqdist(coords, block).to(torch.float32)
            d = torch.where(my_gidx[:, None] == gidx[None, :], -1.0, d)
            cand_d = torch.cat([best_d, d], dim=1).contiguous()
            cand_i = torch.cat([best_i, gidx[None, :].expand(n_loc, n_loc)],
                               dim=1)
            best_d, sel = select_rows(cand_d, cand_d.shape[1], 1, kk,
                                      largest=False)
            best_i = torch.gather(cand_i, 1, sel)
            if step < mesh.size - 1:
                block = ppermute(block, mesh, _ring_perm(mesh.size))
    if not self_loop:
        best_d, best_i = best_d[:, 1:], best_i[:, 1:]
    best_d = best_d.clamp(min=0.0)
    return (best_i, best_d) if return_dist else best_i


def sharded_gather_neighbors(feats: torch.Tensor, idx: torch.Tensor,
                             mesh: Mesh) -> torch.Tensor:
    """(n_loc, k, C) neighbour features for global indices when both the
    feature table and the queries are split along the points axis: the
    feature block travels round the ring, and each rank picks the indices
    that fall in the visiting block's global range (no gather of the whole
    table).

    :param feats: (n_loc, C) this rank's rows of the table
    :param idx: (n_loc, k) global indices (this rank's queries)
    """
    n_loc = feats.shape[0]
    block = feats
    out = torch.zeros((*idx.shape, feats.shape[-1]), dtype=feats.dtype,
                      device=feats.device)
    for step in range(mesh.size):
        owner = (mesh.rank - step) % mesh.size
        rel = idx - owner * n_loc
        inb = (rel >= 0) & (rel < n_loc)
        picked = block[rel.clamp(0, n_loc - 1)]
        out = out + torch.where(inb[..., None], picked, 0)
        if step < mesh.size - 1:
            block = ppermute(block, mesh, _ring_perm(mesh.size))
    return out


def sharded_edge_features(x: torch.Tensor, k: int, mesh: Mesh
                          ) -> torch.Tensor:
    """The EdgeConv input [x_j - x_i, x_i] for a cloud split along the
    points axis: the ring kNN, then the ring gather.

    :param x: (n_loc, C) this rank's features or coordinates
    :return: (n_loc, k, 2C)
    """
    idx = sharded_knn(x, k, mesh)
    xj = sharded_gather_neighbors(x, idx, mesh)
    xi = x[:, None, :].expand_as(xj)
    return torch.cat([xj - xi, xi], dim=-1)
