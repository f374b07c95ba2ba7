"""Ensembled full-cloud inference with the subsets split over the ranks
(counterpart of parallel/ensemble.py).

Every rank builds the same subsets (the same generator, or the `subsets`
passed in), pads them to a multiple of ``size * subset_batch`` with the
first subsets, as the JAX function does, and runs its contiguous share in
groups of `subset_batch`, adding each subset's softmax into a partial
(N, C) sum with `index_add_` (models/ensemble.py). One all-reduce (SUM)
merges the partial sums; every rank returns the softmax of the total.
Where the subset count does not divide, the padding repeats subsets, so
the result is the JAX sharded function's, not the single-device one's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.ensemble import build_subsets
from .mesh import Mesh


def sharded_ensemble_predict(model, pc: torch.Tensor, mesh: Mesh,
                             sample_points: int = 2048, n_runs_min: int = 50,
                             subset_batch: int = 5,
                             generator: torch.Generator | None = None,
                             subsets: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Like models.ensemble.ensemble_predict, with the subsets split over
    the mesh's ranks.

    :param model: (B, S, C) -> (B, S, num_classes) logits, in eval mode
    :param pc: (N, C) full cloud on the mesh's device, the same on every
        rank
    :param generator: draws the subsets (seeded alike on every rank)
    :param subsets: (R, S) subset indices to use instead of a draw
    :return: (N, num_classes) softmax scores, on every rank
    """
    if subsets is None:
        subsets = build_subsets(pc.shape[0], sample_points, n_runs_min,
                                generator, pc.device)
    subsets = subsets.to(device=pc.device, dtype=torch.int64)
    group = mesh.size * subset_batch
    r, s = subsets.shape
    if r % group:
        subsets = torch.cat([subsets, subsets[:group - r % group]])
    share = subsets.shape[0] // mesh.size
    local = subsets[mesh.rank * share:(mesh.rank + 1) * share]
    acc = None
    with torch.no_grad():
        for rows_group in local.reshape(-1, subset_batch, s):
            probs = torch.softmax(model(pc[rows_group]), dim=-1)
            if acc is None:
                acc = torch.zeros(pc.shape[0], probs.shape[-1],
                                  dtype=torch.float32, device=pc.device)
            for rows, p in zip(rows_group, probs):
                acc.index_add_(0, rows, p.to(torch.float32))
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.group)
    return torch.softmax(acc, dim=-1)
