"""Ensembled full-point-cloud inference (counterpart of models/ensemble.py).

The full cloud is segmented by running the model on many random
`sample_points`-sized subsets and summing their softmax scores per point;
a final softmax over the sum gives the prediction. Coverage is guaranteed
by construction: the first ceil(N/S) subsets partition one random
permutation (tail wrapped), the rest are extra random draws. The JAX
package's scan over subset groups is a Python loop here, and the
accumulation one `index_add_` a subset: a subset holds no point twice, so
no two of its additions meet on the card's float atomics, and the sum
takes the same order on every run and device (the CPU's).
"""
from __future__ import annotations

from typing import Callable

import torch


def build_subsets(n_points: int, sample_points: int, n_runs_min: int = 50,
                  generator: torch.Generator | None = None,
                  device=None) -> torch.Tensor:
    """Subset index matrix (R, sample_points) with guaranteed coverage.

    The permutations are drawn on the CPU from `generator` (so a seed gives
    the same subsets on any device) and moved to `device`."""
    n_cover = -(-n_points // sample_points)  # ceil
    n_runs = max(n_runs_min, n_cover)
    perm = torch.randperm(n_points, generator=generator)
    pad = n_cover * sample_points - n_points
    covered = torch.cat([perm, perm[:pad]]) if pad else perm
    rows = [covered.reshape(n_cover, sample_points)]
    rows += [torch.randperm(n_points, generator=generator)[None, :sample_points]
             for _ in range(n_runs - n_cover)]
    return torch.cat(rows).to(device, non_blocking=True)


def ensemble_predict(model: Callable[[torch.Tensor], torch.Tensor],
                     pc: torch.Tensor, sample_points: int = 2048,
                     n_runs_min: int = 50, subset_batch: int = 5,
                     generator: torch.Generator | None = None,
                     subsets: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax segmentation of a full cloud by subset ensembling.

    :param model: (B, S, C) -> (B, S, num_classes) logits, in eval mode
    :param pc: (N, C) full point cloud (N >= sample_points)
    :param subsets: optional (R, S) subset indices to use instead of a draw
        from `generator` (tests inject the JAX package's draw)
    :return: (N, num_classes) final softmax scores
    """
    if subsets is None:
        subsets = build_subsets(pc.shape[0], sample_points, n_runs_min,
                                generator, pc.device)
    subsets = subsets.to(device=pc.device, dtype=torch.int64,
                         non_blocking=True)
    r, s = subsets.shape
    if r % subset_batch:  # pad with repeats of the first subsets
        subsets = torch.cat([subsets, subsets[:subset_batch - r % subset_batch]])
    acc = None
    with torch.no_grad():
        for group in subsets.reshape(-1, subset_batch, s):
            probs = torch.softmax(model(pc[group]), dim=-1)
            if acc is None:
                acc = torch.zeros(pc.shape[0], probs.shape[-1],
                                  dtype=torch.float32, device=pc.device)
            for rows, p in zip(group, probs):
                acc.index_add_(0, rows, p)
    return torch.softmax(acc, dim=-1)
