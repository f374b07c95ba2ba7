"""Sums over a process group with the gradients of the global-batch math.

A data-parallel step computes the single-device function of the global
batch: each rank holds its rows, and every statistic that the function
takes over the batch (a BatchNorm's moments, a loss's sums) is summed over
the group. Which backward such a sum needs depends on how its result is
used:

  * `sum_replicated`: every rank applies the same function to the sum (the
    loss: a Dice over the global tp/fp/fn, a CE over the global sum of
    weights). Each rank then already holds the whole derivative of the
    global value with respect to the sum, and that is the derivative with
    respect to each rank's part: the backward is the identity.
  * `sum_local`: each rank uses the sum on its own rows (BatchNorm
    normalizing its rows with the global mean). Each rank then holds only
    its rows' share of the derivative: the backward sums it over the group.

Either way the parameters' gradients that the backward leaves on a rank are
that rank's share, and one sum of them over the group (the trainer's) is
the single-device gradient. Summing the upstream gradients of a replicated
value (what `torch.distributed.nn.functional.all_reduce` does) would count
its terms once per rank.

Every function takes the group explicitly; None is no group (the
single-device function, no collective).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def global_rank(group, rank: int) -> int:
    """The default group's rank of `group`'s rank `rank` (the `src`/`dst`
    that torch.distributed's calls take)."""
    return dist.get_global_rank(group, rank)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place SUM over `group` (no autograd); a no-op without a group."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over `group`, for a value every rank then uses alike
    (backward: the identity)."""
    if group is None:
        return x
    return _SumReplicated.apply(x, group)


def sum_local(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over `group`, for a statistic each rank applies to its own
    rows (backward: the upstream gradient summed over `group`)."""
    if group is None:
        return x
    return _SumLocal.apply(x, group)
