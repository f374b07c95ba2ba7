"""Parameter and operation counts, a timing helper (counterpart of
utils/profiling.py) and `stage`, the synced stage clock of preprocessing.

`param_and_op_count` writes `op_count.csv` with the JAX package's columns
(flops, bytes_accessed, params). The JAX package takes the first two from
XLA's cost analysis of the compiled forward, which counts every operation.
Here they are counted from one forward in eval mode without autograd:
  * flops: the convolution and matrix-product FLOPs (2 a multiply-add)
    that `torch.utils.flop_counter.FlopCounterMode` counts, plus K6's
    (2 x 27 an output, at strides 1 and 2), which runs outside PyTorch's
    operators on a card;
    elementwise passes (BatchNorm, activations, resizes) are not counted,
    so the number is below XLA's;
  * bytes_accessed: the bytes those same operations read and write, each
    input (weights included) once and each output once;
  * params: the number of parameters (exact; BatchNorm's running
    statistics are buffers, as they are batch_stats in the JAX tree).
"""
from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _CountedBytes(TorchDispatchMode):
    """Bytes read and written by the operators FlopCounterMode counts."""

    def __init__(self, counted):
        super().__init__()
        self.counted, self.bytes = counted, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in self.counted:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


@torch.no_grad()
def op_count(model: torch.nn.Module, x: torch.Tensor) -> dict:
    """{"flops", "bytes_accessed"} of one eval-mode forward of `model` on
    `x` (see the module doc for what they count)."""
    from ..models.seg_cnn import DepthwiseConv3, DepthwiseConv3Stride2
    k6 = {"flops": 0, "bytes": 0}

    def hook(mod, args, out):
        taps = mod.kernel if isinstance(mod, DepthwiseConv3) else mod.weight
        k6["flops"] += 2 * 27 * out.numel()
        k6["bytes"] += _nbytes((args, taps, out))
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (DepthwiseConv3, DepthwiseConv3Stride2))]
    training = model.training
    model.eval()
    flops = FlopCounterMode(display=False)
    try:
        with flops, _CountedBytes(flops.flop_registry) as nbytes:
            model(x)
    finally:
        model.train(training)
        for h in handles:
            h.remove()
    return {"flops": flops.get_total_flops() + k6["flops"],
            "bytes_accessed": nbytes.bytes + k6["bytes"]}


def param_and_op_count(model: torch.nn.Module, x: torch.Tensor,
                       out_dir: str | None = None,
                       filename: str = "op_count.csv") -> dict:
    """FLOP, byte and parameter counts, optionally written as op_count.csv
    (the JAX package's layout)."""
    row = {**op_count(model, x), "params": count_parameters(model)}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, filename), "w") as f:
            w = csv.writer(f)
            w.writerow(list(row))
            w.writerow([row[k] for k in row])
    return row


def _sync(out) -> None:
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def time_fn(fn: Callable, *args, repeats: int = 10, warmup: int = 1,
            **kwargs) -> dict:
    """Wall times of `fn(*args, **kwargs)`, each run ended by a sync of
    the card its outputs lie on: mean/std/min over `repeats` after
    `warmup` runs."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {"mean_s": float(np.mean(times)), "std_s": float(np.std(times)),
            "min_s": float(np.min(times)), "times": times}


@contextlib.contextmanager
def stage(stages: dict | None, name: str, device):
    """Time the block as stage `name`: with a dict, the card is
    synchronized before and after it and the seconds are added to
    ``stages[name]``; with None, nothing happens (no sync)."""
    if stages is None:
        yield
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
