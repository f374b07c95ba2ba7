"""Parameter and operation counts, a timing helper, a trace (counterpart
of utils/profiling.py), `stage`, the synced stage clock of
preprocessing, and the span recorder.

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

`cost_analysis(fn, *args)` gives the JAX function's keys ("flops", "bytes
accessed", "transcendentals") for any callable, read from the same
dispatch counters: the flops and bytes of the counted operators as above,
and one transcendental per output element of the elementwise exp, log,
trigonometric, tanh, sigmoid, erf, sqrt, rsqrt and pow operators and of
softmax. `trace(out_dir)` is the counterpart of `jax.profiler.trace`: a
torch.profiler trace of the block (the CPU, and the card where there is
one) written as a Chrome trace, `out_dir`/trace.json.

The span recorder: `span(name)` marks a block of the program (serving's
stages, the train step's parts, the EdgeConv kernels; PERF.md lists the
names and what reads them); `recording()` turns the recorder on for a
block and yields the spans' `Record`s, stamped on the clock of
torch.profiler's host events so they lay over a device trace. Off, a span
costs one flag check.
"""
from __future__ import annotations

import contextlib
import csv
import functools
import itertools
import os
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


_TRANSCENDENTAL = {getattr(torch.ops.aten, name) for name in (
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sin", "cos",
    "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "sigmoid",
    "erf", "erfc", "sqrt", "rsqrt", "pow", "_softmax", "_log_softmax")}


class _CountedBytes(TorchDispatchMode):
    """Bytes read and written by the operators FlopCounterMode counts, and
    the output elements of the transcendental ones."""

    def __init__(self, counted):
        super().__init__()
        self.counted, self.bytes, self.transcendentals = counted, 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in self.counted:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        if func.overloadpacket in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in tree_leaves(out)
                                        if isinstance(t, torch.Tensor))
        return out


@torch.no_grad()
def cost_analysis(fn: Callable, *example_args, **example_kwargs) -> dict:
    """{"flops", "bytes accessed", "transcendentals"} of one call of `fn`
    on the example arguments, without autograd (see the module doc for
    what they count)."""
    flops = FlopCounterMode(display=False)
    with flops, _CountedBytes(flops.flop_registry) as counted:
        fn(*example_args, **example_kwargs)
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(counted.bytes),
            "transcendentals": float(counted.transcendentals)}


@contextlib.contextmanager
def trace(out_dir: str):
    """Context manager: a torch.profiler trace of the block (the CPU, and
    the card where there is one), written as the Chrome trace
    `out_dir`/trace.json (Perfetto, chrome://tracing); yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


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
    """Time the block as stage `name`, inside `span(name)`: with a dict,
    the card is synchronized before and after it and the seconds are added
    to ``stages[name]``; with None, only the span (no sync)."""
    with span(name):
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


# ---- the span recorder ----

class Record(NamedTuple):
    """One span: its name, the native id of the thread that opened it, its
    start and end on the Unix-epoch clock in ns (`time.time_ns()`, the
    clock of torch.profiler's host events), its own id, its parent's (the
    span open on the same thread around it; -1 for none), and the thread's
    `threading.get_ident()` (pthread_self: the CUDA runtime's records under
    torch.profiler carry it, cut to 32 bits, as their thread)."""
    name: str
    tid: int
    start_ns: int
    end_ns: int
    id: int
    parent: int
    ident: int


_records: list | None = None      # the recording's list; None: off
_ids = itertools.count()
_open = threading.local()         # .stack: the ids of this thread's open
                                  # spans; .ids: (native id, ident)
_range_keys: set = set()          # the names spans opened ranges under


class _Span:
    """A span that stamps: on exit its record goes to the recording that
    was on at its entry, and its seconds to `into[name]` where given."""
    __slots__ = ("name", "into", "records", "range", "id", "parent", "t0",
                 "seconds")

    def __init__(self, name: str, into: dict | None):
        self.name, self.into = name, into
        self.records = _records
        self.range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            _range_keys.add(self.name)
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
        if self.records is not None:
            try:
                stack = _open.stack
            except AttributeError:
                stack = _open.stack = []
                _open.ids = (threading.get_native_id(), threading.get_ident())
            self.parent = stack[-1] if stack else -1
            self.id = next(_ids)
            stack.append(self.id)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.seconds = (t1 - self.t0) * 1e-9
        if self.records is not None:
            _open.stack.pop()
            tid, ident = _open.ids
            self.records.append((self.name, tid, self.t0, t1, self.id,
                                 self.parent, ident))
        if self.into is not None:
            self.into[self.name] = self.into.get(self.name, 0.0) + \
                self.seconds
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class _NoSpan:
    """The span of a block while nothing records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, into: dict | None = None):
    """Context manager: the block as span `name`.

    Off (no `recording()` block open, no torch profiler running, no
    `into`) it is one flag check and the shared no-op object: no stamp,
    no allocation, no dispatcher call, no sync. While a `recording()` is
    on, the block's `Record` goes to its list; under a torch profiler the
    block is also a `record_function` range of the same name (in the
    profiler's tables and trace); with a dict `into`, the block's seconds
    are added to ``into[name]`` whether or not anything records (the
    stage timings of `segment_cases`). A span never synchronizes: its
    times are the host's, around the enqueue of the block's device work.
    `spanned(name)` is the decorator form."""
    if _records is None and into is None and \
            not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, into)


def spanned(name: str):
    """Decorator: every call of the function runs in `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording():
    """Turn the span recorder on for the block; yields the list that gets
    the record of every span opened inside it and closed, on any thread
    (spans opened before it record nowhere; a nested recording takes the
    spans opened inside it). Inside the block the records are plain
    tuples in `Record`'s order; at its end they become `Record`s."""
    global _records
    prev, recs = _records, []
    _records = recs
    try:
        yield recs
    finally:
        _records = prev
        recs[:] = map(Record._make, recs)


def device_rows(avg) -> list:
    """The device operations' rows of a profiler's `key_averages()`: its
    CUDA rows less those of the spans' ranges, which where the profiler
    traces the card repeat the time of the operations launched inside
    them."""
    from torch.autograd import DeviceType
    return [e for e in avg if e.device_type == DeviceType.CUDA
            and e.key not in _range_keys]
