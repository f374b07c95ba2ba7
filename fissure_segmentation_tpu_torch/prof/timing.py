"""The port's timing helpers on an NVIDIA card: `median_ms` (CUDA events
around back-to-back calls, the host's time in each call included wherever
it exceeds the card's), `graph_ms` (CUDA-graph replays: the card's work
alone) and `cold_ms` (one call at a time with the L2 cache flushed before
it). They import torch and nothing of the package, so that
prof/kernel_ab.py times two checkouts with one copy of them.
"""
from __future__ import annotations

import statistics

import torch


def median_ms(fn, reps: int = 7, inner: int = 10, warm: int = 3) -> float:
    """Per-call ms: median over `reps` runs of `inner` back-to-back warm
    calls, each run timed with CUDA events (back to back, the host's launch
    overhead overlaps the device work instead of adding to it)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def graph_ms(fn, inner: int = 20, reps: int = 7, warm: int = 3) -> float:
    """Per-call ms of `fn`'s work on the card: `inner` calls captured in one
    CUDA graph, the graph replayed `reps` times between CUDA events, the
    median. The host's time in `fn` (its checks, allocations, the ctypes
    call) is left out, which `median_ms` counts wherever it exceeds the
    device's; the launches' own cost on the card stays in. `fn` must be
    capturable: no synchronisation, no host read of device data."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def cold_ms(fn, reps: int = 7, warm: int = 2,
            flush_bytes: int = 1 << 28) -> float:
    """Per-call ms of `fn` started with a cold L2 cache: before each call a
    256 MiB buffer is written (the H100's L2 holds 50 MB), then the card
    spins for about 0.1 ms so that the host has enqueued `fn` before its
    start event fires; CUDA events bracket `fn` alone; the median over
    `reps` calls."""
    buf = torch.empty(flush_bytes // 4, dtype=torch.int32, device="cuda")
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        buf.zero_()
        torch.cuda._sleep(200_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
