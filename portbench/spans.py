"""The program's spans laid over the device trace: which span launched each
device operation, which spans the card sat idle in, and the runtime calls
(launches, copies, syncs) made inside each span.

The program marks its stages with spans (fissure_segmentation_tpu_torch/
utils/profiling.py: `span`, `recording`), stamped with `time.time_ns()`,
the clock of torch.profiler's host events. `SpanTracer` is common.Tracer
that also turns the span recorder on and, under the profiler, keeps the
CUDA runtime records (cudaLaunchKernel, cudaMemcpyAsync, the syncs; the
lower API's cuLaunchKernel for the kernels the port launches through its
own library) with their correlation ids. `attribute` then gives each device
operation the innermost span open when it was launched: the launch is
found by correlation id, the span is the innermost one open on the
launching thread at the launch, else (autograd's thread inside
"train.backward") the innermost one open on any thread; a device
operation with no runtime record takes the span of the nearest earlier
operation that has one (stream order). `idle_s` puts each idle gap of the
card down to the spans open during it.

The stock loops build common.Tracer, whose summary keeps none of this, so
the readers of these spans (portbench/metrics/: dispatch_launches.stream,
dispatch_syncs.stream, idle_upload.stream, k6_span_roofline.stream,
components_ms.one, labelmap_ms.one, idle_host_half.one,
edgeconv_span_roofline.train, optimizer_ms.train, sample_device_ms.train)
read nothing in a stock run and BENCHMARK.json does not list them. This
module runs a cell with SpanTracer in the loops' place and prints the
result line with them:

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--record 0|1]

`--trace 1`: the per-layer metrics, the listed and these, and a "spans"
object (the share of the device's busy time attributed to a span, by how,
device ms, idle ms and the runtime calls by span); `--trace 0 --record 1`:
the end-to-end metrics with the recorder on in the window (its cost).
"""
from __future__ import annotations

import argparse
import bisect
import copy
import dataclasses
import json
import os
import sys
import time

from . import common

# runtime calls that hold the host until the card reaches them (the CUDA
# runtime's and the lower cu* API's names as CUPTI gives them); a copy
# call whose device operation is from or to pageable memory counts too
SYNC_CALLS = frozenset((
    "cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D", "cudaMemcpyToSymbol",
    "cudaMemcpyFromSymbol", "cudaFree", "cudaFreeHost", "cuCtxSynchronize",
    "cuStreamSynchronize", "cuEventSynchronize", "cuMemcpyHtoD_v2",
    "cuMemcpyDtoH_v2", "cuMemcpyDtoD_v2", "cuMemFree_v2", "cuMemFreeHost"))
COPY_CALLS = ("cudaMemcpyAsync", "cuMemcpyAsync", "cuMemcpyHtoDAsync_v2",
              "cuMemcpyDtoHAsync_v2")
QUEUE_FULL = "Command Buffer Full"

# the readers of portbench/metrics/ that BENCHMARK.json does not list
# (nothing in a stock run for them to read): (name, unit) by cell
PENDING = {
    "mobilenet_aspp.serve_stream": [
        ("dispatch_launches.stream", "launches"),
        ("dispatch_syncs.stream", "syncs"), ("idle_upload.stream", "%"),
        ("k6_span_roofline.stream", "%")],
    "mobilenet_aspp.serve_one": [
        ("components_ms.one", "ms"), ("labelmap_ms.one", "ms"),
        ("idle_host_half.one", "%")],
    "dgcnn_k40.train": [
        ("edgeconv_span_roofline.train", "%"), ("optimizer_ms.train", "ms"),
        ("sample_device_ms.train", "ms")],
}


def int32(x: int) -> int:
    """`x` cut to a signed 32-bit integer."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


class Spans:
    """The program's span records (fields as utils/profiling.py's Record:
    name, tid, start_ns, end_ns, id, parent, ident) indexed by thread:
    which span is innermost open on a thread, or on any, at a time. A
    thread goes by two keys, those a runtime record may carry for it: its
    native id (torch.profiler with CPU activity, for the threads whose
    operators it saw) and its ident cut to 32 bits (the CUDA runtime's
    own, pthread_self). A key that a later thread takes over keeps each
    thread's spans apart in time."""

    def __init__(self, records):
        self.records = list(records)
        where = {r[4]: i for i, r in enumerate(self.records)}
        self.parent = [where.get(r[5], -1) for r in self.records]
        # each span's name and those of the spans around it
        self.chain = []
        for i in range(len(self.records)):
            names, j = [], i
            while j >= 0:
                if self.records[j][0] not in names:
                    names.append(self.records[j][0])
                j = self.parent[j]
            self.chain.append(tuple(names))
        threads: dict = {}
        for i, r in enumerate(self.records):
            threads.setdefault(r[1], []).append(i)
            if int32(r[6]) != r[1]:
                threads.setdefault(int32(r[6]), []).append(i)
        self.threads = {}
        for tid, idx in threads.items():
            idx.sort(key=lambda i: self.records[i][2])
            self.threads[tid] = ([self.records[i][2] for i in idx], idx)

    def on(self, tid: int, t: int) -> int:
        """The innermost span open on thread `tid` at `t` (an index, -1 for
        none). A thread's spans nest, so it is the span that started last
        before `t`, or the nearest span around it that had not ended."""
        got = self.threads.get(tid)
        if got is None:
            return -1
        starts, idx = got
        k = bisect.bisect_right(starts, t) - 1
        i = idx[k] if k >= 0 else -1
        while i >= 0 and self.records[i][3] < t:
            i = self.parent[i]
        return i

    def on_any(self, t: int) -> int:
        """The innermost span open at `t` on any thread: of each thread's
        innermost, the one that started last."""
        best = -1
        for tid in self.threads:
            i = self.on(tid, t)
            if i >= 0 and (best < 0 or self.records[i][2]
                           > self.records[best][2]):
                best = i
        return best

    def intervals(self, name: str) -> list:
        """The union of the spans named `name`, as sorted (start, end)."""
        return union(sorted((r[2], r[3]) for r in self.records
                            if r[0] == name))


def union(intervals) -> list:
    """Sorted (start, end) pairs merged where they overlap."""
    out: list = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def overlap(a: list, b: list) -> int:
    """The length of the intersection of two unions (`union`)."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def attribute(spans: Spans, runtime: list, device: list) -> tuple:
    """(owner, how) of each device operation: the index of the span that
    launched it (-1 for none) and how it was found ("thread", "any",
    "stream", "none"). `runtime`: (start_ns, end_ns, tid, name,
    correlation) of the runtime calls; `device`: (start_ns, end_ns, name,
    correlation, stream) of the device operations, sorted by start."""
    launch = {r[4]: r for r in runtime if r[4]}
    owner, how = [], []
    last = -1
    for op in device:
        r = launch.get(op[3]) if op[3] else None
        if r is None:
            owner.append(last)
            how.append("stream" if last >= 0 else "none")
            continue
        i, h = spans.on(r[2], r[0]), "thread"
        if i < 0:
            i, h = spans.on_any(r[0]), "any"
        owner.append(i)
        how.append(h if i >= 0 else "none")
        last = i
    return owner, how


@dataclasses.dataclass
class SpanTrace:
    """A traced window's device operations, runtime calls and spans, each
    operation with the span that launched it (`attribute`)."""
    spans: Spans
    runtime: list                 # (start_ns, end_ns, tid, name, corr)
    device: list                  # (start_ns, end_ns, name, corr, stream)
    window: tuple                 # (start_ns, end_ns), host clock
    waits: list = dataclasses.field(default_factory=list)  # queue full
    owner: list = dataclasses.field(init=False)   # span index an operation
    how: list = dataclasses.field(init=False)     # how it was found

    def __post_init__(self):
        self.device = sorted(self.device)
        self.owner, self.how = attribute(self.spans, self.runtime,
                                         self.device)
        self.busy = union((op[0], op[1]) for op in self.device)
        # the card's idle intervals inside the window
        self.gaps, t = [], self.window[0]
        for s, e in self.busy:
            if s > t:
                self.gaps.append((t, min(s, self.window[1])))
            t = max(t, e)
        if t < self.window[1]:
            self.gaps.append((t, self.window[1]))

    def coverage(self) -> float:
        """The share of the device's busy time whose operations a span
        launched."""
        busy = sum(e - s for s, e in self.busy)
        mine = union((op[0], op[1]) for op, i in zip(self.device, self.owner)
                     if i >= 0)
        return sum(e - s for s, e in mine) / busy if busy else 0.0

    def device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside spans named
        `name` (spans inside them included)."""
        return 1e-9 * sum(op[1] - op[0] for op, i in zip(self.device,
                                                         self.owner)
                          if i >= 0 and name in self.spans.chain[i])

    def launches(self, name: str) -> int:
        """Device operations launched inside spans named `name`."""
        return sum(1 for i in self.owner
                   if i >= 0 and name in self.spans.chain[i])

    def calls(self, name: str) -> list:
        """The runtime calls made on a span's own thread inside spans named
        `name`, each with its device operation's name ("" for none)."""
        ops = {op[3]: op[2] for op in self.device if op[3]}
        out = []
        for r in self.runtime:
            i = self.spans.on(r[2], r[0])
            if i >= 0 and name in self.spans.chain[i]:
                out.append((r, ops.get(r[4], "")))
        return out

    def syncs(self, name: str) -> int:
        """Host-blocking runtime calls inside spans named `name`: SYNC_CALLS,
        and copies whose device operation is pageable."""
        return sum(1 for r, op in self.calls(name)
                   if r[3] in SYNC_CALLS
                   or (r[3] in COPY_CALLS and "Pageable" in op))

    def waits_s(self, name: str) -> float:
        """Seconds of the window in which a launch was held for room in
        the card's queue while a span named `name` was open (on any
        thread: the records name none)."""
        return 1e-9 * overlap(union(sorted(self.waits)),
                              self.spans.intervals(name))

    def idle_s(self, name: str) -> float:
        """Seconds of the window in which the card was idle while a span
        named `name` was open (on any thread)."""
        return 1e-9 * overlap(self.gaps, self.spans.intervals(name))

    def report(self, per: int = 1, top: int = 8) -> dict:
        """What the result line's "spans" object gives: the attributed
        share and the share by how it was found; by span name, device ms,
        idle ms, launches, syncs, the host's ms held in launches for room
        in the card's queue (`waits_s`) and the runtime calls made on its
        own thread (host ms and count by call, the `top` longest), each
        over `per` (cases or steps)."""
        by: dict = {}

        def entry(n):
            return by.setdefault(n, {"device_ms": 0.0, "launches": 0.0,
                                     "idle_ms": 0.0, "calls": {}})
        for op, i in zip(self.device, self.owner):
            if i >= 0:
                for n in self.spans.chain[i]:
                    e = entry(n)
                    e["device_ms"] += (op[1] - op[0]) * 1e-6 / per
                    e["launches"] += 1 / per
        for r in self.runtime:
            i = self.spans.on(r[2], r[0])
            if i >= 0:
                for n in self.spans.chain[i]:
                    c = entry(n)["calls"].setdefault(r[3], [0.0, 0.0])
                    c[0] += (r[1] - r[0]) * 1e-6 / per
                    c[1] += 1 / per
        for n in {r[0] for r in self.spans.records}:
            entry(n)["idle_ms"] = 1e3 * self.idle_s(n) / per
            entry(n)["queue_full_ms"] = 1e3 * self.waits_s(n) / per
            entry(n)["syncs"] = self.syncs(n) / per
        for e in by.values():
            e["calls"] = dict(sorted(e["calls"].items(),
                                     key=lambda kv: -kv[1][0])[:top])
        total = sum(op[1] - op[0] for op in self.device) or 1
        how: dict = {}
        for op, h in zip(self.device, self.how):
            how[h] = how.get(h, 0.0) + (op[1] - op[0]) / total
        return {"coverage": self.coverage(), "how": how, "per": per,
                "window_ms": (self.window[1] - self.window[0]) * 1e-6,
                "idle_ms": 1e-6 * sum(e - s for s, e in self.gaps),
                "by_span": by}


def profiler_records(prof) -> tuple:
    """(runtime calls, device operations, queue waits) of a finished
    torch.profiler run, read from the raw results: device operations are
    the CUDA events that are no annotation range; runtime calls the host
    events of the CUDA runtime and its lower API ("cuda…", "cu…"); queue waits
    the (start_ns, end_ns) of CUPTI's "Command Buffer Full" records, a
    launch held until the card's queue has room (they carry the held
    launch's correlation id but no thread)."""
    from torch.autograd import DeviceType
    runtime, device, waits = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        s = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.duration_ns() > 0:
                device.append((s, s + e.duration_ns(), e.name(),
                               e.correlation_id(), e.device_resource_id()))
        elif e.name() == QUEUE_FULL:
            waits.append((s, s + e.duration_ns()))
        elif e.correlation_id() and e.name().startswith("cu"):
            # the thread the runtime gives (start_thread_id is the
            # profiler's own number, 1 for every runtime record)
            runtime.append((s, s + e.duration_ns(), e.device_resource_id(),
                            e.name(), e.correlation_id()))
    return runtime, device, waits


@dataclasses.dataclass
class SpanSummary(common.TraceSummary):
    """common.TraceSummary with the window's spans over its device trace."""
    program: SpanTrace | None = None


class SpanTracer(common.Tracer):
    """common.Tracer that also turns the program's span recorder on for
    the window (with tracing, or where `record`) and keeps the records
    (`records`); with tracing its summary is a SpanSummary."""

    def __init__(self, on: bool, cuda: bool, record: bool | None = None):
        super().__init__(on, cuda)
        self.record = on if record is None else record
        self.records = None
        self._recording = None
        self.t0_ns = self.t1_ns = None

    def start(self):
        if self.record:
            from fissure_segmentation_tpu_torch.utils.profiling import \
                recording
            self._recording = recording()
            self.records = self._recording.__enter__()
        super().start()
        self.t0_ns = time.time_ns()

    def stop(self):
        self.t1_ns = time.time_ns()
        super().stop()
        if self._recording is not None:
            self._recording.__exit__(None, None, None)
            self._recording = None

    def summary(self) -> SpanSummary | None:
        base = super().summary()
        if base is None:
            return None
        runtime, device, waits = profiler_records(self.prof)
        program = SpanTrace(Spans(self.records or []), runtime, device,
                            (self.t0_ns, self.t1_ns), waits)
        return SpanSummary(**dataclasses.asdict(base), program=program)


class _Tracers:
    """Stands in for common.Tracer in the loops: SpanTracers, the recorder
    on in every traced window and, where `record`, in the untraced one."""

    def __init__(self, record: bool):
        self.record, self.made = record, []

    def __call__(self, on: bool, cuda: bool) -> SpanTracer:
        t = SpanTracer(on, cuda, record=on or self.record)
        self.made.append(t)
        return t


def execute(cell: common.Cell, seed: int, seconds: float, trace: bool,
            record: bool, device, root: str = common.ROOT):
    """run.execute with SpanTracer in the loops: (result dict, checks,
    set-up's marks). With tracing, or where `record`, the recorder is on in
    the untraced window and the run carries its spans (`records`); with
    tracing the metrics of PENDING are read too."""
    import torch
    from . import run as run_mod
    from .loops import serve, train
    tracers = _Tracers(record or trace)
    saved = serve.Tracer, train.Tracer
    serve.Tracer = train.Tracer = tracers
    try:
        device = torch.device(device)
        ctx = run_mod.Context(cell.name, cell.config, cell.traffic, seed,
                              seconds, trace, device)
        ctx.mark("imports")
        out = common.loop_module(cell.traffic).run(ctx)
    finally:
        serve.Tracer, train.Tracer = saved
    untraced = next((t for t in tracers.made if not t.on), None)
    out.run.records = untraced.records if untraced is not None else None
    if trace:
        cell = copy.copy(cell)
        cell.per_layer = cell.per_layer + [
            {"name": n, "unit": u} for n, u in PENDING.get(cell.name, [])]
        metrics = common.per_layer_values(cell, out.run, root)
    else:
        metrics = {m["name"]: {"value": float(out.values[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out.values}
        metrics["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
    cuda = device.type == "cuda"
    result = {"correct": all(c.ok for c in out.checks),
              "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "record": bool(record or trace),
              "device": {"kind": torch.cuda.get_device_name(device)
                         if cuda else "cpu",
                         "memory_peak_bytes": int(out.memory_peak_bytes)}}
    if trace and out.run.trace is not None:
        result["device"]["busy_s"] = out.run.trace.busy_s
        result["device"]["window_s"] = out.run.trace.window_s
        result["spans"] = out.run.trace.program.report(
            out.run.trace_cases or out.run.trace_steps or 1)
        result["spans"]["stage_sum_over_dispatch"] = stage_share(
            out.run.timings)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.checks}
    return result, out.checks, ctx.marks


STAGE_KEYS = ("upload_s", "keypoints_s", "ensemble_s", "surface_s",
              "copy_out_s")


def stage_share(timings: list) -> float | None:
    """The dispatch stages' seconds summed over the cases, over the cases'
    "dispatch_s" (segment_cases' timings; None without them)."""
    v = [t for t in timings if "dispatch_s" in t and "upload_s" in t]
    if not v:
        return None
    return (sum(t[k] for t in v for k in STAGE_KEYS)
            / sum(t["dispatch_s"] for t in v))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from . import run as _  # noqa: F401  (its environment, before torch)
    import torch
    cell = common.resolve(args.workload)
    if not torch.cuda.is_available():
        print(f"portbench.spans: {args.workload} needs an NVIDIA card",
              file=sys.stderr)
        return 1
    result, checks, marks = execute(cell, args.seed, args.seconds,
                                    bool(args.trace), bool(args.record),
                                    "cuda")
    print("set-up: " + ", ".join(f"{w} {t:.2f} s" for w, t in marks),
          file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.exit(main())
