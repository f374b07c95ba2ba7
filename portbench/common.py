"""What every cell's run shares: the manifest and the files it names, seeds,
the checks that decide `correct`, the device trace, the per-layer readers
and the result line.

Files are found by name: a cell `<config>.<traffic>` of BENCHMARK.json
names its configuration (`configs` entry -> its `file`) and its traffic
mix (`portbench/traffic/<traffic>.json`, whose `loop` names the window
loop `portbench/loops/<loop>.py`); a per-layer metric `<name>` is read by
`portbench/metrics/<name>.py`'s `read(run)`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules no run may load: JAX and the JAX package (compared by
# the whole top-level name: the port's own name begins with the JAX
# package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "fissure_segmentation_tpu")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the workloads entry
    config: dict         # the configuration file's contents
    traffic: dict        # the traffic file's contents
    end_to_end: list     # the metrics entries this cell reports
    per_layer: list


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: str = ROOT) -> Cell:
    """The cell named `workload` with the files it names."""
    man = load_manifest(root)
    entry = {w["name"]: w for w in man["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in man["configs"]}[entry["config"]]
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           entry["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(workload, entry, config, traffic,
                [m for m in man["end_to_end"] if _applies(m, workload)],
                [m for m in man["per_layer"] if _applies(m, workload)])


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_module(traffic: dict):
    return importlib.import_module(f"portbench.loops.{traffic['loop']}")


def metric_reader(name: str, root: str = ROOT):
    """The `read(run)` of portbench/metrics/<name>.py."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    return load_file_module(path, "portbench_metric_" +
                            name.replace(".", "_")).read


def derive_seed(seed: int, *stream) -> int:
    """A 63-bit seed for the named stream of a run's seed: every purpose
    (weights, store, cases, case i) draws from its own stream."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32]
    for s in stream:
        if isinstance(s, str):
            words.extend(s.encode())
        else:
            words.append(int(s))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


@dataclasses.dataclass
class Check:
    """One number compared against its limit: correct iff value <= limit
    (NaN fails)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for cuBLAS and cuDNN inside the block."""
    import torch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def forbidden_loaded() -> list:
    """Top-level names of FORBIDDEN modules in sys.modules."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


# ---- the device trace ----

def _device_events(prof):
    """(start_s, end_s, name) of every device operation (kernels, copies,
    sets; no annotation ranges) of a finished torch.profiler run, read from
    the raw results (no event tree is built)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "is_user_annotation") and e.is_user_annotation():
            continue
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if end > start:
            out.append((start, end, e.name()))
    return sorted(out)


NAME_CHARS = 160   # a device operation's name as the breakdown gives it


@dataclasses.dataclass
class TraceSummary:
    busy_s: float                # union of the device's operations
    window_s: float              # the traced window, host clock
    device_s: dict               # device seconds by operation name
    idle_before: dict            # idle seconds by the operation that ended
                                 # the gap (what the card waited for)

    def device_time(self, *patterns: str) -> float:
        """Device seconds of operations whose name contains any pattern."""
        return sum(t for n, t in self.device_s.items()
                   if any(p in n for p in patterns))

    def breakdown(self) -> dict:
        top = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_before.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], t] for n, t in top],
                "idle_gaps": [["before " + n[:NAME_CHARS], t]
                              for n, t in gaps]}


def idle_percent(run) -> float | None:
    """The share of the traced window in which no operation ran on the
    card, in %."""
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def summarize(prof, window_s: float) -> TraceSummary:
    """Busy seconds (the union of the device's operations), device seconds
    by name, and idle seconds by the operation after each gap, of a traced
    window. Only the device is traced (tracing the host's operators slows
    the host enough to starve a device-bound step); the operation that
    ends a gap is the launch the card was waiting for."""
    dev = _device_events(prof)
    device_s: dict = {}
    idle: dict = {}
    busy = 0.0
    cur_s = cur_e = None
    for s, e, n in dev:
        device_s[n] = device_s.get(n, 0.0) + (e - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                idle[n] = idle.get(n, 0.0) + (s - cur_e)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return TraceSummary(busy, window_s, device_s, idle)


class Tracer:
    """torch.profiler over the window when tracing, else nothing; the
    summary is read after `stop`."""

    def __init__(self, on: bool, cuda: bool):
        self.on, self.cuda = on, cuda
        self.prof = None
        self.t0 = self.t1 = None

    def start(self):
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        if not self.on:
            return
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self) -> TraceSummary | None:
        if not self.on:
            return None
        return summarize(self.prof, self.t1 - self.t0)


@dataclasses.dataclass
class Run:
    """What a run leaves for the per-layer readers: the measured window's
    counts, rates and the program's counters, and with tracing those of a
    second, traced window."""
    config: dict
    traffic: dict
    window_s: float                 # host clock, the measured window
    steps: int = 0                  # train steps in the window
    cases: int = 0                  # served cases in the window
    trace: TraceSummary | None = None   # the traced window's, if traced
    trace_steps: int = 0            # train steps in the traced window
    trace_cases: int = 0            # served cases in the traced window
    spans: dict = dataclasses.field(default_factory=dict)
    timings: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Outcome:
    """A loop's result: counts, the end-to-end values by name, the checks,
    the run record, and the device's peak bytes (read before the
    reference ran)."""
    attempted: int
    failed: int
    values: dict
    checks: list
    run: Run
    memory_peak_bytes: int


def per_layer_values(cell: Cell, run: Run, root: str = ROOT) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], root)(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
