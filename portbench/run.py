"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell `<name>` is an entry of BENCHMARK.json's `workloads`; it names
its configuration and its traffic mix, and the mix names the window loop
(portbench/common.py says how files are found). The run makes its inputs
and weights from `--seed`, warms up the cell's shapes (set-up), measures
for `--seconds` seconds (with `--trace 1` under the profiler, reporting
the per-layer metrics instead of the end-to-end ones), judges the
program's answers by the plain reference, and prints, as the last line of
standard output, one JSON object: correct, attempted, failed, metrics,
device (with `--trace 1` also busy_s and window_s, and a breakdown), and
last the numbers compared, each with its limit (also the last lines of
standard error).

It needs as many NVIDIA cards as the cell asks for, and exits 1 without a
result when they are missing, when the run loads JAX or the JAX package,
or when anything fails.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# a library that would load JAX by itself stays off it
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# build caches at fixed paths inside the checkout (the port's kernels keep
# theirs in its package: kernels/_build, native/_build)
_CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".cache", "portbench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")

import torch  # noqa: E402

from portbench import common  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a window loop gets: the cell's files, the run's arguments and
    the device; `setup_done()` marks the end of set-up."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float = T_START
    setup_s: float | None = None
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, what: str) -> None:
        """Note the seconds since the process started at a step of
        set-up (printed to standard error)."""
        self.marks.append((what, time.perf_counter() - self.t_start))

    def setup_done(self) -> None:
        """The end of set-up: the device's peak memory is counted from
        here (set-up may run the reference, which no window runs)."""
        self.mark("set-up done")
        self.setup_s = self.marks[-1][1]
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)


def execute(cell: common.Cell, seed: int, seconds: float, trace: bool,
            device, root: str = common.ROOT, t_start: float = T_START):
    """Run the cell on `device`; returns (result dict, checks, set-up's
    marks)."""
    device = torch.device(device)
    ctx = Context(cell.name, cell.config, cell.traffic, seed, seconds, trace,
                  device, t_start)
    ctx.mark("imports")
    out = common.loop_module(cell.traffic).run(ctx)
    if trace:
        metrics = common.per_layer_values(cell, out.run, root)
    else:
        metrics = {m["name"]: {"value": float(out.values[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out.values}
        metrics["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
    cuda = device.type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.entry["chips"] if cuda else 0,
            "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": all(c.ok for c in out.checks),
              "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": info}
    if trace and out.run.trace is not None:
        info["busy_s"] = out.run.trace.busy_s
        info["window_s"] = out.run.trace.window_s
        result["breakdown"] = out.run.trace.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.checks}
    return result, out.checks, ctx.marks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = common.resolve(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} NVIDIA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result, checks, marks = execute(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda")
    print("set-up: " + ", ".join(f"{w} {t:.2f} s" for w, t in marks),
          file=sys.stderr)
    found = common.forbidden_loaded()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 1
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
