"""The fused EdgeConv tail on and off on one NVIDIA card (the A/B that sets
ops/fused_edge.py:CUDA_TAIL_DEFAULT).

    python -m fissure_segmentation_tpu_torch.prof.tail_ab [--runs 4] [--steps 10] [--cases ...] [--profile] [--out FILE.json]

Cases (`build_cases`), each at its full width, with DGCNNSeg's EdgeConv_0
[64, 64] (and the spatial transformer's [64, 128]) the tail's call sites:
  * "static f32", "static bf16": the canonical DGCNNSeg train step (k = 40,
    static graph, 32 x 2048, NNU loss, Adam; train/profile_step.py);
  * "dynamic bf16": the default run's step (the dynamic graph);
  * "stems bf16": the step with the spatial transformer and the image
    features (static);
  * "serving f32": serving's 50 x 2048-point subset ensemble of a 20 000-
    point cloud (`models/ensemble.py:ensemble_predict`, subsets of 5,
    DGCNNSeg(k = 40, static) in eval mode under no_grad).
For each case the tail is switched by FSEG_FUSED_EDGE_TAIL, read at every
EdgeConv call; both settings are warmed, then timed in the order on, off,
off, on, ... (`runs` runs each, so drift falls on both alike), each run
`steps` back-to-back calls between two CUDA events. Prints one JSON line
per case with the runs' ms per call and their medians, and the card's name
and power limit. `--profile` then prints, for each setting, the
torch.profiler table of 3 more calls (device time by operator).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import torch

FLAG = "FSEG_FUSED_EDGE_TAIL"
CASES = ("static f32", "static bf16", "dynamic bf16", "stems bf16",
         "serving f32")


def build_cases(tmp: str, names=CASES, serving_cloud=None, device="cuda"):
    """{name: fn} for the cases `names`; fn() is one train step or one
    ensemble forward. `serving_cloud`: the (N, C) cloud of grid coordinates
    the ensemble reads (default: 20 000 points drawn from a seeded
    generator, uniform in [-1, 1]^3)."""
    from ..models import DGCNNSeg, ensemble_predict
    from ..train.profile_step import canonical_data, make_step
    ds, loss_fn = canonical_data(device)
    fns = {}
    for name in names:
        if name == "serving f32":
            model = DGCNNSeg(k=40, in_features=3, num_classes=ds.num_classes,
                             dynamic=False,
                             generator=torch.Generator().manual_seed(0))
            model = model.to(device).eval()
            pc = serving_cloud
            if pc is None:
                pc = torch.rand(20000, 3, generator=torch.Generator()
                                .manual_seed(0)) * 2 - 1
            pc = pc.to(device)

            def forward(model=model, pc=pc):
                # the subsets' draw is on the CPU (models/ensemble.py)
                gen = torch.Generator().manual_seed(0)
                return ensemble_predict(model, pc, generator=gen)
            fns[name] = forward
            continue
        kind, dt = name.split()
        fns[name] = make_step(
            ds, loss_fn, tmp, device=device,
            dtype=torch.bfloat16 if dt == "bf16" else None,
            dynamic=kind == "dynamic",
            **({"spatial_transformer": True, "image_feat_module": True}
               if kind == "stems" else {}))
    return fns


def _run_ms(fn, steps: int):
    """(ms per call between CUDA events, ms per call the host took to
    enqueue the calls, before the closing sync)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(steps):
        fn()
    b.record()
    host = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    return a.elapsed_time(b) / steps, host


def ab(fn, runs: int = 4, steps: int = 10, warm: int = 3) -> dict:
    """ms per call of `fn` with the tail on and off: `runs` runs of each in
    the order on, off, off, on, ...; returns {"on": [...], "off": [...],
    "on_median", "off_median", "on_over_off", "on_host_ms",
    "off_host_ms"} (the last two: the medians of the host's enqueue time
    a call). Leaves FSEG_FUSED_EDGE_TAIL as it found it."""
    before = os.environ.get(FLAG)
    try:
        for flag in ("1", "0"):
            os.environ[FLAG] = flag
            for _ in range(warm):
                fn()
        torch.cuda.synchronize()
        res = {"on": [], "off": []}
        host = {"on": [], "off": []}
        order = [("1", "0")[(i // 2 + i) % 2] for i in range(2 * runs)]
        for flag in order:
            os.environ[FLAG] = flag
            ms, host_ms = _run_ms(fn, steps)
            res["on" if flag == "1" else "off"].append(ms)
            host["on" if flag == "1" else "off"].append(host_ms)
    finally:
        if before is None:
            os.environ.pop(FLAG, None)
        else:
            os.environ[FLAG] = before
    res["on_median"] = statistics.median(res["on"])
    res["off_median"] = statistics.median(res["off"])
    res["on_over_off"] = res["on_median"] / res["off_median"]
    res["on_host_ms"] = statistics.median(host["on"])
    res["off_host_ms"] = statistics.median(host["off"])
    return res


def _profile(fn, calls: int = 3) -> str:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="self_device_time_total",
                                     row_limit=18, max_name_column_width=70)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=CASES)
    ap.add_argument("--profile", action="store_true",
                    help="print each setting's device time by operator")
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tail_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    from ..train.profile_step import card_line
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    results = {"card": card, "runs": args.runs, "steps": args.steps}
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.cases:
            fn = build_cases(tmp, (name,))[name]
            results[name] = ab(fn, args.runs, args.steps)
            print(json.dumps({"case": name, **results[name],
                              "card": card}), flush=True)
            if args.profile:
                for flag in ("1", "0"):
                    os.environ[FLAG] = flag
                    print(f"{name}, tail {'on' if flag == '1' else 'off'}:"
                          f" 3 calls", flush=True)
                    print(_profile(fn), flush=True)
                os.environ.pop(FLAG)
            del fn
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
