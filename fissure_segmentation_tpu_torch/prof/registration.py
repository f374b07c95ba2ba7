"""Where the time of the registration loops goes on an NVIDIA card:

    python -m fissure_segmentation_tpu_torch.prof.registration [--steps 5]

times `--steps` iterations of each loop at the sizes chip_smoke.py's
phases 45 and 46 give it after a warm-up (host clock, synced), then
profiles as many (torch.profiler, CPU and CUDA activity): the rigid CPD at
12 288 x 12 288 points, the deformable CPD at 4096 x 4096 and the dense
Adam registration on a (28, 128^3) feature volume (the 256^3 case's
half-resolution MIND-SSC and one-hot labels). The inputs are seeded random
clouds and features of those shapes (the loops' work does not depend on
the values). Prints, for each loop, the wall ms an iteration, the device
busy share (summed kernel time over wall time), the host synchronisations
an iteration (`torch.cuda.set_sync_debug_mode`) and the kernels with the
most device time. Raises without a card.
"""
from __future__ import annotations

import argparse
import time
import warnings

import torch

from ..shape_model import adam_registration as ar
from ..shape_model.registration import (register_cpd_deformable,
                                        register_cpd_rigid)
from ..train.profile_step import card_line


def _loops(g: torch.Generator) -> dict:
    """{name: fn(iterations)} over seeded inputs on the card."""
    def cloud(n):
        return torch.rand((n, 3), generator=g, device="cuda") * 160 + 48
    x_r, y_r, x_d, y_d = cloud(12288), cloud(12288), cloud(4096), cloud(4096)
    feat = torch.rand((28, 128, 128, 128), generator=g, device="cuda")
    feat_mov = feat + 0.1 * torch.rand(feat.shape, generator=g,
                                       device="cuda")
    return {"cpd_rigid_12288": lambda n: register_cpd_rigid(x_r, y_r,
                                                            max_iter=n),
            "cpd_deformable_4096": lambda n: register_cpd_deformable(
                x_d, y_d, max_iter=n),
            "adam_registration_128^3x28": lambda n: ar.dense_adam_registration(
                feat, feat_mov, iters=n)}


def _syncs(fn) -> int:
    """Host synchronisations of one call of fn."""
    seen = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            seen = [w for w in caught if "synchroniz" in str(w.message)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return len(seen)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("prof.registration needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    out = {}
    for name, fn in _loops(torch.Generator(device="cuda").manual_seed(0)
                           ).items():
        fn(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(args.steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.steps
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn(args.steps)
            torch.cuda.synchronize()
        avg = prof.key_averages()
        busy = sum(e.self_device_time_total for e in avg
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        busy = busy / 1e3 / args.steps
        top = sorted((e for e in avg if e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)[:8]
        syncs = _syncs(lambda: fn(args.steps)) / args.steps
        out[name] = {"wall_ms": wall, "device_ms": busy,
                     "busy_share": busy / wall, "syncs_per_iter": syncs,
                     "top_ms": {e.key[:60]: e.self_device_time_total
                                / 1e3 / args.steps for e in top}}
        print(f"{name}: {wall:.3f} ms an iteration, kernels {busy:.3f} ms "
              f"(busy {busy / wall:.3f}), {syncs:.1f} host syncs an "
              f"iteration, on {card}", flush=True)
        for k, v in out[name]["top_ms"].items():
            print(f"  {k:60s} {v:.3f}", flush=True)
    return out


if __name__ == "__main__":
    main()
