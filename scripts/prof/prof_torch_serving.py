"""Where the time of the PyTorch port's serving slice goes, on one NVIDIA card.

Run from the repository root on the card's machine:

    python scripts/prof/prof_torch_serving.py [--cases 3] [--ab 0] [--trace PATH]
        [--kp_mode foerstner|cnn|enhancement]

Prints, for the full-size chip_smoke.py case (synthetic 256^3 CT, DGCNNSeg
k=40 with seeded weights and the bench-style class bias, segment_case
defaults; in kp_mode "cnn" chip_smoke's seeded MobileNetASPP runs on the
CT, in kp_mode "enhancement" the intensity weighting is chip_smoke's for
the synthetic intensities):
  * the program's spans (utils/profiling.py: serving's stages, the CNN's
    depthwise layers, the EdgeConv kernels) of --cases unstaged warm cases
    (segment_case as a user calls it, the recorder on): each span's host ms
    a case and its count a case, median over the cases; the spans time the
    host's enqueue of the device half, which never waits for the card, and
    the host half, which waits for its outputs first ("serving.fetch");
  * the median wall time of those cases;
  * a torch.profiler table of one warm case: device time per kernel, and
    the summed kernel time against the unstaged median (the device's busy
    share);
  * K1's device time per launch at the two path shapes, from the profiler;
  * with --ab N, the eval EdgeConv routings against each other
    (FSEG_FUSED_EDGE=0: gather -> BatchNorm -> LeakyReLU -> max over k;
    =1: fused_edge_eval, max/min over k -> pointwise tail): N pairs in
    alternating order, each pair on the same subsets, of the ensemble
    stage timed with CUDA events and of whole cases on the host clock,
    plus the summed kernel time of one profiled ensemble stage per routing.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from chip_smoke import (SHAPE, _cnn_model, biased_model,  # noqa: E402
                        card_line)
from fissure_segmentation_tpu_torch.data.synthetic import \
    make_synthetic_image_case  # noqa: E402
from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda  # noqa: E402
from fissure_segmentation_tpu_torch.keypoints.foerstner import \
    foerstner_keypoints  # noqa: E402
from fissure_segmentation_tpu_torch.models import (DGCNNSeg,  # noqa: E402
                                                   ensemble_predict)
from fissure_segmentation_tpu_torch.serving import (kpts_to_grid,  # noqa: E402
                                                    segment_case)
from fissure_segmentation_tpu_torch.utils.profiling import (  # noqa: E402
    device_rows, recording)

# chip_smoke phase 14's weighting for the synthetic CT's intensities
ENHANCEMENT = dict(fissure_mu=-0.25, fissure_sigma=0.1)


def span_ms(records) -> dict:
    """{span name: (host ms summed over its spans, count)}, in the order
    the names first opened."""
    out: dict = {}
    for r in sorted(records, key=lambda r: r.start_ns):
        ms, n = out.get(r.name, (0.0, 0))
        out[r.name] = (ms + (r.end_ns - r.start_ns) * 1e-6, n + 1)
    return out


def routing_ab(vol, mask, apply, full, pairs: int, card: str) -> None:
    """Unfused against fused eval EdgeConvs in the ensemble and the case."""
    with torch.no_grad():
        kpts, valid, _ = foerstner_keypoints(vol, mask, sigma=0.5, d=5,
                                             thresh=1e-8, max_kpts=20000)
        coords = torch.where(valid[:, None],
                             kpts_to_grid(kpts.flip(-1).float(), vol.shape),
                             -1.0)

    def stage(seed):
        return ensemble_predict(apply, coords,
                                generator=torch.Generator().manual_seed(seed))
    names = {"0": "unfused", "1": "fused"}
    ev = {r: [] for r in names}
    wall = {r: [] for r in names}
    for r in names:  # warm both routings
        os.environ["FSEG_FUSED_EDGE"] = r
        stage(0)
    for p in range(pairs):
        for r in (("0", "1") if p % 2 == 0 else ("1", "0")):
            os.environ["FSEG_FUSED_EDGE"] = r
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            stage(100 + p)
            b.record()
            torch.cuda.synchronize()
            ev[r].append(a.elapsed_time(b))
            t0 = time.perf_counter()
            full(200 + p)
            wall[r].append(time.perf_counter() - t0)
    for r, name in names.items():
        os.environ["FSEG_FUSED_EDGE"] = r
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            stage(1)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total
                   for e in device_rows(prof.key_averages())) / 1e3
        print(f"routing {name}: ensemble stage {statistics.median(ev[r]):.3f}"
              f" ms (CUDA events, median of {pairs}: "
              f"{[round(t, 3) for t in ev[r]]}), summed kernel time "
              f"{busy:.3f} ms (profiler, one stage); whole case "
              f"{statistics.median(wall[r]):.4f} s/case (host clock, median "
              f"of {pairs}) on {card}", flush=True)
    os.environ.pop("FSEG_FUSED_EDGE")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", type=int, default=3)
    ap.add_argument("--ab", type=int, default=0,
                    help="pairs of the unfused/fused eval EdgeConv A/B")
    ap.add_argument("--trace", default=None,
                    help="write the profiler's chrome trace here")
    ap.add_argument("--kp_mode", default="foerstner",
                    choices=("foerstner", "cnn", "enhancement"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    case = make_synthetic_image_case(0, shape=SHAPE)
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    model = DGCNNSeg(k=40, in_features=3, num_classes=4, dynamic=False,
                     generator=torch.Generator().manual_seed(0)).cuda().eval()
    apply = biased_model(model, case, SHAPE)
    cnn = _cnn_model(0).cuda() if args.kp_mode == "cnn" else None
    kw = dict(kp_mode=args.kp_mode, cnn_model=cnn)
    if args.kp_mode == "enhancement":
        kw.update(ENHANCEMENT)

    def full(seed):
        return segment_case(vol, mask, apply,
                            torch.Generator().manual_seed(seed),
                            center_x=SHAPE[2] / 2, **kw)

    full(1)  # warm-up (builds the kernels, fills the caching allocator)
    walls, cases = [], []
    for i in range(args.cases):
        torch.cuda.synchronize()
        with recording() as records:
            t0 = time.perf_counter()
            full(20 + i)
            walls.append(time.perf_counter() - t0)
        cases.append(span_ms(records))
    print(f"kp_mode {args.kp_mode}: the program's spans, host ms a case "
          f"(median of {args.cases} unstaged warm cases) and spans a case, "
          f"on {card}:")
    for name in cases[0]:
        ms = statistics.median(c.get(name, (0.0, 0))[0] for c in cases)
        n = statistics.median(c.get(name, (0.0, 0))[1] for c in cases)
        print(f"  {name:20s} {ms:9.3f} ms  x{n:g}")
    wall = statistics.median(walls)
    print(f"unstaged: {wall:.4f} s/case median of "
          f"{[round(w, 4) for w in walls]} on {card}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        full(9)
        torch.cuda.synchronize()
    # kernels only: CPU-side op rows repeat their kernels' device time
    busy = sum(e.self_device_time_total
               for e in device_rows(prof.key_averages())) / 1e6
    print(f"profiled case: summed device kernel time {busy:.4f} s, busy "
          f"share of the unstaged median {busy / wall:.3f} on {card}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25, max_name_column_width=70))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    if args.ab:
        routing_ab(vol, mask, apply, full, args.ab, card)

    g = torch.Generator().manual_seed(0)
    for name, shape, k, self_loop in (("dgcnn_graph", (5, 2048, 3), 40, False),
                                      ("psr_normals", (3, 8192, 3), 30, True)):
        x = (torch.rand(shape, generator=g) * 2 - 1).cuda()
        knn_cuda(x, k, self_loop)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            for _ in range(10):
                knn_cuda(x, k, self_loop)
            torch.cuda.synchronize()
        ev = [e for e in p.key_averages() if "knn_kernel" in e.key]
        per = sum(e.device_time_total for e in ev) / 10 / 1e3
        print(f"K1 {name} {shape} k={k}: {per:.4f} ms device time per launch "
              f"(profiler) on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
