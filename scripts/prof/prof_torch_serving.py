"""Where the time of the PyTorch port's serving slice goes, on one NVIDIA card.

Run from the repository root on the card's machine:

    python scripts/prof/prof_torch_serving.py [--cases 3] [--ab 0] [--trace PATH]
        [--kp_mode foerstner|cnn|enhancement]

Prints, for the full-size chip_smoke.py case (synthetic 256^3 CT, DGCNNSeg
k=40 with seeded weights and the bench-style class bias, segment_case
defaults; in kp_mode "cnn" chip_smoke's seeded MobileNetASPP runs on the
CT, in kp_mode "enhancement" the intensity weighting is chip_smoke's for
the synthetic intensities):
  * per-stage wall time with a device sync between stages (keypoints —
    in cnn mode the CNN forward and the keypoint selection apart —
    ensemble, device surface fit, device->host copy, host mesh filter +
    labelmap), median over --cases warm cases;
  * the median wall time of --cases unstaged warm cases (segment_case as
    a user calls it);
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

import numpy as np
import torch
from torch.autograd import DeviceType
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
                                                   ensemble_predict,
                                                   predict_full_volume)
from fissure_segmentation_tpu_torch.postprocess.surface_fitting import (  # noqa: E402
    _host_mesh_filter, batched_psr_mc, mesh_to_labelmap)
from fissure_segmentation_tpu_torch.serving import (_keypoints,  # noqa: E402
                                                    kpts_to_grid,
                                                    segment_case)

# chip_smoke phase 14's weighting for the synthetic CT's intensities
ENHANCEMENT = dict(fissure_mu=-0.25, fissure_sigma=0.1)


def staged_case(vol, mask, apply, seed, kp_mode="foerstner", cnn=None):
    """segment_case's steps with a sync after each; returns stage seconds."""
    t = {}
    sync = torch.cuda.synchronize
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        kp_vol = vol
        if kp_mode == "cnn":
            kp_vol = predict_full_volume(cnn, vol)
            sync()
            t["cnn_forward"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        kpts, valid, _ = _keypoints(kp_vol, mask, gen, kp_mode=kp_mode,
                                    max_kpts=20000, cnn_model=None,
                                    cnn_dtype=None, kp_scores=None,
                                    approx_top_k=False, **ENHANCEMENT)
        coords = torch.where(valid[:, None],
                             kpts_to_grid(kpts.flip(-1).float(), vol.shape),
                             -1.0)
        sync()
        t["keypoints"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = ensemble_predict(apply, coords, generator=gen).argmax(-1)
        sync()
        t["ensemble"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cv = torch.stack([valid & (pred == c) for c in (1, 2, 3)])
        inside, tris, n_tris = batched_psr_mc(coords.flip(-1), cv,
                                              (64, 64, 64), 4.0, 30, 24000)
        sync()
        t["surface_fit_device"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kpts, valid, pred, inside, tris, n_tris = (
            a.cpu().numpy() for a in (kpts, valid, pred, inside, tris, n_tris))
        t["device_to_host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    world = kpts[:, ::-1].astype(np.float32)
    meshes = []
    for i in range(3):
        pts_c = world[valid & (pred == i + 1)]
        n = int(n_tris[i])
        meshes.append(_host_mesh_filter(
            inside[i], tris[i, :n], np.ones(n, bool), pts_c, SHAPE,
            (64, 64, 64), None, 1, [False, True, True][i], SHAPE[2] / 2,
            True))
    t["host_filter"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_to_labelmap(meshes, SHAPE)
    t["host_labelmap"] = time.perf_counter() - t0
    return t


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
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
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
    stages = [staged_case(vol, mask, apply, 2 + i, args.kp_mode, cnn)
              for i in range(args.cases)]
    print(f"kp_mode {args.kp_mode}: stages, median of {args.cases} warm "
          f"cases, on {card}:")
    for k in stages[0]:
        print(f"  {k:20s} {statistics.median(s[k] for s in stages):.4f} s")
    print(f"  {'sum':20s} "
          f"{statistics.median(sum(s.values()) for s in stages):.4f} s")

    walls = []
    for i in range(args.cases):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full(20 + i)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"unstaged: {wall:.4f} s/case median of "
          f"{[round(w, 4) for w in walls]} on {card}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        full(9)
        torch.cuda.synchronize()
    # kernels only: CPU-side op rows repeat their kernels' device time
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6
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
