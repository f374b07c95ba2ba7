#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fissure_segmentation_tpu_torch) on
one NVIDIA card. Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero, nothing falls back to the CPU:
  1. card and settings: CUDA present, card name and power limit, TF32 off,
     the native C++ host runtime available;
  2. build every kernel from kernels/csrc with nvcc (timed);
  3. K1 (kNN) against its plain PyTorch version on the card, at the two
     shapes the serving path gives it, a ragged N and a lattice full of
     ties: indices and distances must be equal; median times of both;
  4. the serving slice at full size: a synthetic 256^3 CT, DGCNNSeg(k=40)
     with seeded random weights and a coordinate-keyed class bias added
     after the full forward (untrained weights put every keypoint in one
     class), segment_case with its defaults — one warm-up, then timed
     cases; checks keypoints, per-class meshes, labelmap, finiteness, and
     that every case launched K1 at least 11 times (10 ensemble groups +
     the normals);
  5. reference check on a small input: the same slice at 128^3 on the card
     (kernels) and on the CPU (plain versions) must agree.

The line before the last is a JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KNN_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/knn.cu"
KNN_REPLACES = "fissure_segmentation_tpu/ops/pallas/knn.py:158"
SHAPE = (256, 256, 256)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def phase_kernels(knn_cuda, knn_plain):
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    lattice = torch.randint(0, 6, (3, 4096, 3), generator=g).float()
    lattice[:, :800] = -1.0
    cases = {
        # name: (x, k, self_loop, timed)
        "dgcnn_graph_5x2048x3_k40": (
            torch.rand((5, 2048, 3), generator=g) * 2 - 1, 40, False, True),
        "psr_normals_3x8192x3_k30": (
            torch.rand((3, 8192, 3), generator=g) * 2 - 1, 30, True, True),
        "ragged_2x1000x3_k16": (
            torch.rand((2, 1000, 3), generator=g) * 2 - 1, 16, False, False),
        "lattice_ties_3x4096x3_k30": (lattice, 30, True, False),
    }
    max_err, timings = 0.0, {}
    for name, (x, k, self_loop, timed) in cases.items():
        x = x.to(dev)
        i_k, d_k = knn_cuda(x, k, self_loop)
        torch.cuda.synchronize()
        i_p, d_p = knn_plain(x, k, self_loop)
        torch.cuda.synchronize()
        if not (torch.equal(i_k, i_p) and torch.equal(d_k, d_p)):
            raise AssertionError(f"K1 {name}: kernel differs from plain "
                                 f"({(i_k != i_p).sum().item()} indices)")
        err = (d_k - d_p).abs().max().item()
        max_err = max(max_err, err)
        line = f"K1 {name}: kernel == plain (indices, distances)"
        if timed:
            t_k = median_ms(lambda: knn_cuda(x, k, self_loop))
            t_p = median_ms(lambda: knn_plain(x, k, self_loop))
            timings[name] = {"ms": t_k, "plain_ms": t_p}
            line += f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median)"
        print(line, flush=True)
    return max_err, timings


def biased_model(model, case, shape):
    """bench.py's class bias: keypoints in a z-band around each synthetic
    fissure sheet, on its lung's side, get +50 on that class's logit."""
    from fissure_segmentation_tpu_torch.data.synthetic import \
        sample_fissure_surface
    from fissure_segmentation_tpu_torch.serving import kpts_to_grid
    rng = np.random.default_rng(11)
    scale = np.array(shape[::-1], np.float32) - 1
    bands = []
    for c in (1, 2, 3):
        s = sample_fissure_surface(case["surface_params"], c, 2000, rng)
        gc = kpts_to_grid(torch.from_numpy((s * scale).astype(np.float32)),
                          shape).numpy()
        bands.append((float(gc[:, 2].mean()), float(2 * gc[:, 2].std() + 0.02),
                      float(np.sign(gc[:, 0].mean()))))

    def apply(x):
        logits = model(x)
        z, xg = x[..., 2], x[..., 0]
        bias = torch.zeros_like(logits)
        for c, (mu, w, side) in enumerate(bands, start=1):
            bias[..., c] = 50.0 * ((z - mu).abs() < w) * (xg * side > 0)
        return logits + bias
    return apply


def check_result(res, shape, what: str):
    if len(res.kpts) == 0:
        raise AssertionError(f"{what}: no valid keypoints")
    for c, (tris, valid) in enumerate(res.meshes, start=1):
        if int(valid.sum()) == 0:
            raise AssertionError(f"{what}: class {c} has no valid triangles")
        if tris.ndim != 3 or tris.shape[1:] != (3, 3) or \
                not np.isfinite(tris[valid]).all():
            raise AssertionError(f"{what}: class {c} triangles malformed")
    if res.labelmap.shape != shape or not (res.labelmap > 0).any():
        raise AssertionError(f"{what}: empty or misshapen labelmap")


def phase_slice(knn_cuda, card: str):
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    from fissure_segmentation_tpu_torch.serving import segment_case
    t0 = time.perf_counter()
    case = make_synthetic_image_case(0, shape=SHAPE)
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    model = DGCNNSeg(k=40, in_features=3, num_classes=4,
                     generator=torch.Generator().manual_seed(0)).cuda().eval()
    apply = biased_model(model, case, SHAPE)
    print(f"slice: synthetic {SHAPE} case made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def run(seed):
        return segment_case(vol, mask, apply, torch.Generator().manual_seed(seed),
                            center_x=SHAPE[2] / 2)

    t0 = time.perf_counter()
    check_result(run(1), SHAPE, "warm-up case")
    print(f"slice: warm-up case {time.perf_counter() - t0:.3f} s", flush=True)

    n_cases = 10
    knn_cuda.launches = 0
    times = []
    for i in range(n_cases):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(2 + i)
        times.append(time.perf_counter() - t0)
        check_result(res, SHAPE, f"case {i}")
    launches = knn_cuda.launches
    if launches < 11 * n_cases:
        raise AssertionError(f"K1 launched {launches} times in {n_cases} "
                             f"cases; the path needs >= {11 * n_cases}")
    tri = [int(v.sum()) for _, v in res.meshes]
    print(f"slice: {len(res.kpts)} valid keypoints, labels "
          f"{np.bincount(res.labels, minlength=4).tolist()}, valid triangles "
          f"per class {tri}, labelmap voxels per class "
          f"{np.bincount(res.labelmap.ravel(), minlength=4)[1:].tolist()}",
          flush=True)
    print(f"slice: K1 launches in {n_cases} timed cases: {launches}",
          flush=True)
    print(f"slice: {statistics.median(times):.4f} s/case median of "
          f"{[round(t, 4) for t in times]} on {card}", flush=True)
    return launches


def phase_reference(card: str):
    """Small input: the slice on the card (kernels) vs on the CPU (plain
    versions), same weights, same subsets."""
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    from fissure_segmentation_tpu_torch.serving import segment_case
    shape = (128, 128, 128)
    case = make_synthetic_image_case(1, shape=shape)
    model = DGCNNSeg(k=40, in_features=3, num_classes=4,
                     generator=torch.Generator().manual_seed(3)).eval()
    cfg = dict(max_kpts=4000, sample_points=512, n_runs_min=8,
               subset_batch=2, grid_res=(32, 32, 32), center_x=shape[2] / 2)
    out = {}
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        out[dev] = segment_case(case["image"], case["lung_mask"],
                                biased_model(m, case, shape),
                                torch.Generator().manual_seed(4), device=dev,
                                **cfg)
    a, b = out["cuda"], out["cpu"]
    if not np.array_equal(a.kpts, b.kpts):
        raise AssertionError("reference: keypoints differ card vs CPU")
    agree = float((a.labels == b.labels).mean())
    if agree < 0.99:
        raise AssertionError(f"reference: labels agree on {agree:.4f} only")
    for c, ((t1, v1), (t2, v2)) in enumerate(zip(a.meshes, b.meshes), 1):
        n1, n2 = int(v1.sum()), int(v2.sum())
        if abs(n1 - n2) > max(8, 0.05 * max(n1, n2)):
            raise AssertionError(f"reference: class {c} triangles {n1} vs {n2}")
        x, y = a.labelmap == c, b.labelmap == c
        if x.any() or y.any():
            dice = 2 * (x & y).sum() / (x.sum() + y.sum())
            if dice < 0.9:
                raise AssertionError(f"reference: class {c} Dice {dice:.3f}")
    print(f"reference: {shape} card vs CPU: keypoints equal "
          f"({len(a.kpts)}), labels agree {agree:.4f}, triangles per class "
          f"{[int(v.sum()) for _, v in a.meshes]} vs "
          f"{[int(v.sum()) for _, v in b.meshes]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA card", file=sys.stderr)
        return 2
    from fissure_segmentation_tpu_torch.kernels import _build
    from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda, knn_plain
    from fissure_segmentation_tpu_torch.postprocess.surface_fitting import \
        native_runtime

    # 1. card and settings
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    native_runtime()  # raises if the native C++ host runtime is unavailable

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"build: {_build.sources()} -> {lib} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain versions
    max_err, timings = phase_kernels(knn_cuda, knn_plain)

    # 4. the slice at full size
    launches = phase_slice(knn_cuda, card)

    # 5. reference check on a small input
    phase_reference(card)

    graph = timings["dgcnn_graph_5x2048x3_k40"]
    print(json.dumps({"kernels": [{
        "name": "knn", "route": "cuda", "source": KNN_SOURCE,
        "replaces": KNN_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": graph["ms"],
        "plain_ms": graph["plain_ms"], "shapes": timings}]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
