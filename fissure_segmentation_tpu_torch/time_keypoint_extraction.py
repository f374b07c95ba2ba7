"""Per-mode keypoint and feature extraction timing (counterpart of
time_keypoint_extraction.py).

    python -m fissure_segmentation_tpu_torch.time_keypoint_extraction \\
        --synthetic 2 --shape 256 --output OUT [--modes foerstner cnn ...]

Times the Förstner, enhancement and cnn keypoint modes and the MIND,
MIND-SSC and patch features of each case of a processed dataset
(`--data_dir`, its *_img_*.npz files) or of synthetic cases, and writes
one CSV a mode with the mean and standard deviation (`write_times`: the
JAX entry's names and columns) into `--output`. The cnn mode runs a seeded
MobileNetASPP(num_classes=4) in bfloat16 (`predict_full_volume(dtype=
torch.bfloat16)`) and then `get_cnn_keypoints`. On a card each unit is
timed by CUDA events recorded before and after it on the stream (the time
its work held the stream, host gaps between its launches included); on the
CPU by the host clock. The first call for each (mode, volume shape) is
thrown away, as the JAX entry throws away its compile. Runs on the card
unless `main` is given ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from glob import glob

import numpy as np
import torch

NAMES = {"foerstner": "foerstner_kpts.csv",
         "enhancement": "enhancement_kpts.csv", "cnn": "cnn_kpts.csv",
         "mind": "mind_feat.csv", "ssc": "ssc_feat.csv",
         "patch": "patch_feat.csv"}


def write_times(out_filename: str, times, num_points=None) -> None:
    """One-row mean/std CSV (time_keypoint_extraction.py:write_times)."""
    times = np.asarray(times, np.float64)
    with open(out_filename, "w", newline="") as f:
        w = csv.writer(f)
        header = ["Inference", "Inference_std"]
        row = [times.mean() if len(times) else float("nan"),
               times.std() if len(times) else float("nan")]
        if num_points is not None:
            header += ["points", "points_std"]
            npts = np.asarray(num_points, np.float64)
            row += [npts.mean(), npts.std()]
        w.writerow(header)
        w.writerow(row)


def _seconds(fn, device: torch.device):
    """(fn's output, its seconds): CUDA events on a card, the host clock
    on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def _cases(args) -> list:
    if args.data_dir:
        cases = []
        for path in sorted(glob(os.path.join(args.data_dir, "*_img_*.npz"))):
            with np.load(path) as z:
                cases.append((z["image"], z["lung_mask"]))
        return cases
    from .data.synthetic import make_synthetic_image_case
    return [(c["image"], c["lung_mask"]) for c in (
        make_synthetic_image_case(i, shape=(args.shape,) * 3)
        for i in range(args.synthetic or 3))]


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_dir", default=None,
                        help="folder of processed *_img_*.npz cases")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="generate N synthetic cases instead")
    parser.add_argument("--shape", type=int, default=128,
                        help="synthetic volume edge length")
    parser.add_argument("--output", default="results/preproc_timing")
    parser.add_argument("--modes", nargs="+", default=list(NAMES))
    args = parser.parse_args(argv)

    from .keypoints.extraction import (MAX_KPTS, get_cnn_keypoints,
                                       get_enhancement_keypoints)
    from .keypoints.features import descriptor_at_keypoints, mind
    from .keypoints.foerstner import foerstner_keypoints
    from .keypoints.hessian import hessian_fissure_enhancement
    from .models import MobileNetASPP, predict_full_volume
    from .utils.coords import kpts_to_grid
    from .utils.device import resolve_device
    from .utils.sampling import sample_patches_at_kpts

    dev = resolve_device(device, "time_keypoint_extraction")
    os.makedirs(args.output, exist_ok=True)
    cases = _cases(args)
    if not cases:
        raise FileNotFoundError("no cases found")
    cnn = None
    if "cnn" in args.modes:
        cnn = MobileNetASPP(num_classes=4, generator=torch.Generator()
                            .manual_seed(0)).to(dev).eval()

    timers: dict[str, list] = {m: [] for m in args.modes}
    kpt_counts: dict[str, list] = {}
    seen: set = set()   # (mode, shape) pairs whose first call was dropped

    def timed(key, fn, shape):
        out, seconds = _seconds(fn, dev)
        recorded = (key, shape) in seen
        if recorded:
            timers[key].append(seconds)
        seen.add((key, shape))
        return out, recorded

    need_kpts = bool({"foerstner", "mind", "ssc", "patch"} & set(args.modes))
    with torch.no_grad():
        for i, (img_np, mask_np) in enumerate(cases):
            img = torch.as_tensor(np.asarray(img_np, np.float32), device=dev)
            mask = torch.as_tensor(np.asarray(mask_np) > 0, device=dev)
            shape = tuple(img.shape)

            if need_kpts:
                # sigma 0.5, NMS d = 5, threshold 1e-8 (keypoints/
                # extraction.py's Förstner mode)
                def run_foerstner():
                    return foerstner_keypoints(img, mask, sigma=0.5, d=5,
                                               thresh=1e-8,
                                               max_kpts=MAX_KPTS)
                if "foerstner" in args.modes:
                    (kp, valid, _), recorded = timed(
                        "foerstner", run_foerstner, shape)
                    if recorded:
                        kpt_counts.setdefault("foerstner", []).append(
                            int(valid.sum()))
                else:
                    kp, valid, _ = run_foerstner()
            if "enhancement" in args.modes:
                timed("enhancement", lambda: get_enhancement_keypoints(
                    hessian_fissure_enhancement(img, -313.5, 62.6)), shape)
            if "cnn" in args.modes:
                gen = torch.Generator(device=dev).manual_seed(i)

                def run_cnn():
                    soft = predict_full_volume(cnn, img,
                                               dtype=torch.bfloat16)
                    return get_cnn_keypoints(soft, mask, max_kpts=MAX_KPTS,
                                             generator=gen)
                timed("cnn", run_cnn, shape)
            if need_kpts:
                kpg = kpts_to_grid(kp.flip(-1).to(torch.float32), shape)
                if "mind" in args.modes:
                    timed("mind", lambda: descriptor_at_keypoints(
                        mind(img, ssc=False), kpg), shape)
                if "ssc" in args.modes:
                    timed("ssc", lambda: descriptor_at_keypoints(
                        mind(img, ssc=True), kpg), shape)
                if "patch" in args.modes:
                    timed("patch", lambda: sample_patches_at_kpts(
                        img, kpg, 5), shape)

    for mode, ts in timers.items():
        if not ts:
            continue
        write_times(os.path.join(args.output, NAMES[mode]), ts,
                    num_points=kpt_counts.get(mode))
        print(f"{mode}: {np.mean(ts):.4f} +- {np.std(ts):.4f} s "
              f"({len(ts)} cases)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
