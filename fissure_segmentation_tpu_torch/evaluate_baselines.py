"""Evaluate external baseline predictions (e.g. nnU-Net labelmaps or
voxel2mesh surfaces) with the port's metric stack (counterpart of
evaluate_baselines.py):

    python -m fissure_segmentation_tpu_torch.evaluate_baselines \
        --result_dir PRED --data_dir DATA --output OUT \
        [--mode voxels|surface|subsample] [--split SPLIT]

For each predicted fissure labelmap (*.nii.gz, named {case}_..._{sequence})
and its ground truth in a reference-layout data directory: fit a surface
to each label's voxel cloud (`pointcloud_surface_fitting`: K1's normals,
the PSR grid and marching on the card, then the host filter), in
'subsample' mode after subsampling the cloud to a point budget ('surface'
is treated as 'voxels'), sample it, compute Dice and ASSD/SDSD/HD/HD95
against the ground truth, aggregate per fold and write the JAX entry's
CSVs (fold*/test_results_{mode}.csv, cv_results_{mode}.csv). It runs on
the first CUDA card, and raises without one unless `main(argv,
device="cpu")` asks for the CPU.

The subsample draws are numpy's (seeded `seed`), as in the JAX entry; the
surface samples of label L draw from a torch generator seeded `seed + L`
(JAX's PRNGKey(seed + L) cannot be replayed), or take `draws[L]`.
"""
from __future__ import annotations

import argparse
import os
import re
from glob import glob

import numpy as np
import torch

from .data.dataset import load_split_file
from .data.image_dataset import LungDataIndex
from .data.mesh_dataset import load_meshes
from .metrics import batch_dice, mesh_metrics_from_point_sets
from .ops.marching import sample_points_on_triangles
from .postprocess.surface_fitting import pointcloud_surface_fitting
from .train.evaluation import write_results
from .utils.device import resolve_device
from .utils.nifti import load_nifti
from .utils.profiling import stage


def find_test_fold_for_id(case: str, sequence: str, split: list) -> int:
    """(reference utils.general_utils.find_test_fold_for_id)"""
    for fold, s in enumerate(split):
        for entry in s["val"]:
            ident = entry if isinstance(entry, str) else "_".join(entry)
            if case in ident and (not isinstance(entry, (list, tuple))
                                  or sequence in ident):
                return fold
    raise ValueError(f"id {case}_{sequence} not in any validation split")


def parse_case_sequence(filename: str) -> tuple[str, str]:
    base = os.path.basename(filename).replace(".nii.gz", "")
    m = re.match(r"(COPD[0-1][0-9])([fm])", base)
    if m:
        return m.group(1), {"f": "fixed", "m": "moving"}[m.group(2)]
    parts = base.split("_")
    case, sequence = parts[0], parts[-1]
    # map the short forms; leave full names alone (a str.replace would turn
    # an already-full "fixed" into "fixeded")
    sequence = {"fix": "fixed", "mov": "moving"}.get(sequence, sequence)
    return case, sequence


def evaluate_prediction(pred_labels: np.ndarray, gt_surface_pts: dict,
                        mask: np.ndarray | None, shape,
                        mode: str = "voxels", pts_subsample: int = 20000,
                        n_fissures: int = 3, seed: int = 0, device=None,
                        draws: dict | None = None,
                        stages: dict | None = None):
    """One case: predicted labelmap -> per-class fitted surface -> metrics.

    :param draws: {label: (u (10000,), uv (10000, 2))} surface-sample
        uniforms to use instead of the generator's
    :param stages: optional dict of synced stage seconds ("fit", "sample",
        "metrics")
    :return: {label: {"assd", "sdsd", "hd", "hd95"} as floats, or None}
    """
    dev = resolve_device(device, "evaluate_prediction")
    rng = np.random.default_rng(seed)
    results = {}
    for lbl in range(1, n_fissures + 1):
        pts_zyx = np.argwhere(pred_labels == lbl)
        if len(pts_zyx) < 10 or lbl not in gt_surface_pts:
            results[lbl] = None
            continue
        pts_world = pts_zyx[:, ::-1].astype(np.float32)
        if mode.startswith("subsample") and len(pts_world) > pts_subsample:
            sel = rng.choice(len(pts_world), pts_subsample, replace=False)
            pts_world = pts_world[sel]
        with stage(stages, "fit", dev):
            tris, valid = pointcloud_surface_fitting(
                pts_world, shape, mask=mask, right=lbl > 1,
                center_x=shape[2] / 2, device=dev)
        if not np.any(valid):
            results[lbl] = None
            continue
        with stage(stages, "sample", dev):
            gen = None if draws is not None else \
                torch.Generator(device=dev).manual_seed(seed + lbl)
            pred_pts = sample_points_on_triangles(
                torch.as_tensor(tris, device=dev),
                torch.as_tensor(valid, device=dev), 10000, generator=gen,
                draws=None if draws is None else draws[lbl])
        with stage(stages, "metrics", dev):
            metrics = mesh_metrics_from_point_sets(
                pred_pts, torch.as_tensor(
                    np.asarray(gt_surface_pts[lbl], np.float32), device=dev))
            results[lbl] = dict(zip(("assd", "sdsd", "hd", "hd95"),
                                    (float(v) for v in metrics)))
    return results


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluate baseline (nnU-Net / voxel2mesh) predictions.")
    parser.add_argument("--result_dir", required=True,
                        help="directory of predicted fissure labelmaps (*.nii.gz)")
    parser.add_argument("--data_dir", required=True,
                        help="reference-layout data directory (GT)")
    parser.add_argument("--output", default="./results/baselines")
    parser.add_argument("--split", default=None, help="cross-val split file")
    parser.add_argument("--mode", default="voxels",
                        choices=["voxels", "surface", "subsample"])
    parser.add_argument("--pts_subsample", type=int, default=20000)
    parser.add_argument("--n_fissures", type=int, default=3)
    return parser


def main(argv=None, device=None, draws: dict | None = None,
         stages: dict | None = None) -> None:
    """Run the entry.

    :param draws: {(case, sequence): evaluate_prediction's draws}
    :param stages: optional dict of synced stage seconds (those of
        evaluate_prediction and "io", the reading of the files)
    """
    args = get_parser().parse_args(argv)
    dev = resolve_device(device, "evaluate_baselines")
    index = LungDataIndex(args.data_dir)
    split = load_split_file(args.split) if args.split else None
    files = sorted(glob(os.path.join(args.result_dir, "*.nii.gz")))
    if not files:
        raise FileNotFoundError(f"no prediction labelmaps in {args.result_dir}")

    n_folds = len(split) if split else 1
    per_fold = {f: [] for f in range(n_folds)}
    for f in files:
        case, sequence = parse_case_sequence(f)
        fold = find_test_fold_for_id(case, sequence, split) if split else 0
        per_fold[fold].append((f, case, sequence))

    all_rows = []
    for fold in range(n_folds):
        out_dir = os.path.join(args.output, f"fold{fold}")
        os.makedirs(out_dir, exist_ok=True)
        dices, assds, sdsds, hds, hd95s, missing = [], [], [], [], [], []
        for f, case, sequence in per_fold[fold]:
            with stage(stages, "io", dev):
                pred = load_nifti(f).array.astype(np.int32)
                i = index.get_index(case, sequence)
                gt = index.get_fissures(i)
                mask_img = index.get_lung_mask(i)
                mask = None if mask_img is None else mask_img.array > 0
                gt_arr = None if gt is None else gt.array.astype(np.int32)

                # GT surfaces from meshes if present, else from GT label
                # voxels
                gt_pts = {}
                meshes = load_meshes(args.data_dir, case, sequence)
            if meshes:
                for lbl, soup in enumerate(meshes, start=1):
                    gt_pts[lbl] = soup.reshape(-1, 3)[:20000]
            elif gt_arr is not None:
                for lbl in range(1, args.n_fissures + 1):
                    p = np.argwhere(gt_arr == lbl)[:, ::-1].astype(np.float32)
                    if len(p):
                        gt_pts[lbl] = p

            case_res = evaluate_prediction(
                pred, gt_pts, mask, pred.shape, mode=args.mode,
                pts_subsample=args.pts_subsample,
                n_fissures=args.n_fissures, device=dev,
                draws=None if draws is None else draws[(case, sequence)],
                stages=stages)
            row_assd, row_sdsd, row_hd, row_hd95, row_miss = [], [], [], [], []
            for lbl in range(1, args.n_fissures + 1):
                r = case_res.get(lbl)
                if r is None:
                    row_assd.append(np.nan); row_sdsd.append(np.nan)
                    row_hd.append(np.nan); row_hd95.append(np.nan)
                    row_miss.append(100.0)
                else:
                    row_assd.append(r["assd"])
                    row_sdsd.append(r["sdsd"])
                    row_hd.append(r["hd"])
                    row_hd95.append(r["hd95"])
                    row_miss.append(0.0)
            assds.append(row_assd); sdsds.append(row_sdsd)
            hds.append(row_hd); hd95s.append(row_hd95); missing.append(row_miss)

            if gt_arr is not None and gt_arr.shape == pred.shape:
                d = batch_dice(
                    torch.as_tensor(pred.reshape(1, -1), device=dev),
                    torch.as_tensor(gt_arr.reshape(1, -1), device=dev),
                    args.n_fissures + 1)
                dices.append(d.cpu().numpy()[1:])

        def _nm(x):
            a = np.asarray(x, float)
            # ddof=1: the reference writes torch.std (unbiased) into CSVs
            return np.nanmean(a, axis=0), \
                np.nanstd(a, axis=0, ddof=1 if len(a) > 1 else 0)

        mean_dice, std_dice = _nm(dices) if dices else (np.full(args.n_fissures, np.nan),) * 2
        mean_assd, std_assd = _nm(assds)
        mean_sdsd, std_sdsd = _nm(sdsds)
        mean_hd, std_hd = _nm(hds)
        mean_hd95, std_hd95 = _nm(hd95s)
        write_results(os.path.join(out_dir, f"test_results_{args.mode}.csv"),
                      mean_dice, std_dice, mean_assd, std_assd, mean_sdsd,
                      std_sdsd, mean_hd, std_hd, mean_hd95, std_hd95,
                      proportion_missing=np.nanmean(np.asarray(missing), 0))
        all_rows.append({"assd": np.nanmean(mean_assd),
                         "dice": np.nanmean(mean_dice)})
        print(f"fold {fold}: ASSD {np.nanmean(mean_assd):.3f}, "
              f"Dice {np.nanmean(mean_dice):.3f}")

    with open(os.path.join(args.output, f"cv_results_{args.mode}.csv"), "w") as f:
        f.write("fold,assd,dice\n")
        for i, r in enumerate(all_rows):
            f.write(f"{i},{r['assd']},{r['dice']}\n")


if __name__ == "__main__":
    main()
