"""DSEG-AE at test time: a trained segmentation model regularized by a
trained point-cloud autoencoder (counterpart of
dseg_ae_regularization.py).

    python -m fissure_segmentation_tpu_torch.dseg_ae_regularization \\
        --ds synthetic --seg_dir SEG --ae_dir AE --output OUT \\
        [--sampling farthest|accumulate] [--pad_with_random_offsets]

Per fold directory of `--seg_dir`, both models are loaded from their
cross-validation directories, written by either package (`model.pt`, or
the JAX package's `model.fst`); each validation case is segmented by the
50-subset ensemble, each fissure class sampled and reconstructed by the
PC-AE (models/dseg_ae.py), and the reconstructions are held against the
GT surfaces (Chamfer distance in grid coordinates) while the whole chain
is timed: fold*/ae_reg_results.csv, fold*/inference_time.csv and
cv_results.csv in the JAX entry's layouts. Case i draws from a CPU
generator seeded with i. Everything runs on CUDA card `--gpu`; without a
card it raises, unless the caller of `run` or `main` passes
``device="cpu"``.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .cli import get_ae_reg_parser, load_args_dict
from .data.dataset import PointDataset, load_split_file
from .data.synthetic import make_synthetic_dataset
from .losses import chamfer_distance
from .models.dgcnn import DGCNNSeg
from .models.dseg_ae import RegularizedSegDGCNN
from .models.folding_net import DGCNNFoldingNet
from .models.weights import load_fold_model
from .train.evaluation import write_speed_results
from .utils.coords import kpts_to_grid
from .utils.device import resolve_device


def default_device(args) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("dseg_ae_regularization: no CUDA card found; "
                           "pass device='cpu' to run() or main() to run on "
                           "the CPU")
    return torch.device("cuda", args.gpu)


def build_dataset(args, seg_args: dict) -> PointDataset:
    pts = seg_args.get("pts", 2048)
    if args.ds == "synthetic" or args.data_dir is None:
        # train_point_seg's synthetic cases carry 1 feature channel
        cases = make_synthetic_dataset(20, n_points=8000, gt_surfaces=True,
                                       with_feature=True)
        return PointDataset(cases, sample_points=pts,
                            exclude_rhf=seg_args.get("exclude_rhf", False),
                            binary=seg_args.get("binary", False))
    return PointDataset.from_folder(args.data_dir, sample_points=pts)


def evaluate_fold(ds: PointDataset, model: RegularizedSegDGCNN,
                  out_dir: str, device=None, draws: list | None = None):
    """Reconstruct every case of `ds`; ae_reg_results.csv (mean and std of
    the Chamfer distances, mean s/case) and inference_time.csv.

    :param device: where `model` is (default: the first CUDA card; the CPU
        only when asked for)
    :param draws: per case, the `draws` of RegularizedSegDGCNN.__call__
        (tests inject the JAX entry's)
    """
    device = resolve_device(device, "evaluate_fold")
    os.makedirs(out_dir, exist_ok=True)
    chamfers, times, reconstructed = [], [], []
    for i in range(len(ds)):
        x, _ = ds.get_full_pointcloud(i)
        x = torch.as_tensor(np.asarray(x, np.float32), device=device)
        t0 = time.perf_counter()
        outputs, _ = model(x, torch.Generator().manual_seed(i),
                           draws=None if draws is None else draws[i])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
        reconstructed.append(sum(o is not None for o in outputs))

        gt = ds.cases[i].get("gt_surfaces")
        for cls, out in enumerate(outputs, start=1):
            if out is None or gt is None or cls not in gt:
                continue
            verts = (out[0] if isinstance(out, tuple) else out).reshape(-1, 3)
            # GT surfaces are world xyz; the model's output is grid coords
            gt_grid = kpts_to_grid(torch.as_tensor(gt[cls], device=device),
                                   ds.cases[i]["shape"])
            chamfers.append(float(chamfer_distance(verts[None],
                                                   gt_grid[None])))

    mean = float(np.mean(chamfers)) if chamfers else float("nan")
    with open(os.path.join(out_dir, "ae_reg_results.csv"), "w") as f:
        f.write("mean_chamfer,std_chamfer,mean_time_s\n")
        f.write(f"{mean},{np.std(chamfers) if chamfers else 'nan'},"
                f"{np.mean(times)}\n")
    write_speed_results(out_dir, times)
    print(f"AE-reg chamfer: {mean:.5f}; {np.mean(times):.3f}s/case")
    return {"chamfer": mean, "chamfers": chamfers, "times": times,
            "reconstructed": reconstructed}


def run(args, device=None) -> list:
    """Test every fold of `--seg_dir`; returns the per-fold metrics."""
    device = default_device(args) if device is None else torch.device(device)
    os.makedirs(args.output, exist_ok=True)
    seg_args = load_args_dict(args.seg_dir)
    ae_args = load_args_dict(args.ae_dir)

    ds = build_dataset(args, seg_args)
    split_path = os.path.join(args.seg_dir, "cross_val_split.json")
    split = load_split_file(split_path) if os.path.exists(split_path) \
        else None

    fold_metrics = []
    folds = sorted(d for d in os.listdir(args.seg_dir)
                   if d.startswith("fold"))
    for fold_name in folds:
        fold = int(fold_name.replace("fold", ""))
        print(f"------------ FOLD {fold} ----------------------")
        seg = load_fold_model(os.path.join(args.seg_dir, fold_name),
                              DGCNNSeg).to(device)
        ae = load_fold_model(os.path.join(args.ae_dir, fold_name),
                             DGCNNFoldingNet).to(device)
        model = RegularizedSegDGCNN(
            seg, ae, n_points_seg=seg_args.get("pts", 2048),
            n_points_ae=ae_args.get("pts", 1024),
            sample_mode=args.sampling,
            random_extend=args.pad_with_random_offsets)
        val_ds = ds.split_data_set(split[fold])[1] if split is not None \
            else ds
        fold_metrics.append(evaluate_fold(
            val_ds, model, os.path.join(args.output, fold_name), device))

    vals = [m["chamfer"] for m in fold_metrics if np.isfinite(m["chamfer"])]
    if vals:
        with open(os.path.join(args.output, "cv_results.csv"), "w") as f:
            f.write("fold,chamfer\n")
            for i, m in enumerate(fold_metrics):
                f.write(f"{i},{m['chamfer']}\n")
            f.write(f"mean,{np.mean(vals)}\n")
    return fold_metrics


def main(argv=None, device=None) -> int:
    run(get_ae_reg_parser().parse_args(argv), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
