"""End-to-end test pipeline and result CSV writers (counterpart of
train/evaluation.py).

Per case: ensembled full-cloud prediction on the model's device, per-class
point extraction, the surface fit (kNN-PCA normals through K1, spectral
PSR, marching tetrahedra, the native host filter), label Dice and the mesh
distances (ASSD / SDSD / HD / HD95) against the case's GT surface samples,
NaN rows for fissures that could not be fitted, then mean/std CSVs in the
JAX package's layout.

Random draws: the ensemble's subsets come from one CPU `torch.Generator`
seeded with `seed`, drawn case after case (the JAX package splits a
PRNGKey(seed) per case); the surface samples of class c from a generator
seeded with `seed + c` (JAX: PRNGKey(seed + c)). `draws` injects both
instead, per case (tests inject the JAX package's).

The inference clock stops after `torch.cuda.synchronize()` (JAX: after
`block_until_ready`); the copy of the labels to the host is not timed.
The "lobes" label space turns lobe predictions into fissure labels by the
random-walk fill on the device (`lobe_points_to_fissure_labels`); its cases
must carry ``fissure_labels`` and ``lung_mask``, as in the JAX package.
"""
from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from ..data.dataset import PointDataset
from ..metrics import batch_dice, mesh_metrics_from_point_sets
from ..models.ensemble import ensemble_predict
from ..ops.marching import sample_points_on_triangles
from ..postprocess.surface_fitting import (mesh_to_labelmap,
                                           pointcloud_surface_fitting)
from ..utils.coords import kpts_to_world
from ..utils.device import resolve_device
from ..utils.mesh_viewer import export_mesh_viewer
from ..utils.nifti import save_nifti
from ..utils.objio import save_obj
from ..utils.visualization import matplotlib_available, plot_point_cloud


def binary_to_fissure_labels(pred_binary: np.ndarray, pts_idx_zyx: np.ndarray,
                             lung_lr: np.ndarray) -> np.ndarray:
    """Binary fissure prediction -> left/right fissure labels through the
    left (1) / right (2) lung mask; points outside the lung get label 0.

    :param pred_binary: (N,) 0/1 predictions
    :param pts_idx_zyx: (N, 3) int voxel indices into lung_lr
    :param lung_lr: (D, H, W) 0 background / 1 left / 2 right
    """
    idx = np.clip(pts_idx_zyx, 0, np.asarray(lung_lr.shape) - 1)
    lr = np.asarray(lung_lr)[idx[:, 0], idx[:, 1], idx[:, 2]]
    return np.where(np.asarray(pred_binary) > 0, lr, 0).astype(np.int32)


def lobe_points_to_fissure_labels(pred_lobes: np.ndarray,
                                  pts_idx_zyx: np.ndarray,
                                  lung_mask: np.ndarray, cg_iters: int = 300,
                                  device=None):
    """Sparse lobe predictions at the points -> fissure labels at the
    points: the point labels voxelized as random-walk seeds, the lung
    filled on `device` (postprocess/random_walk.py:lobes_to_fissures), the
    fissure map read back at the points.

    :param device: the card unless asked for the CPU
    :return: (pred_fissure_labels (N,) int32, fissure_map (D, H, W) uint8)
    """
    from ..postprocess.random_walk import lobes_to_fissures
    device = resolve_device(device, "lobe_points_to_fissure_labels")
    shape = np.asarray(lung_mask).shape
    sparse = np.zeros(shape, np.int32)
    idx = np.clip(pts_idx_zyx, 0, np.asarray(shape) - 1)
    sparse[idx[:, 0], idx[:, 1], idx[:, 2]] = np.asarray(pred_lobes)
    fis, _ = lobes_to_fissures(
        torch.as_tensor(sparse, device=device),
        torch.as_tensor(np.asarray(lung_mask, bool), device=device),
        cg_iters=cg_iters)
    fis = fis.cpu().numpy()
    return fis[idx[:, 0], idx[:, 1], idx[:, 2]].astype(np.int32), fis


def evaluate_case(pred_labels: np.ndarray, coords_grid: np.ndarray, case: dict,
                  num_classes: int, grid_res=(64, 64, 64),
                  n_metric_samples: int = 4000, seed: int = 42, device=None,
                  surface_draws: dict | None = None):
    """Post-process one case: per-fissure surface fit and mesh metrics.

    :param device: where the fit and the metrics run (default: the first
        CUDA card; without one it raises, the CPU only when asked for)
    :param surface_draws: {class: (u, uv)} uniforms for
        `sample_points_on_triangles` instead of the generator seeded with
        `seed + class`
    :return: dict with 'assd', 'sdsd', 'hd', 'hd95' (num_classes - 1,)
        float64 arrays (NaN where the fit failed), 'missing' (bool) and
        'meshes' (the fitted (tris, valid) per fissure class, or None)
    """
    device = resolve_device(device, "evaluate_case")
    shape = case["shape"]
    n_f = num_classes - 1
    out = {k: np.full(n_f, np.nan) for k in ("assd", "sdsd", "hd", "hd95")}
    out["missing"] = np.ones(n_f, bool)
    out["meshes"] = [None] * n_f
    gt_surfaces = case.get("gt_surfaces")
    for c in range(1, num_classes):
        pts = coords_grid[pred_labels == c]
        if pts.shape[0] < 4:
            continue
        pts_world = kpts_to_world(np.asarray(pts, np.float32), shape)
        try:
            tris, valid = pointcloud_surface_fitting(
                pts_world, shape, grid_res=grid_res, right=c > 1,
                center_x=shape[2] / 2, device=device)
        except ValueError:
            continue       # fewer points than the normals' neighbourhood
        if not valid.any():
            continue
        out["missing"][c - 1] = False
        out["meshes"][c - 1] = (tris, valid)
        if gt_surfaces is None or c not in gt_surfaces:
            continue
        pred_samples = sample_points_on_triangles(
            torch.from_numpy(tris).to(device),
            torch.from_numpy(valid).to(device), n_metric_samples,
            generator=torch.Generator().manual_seed(seed + c),
            draws=None if surface_draws is None else surface_draws[c])
        gt = torch.as_tensor(np.asarray(gt_surfaces[c]), dtype=torch.float32,
                             device=device)
        values = mesh_metrics_from_point_sets(pred_samples, gt)
        for key, v in zip(("assd", "sdsd", "hd", "hd95"), values):
            out[key][c - 1] = float(v)
    return out


def _export_case_artifacts(case_id: str, coords_grid: np.ndarray,
                           pred: np.ndarray, targ: np.ndarray, meshes,
                           case: dict, mesh_dir: str, label_dir: str,
                           plot_dir: str, show: bool = False,
                           plots: bool = True) -> None:
    """Per-case test artifacts: the predicted fissure meshes as OBJ, the
    voxelized predicted labelmap as NIfTI, an offline HTML viewer of both,
    and (with `plots`) predicted and target point-cloud PNGs."""
    shape = case["shape"]
    world = kpts_to_world(np.asarray(coords_grid, np.float32), shape)
    if plots:
        for what, labels in (("pred", pred), ("targ", targ)):
            name = "prediction" if what == "pred" else "target"
            plot_point_cloud(
                world, labels, title=f"{case_id} point cloud {name}",
                show=show,
                path=os.path.join(plot_dir,
                                  f"{case_id}_point_cloud_{what}.png"))

    present = []
    for c, m in enumerate(meshes, start=1):
        if m is None:
            present.append((np.zeros((0, 3, 3), np.float32),
                            np.zeros((0,), bool)))
            continue
        tris, valid = m
        verts = tris[valid].reshape(-1, 3)
        faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
        save_obj(os.path.join(mesh_dir, f"{case_id}_fissure{c}_pred.obj"),
                 verts, faces)
        present.append((tris, valid))

    labelmap = mesh_to_labelmap(present, shape)
    save_nifti(os.path.join(label_dir, f"{case_id}_fissures_pred.nii.gz"),
               labelmap.astype(np.uint8),
               spacing=tuple(case.get("spacing", (1.0, 1.0, 1.0))))
    export_mesh_viewer(present,
                       os.path.join(plot_dir, f"{case_id}_viewer.html"),
                       points=world, point_labels=pred,
                       title=f"{case_id} predicted fissures")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def test_pipeline(ds: PointDataset, model, out_dir: str,
                  sample_points: int = 2048, n_runs_min: int = 50,
                  grid_res=(64, 64, 64), seed: int = 42, show: bool = False,
                  label_space: str = "fissures",
                  export_artifacts: bool = True, copd: bool = False,
                  device=None, draws=None):
    """The test harness over a dataset.

    :param model: (B, S, C) -> (B, S, num_classes) logits, in eval mode, on
        `device`
    :param label_space: "fissures" (default), "lobes" (lobe predictions
        to fissure labels by the random-walk fill in the case's
        ``lung_mask``; GT from ``fissure_labels``; 5 lobes give 3 fissures,
        4 lobes 2) or "binary" (left/right relabel through the case's
        ``lung_lr`` volume; GT from ``fissure_labels_lr``)
    :param export_artifacts: write OBJ meshes, NIfTI labelmaps, the HTML
        viewer and (where matplotlib is installed) the point-cloud PNGs
        under ``out_dir/test_predictions/``
    :param device: where inference, the surface fit and the metrics run
        (default: the first CUDA card; the CPU only when asked for)
    :param draws: per case, a dict of injected random draws: "subsets"
        ((R, S) ints for `ensemble_predict`) and "surface" ({class: (u,
        uv)}); either key may be left out
    :return: dict of per-class aggregate metric arrays
    """
    if label_space not in ("fissures", "lobes", "binary"):
        raise ValueError(f"unknown label_space {label_space!r}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("test_pipeline: no CUDA card found; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    plots = export_artifacts and matplotlib_available()
    if export_artifacts:
        pred_dir = os.path.join(out_dir, "test_predictions")
        mesh_dir = os.path.join(pred_dir, "meshes")
        label_dir = os.path.join(pred_dir, "labelmaps")
        plot_dir = os.path.join(pred_dir, "plots")
        for d in (mesh_dir, label_dir, plot_dir):
            os.makedirs(d, exist_ok=True)
        if not plots:
            print("test_pipeline: matplotlib is not installed; the "
                  "point-cloud PNGs are not written")
    if label_space == "fissures":
        num_classes = ds.num_classes
    elif label_space == "binary":
        num_classes = 3                      # bg / left / right
    else:  # lobes: 5 lobes -> 3 fissures, 4 lobes (exclude_rhf) -> 2
        num_classes = 4 if ds.num_classes >= 6 else 3
    generator = torch.Generator().manual_seed(seed)

    dices, per_case, ids = [], [], []
    inference_times, post_times = [], []
    for i in range(len(ds)):
        x, y = ds.get_full_pointcloud(i)
        drawn = {} if draws is None else draws[i]
        pc = torch.as_tensor(np.asarray(x, np.float32), device=device)
        subsets = drawn.get("subsets")
        _sync(device)
        t0 = time.time()
        probs = ensemble_predict(
            model, pc, sample_points=min(sample_points, x.shape[0]),
            n_runs_min=n_runs_min, generator=generator,
            subsets=None if subsets is None else torch.as_tensor(subsets))
        argmax = probs.argmax(-1)
        _sync(device)                          # compute only ...
        inference_times.append(time.time() - t0)
        pred = argmax.cpu().numpy()            # ... transfer not timed

        if label_space != "fissures":
            case = ds.cases[i]
            world = kpts_to_world(np.asarray(x[:, :3], np.float32),
                                  case["shape"])
            idx_zyx = np.round(world[:, ::-1]).astype(int)
            gt_key = ("fissure_labels_lr" if label_space == "binary"
                      else "fissure_labels")
            if gt_key not in case:
                raise KeyError(
                    f"label_space={label_space!r} evaluation needs fissure-"
                    f"space GT labels (case key {gt_key!r}); the "
                    f"{label_space} labels cannot be compared against the "
                    "converted predictions")
            if label_space == "binary":
                pred = binary_to_fissure_labels(pred, idx_zyx,
                                                case["lung_lr"])
            else:
                pred, _ = lobe_points_to_fissure_labels(
                    pred, idx_zyx, case["lung_mask"], device=device)
            y = np.asarray(case[gt_key])

        dices.append(batch_dice(torch.from_numpy(np.asarray(pred))[None],
                                torch.from_numpy(np.asarray(y))[None],
                                num_classes).numpy())
        t0 = time.time()
        per_case.append(evaluate_case(pred, x[:, :3], ds.cases[i],
                                      num_classes, grid_res=grid_res,
                                      seed=seed, device=device,
                                      surface_draws=drawn.get("surface")))
        post_times.append(time.time() - t0)
        case_id = "_".join(str(s) for s in ds.ids[i])
        ids.append(case_id)

        if export_artifacts:
            _export_case_artifacts(
                case_id, np.asarray(x[:, :3]), pred, np.asarray(y),
                per_case[-1]["meshes"], ds.cases[i], mesh_dir, label_dir,
                plot_dir, show=show, plots=plots)

    dices = np.stack(dices)
    metrics = {k: np.stack([c[k] for c in per_case])
               for k in ("assd", "sdsd", "hd", "hd95")}
    missing = np.stack([c["missing"] for c in per_case])

    def mean(a):
        return np.nanmean(a, axis=0)

    def std(a):
        # ddof=1: the reference's nanstd is torch.std, the unbiased one
        return np.nanstd(a, axis=0, ddof=1)
    suffix = "_copd" if copd else ""
    write_results(os.path.join(out_dir, f"test_results{suffix}.csv"),
                  dices.mean(0), dices.std(0, ddof=1),
                  mean(metrics["assd"]), std(metrics["assd"]),
                  mean(metrics["sdsd"]), std(metrics["sdsd"]),
                  mean(metrics["hd"]), std(metrics["hd"]),
                  mean(metrics["hd95"]), std(metrics["hd95"]),
                  missing.mean(0))
    write_raw_results_per_instance(out_dir, ids=ids, copd=copd,
                                   dice=dices[:, 1:], assd=metrics["assd"])
    write_speed_results(out_dir, inference_times, post_times, suffix=suffix)
    return {"dice": dices.mean(0), "assd": mean(metrics["assd"]),
            "sdsd": mean(metrics["sdsd"]), "hd": mean(metrics["hd"]),
            "hd95": mean(metrics["hd95"]), "missing": missing.mean(0)}


def write_results(filepath, mean_dice, std_dice, mean_assd, std_assd,
                  mean_sdsd, std_sdsd, mean_hd, std_hd, mean_hd95, std_hd95,
                  proportion_missing=None, **additional_metrics):
    """test_results.csv in the JAX package's layout."""
    def row(name, arr):
        arr = np.atleast_1d(np.asarray(arr, np.float64))
        return [name] + [float(v) for v in arr] + [float(np.nanmean(arr))]

    with open(filepath, "w") as f:
        w = csv.writer(f)
        if mean_dice is not None:
            w.writerow(["Class"] + [str(i) for i in range(len(mean_dice))]
                       + ["mean"])
            w.writerow(row("Mean Dice", mean_dice))
            w.writerow(row("StdDev Dice", std_dice))
            w.writerow([])
        w.writerow(["Fissure"] + [str(i + 1) for i in range(len(mean_assd))]
                   + ["mean"])
        w.writerow(row("Mean ASSD", mean_assd))
        w.writerow(row("StdDev ASSD", std_assd))
        w.writerow(row("Mean SDSD", mean_sdsd))
        w.writerow(row("StdDev SDSD", std_sdsd))
        w.writerow(row("Mean HD", mean_hd))
        w.writerow(row("StdDev HD", std_hd))
        w.writerow(row("Mean HD95", mean_hd95))
        w.writerow(row("StdDev HD95", std_hd95))
        if proportion_missing is None:
            proportion_missing = np.zeros_like(np.asarray(mean_assd))
        w.writerow(row("proportion missing", proportion_missing))
        for key, value in additional_metrics.items():
            arr = np.atleast_1d(np.asarray(value))
            w.writerow([key] + [float(v) for v in arr])


def write_raw_results_per_instance(out_folder, ids=None, copd=False,
                                   **metrics):
    """{name}_per_instance[_copd].csv: one row per case, one column per
    fissure and their nanmean."""
    for name, values in metrics.items():
        values = np.asarray(values)
        path = os.path.join(out_folder,
                            f"{name}_per_instance{'_copd' if copd else ''}"
                            ".csv")
        with open(path, "w") as f:
            w = csv.writer(f)
            w.writerow(["ID"] + [f"fissure {i + 1}"
                                 for i in range(values.shape[1])] + ["mean"])
            for r, vid in enumerate(ids or range(values.shape[0])):
                w.writerow([vid] + [float(v) for v in values[r]]
                           + [float(np.nanmean(values[r]))])


def write_speed_results(out_dir, all_inference_times, all_post_proc_times=None,
                        points_per_fissure=None, suffix=""):
    """inference_time{suffix}.csv: mean and std (ddof 1 for more than one
    run, as torch.std) of inference, post-processing and their total."""
    inf = np.asarray(all_inference_times, np.float64)
    post = np.asarray(all_post_proc_times, np.float64) \
        if all_post_proc_times is not None else np.zeros_like(inf)
    total = inf + post
    header = ["Inference", "Inference_std", "Post-Processing",
              "Post-Processing_std", "Total", "Total_std"]
    ddof = 1 if len(inf) > 1 else 0
    row = [inf.mean(), inf.std(ddof=ddof), post.mean(), post.std(ddof=ddof),
           total.mean(), total.std(ddof=ddof)]
    if points_per_fissure is not None:
        ppf = np.asarray(points_per_fissure, np.float64)
        header += ["Points_per_Fissure", "Points_per_Fissure_std"]
        row += [ppf.mean(), ppf.std(0, ddof=1 if len(ppf) > 1 else 0).mean()]
    with open(os.path.join(out_dir, f"inference_time{suffix}.csv"), "w") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerow([float(v) for v in row])
