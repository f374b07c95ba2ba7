"""Corresponding-point generation across a dataset of fissure surfaces
(counterpart of shape_model/correspondences.py).

Pick a fixed case, register every moving case's per-object point clouds
onto it (similarity CPD over the whole lung, then deformable CPD per
object, both on the card), choose common sampling locations in the
registered space ('simple' = farthest point sampling on the fixed cloud,
K5 on the card; 'kmeans' = cluster centroids over all moved clouds), and
for each case take the pre-registered (similarity-aligned, un-deformed)
position of the moved point nearest each location.

The nearest-point search and k-means stay host numpy with numpy's
generator, as in the JAX package, so equal inputs give equal draws; the
npz files are the JAX package's layout, so either package reads the
other's.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.fps import farthest_point_sampling
from ..utils.device import resolve_device
from .registration import register_cpd_deformable, register_cpd_rigid


def _nearest(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Index into b of the nearest neighbor for each point of a."""
    d2 = ((a[:, None] - b[None]) ** 2).sum(-1)
    return d2.argmin(1)


def generate_corresponding_points(case_objs: list, n_per_object: int = 256,
                                  fixed_index: int = 0, mode: str = "simple",
                                  rigid_iters: int = 60,
                                  deform_iters: int = 60,
                                  deform_alpha: float = 0.01,
                                  deform_beta: float = 10.0, device=None):
    """
    :param case_objs: per case, a list of per-object (N_i, 3) world point
        arrays (all cases must have the same number of objects)
    :param mode: 'simple' (FPS on the fixed cloud) or 'kmeans'
    :param device: where the registrations and FPS run (default: the first
        CUDA card; without one it raises)
    :return: (corr (n_cases, O*n_per_object, 3), labels (O*n_per_object,),
              transforms: per case {'rotation','translation','scale'} mapping
              the case into the fixed frame)
    """
    if mode not in ("simple", "kmeans"):
        raise ValueError(f"unknown correspondence mode {mode!r}")
    dev = resolve_device(device, "generate_corresponding_points")
    n_cases = len(case_objs)
    n_objs = len(case_objs[fixed_index])
    if any(len(c) != n_objs for c in case_objs):
        raise ValueError("every case needs the same number of objects")

    def on_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    # 1. register every case onto the fixed one (whole-lung rigid, then
    # per-object deformable refinement)
    fixed_all = on_dev(np.concatenate(case_objs[fixed_index], axis=0))
    transforms, moved, prereg = [], [], []
    for c in range(n_cases):
        if c == fixed_index:
            transforms.append({"rotation": np.eye(3, dtype=np.float32),
                               "translation": np.zeros(3, np.float32),
                               "scale": 1.0})
            prereg.append([np.asarray(o, np.float32) for o in case_objs[c]])
            moved.append([np.asarray(o, np.float32) for o in case_objs[c]])
            continue
        mov_all = on_dev(np.concatenate(case_objs[c], axis=0))
        _, (s, r, t) = register_cpd_rigid(fixed_all, mov_all,
                                          max_iter=rigid_iters)
        s, r, t = float(s), r.cpu().numpy(), t.cpu().numpy()
        # the rigid CPD maps y -> s*y@R^T + t; stored in the row-vector
        # convention of CorrespondingPointDataset (p @ R * s + t)
        transforms.append({"rotation": r.T.astype(np.float32),
                           "translation": t.astype(np.float32),
                           "scale": s})
        pre_c, moved_c = [], []
        for o in range(n_objs):
            pre = s * np.asarray(case_objs[c][o]) @ r.T + t
            reg, _ = register_cpd_deformable(
                on_dev(case_objs[fixed_index][o]), on_dev(pre),
                alpha=deform_alpha, beta=deform_beta, max_iter=deform_iters)
            pre_c.append(pre.astype(np.float32))
            moved_c.append(reg.cpu().numpy())
        prereg.append(pre_c)
        moved.append(moved_c)

    # 2. common sampling locations per object
    locations = []
    for o in range(n_objs):
        if mode == "simple":
            pts = np.asarray(case_objs[fixed_index][o], np.float32)
            idx = farthest_point_sampling(on_dev(pts), n_per_object)
            locations.append(pts[idx.cpu().numpy()])
        else:
            allpts = np.concatenate([moved[c][o] for c in range(n_cases)])
            locations.append(_kmeans(allpts, n_per_object))

    # 3. correspondences: nearest moved point, taken at its pre-registered
    # (un-deformed) position
    labels = np.concatenate([np.full(n_per_object, o + 1, np.int32)
                             for o in range(n_objs)])
    corr = np.zeros((n_cases, n_objs * n_per_object, 3), np.float32)
    for c in range(n_cases):
        outs = []
        for o in range(n_objs):
            nn = _nearest(locations[o], moved[c][o])
            outs.append(prereg[c][o][nn])
        corr[c] = np.concatenate(outs)
    return corr, labels, transforms


def _kmeans(pts: np.ndarray, k: int, iters: int = 20,
            seed: int = 0) -> np.ndarray:
    """Plain Lloyd k-means (stand-in for sklearn.k_means)."""
    rng = np.random.default_rng(seed)
    centers = pts[rng.choice(len(pts), k, replace=False)]
    for _ in range(iters):
        assign = _nearest(pts, centers)
        for j in range(k):
            m = assign == j
            if m.any():
                centers[j] = pts[m].mean(0)
    return centers.astype(np.float32)


def save_corresponding_points(folder: str, ids: list, corr: np.ndarray,
                              labels: np.ndarray, transforms: list) -> None:
    """`{case}_{seq}_corr_pts.npz` layout (ssm.save_shape counterpart)."""
    os.makedirs(folder, exist_ok=True)
    for (case, seq), pts, tr in zip(ids, corr, transforms):
        np.savez(os.path.join(folder, f"{case}_{seq}_corr_pts.npz"),
                 points=pts, labels=labels, rotation=tr["rotation"],
                 translation=tr["translation"], scale=tr["scale"])


def load_corresponding_points(folder: str):
    """:return: (ids, corr (n, P, 3), labels, transforms)"""
    from glob import glob
    files = sorted(glob(os.path.join(folder, "*_corr_pts.npz")))
    ids, pts, transforms, labels = [], [], [], None
    for f in files:
        with np.load(f) as z:
            base = os.path.basename(f).replace("_corr_pts.npz", "")
            case, seq = base.split("_", 1)
            ids.append((case, seq))
            pts.append(z["points"])
            labels = z["labels"]
            transforms.append({"rotation": z["rotation"],
                               "translation": z["translation"],
                               "scale": float(z["scale"])})
    return ids, np.stack(pts), labels, transforms
