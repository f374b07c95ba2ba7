"""Synthetic CT and keypoint-cloud cases, numpy only (copy of
data/synthetic.py's image case and point cases).

A copy, not an import: `fissure_segmentation_tpu.data` imports jax in its
package __init__, and the machine that runs the port has no jax. The
functions below are line-for-line copies of data/synthetic.py:36-160,
:203-259 and :262-269 with their constants, so a seed gives a bit-identical
case in both packages (pinned by tests/test_torch_keypoints.py and
tests/test_torch_train.py).
"""
from __future__ import annotations

import numpy as np

from fissure_segmentation_tpu.utils.coords import np_grid_coords

# (center, semi-axes) of the two lungs in normalized [0,1]^3 (x lateral,
# y ant-post, z cranio-caudal); the subject's RIGHT lung is at small x.
_LUNGS = {
    "left": (np.array([0.70, 0.5, 0.5]), np.array([0.17, 0.30, 0.40])),
    "right": (np.array([0.28, 0.5, 0.5]), np.array([0.18, 0.32, 0.42])),
}

_FISSURES = {
    # label: (lung, baseline z0, baseline y-slope)
    1: ("left", 0.50, 0.55),   # LOF — oblique
    2: ("right", 0.45, 0.55),  # ROF — oblique
    3: ("right", 0.68, 0.05),  # RHF — near-horizontal
}


def _surface_params(rng: np.random.Generator, z0: float, slope_y: float):
    """Random height-field z(x,y) = z0 + a(y-cy) + b(x-cx) + quadratics."""
    return {
        "z0": z0 + rng.uniform(-0.03, 0.03),
        "a": slope_y + rng.uniform(-0.1, 0.1),
        "b": rng.uniform(-0.15, 0.15),
        "qx": rng.uniform(-0.3, 0.3),
        "qy": rng.uniform(-0.3, 0.3),
    }


def _surface_z(p: dict, x: np.ndarray, y: np.ndarray, cx: float, cy: float = 0.5):
    dx, dy = x - cx, y - cy
    return p["z0"] + p["a"] * dy + p["b"] * dx + p["qx"] * dx ** 2 + p["qy"] * dy ** 2


def _in_lung(pts: np.ndarray, lung: str, margin: float = 1.0) -> np.ndarray:
    c, ax = _LUNGS[lung]
    return (((pts - c) / ax) ** 2).sum(-1) < margin


def sample_fissure_surface(params: dict, label: int, n: int,
                           rng: np.random.Generator) -> np.ndarray:
    """Dense points on fissure `label`'s surface, normalized [0,1]^3 coords."""
    lung, _, _ = _FISSURES[label]
    c, ax = _LUNGS[lung]
    out = []
    while sum(len(o) for o in out) < n:
        x = rng.uniform(c[0] - ax[0], c[0] + ax[0], 4 * n)
        y = rng.uniform(c[1] - ax[1], c[1] + ax[1], 4 * n)
        z = _surface_z(params[label], x, y, c[0])
        pts = np.stack([x, y, z], -1)
        out.append(pts[_in_lung(pts, lung, margin=0.85)])
    return np.concatenate(out)[:n]


def make_synthetic_case(seed: int, n_points: int = 8000, shape=(128, 128, 128),
                        fissure_fraction: float = 0.35, jitter: float = 0.004,
                        with_feature: bool = True) -> dict:
    """One synthetic case: grid-coord keypoints + labels (+1 feature chan)."""
    rng = np.random.default_rng(seed)
    params = {lbl: _surface_params(rng, z0, sl)
              for lbl, (_, z0, sl) in _FISSURES.items()}

    n_fis = int(n_points * fissure_fraction)
    per_fissure = [n_fis // 3 + (1 if i < n_fis % 3 else 0) for i in range(3)]
    pts, lbls = [], []
    for lbl, n_f in zip(_FISSURES, per_fissure):
        p = sample_fissure_surface(params, lbl, n_f, rng)
        p += rng.normal(0, jitter, p.shape)
        pts.append(p)
        lbls.append(np.full(n_f, lbl, np.int32))

    # background clutter uniform in the lungs
    n_bg = n_points - n_fis
    bg = []
    while sum(len(b) for b in bg) < n_bg:
        cand = rng.uniform(0, 1, (4 * n_bg, 3))
        inside = _in_lung(cand, "left") | _in_lung(cand, "right")
        bg.append(cand[inside])
    bg = np.concatenate(bg)[:n_bg]
    pts.append(bg)
    lbls.append(np.zeros(n_bg, np.int32))

    pts = np.concatenate(pts).astype(np.float32)
    lbls = np.concatenate(lbls)
    order = rng.permutation(len(pts))
    pts, lbls = pts[order], lbls[order]

    d, h, w = shape
    world = pts * (np.array([w, h, d], np.float32) - 1)  # xyz voxel coords
    grid = np_grid_coords(world, shape)

    case = {
        "coords": grid.astype(np.float32),
        "labels": lbls,
        "shape": tuple(shape),
        "spacing": (1.0, 1.0, 1.0),
        "surface_params": params,
        "case_id": f"synth{seed:04d}",
        "sequence": "fixed",
    }
    if with_feature:
        # proximity-to-fissure pseudo-enhancement feature with noise
        dmin = np.full(len(pts), np.inf, np.float32)
        for lbl in _FISSURES:
            surf = sample_fissure_surface(params, lbl, 2000, rng)
            # chunked nearest distance (host, generation-time only); the
            # three squared differences are added in the order .sum(-1)
            # adds them, without the (chunk, 2000, 3) temporary: the same
            # bits, 3x faster
            for i in range(0, len(pts), 2048):
                p = pts[i:i + 2048]
                d2 = (p[:, None, 0] - surf[None, :, 0]) ** 2
                d2 += (p[:, None, 1] - surf[None, :, 1]) ** 2
                d2 += (p[:, None, 2] - surf[None, :, 2]) ** 2
                dmin[i:i + 2048] = np.minimum(dmin[i:i + 2048], d2.min(1))
        feat = np.exp(-np.sqrt(dmin) / 0.02) + rng.normal(0, 0.05, len(pts))
        case["features"] = feat[:, None].astype(np.float32)
    return case


def gt_surface_points(case: dict, label: int, n: int = 5000,
                      seed: int = 0) -> np.ndarray:
    """Dense ground-truth surface samples in *grid* coords for mesh metrics."""
    rng = np.random.default_rng(seed)
    pts = sample_fissure_surface(case["surface_params"], label, n, rng)
    d, h, w = case["shape"]
    world = pts * (np.array([w, h, d], np.float32) - 1)
    return np_grid_coords(world, case["shape"])


def attach_gt_surfaces(case: dict, n: int = 4000, seed: int = 0) -> dict:
    """Add dense GT surface samples in *world* coords per fissure label."""
    rng = np.random.default_rng(seed)
    d, h, w = case["shape"]
    scale = np.array([w, h, d], np.float32) - 1
    case["gt_surfaces"] = {
        lbl: (sample_fissure_surface(case["surface_params"], lbl, n, rng)
              * scale).astype(np.float32)
        for lbl in _FISSURES
    }
    return case


def make_synthetic_dataset(n_cases: int = 20, n_points: int = 8000,
                           seed: int = 0, gt_surfaces: bool = False,
                           **kwargs) -> list[dict]:
    cases = [make_synthetic_case(seed * 1000 + i, n_points, **kwargs)
             for i in range(n_cases)]
    if gt_surfaces:
        cases = [attach_gt_surfaces(c, seed=seed) for c in cases]
    return cases


def make_synthetic_image_case(seed: int, shape=(64, 64, 64),
                              noise: float = 0.05) -> dict:
    """Rasterized synthetic CT: lungs are darker ellipsoids, fissures are
    thin bright sheets; labels mark fissure voxels (1/2/3) and `lobes`
    partition each lung by its fissures."""
    rng = np.random.default_rng(seed)
    params = {lbl: _surface_params(rng, z0, sl)
              for lbl, (_, z0, sl) in _FISSURES.items()}
    d, h, w = shape
    zz, yy, xx = np.meshgrid(np.linspace(0, 1, d), np.linspace(0, 1, h),
                             np.linspace(0, 1, w), indexing="ij")
    pts = np.stack([xx, yy, zz], -1).reshape(-1, 3)

    lung_mask = np.zeros(len(pts), bool)
    lung_lr = np.zeros(len(pts), np.int32)  # 1 = left, 2 = right
    for k, lung in enumerate(("left", "right")):
        m = _in_lung(pts, lung)
        lung_mask |= m
        lung_lr[m] = k + 1

    img = rng.normal(0, noise, len(pts)).astype(np.float32)
    img[lung_mask] -= 0.6  # air-filled lungs are dark

    labels = np.zeros(len(pts), np.int32)
    lobes = np.zeros(len(pts), np.int32)
    voxel = 1.0 / max(shape)
    for lbl, (lung, _, _) in _FISSURES.items():
        c, _ = _LUNGS[lung]
        zs = _surface_z(params[lbl], pts[:, 0], pts[:, 1], c[0])
        on = (np.abs(pts[:, 2] - zs) < voxel) & _in_lung(pts, lung, 0.85)
        labels[on & lung_mask] = lbl
        img[on & lung_mask] += 0.35  # fissures are brighter than parenchyma

    # lobes: left lung split by LOF; right lung split by ROF then RHF.
    # Reference label convention (find_lobes.py:50-56): 1 RLL, 2 RUL,
    # 3 LLL, 4 LUL, 5 RML.
    zs1 = _surface_z(params[1], pts[:, 0], pts[:, 1], _LUNGS["left"][0][0])
    zs2 = _surface_z(params[2], pts[:, 0], pts[:, 1], _LUNGS["right"][0][0])
    zs3 = _surface_z(params[3], pts[:, 0], pts[:, 1], _LUNGS["right"][0][0])
    left, right = lung_lr == 1, lung_lr == 2
    lobes[left & (pts[:, 2] < zs1)] = 3
    lobes[left & (pts[:, 2] >= zs1)] = 4
    lobes[right & (pts[:, 2] < zs2)] = 1
    lobes[right & (pts[:, 2] >= zs2) & (pts[:, 2] < zs3)] = 5
    lobes[right & (pts[:, 2] >= zs2) & (pts[:, 2] >= zs3)] = 2

    return {
        "image": img.reshape(shape),
        "labels": labels.reshape(shape),
        "lobes": lobes.reshape(shape),
        "lung_mask": lung_mask.reshape(shape),
        "lung_lr": lung_lr.reshape(shape),
        "shape": tuple(shape), "spacing": (1.0, 1.0, 1.0),
        "surface_params": params,
        "case_id": f"synthimg{seed:04d}", "sequence": "fixed",
    }
