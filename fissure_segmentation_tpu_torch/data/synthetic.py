"""Synthetic CT cases, numpy only (copy of data/synthetic.py's image case).

A copy, not an import: `fissure_segmentation_tpu.data` imports jax in its
package __init__, and the machine that runs the port has no jax. The
functions below are line-for-line copies of data/synthetic.py:36-80 and
:203-259 with their constants, so a seed gives a bit-identical case in both
packages (pinned by tests/test_torch_synthetic.py).
"""
from __future__ import annotations

import numpy as np

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
