"""The training cell's point store, made on the device from the seed.

A fold's training set of synthetic keypoint clouds in one batched pass: per
case three fissure height fields (z = z0 + a (y - 0.5) + b (x - cx) + qx
(x - cx)^2 + qy (y - 0.5)^2, drawn around the baselines of the port's
numpy generator, `data/synthetic.py`), 35 % of the points on the sheets
inside their lung (jittered by 0.004), the rest uniform inside the two lung
ellipsoids, shuffled, in grid coordinates of a 128^3 volume. Labels: 0
background, 1 left oblique, 2 right oblique, 3 right horizontal fissure.

Everything is drawn by one `torch.Generator` on the target device in a few
large calls, so a seed gives the same store on every run, and set-up pays
milliseconds instead of the numpy generator's seconds a case.
"""
from __future__ import annotations

import torch

# (centre, semi-axes) of the two lungs in [0, 1]^3, xyz; the subject's right
# lung lies at small x
LUNGS = {"left": ((0.70, 0.5, 0.5), (0.17, 0.30, 0.40)),
         "right": ((0.28, 0.5, 0.5), (0.18, 0.32, 0.42))}
# label: (lung, baseline z0, baseline slope in y)
FISSURES = {1: ("left", 0.50, 0.55), 2: ("right", 0.45, 0.55),
            3: ("right", 0.68, 0.05)}
GRID = 128   # the volume the coordinates are normalised in


def surface_params(gen: torch.Generator, n: int, device) -> dict:
    """Per fissure label, (n, 5) height-field parameters (z0, a, b, qx, qy)."""
    out = {}
    for lbl, (_, z0, slope) in FISSURES.items():
        u = torch.rand((n, 5), generator=gen, device=device)
        lo = torch.tensor([z0 - 0.03, slope - 0.1, -0.15, -0.3, -0.3],
                          device=device)
        hi = torch.tensor([z0 + 0.03, slope + 0.1, 0.15, 0.3, 0.3],
                          device=device)
        out[lbl] = lo + u * (hi - lo)
    return out


def surface_z(p: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
              cx: float) -> torch.Tensor:
    """Height of the fields `p` (..., 5) at (x, y) (broadcast)."""
    dx, dy = x - cx, y - 0.5
    return (p[..., 0:1] + p[..., 1:2] * dy + p[..., 2:3] * dx
            + p[..., 3:4] * dx * dx + p[..., 4:5] * dy * dy)


def in_lung(pts: torch.Tensor, lung: str, margin: float = 1.0) -> torch.Tensor:
    c, ax = LUNGS[lung]
    c = torch.tensor(c, device=pts.device)
    ax = torch.tensor(ax, device=pts.device)
    return (((pts - c) / ax) ** 2).sum(-1) < margin


def _first_valid(cand: torch.Tensor, ok: torch.Tensor, n: int) -> torch.Tensor:
    """The first n candidates of each row where `ok`, (B, n, 3); raises if a
    row has fewer (the callers draw about four times what they need)."""
    if int(ok.sum(1).min()) < n:
        raise RuntimeError("point generator: too few candidates accepted")
    order = torch.sort((~ok).to(torch.int8), dim=1, stable=True).indices
    return torch.gather(cand, 1, order[:, :n, None].expand(-1, -1, 3))


def fissure_points(gen, params: dict, lbl: int, n: int,
                   device) -> torch.Tensor:
    """(B, n, 3) points on fissure `lbl`'s sheet inside its lung (margin
    0.85), [0, 1]^3 xyz."""
    lung = FISSURES[lbl][0]
    c, ax = LUNGS[lung]
    b = params[lbl].shape[0]
    m = 8 * n
    u = torch.rand((b, m, 2), generator=gen, device=device)
    x = c[0] - ax[0] + u[..., 0] * 2 * ax[0]
    y = c[1] - ax[1] + u[..., 1] * 2 * ax[1]
    z = surface_z(params[lbl][:, None, :], x[..., None], y[..., None],
                  c[0])[..., 0]
    cand = torch.stack([x, y, z], -1)
    return _first_valid(cand, in_lung(cand, lung, 0.85), n)


def background_points(gen, b: int, n: int, device) -> torch.Tensor:
    """(B, n, 3) points uniform inside either lung."""
    cand = torch.rand((b, 10 * n, 3), generator=gen, device=device)
    ok = in_lung(cand, "left") | in_lung(cand, "right")
    return _first_valid(cand, ok, n)


def make_store(seed: int, n_cases: int, n_points: int, device,
               fissure_fraction: float = 0.35, jitter: float = 0.004):
    """The store's tensors: coords (n_cases, N_pad, 3) float32 grid
    coordinates, labels (n_cases, N_pad) int64, valid (n_cases, N_pad)
    bool, with N_pad = n_points rounded up to a multiple of 128 (the
    port's store pads so); padding is 0 and invalid."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = surface_params(gen, n_cases, device)
    n_fis = int(n_points * fissure_fraction)
    per = [n_fis // 3 + (1 if i < n_fis % 3 else 0) for i in range(3)]
    pts, lbls = [], []
    for lbl, n_f in zip(FISSURES, per):
        p = fissure_points(gen, params, lbl, n_f, device)
        p = p + jitter * torch.randn(p.shape, generator=gen, device=device)
        pts.append(p)
        lbls.append(torch.full((n_cases, n_f), lbl, dtype=torch.int64,
                               device=device))
    n_bg = n_points - n_fis
    pts.append(background_points(gen, n_cases, n_bg, device))
    lbls.append(torch.zeros((n_cases, n_bg), dtype=torch.int64,
                            device=device))
    pts, lbls = torch.cat(pts, 1), torch.cat(lbls, 1)
    order = torch.argsort(torch.rand((n_cases, n_points), generator=gen,
                                     device=device), dim=1)
    pts = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
    lbls = torch.gather(lbls, 1, order)
    # voxel xyz of a GRID^3 volume, then grid coordinates (align_corners
    # False): (w / (G - 1) * 2 - 1) * (G - 1) / G
    grid = (pts * 2 - 1) * ((GRID - 1) / GRID)
    n_pad = -(-n_points // 128) * 128
    coords = torch.zeros((n_cases, n_pad, 3), device=device)
    labels = torch.zeros((n_cases, n_pad), dtype=torch.int64, device=device)
    valid = torch.zeros((n_cases, n_pad), dtype=torch.bool, device=device)
    coords[:, :n_points] = grid
    labels[:, :n_points] = lbls
    valid[:, :n_points] = True
    return coords, labels, valid


def class_weights(labels: torch.Tensor, valid: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """(1 - normalised class frequency) * num_classes over the store (the
    reference's weighting of the NNU loss's cross entropy)."""
    freq = torch.bincount(labels[valid], minlength=num_classes)[:num_classes]
    f = freq.to(torch.float64) / freq.sum()
    return ((1 - f) * num_classes).to(torch.float32)
