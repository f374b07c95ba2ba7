"""The serving cells' CTs and lung masks, made on the device from the seed.

A torch rewrite of the port's numpy `make_synthetic_image_case` (its
image and lung mask; no labels or lobes): two darker lung ellipsoids in
Gaussian noise (sigma 0.05, lungs at -0.6), and in them three brighter
fissure sheets (+0.35, one voxel thick), the height fields of
portbench/gen/points.py. The numpy original takes about 19 s a 256^3 case
on a CPU, which every run's set-up would pay; here a case takes
milliseconds on the card.
"""
from __future__ import annotations

import torch

from .points import FISSURES, LUNGS, in_lung, surface_params, surface_z


def make_ct(seed: int, shape, device, noise: float = 0.05):
    """(image (D, H, W) float32, lung mask (D, H, W) bool, the fissures'
    height-field parameters {label: (5,)}) of one case."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {k: v[0] for k, v in surface_params(gen, 1, device).items()}
    d, h, w = shape
    zz = torch.linspace(0, 1, d, device=device)[:, None, None]
    yy = torch.linspace(0, 1, h, device=device)[None, :, None]
    xx = torch.linspace(0, 1, w, device=device)[None, None, :]
    pts = torch.stack(torch.broadcast_tensors(xx, yy, zz), -1)
    lung = in_lung(pts, "left") | in_lung(pts, "right")
    img = noise * torch.randn(shape, generator=gen, device=device)
    img = img - 0.6 * lung
    voxel = 1.0 / max(shape)
    for lbl, (side, _, _) in FISSURES.items():
        zs = surface_z(params[lbl], pts[..., 0:1], pts[..., 1:2],
                       LUNGS[side][0][0])[..., 0]
        on = ((pts[..., 2] - zs).abs() < voxel) & in_lung(pts, side, 0.85)
        img = img + 0.35 * (on & lung)
    return img.contiguous(), lung.contiguous(), params


def make_pool(seed: int, n: int, shape, device):
    """`n` distinct cases, case j from the seed derived from (seed, j)."""
    from ..common import derive_seed
    return [make_ct(derive_seed(seed, "ct", j), shape, device)
            for j in range(n)]
