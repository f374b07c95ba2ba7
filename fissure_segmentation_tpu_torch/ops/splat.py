"""Trilinear point-to-grid splatting and grid interpolation for the DPSR
solver (counterpart of ops/splat.py: `_splat_zyx` in drop mode,
`point_rasterize`, `grid_interp`).

Conventions: points (..., 3) in [0, 1], index order matching the grid dims
(the last coordinate indexes the last grid dim), cubesize 1/(size-1).

JAX drops out-of-range scatter updates and clamps out-of-range gathers
silently; torch raises on both, so the port masks explicitly: a corner
outside the grid contributes weight 0 at index 0 (adding +0.0 leaves every
cell's value unchanged), and interpolation clamps its corner indices.
"""
from __future__ import annotations

import torch


def _corner_weight(frac: torch.Tensor, dz: int, dy: int, dx: int):
    return ((frac[..., 0] if dz else 1 - frac[..., 0])
            * (frac[..., 1] if dy else 1 - frac[..., 1])
            * (frac[..., 2] if dx else 1 - frac[..., 2]))


def _splat_zyx(vals: torch.Tensor, idx: torch.Tensor, grid_shape
               ) -> torch.Tensor:
    """Batched trilinear scatter with out-of-range corners dropped:
    vals (B, N, F), float zyx indices idx (B, N, 3) -> (B, F, D, H, W).
    Corners are added in the JAX package's order (dz, dy, dx), points in
    index order within each corner."""
    d, h, w = grid_shape
    b, n, f = vals.shape
    lo = torch.floor(idx)
    frac = idx - lo
    lo = lo.to(torch.int64)
    dims = torch.tensor([d, h, w], device=idx.device)
    base = (torch.arange(b, device=idx.device) * (d * h * w))[:, None]
    out = torch.zeros(b * d * h * w, f, dtype=vals.dtype, device=vals.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corner = lo + torch.tensor([dz, dy, dx], device=idx.device)
                inside = ((corner >= 0) & (corner < dims)).all(-1)
                flat = (corner[..., 0] * h + corner[..., 1]) * w \
                    + corner[..., 2]
                flat = torch.where(inside, flat + base, 0)
                wgt = torch.where(inside, _corner_weight(frac, dz, dy, dx),
                                  0.0)
                out.index_add_(0, flat.reshape(-1),
                               (wgt[..., None] * vals).reshape(-1, f))
    return out.reshape(b, d, h, w, f).permute(0, 4, 1, 2, 3)


def point_rasterize(pts: torch.Tensor, vals: torch.Tensor, size
                    ) -> torch.Tensor:
    """DPSR rasterizer: pts (B, N, 3) in [0, 1], vals (B, N, F) ->
    (B, F, *size)."""
    sz = torch.tensor(size, dtype=torch.float32, device=pts.device)
    return _splat_zyx(vals, pts * (sz - 1), tuple(size))


def grid_interp(grid: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """DPSR grid interpolation: grid (B, *size, F), pts (B, N, 3) in
    [0, 1] -> (B, N, F); corner indices clamp to the grid."""
    b = grid.shape[0]
    size = grid.shape[1:4]
    f = grid.shape[-1]
    sz = torch.tensor(size, dtype=torch.float32, device=pts.device)
    idx = pts * (sz - 1)
    lo = torch.floor(idx)
    frac = idx - lo
    lo = lo.to(torch.int64)
    flat_grid = grid.reshape(b, -1, f)
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                zi = (lo[..., 0] + dz).clamp(0, size[0] - 1)
                yi = (lo[..., 1] + dy).clamp(0, size[1] - 1)
                xi = (lo[..., 2] + dx).clamp(0, size[2] - 1)
                flat = (zi * size[1] + yi) * size[2] + xi        # (B, N)
                g = torch.gather(flat_grid, 1,
                                 flat[..., None].expand(*flat.shape, f))
                out = out + _corner_weight(frac, dz, dy, dx)[..., None] * g
    return out
