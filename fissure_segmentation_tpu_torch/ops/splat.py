"""Trilinear point-to-grid splatting and grid interpolation (counterpart
of ops/splat.py: `_splat_zyx`, `splat_grid_sample`, `point_rasterize`,
`grid_interp`).

Conventions: `splat_grid_sample` takes xyz coords in [-1, 1]
(align_corners=False), the transpose of grid_sample; `point_rasterize` and
`grid_interp` take points (..., 3) in [0, 1], index order matching the
grid dims (the last coordinate indexes the last grid dim), cubesize
1/(size-1). Every function is differentiable in its values and grid
(the scatter's backward is a gather), as the JAX package's scatter is.

JAX drops out-of-range scatter updates and clamps out-of-range gathers
silently; torch raises on both, so the port masks explicitly: a corner
outside the grid contributes weight 0 at index 0 (adding +0.0 leaves every
cell's value unchanged), and interpolation clamps its corner indices.

The scatter is deterministic on every device: one `index_add_` on the
CPU, which adds in index order, and on the card one `index_put_` with
`accumulate=True`, which sorts the indices stably and sums each cell's
contributions in that order (`index_add_` on the card adds with float
atomics in no fixed order). With more than one feature a cell the card's
sums are the CPU's bit for bit; with one, its sorted path sums a cell's
contributions by warp and is the same from run to run only. Serving's
`segment_cases` relies on this to match a loop of `segment_case`.
"""
from __future__ import annotations

import torch

from ..utils.coords import kpts_to_world
from ..utils.device import host_to


def _corner_weight(frac: torch.Tensor, dz: int, dy: int, dx: int):
    return ((frac[..., 0] if dz else 1 - frac[..., 0])
            * (frac[..., 1] if dy else 1 - frac[..., 1])
            * (frac[..., 2] if dx else 1 - frac[..., 2]))


def _splat_zyx(vals: torch.Tensor, idx: torch.Tensor, grid_shape,
               mode: str = "drop") -> torch.Tensor:
    """Batched trilinear scatter: vals (B, N, F), float zyx indices idx
    (B, N, 3) -> (B, F, D, H, W). Corners are added in the JAX package's
    order (dz, dy, dx), points in index order within each corner.

    mode "drop": out-of-range corners contribute nothing (the transpose of
    grid_sample's zeros padding); "clamp": corners clamp to the border (the
    transpose of border padding)."""
    if mode not in ("drop", "clamp"):
        raise ValueError(f"unknown splat mode {mode!r}")
    d, h, w = grid_shape
    b, n, f = vals.shape
    lo = torch.floor(idx)
    frac = idx - lo
    lo = lo.to(torch.int64)
    dims = host_to([d, h, w], idx.device)
    flats, pays = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corner = lo + host_to([dz, dy, dx], idx.device)
                if mode == "clamp":
                    corner = torch.minimum(corner.clamp(min=0), dims - 1)
                inside = ((corner >= 0) & (corner < dims)).all(-1)
                flat = (corner[..., 0] * h + corner[..., 1]) * w \
                    + corner[..., 2]
                flats.append(torch.where(inside, flat, 0))
                wgt = torch.where(inside, _corner_weight(frac, dz, dy, dx),
                                  0.0)
                pays.append(wgt[..., None] * vals)
    base = (torch.arange(b, device=idx.device) * (d * h * w))[:, None]
    flat = (torch.cat(flats, 1) + base).reshape(-1)
    pay = torch.cat(pays, 1).reshape(-1, f)
    out = torch.zeros(b * d * h * w, f, dtype=vals.dtype, device=vals.device)
    if out.is_cuda:
        out.index_put_((flat,), pay, accumulate=True)
    else:
        out.index_add_(0, flat, pay)
    return out.reshape(b, d, h, w, f).permute(0, 4, 1, 2, 3)


def splat_grid_sample(values: torch.Tensor, coords: torch.Tensor,
                      grid_shape, mode: str = "drop") -> torch.Tensor:
    """The transpose of grid_sample (DiVRoC): splat (B, N, F) values at
    (B, N, 3) xyz coords in [-1, 1] (align_corners=False) into a
    (B, F, D, H, W) grid; (N, F), (N, 3) give (F, D, H, W)."""
    if values.ndim == 2:
        return splat_grid_sample(values[None], coords[None], grid_shape,
                                 mode)[0]
    grid_shape = tuple(grid_shape)
    idx_zyx = kpts_to_world(coords, grid_shape).flip(-1)
    return _splat_zyx(values, idx_zyx, grid_shape, mode)


def point_rasterize(pts: torch.Tensor, vals: torch.Tensor, size
                    ) -> torch.Tensor:
    """DPSR rasterizer: pts (B, N, 3) in [0, 1], vals (B, N, F) ->
    (B, F, *size)."""
    sz = host_to(size, pts.device, torch.float32)
    return _splat_zyx(vals, pts * (sz - 1), tuple(size))


def grid_interp(grid: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """DPSR grid interpolation: grid (B, *size, F), pts (B, N, 3) in
    [0, 1] -> (B, N, F); corner indices clamp to the grid."""
    b = grid.shape[0]
    size = grid.shape[1:4]
    f = grid.shape[-1]
    sz = host_to(size, pts.device, torch.float32)
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
