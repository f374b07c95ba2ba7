"""Volume sampling at normalized grid coordinates (counterpart of
utils/sampling.py): torch.nn.functional.grid_sample's semantics for 3-D
volumes (xyz coordinates in [-1, 1], align_corners=False, border or zeros
padding, nearest or trilinear) written out as the JAX package's explicit
gathers, in its order of operations, so both packages round alike; the
keypoint patch features sample 5^3 patches with it.
"""
from __future__ import annotations

import torch

from .coords import kpts_to_world


def _gather_zyx(vol: torch.Tensor, z, y, x) -> torch.Tensor:
    """vol (..., D, H, W); z, y, x integer tensors of one shape."""
    return vol[..., z, y, x]


def grid_sample_volume(vol: torch.Tensor, coords: torch.Tensor,
                       mode: str = "bilinear",
                       padding_mode: str = "border") -> torch.Tensor:
    """Sample a (D, H, W) or (C, D, H, W) volume at (..., 3) xyz grid
    coordinates.

    :return: (...) samples, or (C, ...) for a multichannel volume
    """
    dhw = tuple(vol.shape[-3:])
    dev = vol.device
    idx = kpts_to_world(coords, dhw).flip(-1)          # zyx float indices
    maxi = torch.tensor([s - 1 for s in dhw], dtype=torch.float32,
                        device=dev)
    max_int = torch.tensor([s - 1 for s in dhw], device=dev)

    if padding_mode == "border":
        idx = torch.minimum(torch.maximum(idx, torch.zeros_like(maxi)), maxi)
    elif padding_mode != "zeros":
        raise ValueError(padding_mode)

    if mode == "nearest":
        near = torch.floor(idx + 0.5).to(torch.int64)
        near = torch.minimum(torch.maximum(near, torch.zeros_like(max_int)),
                             max_int)
        out = _gather_zyx(vol, near[..., 0], near[..., 1], near[..., 2])
        if padding_mode == "zeros":
            inside = ((idx >= -0.5) & (idx <= maxi + 0.5)).all(-1)
            out = torch.where(inside, out, 0.0)
        return out

    if mode != "bilinear":
        raise ValueError(mode)

    lo_f = torch.floor(idx)
    lo = lo_f.to(torch.int64)
    frac = idx - lo_f
    out = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                corner = lo + torch.tensor([dz, dy, dx], device=dev)
                w = ((frac[..., 0] if dz else 1 - frac[..., 0])
                     * (frac[..., 1] if dy else 1 - frac[..., 1])
                     * (frac[..., 2] if dx else 1 - frac[..., 2]))
                if padding_mode == "zeros":
                    # each out-of-range corner contributes 0
                    in_rng = ((corner >= 0) & (corner <= max_int)).all(-1)
                    w = torch.where(in_rng, w, 0.0)
                corner = torch.minimum(torch.maximum(
                    corner, torch.zeros_like(max_int)), max_int)
                term = w * _gather_zyx(vol, corner[..., 0], corner[..., 1],
                                       corner[..., 2])
                out = term if out is None else out + term
    return out


def patch_grid_offsets(patch_size: int, vol_shape, device=None
                       ) -> torch.Tensor:
    """The identity affine_grid of a patch (align_corners=False) scaled
    into volume-relative grid units.

    :return: (patch_size^3, 3) xyz offsets in grid coordinates
    """
    p = patch_size
    base = (2.0 * torch.arange(p, device=device, dtype=torch.float32)
            + 1.0) / p - 1.0
    zz, yy, xx = torch.meshgrid(base, base, base, indexing="ij")
    grid = torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)   # xyz order
    d, h, w = vol_shape[-3:]
    scale = p / torch.tensor([w, h, d], dtype=torch.float32, device=device)
    return grid * scale


def sample_patches_at_kpts(vol: torch.Tensor, kpts_grid: torch.Tensor,
                           patch_size: int) -> torch.Tensor:
    """A patch_size^3 patch around each keypoint (nearest for an odd size,
    trilinear for an even one), border padding.

    :param vol: (D, H, W) volume, or (C, D, H, W)
    :param kpts_grid: (N, 3) xyz grid coordinates in [-1, 1]
    :return: (N, p, p, p), or (C, N, p, p, p)
    """
    offs = patch_grid_offsets(patch_size, vol.shape, device=vol.device)
    coords = kpts_grid[:, None, :] + offs[None]              # (N, p^3, 3)
    mode = "nearest" if patch_size % 2 == 1 else "bilinear"
    out = grid_sample_volume(vol, coords, mode=mode, padding_mode="border")
    p = patch_size
    return out.reshape(*out.shape[:-2], -1, p, p, p)
