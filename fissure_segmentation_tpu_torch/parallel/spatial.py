"""Volume sharding along z with halo exchange: the slab-parallel sliding
window (counterpart of parallel/spatial.py).

Each rank holds a z-slab of the volume; the halo functions move boundary
rows between neighbouring ranks with `ppermute` (parallel/mesh.py), as the
JAX ones do inside `shard_map`:

  halo_exchange      symmetric, one hop: every rank gets the `halo`
                     boundary rows of both z-neighbours (edge-replicated
                     at the mesh's ends);
  halo_reduce        its transpose for sums: each rank's halo partial sums
                     go to the neighbour that owns those rows (the
                     replicated ends' halos have no owner and are dropped);
  halo_exchange_down / halo_reduce_down
                     the multi-hop pair of the sliding window: a patch
                     belongs to the rank whose slab holds its start row,
                     so a rank reads only downward (its slab and the next
                     `hops` slabs) and its partial sums for those slabs go
                     back the same way; a patch may be taller than a slab.

`sharded_predict_all_patches` computes models/seg_cnn.py:predict_all_patches
with the patches split by start row: the same edge padding, patch grid,
Gaussian blending and second softmax; every rank runs the same number of
patches (the padded ones with weight 0, as in the JAX function's static
program), and the blended slabs are gathered so every rank returns the
whole volume.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..models.seg_cnn import (_edge_pad, _softmax_forward,
                              gaussian_importance_map, get_patch_starts)
from ..utils.filters import _pad_axis
from .mesh import Mesh, all_gather, ppermute, shard_along


def halo_exchange(x_local: torch.Tensor, halo: int, mesh: Mesh
                  ) -> torch.Tensor:
    """(local_d, ...) slab -> (halo + local_d + halo, ...) with both
    neighbours' boundary rows; the mesh's ends edge-replicated. Needs
    halo <= local_d."""
    if halo > x_local.shape[0]:
        raise ValueError(f"halo {halo} exceeds local slab {x_local.shape[0]}")
    n, i = mesh.size, mesh.rank
    from_prev = ppermute(x_local[-halo:], mesh,
                         [(r, (r + 1) % n) for r in range(n)])
    from_next = ppermute(x_local[:halo], mesh,
                         [(r, (r - 1) % n) for r in range(n)])
    top = x_local[:1].expand(halo, *x_local.shape[1:]) if i == 0 \
        else from_prev
    bot = x_local[-1:].expand(halo, *x_local.shape[1:]) if i == n - 1 \
        else from_next
    return torch.cat([top, x_local, bot], dim=0)


def halo_reduce(y_ext: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """The transpose of halo_exchange for sums: fold each rank's halo
    partial sums into the neighbour that owns the rows."""
    n, i = mesh.size, mesh.rank
    core = y_ext[halo:-halo].clone()
    to_prev = ppermute(y_ext[:halo], mesh,
                       [(r, (r - 1) % n) for r in range(n)])
    to_next = ppermute(y_ext[-halo:], mesh,
                       [(r, (r + 1) % n) for r in range(n)])
    if i != n - 1:              # from rank i + 1
        core[-halo:] += to_prev
    if i != 0:                  # from rank i - 1
        core[:halo] += to_next
    return core


def halo_exchange_down(x_local: torch.Tensor, hops: int, mesh: Mesh
                       ) -> torch.Tensor:
    """(slab, ...) -> ((1 + hops) * slab, ...): this rank's slab followed by
    the next `hops` ranks' slabs (edge-replicated past the mesh's end)."""
    n, i = mesh.size, mesh.rank
    blocks = [x_local]
    for j in range(1, hops + 1):
        # rank m sends its slab to m - j, so rank i receives i + j's
        blk = ppermute(x_local, mesh, [(m, (m - j) % n) for m in range(n)])
        if i + j > n - 1:
            blk = blocks[-1][-1:].expand_as(x_local)
        blocks.append(blk)
    return torch.cat(blocks, dim=0)


def halo_reduce_down(y_ext: torch.Tensor, hops: int, slab: int, mesh: Mesh
                     ) -> torch.Tensor:
    """The transpose of halo_exchange_down: rank i's partial sums for the
    slabs of ranks i + 1 ... i + hops go back to their owners.
    ((1 + hops) * slab, ...) -> (slab, ...)."""
    n, i = mesh.size, mesh.rank
    core = y_ext[:slab].clone()
    for j in range(1, hops + 1):
        blk = y_ext[j * slab:(j + 1) * slab]
        # rank m computed sums for rank m + j's slab
        recv = ppermute(blk, mesh, [(m, (m + j) % n) for m in range(n)])
        if i >= j:
            core += recv
    return core


def _partition_starts(starts_z, n_dev: int, slab: int):
    """Give each global patch z-start to the rank owning the start row, as
    a coordinate in that rank's slab; pad every rank's list to one length
    with weight-0 dummies. Returns (starts (n_dev, width) int32, valid
    (n_dev, width) bool)."""
    per_dev: list[list[int]] = [[] for _ in range(n_dev)]
    for sz in starts_z:
        d = min(sz // slab, n_dev - 1)
        per_dev[d].append(sz - d * slab)
    width = max(1, max(len(p) for p in per_dev))
    starts = np.zeros((n_dev, width), np.int32)
    valid = np.zeros((n_dev, width), bool)
    for d, p in enumerate(per_dev):
        starts[d, :len(p)] = p
        valid[d, :len(p)] = True
    return starts, valid


@torch.no_grad()
def sharded_predict_all_patches(model, img: torch.Tensor, num_classes: int,
                                mesh: Mesh, patch_size=(128, 128, 128),
                                min_overlap: float = 0.5,
                                use_gaussian: bool = True) -> torch.Tensor:
    """Slab-parallel sliding-window inference, the function of
    models/seg_cnn.py:predict_all_patches (float32).

    :param model: the CNN (eval mode), e.g. MobileNetASPP
    :param img: (D, H, W) volume on the mesh's device, the same on every
        rank
    :return: (D, H, W, num_classes) blended softmax, on every rank
    """
    n_dev = mesh.size
    dhw = tuple(img.shape)
    dev = img.device
    pz, py, px = patch_size
    pad = [max(0, p - s) for s, p in zip(dhw, patch_size)]
    img_p = _edge_pad(img.to(torch.float32), pad)
    d_pad = (-img_p.shape[0]) % n_dev
    if d_pad:
        img_p = _pad_axis(img_p, 0, 0, d_pad, "replicate")
    dp, hp, wp = img_p.shape
    slab = dp // n_dev
    hops = math.ceil(pz / slab)

    starts = get_patch_starts((dp - d_pad, hp, wp), min_overlap, patch_size)
    starts_np, valid_np = _partition_starts(starts[0], n_dev, slab)
    gmap = (torch.as_tensor(gaussian_importance_map(patch_size), device=dev)
            if use_gaussian else
            torch.ones(tuple(patch_size), dtype=torch.float32, device=dev))
    gmap = gmap[..., None]

    ext = halo_exchange_down(shard_along(img_p, mesh, 0), hops, mesh)
    out = torch.zeros((ext.shape[0], hp, wp, num_classes),
                      dtype=torch.float32, device=dev)
    norm = torch.zeros((ext.shape[0], hp, wp, 1), dtype=torch.float32,
                       device=dev)
    for sz, ok in zip(starts_np[mesh.rank].tolist(),
                      valid_np[mesh.rank].tolist()):
        w = 1.0 if ok else 0.0
        for sy in starts[1]:
            for sx in starts[2]:
                sl = (slice(sz, sz + pz), slice(sy, sy + py),
                      slice(sx, sx + px))
                out[sl] += _softmax_forward(model, ext[sl]) * gmap * w
                norm[sl] += gmap * w
    out = halo_reduce_down(out, hops, slab, mesh)
    norm = halo_reduce_down(norm, hops, slab, mesh)
    out = all_gather(out / torch.clamp(norm, min=1e-12), mesh, 0)
    lo = [q // 2 + q % 2 for q in pad]
    out = out[lo[0]:lo[0] + dhw[0], lo[1]:lo[1] + dhw[1],
              lo[2]:lo[2] + dhw[2]]
    return torch.softmax(out, dim=-1)
