"""Iso-surface extraction by marching tetrahedra (counterpart of
ops/marching.py: the tetrahedra table, `_cell_tri_counts`,
`_tet_slot_bits`, `_rank_to_slot`, `_marching_candidates`,
`_gather_triangles` and `marching_tetrahedra` with `cell_mask`).

Each grid cell is split into 6 tetrahedra and triangles come from a
16-case table derived in code. Output is a fixed budget of `max_tris`
triangles, located count-then-emit: per-cell triangle counts, their
inclusive cumsum, one searchsorted per output slot, and a 12-lane bit-rank
for the tet/slot within the cell. Slot j holds the (j+1)-th candidate in
(cell z-order, tet, slot) order, so a budget overflow truncates in z-order
exactly like the JAX package.

Not ported: the batched, hybrid and packed variants.
"""
from __future__ import annotations

import numpy as np
import torch

# 6-tetrahedra decomposition of the unit cube (corner ids 0..7, bit order
# (z, y, x): corner = z*4 + y*2 + x). All 6 tets share the main diagonal 0-7.
_TETS = np.array([
    [0, 5, 1, 7],
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
])
# corner id c has (z, y, x) offset _CORNERS[c] with c = z*4 + y*2 + x
_CORNERS = np.array([[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)])
# the 6 edges of a tetrahedron as (vertex_a, vertex_b) local ids 0..3
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])


def _build_tet_table():
    """Triangle table for the 16 sign cases: case bit i set <=> tet vertex i
    is inside (value < iso); 0, 1 or 2 triangles of tet-edge ids, -1 pad."""
    table = np.full((16, 2, 3), -1, np.int32)
    edge_id = {tuple(sorted(e)): i for i, e in enumerate(_TET_EDGES.tolist())}
    for case in range(1, 15):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if not case & (1 << i)]
        if len(inside) == 1:
            a = inside[0]
            table[case, 0] = [edge_id[tuple(sorted((a, b)))] for b in outside]
        elif len(inside) == 3:
            a = outside[0]
            table[case, 0] = [edge_id[tuple(sorted((a, b)))] for b in inside]
        else:  # 2 inside, 2 outside -> quad -> 2 triangles
            a, b = inside
            c, d = outside
            e_ac = edge_id[tuple(sorted((a, c)))]
            e_ad = edge_id[tuple(sorted((a, d)))]
            e_bc = edge_id[tuple(sorted((b, c)))]
            e_bd = edge_id[tuple(sorted((b, d)))]
            # quad ac-ad-bd-bc split along ac-bd
            table[case, 0] = [e_ac, e_ad, e_bd]
            table[case, 1] = [e_ac, e_bd, e_bc]
    return table


_TET_TABLE = _build_tet_table()


def _cell_tri_counts(phi: torch.Tensor, iso: float, cell_dims):
    """Per-cell triangle counts from shifted corner slices (no gather)."""
    cz, cy, cx = cell_dims
    ins = [(phi[..., dz:dz + cz, dy:dy + cy, dx:dx + cx] < iso).to(torch.int32)
           for dz, dy, dx in _CORNERS]
    counts = torch.zeros(phi.shape[:-3] + (cz, cy, cx), dtype=torch.int32,
                         device=phi.device)
    for t in range(6):
        n_in = (ins[_TETS[t][0]] + ins[_TETS[t][1]]
                + ins[_TETS[t][2]] + ins[_TETS[t][3]])
        counts += ((n_in >= 1) & (n_in <= 3)).to(torch.int32) \
            + (n_in == 2).to(torch.int32)
    return counts


def _tet_slot_bits(ins8: torch.Tensor) -> torch.Tensor:
    """(..., 8) corner inside-flags -> (..., 12) tet/slot emission flags in
    candidate order (tet-major, then slot)."""
    bits = []
    for t in range(6):
        n_in = (ins8[..., _TETS[t][0]] + ins8[..., _TETS[t][1]]
                + ins8[..., _TETS[t][2]] + ins8[..., _TETS[t][3]])
        bits.append((n_in >= 1) & (n_in <= 3))
        bits.append(n_in == 2)
    return torch.stack(bits, dim=-1)


def _rank_to_slot(bits: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Index of the (r+1)-th set flag along the last axis (prefix sum +
    first-hit argmax; a row with no hit gives 0)."""
    brank = torch.cumsum(bits.to(torch.int32), dim=-1)
    hit = (brank == (r + 1)[..., None]) & bits
    return torch.argmax(hit.to(torch.int32), dim=-1)


def _marching_candidates(phi: torch.Tensor, max_tris: int, iso: float,
                         cell_mask: torch.Tensor | None):
    """Count-then-emit candidate selection; returns (tvalid (max_tris,),
    n_tris (), idx_buf (max_tris,) global candidate ids)."""
    d, h, w = phi.shape
    if min(d, h, w) < 2:
        raise ValueError(f"marching_tetrahedra needs >= 2 samples per axis, "
                         f"got {tuple(phi.shape)}")
    cz, cy, cx = d - 1, h - 1, w - 1
    if cell_mask is not None and tuple(cell_mask.shape) != (cz, cy, cx):
        raise ValueError(f"cell_mask shape {tuple(cell_mask.shape)} != cell "
                         f"grid {(cz, cy, cx)}")
    dev = phi.device
    counts = _cell_tri_counts(phi, iso, (cz, cy, cx))
    if cell_mask is not None:
        counts = counts * cell_mask.to(torch.int32)
    n_tris = counts.sum()

    # output slot j's cell: the first cell whose running count reaches j+1
    ccum = torch.cumsum(counts.reshape(-1), dim=0)            # int64
    slots = torch.arange(1, max_tris + 1, device=dev)
    cell_idx = torch.searchsorted(ccum, slots).clamp(0, ccum.shape[0] - 1)
    prev = torch.where(cell_idx > 0, ccum[(cell_idx - 1).clamp(min=0)], 0)
    r = slots - 1 - prev                                      # rank in cell

    x = cell_idx % cx
    y = (cell_idx // cx) % cy
    z = cell_idx // (cx * cy)
    co = torch.from_numpy(_CORNERS).to(dev)
    vals8 = phi[z[:, None] + co[:, 0], y[:, None] + co[:, 1],
                x[:, None] + co[:, 2]]                        # (max_tris, 8)
    bits = _tet_slot_bits((vals8 < iso).to(torch.int32))      # (max_tris, 12)
    s = _rank_to_slot(bits, r)
    tvalid = torch.arange(max_tris, device=dev) < torch.clamp(n_tris,
                                                              max=max_tris)
    idx_buf = torch.where(tvalid, cell_idx * 12 + s, 0)
    return tvalid, n_tris, idx_buf


def _gather_triangles(phi: torch.Tensor, gids: torch.Tensor, iso: float,
                      cy: int, cx: int) -> torch.Tensor:
    """Triangles (M, 3, 3) zyx for global candidate ids
    gid = ((z*cy + y)*cx + x)*12 + tet*2 + slot, by linear interpolation
    along the tet edges the sign case crosses."""
    dev, dt = phi.device, phi.dtype
    cell = gids // 12
    rem = gids % 12
    tet, slot = rem // 2, rem % 2
    x = cell % cx
    y = (cell // cx) % cy
    z = cell // (cx * cy)

    corner_ids = torch.from_numpy(_TETS).to(dev)[tet]          # (M, 4)
    offs = torch.from_numpy(_CORNERS).to(dev)[corner_ids]      # (M, 4, 3)
    vals = phi[z[:, None] + offs[..., 0], y[:, None] + offs[..., 1],
               x[:, None] + offs[..., 2]]                      # (M, 4)
    ins = (vals < iso).to(torch.int64)
    case = ins[:, 0] + 2 * ins[:, 1] + 4 * ins[:, 2] + 8 * ins[:, 3]
    edges = torch.from_numpy(_TET_TABLE).to(dev, torch.int64)[case, slot]
    e = edges.clamp(min=0)                                     # -1 pad -> 0
    ab = torch.from_numpy(_TET_EDGES).to(dev)[e]               # (M, 3, 2)

    ar = torch.arange(gids.shape[0], device=dev)[:, None, None]
    vgath = vals[ar, ab]                                       # (M, 3, 2)
    ogath = offs[ar, ab].to(dt)                                # (M, 3, 2, 3)
    va, vb = vgath[..., 0], vgath[..., 1]
    diff = vb - va
    frac = (iso - va) / torch.where(diff.abs() < 1e-12, 1e-12, diff)
    frac = frac.clamp(0.0, 1.0)                                # (M, 3)
    oa, ob = ogath[:, :, 0, :], ogath[:, :, 1, :]              # (M, 3, 3)
    base = torch.stack([z, y, x], -1).to(dt)[:, None, :]       # (M, 1, 3)
    return base + oa + frac[..., None] * (ob - oa)


def marching_tetrahedra(phi: torch.Tensor, max_tris: int = 200_000,
                        iso: float = 0.0,
                        cell_mask: torch.Tensor | None = None):
    """Extract the iso-surface of a (D, H, W) scalar field.

    :param cell_mask: optional (D-1, H-1, W-1) bool — cells allowed to emit
        triangles (the surface fit passes the point-cloud bbox, so the
        z-order budget is spent on the real surface)
    :return: (tris (max_tris, 3, 3) zyx vertex coords in voxel units,
        valid (max_tris,) bool, n_tris () — the count before truncation)
    """
    tvalid, n_tris, idx_buf = _marching_candidates(phi, max_tris, iso,
                                                   cell_mask)
    out = _gather_triangles(phi, idx_buf, iso, phi.shape[1] - 1,
                            phi.shape[2] - 1)
    return torch.where(tvalid[:, None, None], out, 0.0), tvalid, n_tris
