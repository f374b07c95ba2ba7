"""Iso-surface extraction by marching tetrahedra (counterpart of
ops/marching.py: the tetrahedra table, `_cell_tri_counts`,
`_tet_slot_bits`, `_rank_to_slot`, `_marching_candidates`,
`_gather_triangles` and `marching_tetrahedra` with `cell_mask`), and the
surface sampling of the evaluation (`sample_points_on_triangles`,
`triangles_to_mesh`).

Each grid cell is split into 6 tetrahedra and triangles come from a
16-case table derived in code. Output is a fixed budget of `max_tris`
triangles, located count-then-emit: per-cell triangle counts, their
inclusive cumsum, one searchsorted per output slot, and a 12-lane bit-rank
for the tet/slot within the cell. Slot j holds the (j+1)-th candidate in
(cell z-order, tet, slot) order, so a budget overflow truncates in z-order
exactly like the JAX package. The count and the emission run on the
detached field; the triangles are rebuilt from it with gradients, so
`phi` gets JAX's exact marching gradient. `marching_tetrahedra_batched`
extracts a stack of fields at once (DPSR-Net's B x C' fields), with
per-field z-order truncation.

Not to port: the JAX package's hybrid variant (measured a negative there)
and `marching_tetrahedra_packed`, a transfer encoding for a slow tunnel
(serving.py says why the card's float path needs none).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import host_to

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
    first-hit argmax; a row with no hit gives 0). The prefix sum runs over
    the leading axis of the transposed flags: PyTorch scans a short last
    axis a row at a time, slowly at DPSR-Net's (96, 131072, 12) (PERF.md,
    PR 14)."""
    brank = torch.cumsum(bits.to(torch.int32).movedim(-1, 0).contiguous(),
                         dim=0).movedim(0, -1)
    hit = (brank == (r + 1)[..., None]) & bits
    return torch.argmax(hit.to(torch.int32), dim=-1)


def _marching_candidates(phi: torch.Tensor, max_tris: int, iso: float,
                         cell_mask: torch.Tensor | None):
    """Count-then-emit candidate selection over (B, D, H, W) fields, on
    the detached field (integer work, as the JAX package's stop_gradient);
    returns (tvalid (B, max_tris), n_tris (B,), idx_buf (B, max_tris)
    global candidate ids)."""
    b, d, h, w = phi.shape
    if min(d, h, w) < 2:
        raise ValueError(f"marching_tetrahedra needs >= 2 samples per axis, "
                         f"got {tuple(phi.shape[1:])}")
    cz, cy, cx = d - 1, h - 1, w - 1
    if cell_mask is not None and tuple(cell_mask.shape[-3:]) != (cz, cy, cx):
        raise ValueError(f"cell_mask shape {tuple(cell_mask.shape)} != cell "
                         f"grid {(cz, cy, cx)}")
    dev = phi.device
    phi = phi.detach()
    counts = _cell_tri_counts(phi, iso, (cz, cy, cx))        # (B, cz, cy, cx)
    if cell_mask is not None:
        counts = counts * cell_mask.to(torch.int32)
    n_tris = counts.sum((1, 2, 3))

    # output slot j's cell: the first cell whose running count reaches j+1
    ccum = torch.cumsum(counts.reshape(b, -1), dim=1)         # int64
    slots = torch.arange(1, max_tris + 1, device=dev).expand(b, max_tris)
    cell_idx = torch.searchsorted(ccum, slots.contiguous()).clamp(
        0, ccum.shape[1] - 1)
    prev = torch.where(cell_idx > 0,
                       torch.gather(ccum, 1, (cell_idx - 1).clamp(min=0)), 0)
    r = slots - 1 - prev                                      # rank in cell

    x = cell_idx % cx
    y = (cell_idx // cx) % cy
    z = cell_idx // (cx * cy)
    co = host_to(_CORNERS, dev)
    bi = torch.arange(b, device=dev)[:, None, None]
    vals8 = phi[bi, z[..., None] + co[:, 0], y[..., None] + co[:, 1],
                x[..., None] + co[:, 2]]                      # (B, max_tris, 8)
    bits = _tet_slot_bits((vals8 < iso).to(torch.int32))      # (..., 12)
    s = _rank_to_slot(bits, r)
    tvalid = torch.arange(max_tris, device=dev) < torch.clamp(
        n_tris, max=max_tris)[:, None]
    idx_buf = torch.where(tvalid, cell_idx * 12 + s, 0)
    return tvalid, n_tris, idx_buf


def _gather_triangles(phi: torch.Tensor, gids: torch.Tensor, iso: float,
                      cy: int, cx: int) -> torch.Tensor:
    """Triangles (B, M, 3, 3) zyx of (B, D, H, W) fields for global
    candidate ids gid = ((z*cy + y)*cx + x)*12 + tet*2 + slot (B, M), by
    linear interpolation along the tet edges the sign case crosses; the
    gradient reaches phi through the corner values, as in the JAX
    package."""
    dev, dt = phi.device, phi.dtype
    b, m = gids.shape
    cell = gids // 12
    rem = gids % 12
    tet, slot = rem // 2, rem % 2
    x = cell % cx
    y = (cell // cx) % cy
    z = cell // (cx * cy)

    corner_ids = host_to(_TETS, dev)[tet]          # (B, M, 4)
    offs = host_to(_CORNERS, dev)[corner_ids]      # (B, M, 4, 3)
    bi = torch.arange(b, device=dev)[:, None, None]
    vals = phi[bi, z[..., None] + offs[..., 0], y[..., None] + offs[..., 1],
               x[..., None] + offs[..., 2]]                    # (B, M, 4)
    ins = (vals.detach() < iso).to(torch.int64)
    case = ins[..., 0] + 2 * ins[..., 1] + 4 * ins[..., 2] + 8 * ins[..., 3]
    edges = host_to(_TET_TABLE, dev, torch.int64)[case, slot]
    e = edges.clamp(min=0)                                     # -1 pad -> 0
    ab = host_to(_TET_EDGES, dev)[e]               # (B, M, 3, 2)

    vgath = torch.gather(vals, 2, ab.reshape(b, m, 6)).reshape(b, m, 3, 2)
    ogath = torch.gather(offs, 2, ab.reshape(b, m, 6, 1).expand(
        b, m, 6, 3)).reshape(b, m, 3, 2, 3).to(dt)
    va, vb = vgath[..., 0], vgath[..., 1]
    diff = vb - va
    frac = (iso - va) / torch.where(diff.abs() < 1e-12, 1e-12, diff)
    frac = frac.clamp(0.0, 1.0)                                # (B, M, 3)
    oa, ob = ogath[..., 0, :], ogath[..., 1, :]                # (B, M, 3, 3)
    base = torch.stack([z, y, x], -1).to(dt)[..., None, :]     # (B, M, 1, 3)
    return base + oa + frac[..., None] * (ob - oa)


def marching_tetrahedra_batched(phis: torch.Tensor, max_tris: int = 200_000,
                                iso: float = 0.0,
                                cell_mask: torch.Tensor | None = None):
    """`marching_tetrahedra` of each of (B, D, H, W) fields at once.

    :param cell_mask: optional (D-1, H-1, W-1) or (B, D-1, H-1, W-1) bool
    :return: (tris (B, max_tris, 3, 3), valid (B, max_tris), n_tris (B,)),
        differentiable in `phis` through the triangles' vertices
    """
    tvalid, n_tris, idx_buf = _marching_candidates(phis, max_tris, iso,
                                                   cell_mask)
    out = _gather_triangles(phis, idx_buf, iso, phis.shape[2] - 1,
                            phis.shape[3] - 1)
    return torch.where(tvalid[..., None, None], out, 0.0), tvalid, n_tris


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
    if phi.ndim != 3:
        raise ValueError(f"marching_tetrahedra takes a (D, H, W) field, got "
                         f"{tuple(phi.shape)}")
    tris, tvalid, n_tris = marching_tetrahedra_batched(
        phi[None], max_tris, iso,
        None if cell_mask is None else cell_mask[None])
    return tris[0], tvalid[0], n_tris[0]


def triangles_to_mesh(tris: torch.Tensor):
    """(T, 3, 3) triangle soup -> (verts (3T, 3), faces (T, 3) int32)."""
    verts = tris.reshape(-1, 3)
    faces = torch.arange(verts.shape[0], dtype=torch.int32,
                         device=tris.device).reshape(-1, 3)
    return verts, faces


def sample_points_on_triangles(tris: torch.Tensor, valid: torch.Tensor,
                               n_samples: int,
                               generator: torch.Generator | None = None,
                               draws=None) -> torch.Tensor:
    """Area-weighted uniform samples on a (padded) triangle soup: a
    triangle by inverse CDF over the cumulated areas (searchsorted, right
    side, clipped to the last triangle), a point in it by the square-root
    barycentric map.

    :param tris: (..., T, 3, 3); :param valid: (..., T) bool — leading
        axes are soups sampled each with its own draws
    :param generator: generator of the two uniform draws (the triangles'
        (..., n_samples), then the barycentric (..., n_samples, 2)), drawn
        on its own device
    :param draws: (u (..., n_samples), uv (..., n_samples, 2)) uniforms in
        [0, 1) to use instead (tests inject the JAX package's); leading
        axes broadcast against the soups'
    :return: (..., n_samples, 3), differentiable in `tris`
    """
    lead = tris.shape[:-3]
    a, b, c = tris[..., 0, :], tris[..., 1, :], tris[..., 2, :]
    area = 0.5 * torch.linalg.norm(torch.linalg.cross(b - a, c - a), dim=-1)
    area = torch.where(valid, area, 0.0)
    if draws is None:
        dev = None if generator is None else generator.device
        draws = (torch.rand((*lead, n_samples), generator=generator,
                            device=dev),
                 torch.rand((*lead, n_samples, 2), generator=generator,
                            device=dev))
    u, uv = (d.to(device=tris.device, dtype=tris.dtype) for d in draws)
    u = u.expand(*lead, n_samples)
    cdf = torch.cumsum(area.detach(), -1)
    idx = torch.searchsorted(cdf, (u * cdf[..., -1:]).contiguous(),
                             right=True).clamp(0, area.shape[-1] - 1)
    u_, v_ = torch.sqrt(uv[..., :1]), uv[..., 1:]

    def corner(p):                       # (..., T, 3) -> (..., S, 3)
        return torch.gather(p, -2, idx[..., None].expand(*idx.shape, 3))
    return (1 - u_) * corner(a) + u_ * (1 - v_) * corner(b) \
        + u_ * v_ * corner(c)
