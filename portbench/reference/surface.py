"""The serving cells' reference for the surface fit and the labelmap: for
a served case, each fissure class's Poisson surface worked out again from
the answer's labelled keypoints, and the numbers that judge the answer's
meshes and labelmap by it.

The fit follows the port's protocol (postprocess/surface_fitting.py,
ops/normals.py, ops/dpsr.py), written plainly in float64 NumPy and
SciPy: a class's keypoints (at most `class_cap`, in the answer's order)
in grid coordinates, zyx, on a `grid_res` lattice of index coordinates
v * (res - 1), v = (g + 1) / 2; normals by PCA of each point's k nearest
(itself among them), oriented to the side of the smallest principal axis
of the whole cloud, that axis signed so its last (x) component is >= 0;
the normals splatted trilinearly (corners outside dropped); the spectral
Poisson solve (Gaussian filter exp(-0.5 (sig 2|w| / res0)^2), divergence
over the negative Laplacian, DC zeroed); phi shifted by its mean at the
points (trilinear, clamped) and scaled to -phi / |phi[0, 0, 0]| / 2;
inside where phi < 0, cropped to the points' bounding box of lattice
points, and of it the largest 26-connected component.

The surface is where marching tetrahedra puts triangles and the host
filter keeps them: the cells (lattice cubes) inside the points' cell box
(lower corner from floor(min) - 1, upper ceil(max), as the device half
restricts them) whose corners are not all on one side of 0 and of which
a corner lies in the kept component. The answer is judged against those
cells, at a tolerance of one cell (a voxel of the 256^3 volume is a
quarter of a cell; the answer's corners near 0 may round to the other
side): its class-c labelmap voxels and mesh triangles (centres) must lie
within a cell of a surface cell, and every surface cell must have one of
the answer's class-c voxels and one of its triangles within a cell.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage


def lattice(kpts_zyx: np.ndarray, shape, res) -> np.ndarray:
    """(n, 3) float64 lattice coordinates zyx of zyx voxel keypoints in a
    `shape` volume (kpts_to_grid, align_corners False)."""
    size = np.asarray(shape, np.float64)
    g = (kpts_zyx / (size - 1) * 2 - 1) * ((size - 1) / size)
    return (g + 1) / 2 * (np.asarray(res, np.float64) - 1)


def world_to_lattice(world_xyz: np.ndarray, shape, res) -> np.ndarray:
    """World xyz voxel coordinates (..., 3) -> lattice zyx."""
    return lattice(world_xyz[..., ::-1].astype(np.float64), shape, res)


def normals(p: np.ndarray, k: int, device="cpu",
            block: int = 2048) -> np.ndarray:
    """Unit normals (n, 3) of the points p (n, 3) by kNN-PCA, oriented;
    the distances and the eigenvectors in float64 torch on `device`."""
    pt = torch.as_tensor(p, dtype=torch.float64, device=device)
    k = min(k, len(pt))
    out = []
    for s in range(0, len(pt), block):
        d = torch.cdist(pt[s:s + block], pt)
        nb = pt[d.topk(k, dim=1, largest=False).indices]      # (b, k, 3)
        nb = nb - nb.mean(1, keepdim=True)
        cov = nb.transpose(1, 2) @ nb / k
        out.append(torch.linalg.eigh(cov)[1][..., 0])
    out = torch.cat(out).cpu().numpy()
    c = p - p.mean(0)
    ref = np.linalg.eigh(c.T @ c)[1][:, 0]
    if ref[2] < 0:
        ref = -ref
    return np.where((out @ ref)[:, None] < 0, -out, out)


def splat(p: np.ndarray, vals: np.ndarray, res) -> np.ndarray:
    """Trilinear scatter of (n, f) values at lattice points -> (f, *res)."""
    res = tuple(res)
    grid = np.zeros((vals.shape[1],) + res)
    lo = np.floor(p).astype(np.int64)
    fr = p - lo
    for corner in np.ndindex(2, 2, 2):
        c = lo + corner
        w = np.prod(np.where(corner, fr, 1 - fr), axis=1)
        ok = ((c >= 0) & (c < res)).all(1)
        for f in range(vals.shape[1]):
            np.add.at(grid[f], tuple(c[ok].T), w[ok] * vals[ok, f])
    return grid


def interp(grid: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Trilinear value of `grid` at lattice points p (corners clamped)."""
    lo = np.floor(p).astype(np.int64)
    fr = p - lo
    top = np.asarray(grid.shape) - 1
    out = 0.0
    for corner in np.ndindex(2, 2, 2):
        c = np.clip(lo + corner, 0, top)
        out = out + np.prod(np.where(corner, fr, 1 - fr), axis=1) * \
            grid[tuple(c.T)]
    return out


def poisson(p: np.ndarray, nrm: np.ndarray, res, sig: float) -> np.ndarray:
    """The indicator phi on the lattice of points p with normals nrm."""
    res = tuple(res)
    field = splat(p, nrm, res)
    freqs = np.meshgrid(*[np.fft.fftfreq(r, d=1 / r) for r in res],
                        indexing="ij")
    omega = np.stack(freqs, -1)
    filt = np.exp(-0.5 * (sig * 2 * np.sqrt((omega ** 2).sum(-1)) / res[0])
                  ** 2)
    omega = omega * 2 * np.pi
    lap = -(omega ** 2).sum(-1)
    lap[0, 0, 0] = 1.0
    phi_hat = sum(np.fft.fftn(field[d]) * (-1j * omega[..., d]) * filt / lap
                  for d in range(3))
    phi_hat[0, 0, 0] = 0.0
    phi = np.fft.ifftn(phi_hat).real
    phi = phi - interp(phi, p).mean()
    return -phi / abs(phi[0, 0, 0]) * 0.5


# the 6 tetrahedra of a cell (corner ids z * 4 + y * 2 + x), as the
# port's marching splits it (ops/marching.py)
TETS = ((0, 5, 1, 7), (0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7), (0, 6, 4, 7),
        (0, 4, 5, 7))


def surface_cells(p: np.ndarray, phi: np.ndarray,
                  max_tris: int) -> np.ndarray:
    """Bool (res - 1)^3: the cells the class's surface passes through
    (when the cell box holds more than `max_tris` triangles, the cells
    past that many in z order have none, as in the port's budget)."""
    res = np.asarray(phi.shape)
    inside = phi < 0
    lo = np.maximum(np.floor(p.min(0)).astype(int), 0)
    hi = np.ceil(p.max(0)).astype(int)
    box = np.zeros_like(inside)
    box[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1] = True
    comp, n = ndimage.label(inside & box, structure=np.ones((3, 3, 3)))
    if n:
        sizes = np.bincount(comp.ravel())[1:]
        kept = comp == 1 + int(np.argmax(sizes))
    else:
        kept = np.zeros_like(inside)
    cells = tuple(res - 1)
    corners = [(slice(dz, dz + cells[0]), slice(dy, dy + cells[1]),
                slice(dx, dx + cells[2])) for dz, dy, dx in np.ndindex(2, 2, 2)]
    ins = [inside[sl].astype(np.int64) for sl in corners]
    near_kept = np.zeros(cells, bool)
    for sl in corners:
        near_kept |= kept[sl]
    tris = np.zeros(cells, np.int64)
    for tet in TETS:
        n_in = sum(ins[v] for v in tet)
        tris += ((n_in >= 1) & (n_in <= 3)).astype(np.int64) + (n_in == 2)
    cell_box = np.zeros(cells, bool)
    clo = np.maximum(np.floor(p.min(0)) - 1, 0).astype(int)
    cell_box[clo[0]:hi[0] + 1, clo[1]:hi[1] + 1, clo[2]:hi[2] + 1] = True
    tris = np.where(cell_box, tris, 0)
    before = (np.cumsum(tris.ravel()) - tris.ravel()).reshape(cells)
    return (tris > 0) & (before < max_tris) & near_kept


def _near(cells: np.ndarray) -> np.ndarray:
    return ndimage.binary_dilation(cells, structure=np.ones((3, 3, 3)))


def judge_surfaces(kpts: np.ndarray, labels: np.ndarray, meshes: list,
                   labelmap: np.ndarray, serving: dict,
                   device="cpu") -> dict:
    """The numbers that judge a served case's meshes and labelmap:
      surface_gap  the worst, over the fissure classes, of 1 - the smallest
                   of four shares: of the class's labelmap voxels, and of
                   its valid mesh triangles, those within a cell of a
                   surface cell; of the surface cells, those with a
                   class voxel, and those with a triangle, within a cell
                   (a class the reference fits no surface to: 1 if the
                   answer has voxels or triangles of it, else 0)
    kpts (n, 3) zyx and labels (n,) are the answer's; meshes its
    [(tris (T, 3, 3) world xyz, valid (T,))] a class; labelmap (D, H, W)."""
    shape = labelmap.shape
    res = tuple(serving["grid_res"])
    cells = tuple(r - 1 for r in res)
    gap = 0.0
    for c, (tris, valid) in enumerate(meshes, start=1):
        pts = kpts[labels == c][:serving["class_cap"]].astype(np.float64)
        vox = np.argwhere(labelmap == c).astype(np.float64)
        tris = np.asarray(tris)[np.asarray(valid, bool)]
        if len(pts) < 4:
            gap = max(gap, float(len(vox) > 0 or len(tris) > 0))
            continue
        p = lattice(pts, shape, res)
        phi = poisson(p, normals(p, serving["k_normals"], device), res,
                      serving["sig"])
        surf = surface_cells(p, phi, serving["max_tris"])
        if not surf.any():
            gap = max(gap, float(len(vox) > 0 or len(tris) > 0))
            continue
        near_surf = _near(surf)
        shares = []
        for lat in (lattice(vox, shape, res),
                    world_to_lattice(tris.mean(1), shape, res)):
            if not len(lat):
                shares.append(0.0)
                continue
            at = tuple(np.clip(np.floor(lat).astype(int), 0,
                               np.asarray(cells) - 1).T)
            got = np.zeros(cells, bool)
            got[at] = True
            shares.append(float(near_surf[at].mean()))
            shares.append(float(_near(got)[surf].mean()))
        gap = max(gap, 1.0 - min(shares))
    return {"surface_gap": gap}
