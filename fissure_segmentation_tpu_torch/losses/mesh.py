"""Regularized mesh loss: Chamfer on surface samples + edge length + normal
consistency + uniform Laplacian smoothing (counterpart of losses/mesh.py).

Meshes share a static topology (the FoldingNet plane mesh), so the
adjacency is computed once on the host with numpy (`MeshTopology.
from_faces`, a copy of the JAX package's) and every term gathers from the
(B, V, 3) predicted vertices. The Laplacian's neighbour sums are
`index_add_`s (JAX's `.at[].add`).

Surface samples: the JAX loss takes ``rng=jax.random.PRNGKey(0)`` by
default and the PC-AE entry never passes another, so the reference draws
the same uniforms on every call, for every cloud of the batch (one key for
the whole vmap). The port keeps that: the loss holds one fixed draw
(`surface_draws`, from a generator seeded with 0, or injected: the tests
pass JAX's) and samples every predicted mesh with it; a target given as a
mesh has a fixed draw of its own, as JAX's second key.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.marching import sample_points_on_triangles
from .chamfer import chamfer_distance


class MeshTopology(NamedTuple):
    edges: np.ndarray           # (E, 2) unique undirected edges
    face_pairs: np.ndarray      # (P, 2) faces sharing an edge
    shared_edges: np.ndarray    # (P, 2) the shared edge verts per pair
    opposite_verts: np.ndarray  # (P, 2) the vert opposite the edge, per face
    num_verts: int

    @classmethod
    def from_faces(cls, faces: np.ndarray, num_verts: int) -> "MeshTopology":
        faces = np.asarray(faces)
        e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [0, 2]]])
        e = np.sort(e, axis=1)
        edges, inverse = np.unique(e, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        # faces sharing an edge: group face ids by edge id
        face_ids = np.tile(np.arange(len(faces)), 3)
        order = np.argsort(inverse, kind="stable")
        inv_sorted = inverse[order]
        fid_sorted = face_ids[order]
        pairs, shared, opposite = [], [], []
        start = 0
        for i in range(1, len(inv_sorted) + 1):
            if i == len(inv_sorted) or inv_sorted[i] != inv_sorted[start]:
                group = fid_sorted[start:i]
                if len(group) == 2:
                    edge = edges[inv_sorted[start]]
                    pairs.append(group)
                    shared.append(edge)
                    opp = [int(v) for f in group for v in faces[f]
                           if v not in edge.tolist()]
                    opposite.append(opp[:2])
                start = i
        pairs = np.asarray(pairs) if pairs else np.zeros((0, 2), int)
        shared = np.asarray(shared) if shared else np.zeros((0, 2), int)
        opposite = np.asarray(opposite) if opposite else np.zeros((0, 2), int)
        return cls(edges, pairs, shared, opposite, num_verts)


    def to(self, device) -> "MeshTopology":
        """The index arrays as int64 tensors on `device` (the loss copies
        its topology once per device, not every step)."""
        return MeshTopology(*(_idx(a, device) for a in self[:4]),
                            self.num_verts)


def _idx(a, device) -> torch.Tensor:
    """Index array (numpy or tensor) as int64 on `device`; no copy for a
    tensor already there."""
    return torch.as_tensor(a, dtype=torch.int64, device=device)


def mesh_edge_loss(verts: torch.Tensor, topo: MeshTopology,
                   target_length: float = 0.0) -> torch.Tensor:
    """Mean squared (length - target)^2 over the edges."""
    edges = _idx(topo.edges, verts.device)
    e = verts[..., edges[:, 0], :] - verts[..., edges[:, 1], :]
    return ((torch.linalg.norm(e, dim=-1) - target_length) ** 2).mean()


def mesh_normal_consistency(verts: torch.Tensor, faces: np.ndarray,
                            topo: MeshTopology) -> torch.Tensor:
    """For each edge shared by two faces with opposite vertices a and b,
    n0 = (v1 - v0) x (a - v0), n1 = (v1 - v0) x (b - v0); the mean of
    1 - cos(n0, -n1) (zero on a flat mesh whatever the winding)."""
    if len(topo.face_pairs) == 0:
        return torch.zeros((), device=verts.device)

    shared = _idx(topo.shared_edges, verts.device)
    opposite = _idx(topo.opposite_verts, verts.device)
    v0, v1 = verts[..., shared[:, 0], :], verts[..., shared[:, 1], :]
    a, b = verts[..., opposite[:, 0], :], verts[..., opposite[:, 1], :]
    e = v1 - v0
    n0 = torch.linalg.cross(e, a - v0)
    n1 = torch.linalg.cross(e, b - v0)
    cos = (n0 * -n1).sum(-1) / torch.clamp(
        torch.linalg.norm(n0, dim=-1) * torch.linalg.norm(n1, dim=-1),
        min=1e-12)
    return (1.0 - cos).mean()


def mesh_laplacian_smoothing(verts: torch.Tensor, topo: MeshTopology
                             ) -> torch.Tensor:
    """Uniform Laplacian: the mean over vertices of
    |mean(neighbours) - v| (vertices without an edge count 0)."""
    dev = verts.device
    edges = _idx(topo.edges, dev)
    e0, e1 = edges[:, 0], edges[:, 1]
    deg = torch.zeros(topo.num_verts, device=dev)
    deg.index_add_(0, e0, torch.ones_like(e0, dtype=deg.dtype))
    deg.index_add_(0, e1, torch.ones_like(e1, dtype=deg.dtype))
    nb = torch.zeros((*verts.shape[:-2], topo.num_verts, 3),
                     dtype=verts.dtype, device=dev)
    nb = nb.index_add(-2, e0, verts[..., e1, :])
    nb = nb.index_add(-2, e1, verts[..., e0, :])
    lap = nb / torch.clamp(deg, min=1.0)[:, None] - verts
    lap = torch.where((deg > 0)[:, None], lap, 0.0)
    return torch.linalg.norm(lap, dim=-1).mean()


def surface_draws(n_samples: int, seed: int = 0):
    """The mesh loss's fixed uniforms: (u (n_samples,), uv (n_samples, 2))
    from a CPU generator seeded with `seed`."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n_samples, generator=g),
            torch.rand((n_samples, 2), generator=g))


def make_regularized_mesh_loss(w_chamfer: float = 1.0,
                               w_edge_length: float = 1.0,
                               w_normal_consistency: float = 0.1,
                               w_laplacian: float = 0.1,
                               n_samples: int = 2048, draws=None,
                               target_draws=None):
    """Returns ``loss(pred_verts, target, *, faces, topo, target_faces=None)
    -> (scalar, components)``.

    :param draws: the fixed surface draws of every predicted mesh,
        (u (n_samples,), uv (n_samples, 2)); default `surface_draws(
        n_samples, 0)`
    :param target_draws: those of a target given as a mesh (vertices and
        `target_faces`); default `surface_draws(n_samples, 1)`
    """
    fixed = {"pred": surface_draws(n_samples, 0) if draws is None
             else draws,
             "target": surface_draws(n_samples, 1) if target_draws is None
             else target_draws}
    on_device = {}     # (what, device) -> its copy there

    def cached(what, value, device, convert):
        key = (what, id(value), str(device))
        if key not in on_device:
            on_device[key] = (value, convert(value, device))
        return on_device[key][1]

    def sample(verts, faces, which):
        dev = verts.device
        tris = verts[..., cached("faces", faces, dev, _idx), :]  # (B,F,3,3)
        valid = torch.ones(tris.shape[:-2], dtype=torch.bool, device=dev)
        draws_on = cached(which, fixed[which], dev, lambda d, dv: tuple(
            t.to(dv) for t in d))
        return sample_points_on_triangles(tris, valid, n_samples,
                                          draws=draws_on)

    def loss(pred_verts, target, *, faces, topo: MeshTopology,
             target_faces=None):
        topo = cached("topo", topo, pred_verts.device,
                      lambda t, dv: t.to(dv))
        comps = {}
        total = 0.0
        if w_chamfer > 0:
            sample_t = target if target_faces is None else \
                sample(target, target_faces, "target")
            cham = chamfer_distance(sample(pred_verts, faces, "pred"),
                                    sample_t)
            comps["Chamfer"] = cham
            total = total + w_chamfer * cham
        if w_edge_length > 0:
            el = mesh_edge_loss(pred_verts, topo)
            comps["Edge Length"] = el
            total = total + w_edge_length * el
        if w_normal_consistency > 0:
            nc = mesh_normal_consistency(pred_verts, faces, topo)
            comps["Normal Consistency"] = nc
            total = total + w_normal_consistency * nc
        if w_laplacian > 0:
            lap = mesh_laplacian_smoothing(pred_verts, topo)
            comps["Laplacian"] = lap
            total = total + w_laplacian * lap
        return total, comps

    return loss
