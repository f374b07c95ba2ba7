"""Evaluation metrics (counterpart of metrics.py): label Dice, binary
recall and precision, point-to-surface distances and the ASSD family
(ASSD / SDSD / HD / HD95).

`point_surface_distance` is the JAX package's exact point-to-triangle
distance (the branch-free edge/interior minimum), chunked over queries so
that at most (chunk, T) distances live at once. `mesh_metrics_from_point_sets`
takes the dense nearest-neighbour path that `evaluate_case` uses (both sets
sample their surfaces densely) or, given triangles, the exact distances
both ways: on the host through the native BVH (`native.point_mesh_distance`,
the default, as in the JAX package) or on the tensors' device.
"""
from __future__ import annotations

import torch

from . import native
from .ops.knn import pairwise_sqdist


def batch_dice(prediction: torch.Tensor, target: torch.Tensor,
               n_labels: int) -> torch.Tensor:
    """Per-class hard Dice, averaged over the batch.

    :param prediction: (B, ...) int labels
    :param target: (B, ...) int labels
    :return: (n_labels,) float32 mean Dice per class
    """
    pred = prediction.reshape(prediction.shape[0], -1)
    targ = target.reshape(target.shape[0], -1)
    dice = []
    for lbl in range(n_labels):
        lp, lt = pred == lbl, targ == lbl
        inter = (lp & lt).sum(-1).to(torch.float32)
        dice.append(2 * inter / (lp.sum(-1) + lt.sum(-1) + 1e-8))
    return torch.stack(dice, dim=1).mean(0)


def binary_recall(prediction: torch.Tensor,
                  target: torch.Tensor) -> torch.Tensor:
    """(B, ...) labels, 0 = background -> (B,) recall of the foreground."""
    p = (prediction != 0).reshape(prediction.shape[0], -1)
    t = (target != 0).reshape(target.shape[0], -1)
    return ((p & t).sum(-1) + 1e-8) / (t.sum(-1) + 1e-8)


def binary_precision(prediction: torch.Tensor,
                     target: torch.Tensor) -> torch.Tensor:
    """(B, ...) labels, 0 = background -> (B,) precision of the
    foreground."""
    p = (prediction != 0).reshape(prediction.shape[0], -1)
    t = (target != 0).reshape(target.shape[0], -1)
    return ((p & t).sum(-1) + 1e-8) / (p.sum(-1) + 1e-8)


def _seg_sqdist(p, a, b):
    ab = b - a
    t = ((p - a) * ab).sum(-1) / torch.clamp((ab * ab).sum(-1), min=1e-30)
    proj = a + t.clamp(0.0, 1.0)[..., None] * ab
    return ((p - proj) ** 2).sum(-1)


def _point_triangle_sqdist(p, v0, v1, v2):
    """Exact squared distance from points to triangles, all broadcasting
    (..., 3): the unclamped interior minimizer where it lies inside the
    triangle, else (and also) the nearest of the three edges."""
    e0, e1, d = v1 - v0, v2 - v0, v0 - p
    a = (e0 * e0).sum(-1)
    b = (e0 * e1).sum(-1)
    c = (e1 * e1).sum(-1)
    dd = (e0 * d).sum(-1)
    e = (e1 * d).sum(-1)
    det = torch.clamp(a * c - b * b, min=1e-30)
    s_in = (b * e - c * dd) / det
    t_in = (b * dd - a * e) / det
    inside = (s_in >= 0) & (t_in >= 0) & (s_in + t_in <= 1)
    proj = v0 + s_in[..., None] * e0 + t_in[..., None] * e1
    d_in = ((p - proj) ** 2).sum(-1)
    d_edges = torch.minimum(torch.minimum(_seg_sqdist(p, v0, v1),
                                          _seg_sqdist(p, v0, v2)),
                            _seg_sqdist(p, v1, v2))
    return torch.where(inside, torch.minimum(d_in, d_edges), d_edges)


def point_surface_distance(query_points: torch.Tensor,
                           trg_points: torch.Tensor, trg_tris: torch.Tensor,
                           chunk: int = 1024) -> torch.Tensor:
    """Unsigned distance from each query point to a triangle mesh.

    :param query_points: (N, 3); :param trg_points: (V, 3) vertices;
    :param trg_tris: (T, 3) int faces
    :return: (N,) distances
    """
    faces = trg_tris.long()
    v0, v1, v2 = (trg_points[faces[:, i]][None] for i in range(3))
    out = [torch.sqrt(torch.clamp(_point_triangle_sqdist(
        q[:, None, :], v0, v1, v2).amin(dim=1), min=0.0))
        for q in query_points.split(chunk)]
    return torch.cat(out) if out else query_points.new_zeros(0)


def assd_statistics(dist_xy: torch.Tensor, dist_yx: torch.Tensor):
    """Symmetric ASSD / SDSD / HD / HD95 from two directed distance
    vectors: each the mean of the two directions' mean, population standard
    deviation (ddof 0, as jnp.std), maximum and linear 95 % quantile."""
    def both(f):
        return (f(dist_xy) + f(dist_yx)) / 2
    return (both(torch.mean), both(lambda d: d.std(correction=0)),
            both(torch.amax), both(lambda d: torch.quantile(d, 0.95)))


def mesh_metrics_from_point_sets(pred_pts: torch.Tensor, gt_pts: torch.Tensor,
                                 pred_tris: torch.Tensor | None = None,
                                 gt_tris: torch.Tensor | None = None,
                                 host: bool = True, chunk: int = 1024):
    """ASSD family between a predicted and a GT surface.

    With both triangle sets: exact point-to-mesh distances both ways, on
    the host through the native BVH (`host`, the default) or on the
    tensors' device (`point_surface_distance`). Without: dense point-set
    nearest-neighbour distances (|x|^2 - 2 x.y + |y|^2 clamped at 0, as in
    the JAX package), chunked over the predicted points.

    :param pred_pts: (P, 3); :param gt_pts: (G, 3)
    :return: (assd, sdsd, hd, hd95) 0-d tensors
    """
    if pred_tris is not None and gt_tris is not None:
        if host:
            def host_dist(verts, tris, queries):
                return torch.from_numpy(native.point_mesh_distance(
                    verts.cpu().numpy(), tris.cpu().numpy(),
                    queries.cpu().numpy()))
            return assd_statistics(host_dist(gt_pts, gt_tris, pred_pts),
                                   host_dist(pred_pts, pred_tris, gt_pts))
        return assd_statistics(
            point_surface_distance(pred_pts, gt_pts, gt_tris, chunk),
            point_surface_distance(gt_pts, pred_pts, pred_tris, chunk))
    d_xy, d_yx = [], None
    for p in pred_pts.split(chunk):
        d = torch.clamp(pairwise_sqdist(p, gt_pts), min=0.0)
        d_xy.append(d.amin(dim=1))
        m = d.amin(dim=0)
        d_yx = m if d_yx is None else torch.minimum(d_yx, m)
    return assd_statistics(torch.sqrt(torch.cat(d_xy)), torch.sqrt(d_yx))

