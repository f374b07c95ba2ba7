"""Seeded random-walk segmentation on voxel grids (counterpart of
postprocess/random_walk.py).

The 6-neighbour grid Laplacian is a stencil: `L x` is a few shifted
products with per-edge weights, so the seeded system L_uu u = -L_us u_s is
solved matrix-free by conjugate gradient on the device of the inputs,
plain PyTorch as the JAX package's is plain XLA. It is one CG on the
stacked system of all object channels: alpha and beta are single scalars
summed over every channel and voxel, the guards are max(., 1e-30), and the
loop runs `cg_iters` iterations with no early exit, as in JAX.

Edge weights: 'binary' (1 where the image values are equal, else 0.01) or
'intensity' (exp(-diff^2 / 2 sigma^2), sigma 8); L = 1e-5 + lambda * D on
the diagonal, -lambda * A off it; voxels outside `graph_mask` leave the
graph and get probability 0.
"""
from __future__ import annotations

import torch

from ..preprocess.labels import fissures_between_lobes, one_hot_channels

SIGMA = 8.0
LAMBDA = 1.0
EPS_DIAG = 1e-5


def _edge_weights(im: torch.Tensor, edge_weights: str, mask: torch.Tensor):
    """Per-axis forward-edge weights w_d[i] between voxel i and i + 1
    along d, zero where either end is outside the mask."""
    ws = []
    for d in range(3):
        n = im.shape[d]
        a, b = im.narrow(d, 0, n - 1), im.narrow(d, 1, n - 1)
        if edge_weights == "intensity":
            w = torch.exp(-((a - b) ** 2) / (2 * SIGMA ** 2))
        elif edge_weights == "binary":
            w = torch.where(a == b, 1.0, 0.01)
        else:
            raise ValueError(f'No edge weights named "{edge_weights}" known.')
        both = mask.narrow(d, 0, n - 1) & mask.narrow(d, 1, n - 1)
        ws.append(torch.where(both, w, 0.0))
    return ws


def _laplacian_matvec(x: torch.Tensor, ws, degree: torch.Tensor
                      ) -> torch.Tensor:
    """L x for (..., D, H, W) fields x. Each axis's two neighbour terms
    are added (the zero-padded ones exactly) before they are subtracted,
    as JAX's padded sum does."""
    out = (EPS_DIAG + LAMBDA * degree) * x
    for d, w in enumerate(ws):
        ax = x.ndim - 3 + d
        n = x.shape[ax]
        nb = torch.zeros_like(x)
        nb.narrow(ax, 0, n - 1).copy_(w * x.narrow(ax, 1, n - 1))
        nb.narrow(ax, 1, n - 1).add_(w * x.narrow(ax, 0, n - 1))
        out = out - LAMBDA * nb
    return out


def random_walk(im: torch.Tensor, labels: torch.Tensor, n_objects: int,
                edge_weights: str = "binary",
                graph_mask: torch.Tensor | None = None,
                cg_iters: int = 500) -> torch.Tensor:
    """Seeded random walk on the device of `im`.

    :param im: (D, H, W) image the edge weights come from
    :param labels: (D, H, W) int seeds, 0 = unseeded, 1..n_objects
    :param graph_mask: voxels outside get probability 0 for every object
    :return: (D, H, W, n_objects) float32 probabilities (a channel-last
        view of the channel-first solution)
    """
    im = im.to(torch.float32)
    dev = im.device
    mask = (torch.ones(im.shape, dtype=torch.bool, device=dev)
            if graph_mask is None else graph_mask.to(dev, torch.bool))
    labels = labels.to(dev)
    ws = _edge_weights(im, edge_weights, mask)

    degree = torch.zeros_like(im)
    for d, w in enumerate(ws):
        n = im.shape[d]
        lo, hi = torch.zeros_like(im), torch.zeros_like(im)
        lo.narrow(d, 0, n - 1).copy_(w)
        hi.narrow(d, 1, n - 1).copy_(w)
        degree = degree + lo + hi

    seeded = (labels != 0) & mask
    unknown = (~seeded) & mask
    # jax.nn.one_hot(labels - 1, n) * seeded, channel first
    u_s = one_hot_channels(labels.to(torch.int64) - 1, n_objects) \
        * seeded[None]
    proj = unknown[None].to(torch.float32)

    def A(x):  # restricted Laplacian on the unknowns
        return proj * _laplacian_matvec(proj * x, ws, degree)

    b = -proj * _laplacian_matvec(u_s, ws, degree)
    x = torch.zeros_like(b)
    r = b - A(x)
    p = r
    rs = torch.sum(r * r)
    tiny = torch.tensor(1e-30, device=dev)
    for _ in range(cg_iters):
        ap = A(p)
        alpha = rs / torch.maximum(torch.sum(p * ap), tiny)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.sum(r * r)
        beta = rs_new / torch.maximum(rs, tiny)
        p = r + beta * p
        rs = rs_new
    probs = torch.where(unknown[None], x, u_s)
    probs = torch.where(mask[None], probs, 0.0)
    return probs.movedim(0, -1)


def fill_lobes(lobes: torch.Tensor, mask: torch.Tensor,
               n_objects: int | None = None,
               cg_iters: int = 500) -> torch.Tensor:
    """Grow sparse lobe labels to fill the mask: binary edge weights from
    `lobes != 0`, the argmax of the probabilities (the first object among
    equal ones) + 1 inside the mask.

    :return: (D, H, W) int32
    """
    if n_objects is None:
        n_objects = int(lobes.max())
    mask = mask.to(lobes.device, torch.bool)
    probs = random_walk((lobes != 0).to(torch.float32), lobes, n_objects,
                        edge_weights="binary", graph_mask=mask,
                        cg_iters=cg_iters)
    filled = torch.argmax(probs, dim=-1).to(torch.int32) + 1
    return torch.where(mask, filled, 0)


def lobes_to_fissures(lobes: torch.Tensor, mask: torch.Tensor,
                      cg_iters: int = 500):
    """Fissures as the boundaries between filled lobes. Lobe labels: 1 RLL,
    2 RUL, 3 LLL, 4 LUL, 5 RML (optional); a fissure is set only where its
    lobes exist.

    :return: (fissures (D, H, W) uint8, 1 LOF, 2 ROF, 3 RHF;
              lobes_filled (D, H, W) int32)
    """
    n_lobes = int(lobes.max())
    filled = fill_lobes(lobes, mask, n_objects=n_lobes, cg_iters=cg_iters)
    return fissures_between_lobes(filled, n_lobes), filled
