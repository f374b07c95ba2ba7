"""Point-cloud autoencoder, the PC-AE: DGCNN classification encoder +
Folding or Deforming decoder (counterpart of models/folding_net.py).

The shape generators are numpy copies of the JAX package's (equal arrays).
Submodules and parameters carry the JAX module names (`DGCNNClsEncoder_0/
EdgeMLP_0..3`, `SharedMLP_0`, `FoldingDecoder_0/Dense_0..5`,
`DeformingDecoder_0/SharedMLP_*`), so models/weights.py maps a JAX tree
onto them one to one.

Encoder graphs have a self-loop. Dynamic (the default): EdgeMLP_0's graph
is built from the 3 coordinates (K1, `ops/knn.py:knn`), those of
EdgeMLP_1..3 from their input features (C = 64, 64, 128; `ops/knn.py:
feature_knn`). Static: one coordinate graph for all four layers. As in
JAX, each layer is the unfused EdgeMLP (ops/edge.py:edge_mlp_pre_gather)
followed by a max over k, never the fused core. In a train-mode forward on
the card that records gradients, each graph's transpose
(`kernels/scatter.py:transpose`) is built once there (four a dynamic step,
one a static step) and handed to the gather's backward, K2.

`decode_mesh=True` returns (verts (B, m, 3), faces (F, 3) int32) with the
fixed plane-mesh topology; `return_hidden=True` adds the (B, latent) code.
The model computes in float32, as the JAX entry trains it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..kernels.scatter import transpose
from ..ops.knn import knn
from .blocks import EdgeMLP, SharedMLP, _dense

SHAPE_TYPES = ["sphere", "gaussian", "plane"]
ENCODER_WIDTHS = (64, 64, 128, 256)


def get_plane_mesh(n: int = 2025, xrange=(-1.0, 1.0), yrange=(-1.0, 1.0)):
    """Regular triangulated grid (shapes/shape_constructor.py:8-24)."""
    steps = int(math.sqrt(n))
    x = np.linspace(*xrange, steps)
    y = np.linspace(*yrange, steps)
    gx, gy = np.meshgrid(x, y, indexing="ij")
    points = np.stack([gx.reshape(-1), gy.reshape(-1)], 1).astype(np.float32)
    faces = []
    for j in range(steps - 1):
        for i in range(steps - 1):
            cur = j * steps + i
            faces.append([cur, cur + 1, cur + steps])
            faces.append([cur + 1, cur + steps, cur + 1 + steps])
    return points, np.asarray(faces, np.int32)


def get_plane(m: int):
    """±0.3 plane points (shape_constructor.py:35-40)."""
    steps = int(math.sqrt(m))
    x = np.linspace(-0.3, 0.3, steps)
    return np.array([[a, b] for a in x for b in x], np.float32)


def get_sphere(m: int):
    """Fibonacci sphere (replaces the reference's shipped sphere.npy)."""
    i = np.arange(m) + 0.5
    phi = np.arccos(1 - 2 * i / m)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi),
                     np.sin(theta) * np.sin(phi), np.cos(phi)],
                    1).astype(np.float32)


def get_gaussian(m: int, seed: int = 0):
    return np.random.default_rng(seed).normal(size=(m, 3)).astype(np.float32)


def folding_points_for(shape_type: str, m: int, decode_mesh: bool):
    """(points (m, d), faces or None) (folding_net.py:154-183)."""
    if shape_type == "plane":
        if decode_mesh:
            return get_plane_mesh(n=m, xrange=(-0.3, 0.3),
                                  yrange=(-0.3, 0.3))
        return get_plane(m), None
    if shape_type == "sphere":
        if decode_mesh:
            raise NotImplementedError("No sphere mesh defined yet")
        return get_sphere(m), None
    if shape_type == "gaussian":
        if decode_mesh:
            raise ValueError("No gaussian mesh is possible.")
        return get_gaussian(m), None
    raise ValueError(f'No shape named "{shape_type}". Use one of '
                     f"{SHAPE_TYPES}.")


class _Template:
    """A decoder's fixed template (points or faces): a host tensor, copied
    to each device once. Not a buffer, so the JAX variable tree (and
    model.pt) holds only what the JAX package's does."""

    def __init__(self, arr: np.ndarray):
        self.host = torch.from_numpy(arr)
        self._on: dict = {}

    def on(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._on:
            self._on[key] = self.host.to(device)
        return self._on[key]


def _graph_transpose(graph: torch.Tensor, training: bool):
    """The graph's transpose for the gather's backward (K2), in a
    train-mode forward on the card that records gradients; else None."""
    if not (training and graph.is_cuda and torch.is_grad_enabled()):
        return None
    b, n, k = graph.shape
    return transpose(graph.reshape(b, n * k).to(torch.int32).contiguous(), n)


class DGCNNClsEncoder(nn.Module):
    """4 single-layer EdgeConvs [64, 64, 128, 256] -> a shared 1x1 layer
    to the embedding -> global max (folding_net.py:84-144)."""

    def __init__(self, k: int, n_embedding: int, static: bool = False,
                 in_features: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.k, self.static = k, static
        fin = in_features
        for i, fout in enumerate(ENCODER_WIDTHS):
            setattr(self, f"EdgeMLP_{i}", EdgeMLP(fin, fout,
                                                  generator=generator))
            fin = fout
        self.SharedMLP_0 = SharedMLP(sum(ENCODER_WIDTHS), n_embedding,
                                     generator=generator)

    def point_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, C) -> (B, N, emb), the shared layer's output before the
        global pooling."""
        graph = tr = None
        if self.static:
            graph = knn(x[..., :3], self.k, self_loop=True)
            tr = _graph_transpose(graph, self.training)
        feats, h = [], x
        for i in range(len(ENCODER_WIDTHS)):
            if not self.static:
                graph = knn(h, self.k, self_loop=True)
                tr = _graph_transpose(graph, self.training)
            e = getattr(self, f"EdgeMLP_{i}").edge_responses(h, graph, tr)
            h = e.amax(dim=-2)
            feats.append(h)
        return self.SharedMLP_0(torch.cat(feats, dim=-1))    # (B, N, emb)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.point_features(x).amax(dim=-2)           # (B, emb)


class FoldingDecoder(nn.Module):
    """Two folds of a template shape (folding_net.py:186-228): Dense + ReLU
    with bias, no norm, the last Dense of each fold without activation."""

    def __init__(self, n_embedding: int, shape_type: str, m: int,
                 decode_mesh: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        pts, faces = folding_points_for(shape_type, m, decode_mesh)
        self.grid = _Template(pts)
        self.faces = None if faces is None else _Template(faces)
        e = n_embedding
        sizes = [(e + pts.shape[1], e), (e, e), (e, 3),
                 (e + 3, e), (e, e), (e, 3)]
        for i, (fin, fout) in enumerate(sizes):
            setattr(self, f"Dense_{i}", _dense(fin, fout, True, generator))

    def _fold(self, h: torch.Tensor, first: int) -> torch.Tensor:
        for i in range(first, first + 3):
            h = getattr(self, f"Dense_{i}")(h)
            if i < first + 2:
                h = torch.relu(h)
        return h

    def forward(self, code: torch.Tensor):
        grid = self.grid.on(code.device).to(code.dtype)
        b, m = code.shape[0], grid.shape[0]
        code_rep = code[:, None, :].expand(b, m, code.shape[-1])
        grid_rep = grid[None].expand(b, *grid.shape)
        f1 = self._fold(torch.cat([code_rep, grid_rep], -1), 0)
        f2 = self._fold(torch.cat([code_rep, f1], -1), 3)
        if self.faces is not None:
            return f2, self.faces.on(f2.device)
        return f2


class DeformingDecoder(nn.Module):
    """Residual offset decoder (folding_net.py:231-288): per layer two
    SharedMLPs and a last-layer SharedMLP predicting additive offsets."""

    def __init__(self, n_embedding: int, shape_type: str, m: int,
                 decode_mesh: bool = True, n_deforming_layers: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        pts, faces = folding_points_for(shape_type, m, decode_mesh)
        if pts.shape[1] == 2:  # plane: add z = 0 (folding_net.py:267-271)
            pts = np.concatenate([pts, np.zeros((pts.shape[0], 1),
                                                np.float32)], 1)
        self.points = _Template(pts)
        self.faces = None if faces is None else _Template(faces)
        self.n_layers = n_deforming_layers
        e, g = n_embedding, generator
        for i in range(n_deforming_layers):
            setattr(self, f"SharedMLP_{3 * i}", SharedMLP(e + 3, e,
                                                          generator=g))
            setattr(self, f"SharedMLP_{3 * i + 1}", SharedMLP(e, e,
                                                              generator=g))
            setattr(self, f"SharedMLP_{3 * i + 2}",
                    SharedMLP(e, 3, last_layer=True, generator=g))

    def forward(self, code: torch.Tensor):
        template = self.points.on(code.device).to(code.dtype)
        b, m = code.shape[0], template.shape[0]
        points = template[None].expand(b, *template.shape)
        code_rep = code[:, None, :].expand(b, m, code.shape[-1])
        for i in range(self.n_layers):
            h = torch.cat([code_rep, points], -1)
            for j in range(3):
                h = getattr(self, f"SharedMLP_{3 * i + j}")(h)
            points = points + h
        if self.faces is not None:
            return points, self.faces.on(points.device)
        return points


class DGCNNFoldingNet(nn.Module):
    """The PC-AE (folding_net.py:42-80): (B, N, 3) -> reconstructed
    (B, m, 3) [+ faces with decode_mesh], m = round(sqrt(N))^2."""

    def __init__(self, k: int, n_embedding: int, shape_type: str,
                 n_input_points: int = 1024, decode_mesh: bool = True,
                 deform: bool = False, static: bool = False,
                 dec_depth: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.k, self.shape_type = k, shape_type
        self.decode_mesh, self.deform = decode_mesh, deform
        self.config = dict(k=k, n_embedding=n_embedding,
                           shape_type=shape_type,
                           n_input_points=n_input_points,
                           decode_mesh=decode_mesh, deform=deform,
                           static=static, dec_depth=dec_depth)
        self.m = int(round(math.sqrt(n_input_points))) ** 2
        g = generator
        self.DGCNNClsEncoder_0 = DGCNNClsEncoder(k, n_embedding, static,
                                                 generator=g)
        if deform:
            self.DeformingDecoder_0 = DeformingDecoder(
                n_embedding, shape_type, self.m, decode_mesh, dec_depth,
                generator=g)
        else:
            self.FoldingDecoder_0 = FoldingDecoder(
                n_embedding, shape_type, self.m, decode_mesh, generator=g)

    def forward(self, x: torch.Tensor, return_hidden: bool = False):
        h = self.DGCNNClsEncoder_0(x)
        dec = self.DeformingDecoder_0 if self.deform else \
            self.FoldingDecoder_0
        out = dec(h)
        if return_hidden:
            return out, h
        return out
