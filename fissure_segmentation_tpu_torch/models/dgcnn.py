"""DGCNN point segmentation (counterpart of models/dgcnn.py:EdgeConv and
DGCNNSeg); `.train()` for the train step, `.eval()` for inference.

Dynamic graph (`dynamic=True`, the default, as in JAX): each EdgeConv
builds its own graph with a self-loop. EdgeConv_0 builds it from the 3
coordinate channels through K1 (`ops/knn.py:knn`, which launches K1 for
CUDA tensors), EdgeConv_1 and _2 in feature space from their input (64
channels, in the compute dtype: `ops/knn.py:feature_knn`, a matmul and a
stable sort, without autograd). Static graph (`dynamic=False`, what the
serving path runs): one kNN over the coordinate channels without self-loop,
shared by all three EdgeConvs. In a train-mode forward on the card whose
gradient is recorded, each graph's transpose (`kernels/scatter.py:
transpose`) is built there too (one a step for the static graph, one per
EdgeConv for the dynamic one) and handed to the backward scatters of the
EdgeConv that reads that graph (K2, K3). Edge features concat([x_j - x_i,
x_i]) -> shared MLP -> max over k; seg head: 3x EdgeConv(64) -> 1024-d
global max -> MLP(256, 256, 128, C).
A single-layer EdgeConv runs the fused core (`FusedEdgeMLPMax`, backward
K3 + K4) when `fused_edge_enabled` says so at the call; otherwise the
gather's backward is K2. Both maxima over k and over points are `amax`,
which splits the gradient among ties like `jnp.max`.

`dtype=torch.bfloat16` (or "bfloat16") is the JAX model's bf16 compute
dtype, what `--amp true` trains with: parameters stay float32, the
coordinate graph is built from the float32 coordinates, every EdgeConv
casts its input and every block its kernel to bf16 before the product
(models/blocks.py), so the feature graphs are built from bf16 features, and
the logits are cast back to float32 for the loss. None or float32 computes
in float32.

Not ported yet (each raises NotImplementedError): the spatial transformer,
the image-feature module and approximate kNN (`knn_recall`).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..kernels.scatter import transpose
from ..ops.knn import knn
from ..ops.fused_edge import fused_edge_enabled
from .blocks import EdgeMLP, FusedEdgeMLPMax, SharedMLP


class EdgeConv(nn.Module):
    """EdgeConv block over a given neighbor graph."""

    def __init__(self, in_features: int, features: Sequence[int],
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        mlp = FusedEdgeMLPMax if len(features) == 1 else EdgeMLP
        self.EdgeMLP_0 = mlp(in_features, features[0], generator=generator,
                             dtype=dtype)
        for i, (fin, fout) in enumerate(zip(features[:-1], features[1:])):
            setattr(self, f"SharedMLP_{i}",
                    SharedMLP(fin, fout, generator=generator, dtype=dtype))
        self.n_shared = len(features) - 1

    def forward(self, x: torch.Tensor, idx: torch.Tensor,
                transposed=None) -> torch.Tensor:
        """`transposed`: the graph's transpose, shared by the backward
        scatters (kernels/scatter.py:transpose), or None."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.n_shared == 0 and fused_edge_enabled(x.device):
            return self.EdgeMLP_0(x, idx, transposed)
        e = self.EdgeMLP_0.edge_responses(x, idx, transposed)
        for i in range(self.n_shared):
            e = getattr(self, f"SharedMLP_{i}")(e)
        return e.amax(dim=-2)  # max over neighbors -> (B, N, C')


class DGCNNSeg(nn.Module):
    """Point segmentation DGCNN; (B, N, in_features) -> (B, N, C) logits."""

    def __init__(self, k: int, in_features: int, num_classes: int,
                 spatial_transformer: bool = False, dynamic: bool = True,
                 image_feat_module: bool = False, dtype=None,
                 knn_recall: float | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        unported = {"spatial_transformer": spatial_transformer,
                    "image_feat_module": image_feat_module,
                    "knn_recall": knn_recall is not None}
        for name, on in unported.items():
            if on:
                raise NotImplementedError(f"DGCNNSeg({name}=...) is not "
                                          "ported yet")
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"DGCNNSeg: dtype must be None, float32 or "
                             f"bfloat16, got {dtype}")
        self.dtype = None if dtype == torch.float32 else dtype
        self.k = k
        self.dynamic = bool(dynamic)
        self.config = dict(k=k, in_features=in_features,
                           num_classes=num_classes, dynamic=self.dynamic)
        if self.dtype is not None:   # JSON for model.pt
            self.config["dtype"] = str(self.dtype).removeprefix("torch.")
        g, dt = generator, self.dtype
        self.EdgeConv_0 = EdgeConv(in_features, [64, 64], generator=g,
                                   dtype=dt)
        self.EdgeConv_1 = EdgeConv(64, [64], generator=g, dtype=dt)
        self.EdgeConv_2 = EdgeConv(64, [64], generator=g, dtype=dt)
        self.SharedMLP_0 = SharedMLP(192, 1024, generator=g, dtype=dt)
        self.SharedMLP_1 = SharedMLP(192 + 1024, 256, generator=g, dtype=dt)
        self.SharedMLP_2 = SharedMLP(256, 256, generator=g, dtype=dt)
        self.SharedMLP_3 = SharedMLP(256, 128, generator=g, dtype=dt)
        self.SharedMLP_4 = SharedMLP(128, num_classes, last_layer=True,
                                     generator=g, dtype=dt)

    def _transpose(self, graph: torch.Tensor):
        """The graph's transpose for the backward scatters, in a train-mode
        forward on the card that records gradients; else None."""
        if not (self.training and graph.is_cuda and torch.is_grad_enabled()):
            return None
        b, n, k = graph.shape
        return transpose(graph.reshape(b, n * k).to(torch.int32)
                         .contiguous(), n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dynamic:
            g0 = knn(x[..., :3], self.k, self_loop=True)
            x1 = self.EdgeConv_0(x, g0, self._transpose(g0))
            g1 = knn(x1, self.k, self_loop=True)
            x2 = self.EdgeConv_1(x1, g1, self._transpose(g1))
            g2 = knn(x2, self.k, self_loop=True)
            x3 = self.EdgeConv_2(x2, g2, self._transpose(g2))
        else:
            graph = knn(x[..., :3], self.k, self_loop=False)
            tr = self._transpose(graph)
            x1 = self.EdgeConv_0(x, graph, tr)
            x2 = self.EdgeConv_1(x1, graph, tr)
            x3 = self.EdgeConv_2(x2, graph, tr)
        multi = torch.cat([x1, x2, x3], dim=-1)
        g = self.SharedMLP_0(multi).amax(dim=-2, keepdim=True)
        h = torch.cat([multi, g.expand(*multi.shape[:-1], g.shape[-1])],
                      dim=-1)
        h = self.SharedMLP_1(h)
        h = self.SharedMLP_2(h)
        h = self.SharedMLP_3(h)
        return self.SharedMLP_4(h).to(torch.float32)
