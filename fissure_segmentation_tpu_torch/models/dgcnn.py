"""DGCNN point segmentation with a static kNN graph (counterpart of
models/dgcnn.py:EdgeConv and DGCNNSeg); `.train()` for the train step,
`.eval()` for inference.

Static graph: one kNN over the coordinate channels without self-loop
(`ops/knn.py:knn`, which launches K1 for CUDA tensors), shared by all three
EdgeConvs. Edge features concat([x_j - x_i, x_i]) -> shared MLP -> max over
k; seg head: 3x EdgeConv(64) -> 1024-d global max -> MLP(256, 256, 128, C).
A single-layer EdgeConv runs the fused core (`FusedEdgeMLPMax`, backward
K3 + K4) when `fused_edge_enabled` says so at the call; otherwise the
gather's backward is K2. Both maxima over k and over points are `amax`,
which splits the gradient among ties like `jnp.max`.

`dtype=torch.bfloat16` (or "bfloat16") is the JAX model's bf16 compute
dtype, what `--amp true` trains with: parameters stay float32, the graph is
built from the float32 coordinates, every EdgeConv casts its input and every
block its kernel to bf16 before the product (models/blocks.py), and the
logits are cast back to float32 for the loss. None or float32 computes in
float32.

Not ported yet (each raises NotImplementedError): the dynamic feature-space
graph (`dynamic=True`, the JAX default — here the default is the static
graph the serving path uses), the spatial transformer, the image-feature
module and approximate kNN (`knn_recall`).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

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

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.n_shared == 0 and fused_edge_enabled(x.device):
            return self.EdgeMLP_0(x, idx)
        e = self.EdgeMLP_0.edge_responses(x, idx)
        for i in range(self.n_shared):
            e = getattr(self, f"SharedMLP_{i}")(e)
        return e.amax(dim=-2)  # max over neighbors -> (B, N, C')


class DGCNNSeg(nn.Module):
    """Point segmentation DGCNN; (B, N, in_features) -> (B, N, C) logits."""

    def __init__(self, k: int, in_features: int, num_classes: int,
                 spatial_transformer: bool = False, dynamic: bool = False,
                 image_feat_module: bool = False, dtype=None,
                 knn_recall: float | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        unported = {"dynamic": dynamic,
                    "spatial_transformer": spatial_transformer,
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
        self.config = dict(k=k, in_features=in_features,
                           num_classes=num_classes, dynamic=False)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        graph = knn(x[..., :3], self.k, self_loop=False)
        x1 = self.EdgeConv_0(x, graph)
        x2 = self.EdgeConv_1(x1, graph)
        x3 = self.EdgeConv_2(x2, graph)
        multi = torch.cat([x1, x2, x3], dim=-1)
        g = self.SharedMLP_0(multi).amax(dim=-2, keepdim=True)
        h = torch.cat([multi, g.expand(*multi.shape[:-1], g.shape[-1])],
                      dim=-1)
        h = self.SharedMLP_1(h)
        h = self.SharedMLP_2(h)
        h = self.SharedMLP_3(h)
        return self.SharedMLP_4(h).to(torch.float32)
