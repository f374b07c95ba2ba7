"""DGCNN point segmentation (counterpart of models/dgcnn.py:EdgeConv and
DGCNNSeg); `.train()` for the train step, `.eval()` for inference.

Dynamic graph (`dynamic=True`, the default, as in JAX): each EdgeConv
builds its own graph with a self-loop. EdgeConv_0 builds it from the 3
coordinate channels through K1 (`ops/knn.py:knn`, which launches K1 for
CUDA tensors), EdgeConv_1 and _2 in feature space from their input (64
channels, in the compute dtype: `ops/knn.py:feature_knn`, a matmul and the
exact kk smallest, the approximate top-k's fused row selection on the card
and a stable sort on the CPU, without autograd). Static graph (`dynamic=False`, what the
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
gather's backward is K2. A multi-layer EdgeConv (DGCNNSeg's EdgeConv_0
[64, 64], the spatial transformer's [64, 128]) runs its last sublayer as
`FusedEdgeTail` when `fused_tail_enabled` says so at the call, else as a
SharedMLP followed by the max over k. Both maxima over k and over points
are `amax`, which splits the gradient among ties like `jnp.max`.

`dtype=torch.bfloat16` (or "bfloat16") is the JAX model's bf16 compute
dtype, what `--amp true` trains with: parameters stay float32, the
coordinate graph is built from the float32 coordinates, every EdgeConv
casts its input and every block its kernel to bf16 before the product
(models/blocks.py), so the feature graphs are built from bf16 features, and
the logits are cast back to float32 for the loss. None or float32 computes
in float32.

The stem's two options (counterpart of dgcnn.py:SpatialTransformer,
ImageFeatures and DGCNNBase._common): the static graph is built from the 3
coordinate channels of the input first; `image_feat_module` then embeds the
non-coordinate channels with two 1x1 SharedMLPs (6, 12; slope 0.01), so
EdgeConv_0 reads 3 + 12 channels; `spatial_transformer` then regresses a
3 x 3 matrix from the coordinates (an unfused EdgeConv [64, 128] on the
static graph, or on its own self-loop graph of the coordinates through K1
in a dynamic model, then SharedMLP(1024), a global max, Dense-BatchNorm-
LeakyReLU(0.2) to 512 and 256, and a 256 -> 9 Dense with a zero kernel and
an identity bias) and multiplies the coordinates by it. Both stems are
float32 whatever `dtype` says (their EdgeConv too), as in the JAX package;
the coordinate product is a float32 matmul at full precision as long as
TF32 stays off (torch's default).

DGCNNReg (counterpart of dgcnn.py:DGCNNReg): the same stem, four
single-layer EdgeConvs (64, 64, 128, 256; fused where `fused_edge_enabled`
says so), SharedMLP(1024), a global max to (B, 1024), then SharedMLPs of
512 and 256 on those vectors (BatchNorm over the batch axis) and a last
layer to (B, C).

`knn_recall` (JAX's opt-in approximate graphs): the static graph and every
EdgeConv's dynamic graph are built by `ops/knn.py:knn(recall_target=
knn_recall)` (the distances materialized, the approximate top-k's fused
row selection on the card); the spatial transformer's own graph in a dynamic
model stays exact, as in the JAX package. `config` records it, so model.pt
and `.fst` keep it.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..kernels.scatter import transpose
from ..ops.knn import knn
from ..ops.fused_edge import fused_edge_enabled, fused_tail_enabled
from ..utils.profiling import span
from .blocks import (BatchNorm, EdgeMLP, FusedEdgeMLPMax, FusedEdgeTail,
                     MLPStack, SharedMLP, _dense, leaky_relu)
from .pointnet import _check_dtype, apply_transform, identity_head


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
        self.n_shared = len(features) - 1
        for i, (fin, fout) in enumerate(zip(features[:-1], features[1:])):
            mlp = FusedEdgeTail if i == self.n_shared - 1 else SharedMLP
            setattr(self, f"SharedMLP_{i}",
                    mlp(fin, fout, generator=generator, dtype=dtype))

    def forward(self, x: torch.Tensor, idx: torch.Tensor,
                transposed=None) -> torch.Tensor:
        """`transposed`: the graph's transpose, shared by the backward
        scatters (kernels/scatter.py:transpose), or None."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.n_shared == 0 and fused_edge_enabled(x.device):
            return self.EdgeMLP_0(x, idx, transposed)
        e = self.EdgeMLP_0.edge_responses(x, idx, transposed)
        if self.n_shared == 0:
            return e.amax(dim=-2)  # max over neighbors -> (B, N, C')
        for i in range(self.n_shared - 1):
            e = getattr(self, f"SharedMLP_{i}")(e)
        tail = getattr(self, f"SharedMLP_{self.n_shared - 1}")
        if fused_tail_enabled(x.device):
            return tail(e)
        return tail.unfused(e)


class SpatialTransformer(nn.Module):
    """Learned affine alignment of the coordinate channels, float32."""

    def __init__(self, in_features: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.d = in_features
        self.EdgeConv_0 = EdgeConv(in_features, [64, 128], generator=g)
        self.SharedMLP_0 = SharedMLP(128, 1024, generator=g)
        self.Dense_0 = _dense(1024, 512, True, g)
        self.BatchNorm_0 = BatchNorm(512)
        self.Dense_1 = _dense(512, 256, True, g)
        self.BatchNorm_1 = BatchNorm(256)
        self.Dense_2 = identity_head(256, in_features)

    def forward(self, x: torch.Tensor, graph: torch.Tensor,
                transposed=None) -> torch.Tensor:
        """x (B, N, C) float32 and the graph of its coordinates; returns x
        with its first `in_features` channels transformed."""
        coords = x[..., :self.d]
        t = self.SharedMLP_0(self.EdgeConv_0(coords, graph, transposed))
        t = t.amax(dim=-2)                          # global max over points
        t = leaky_relu(self.BatchNorm_0(self.Dense_0(t)), 0.2)
        t = leaky_relu(self.BatchNorm_1(self.Dense_1(t)), 0.2)
        coords = apply_transform(coords, self.Dense_2(t), self.d)
        return torch.cat([coords, x[..., self.d:]], dim=-1)


class ImageFeatures(MLPStack):
    """1x1 embedding of the non-coordinate channels (a float32 MLPStack of
    6 and 12, slope 0.01); the coordinates pass through."""

    def __init__(self, in_features: int, out_channels=(6, 12),
                 generator: torch.Generator | None = None):
        super().__init__(in_features - 3, out_channels, 1e-2, generator)
        self.out_features = 3 + out_channels[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x[..., :3], super().forward(x[..., 3:])], dim=-1)


class DGCNNBase(nn.Module):
    """The stem and the EdgeConv chain shared by DGCNNSeg and DGCNNReg."""

    edge_widths: tuple = ()

    def __init__(self, k: int, in_features: int, num_classes: int,
                 spatial_transformer: bool = False, dynamic: bool = True,
                 image_feat_module: bool = False, dtype=None,
                 knn_recall: float | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dt = _check_dtype(dtype, type(self).__name__)
        self.k = k
        self.knn_recall = None if knn_recall is None else float(knn_recall)
        self.dynamic = bool(dynamic)
        self.spatial_transformer = bool(spatial_transformer)
        self.image_feat_module = bool(image_feat_module)
        self.config = dict(k=k, in_features=in_features,
                           num_classes=num_classes, dynamic=self.dynamic)
        for name in ("spatial_transformer", "image_feat_module"):
            if getattr(self, name):
                self.config[name] = True
        if dt is not None:   # JSON for model.pt
            self.config["dtype"] = str(dt).removeprefix("torch.")
        if self.knn_recall is not None:
            self.config["knn_recall"] = self.knn_recall
        g = generator
        fin = in_features
        if self.image_feat_module:
            self.ImageFeatures_0 = ImageFeatures(in_features, generator=g)
            fin = self.ImageFeatures_0.out_features
        if self.spatial_transformer:
            self.SpatialTransformer_0 = SpatialTransformer(generator=g)
        for i, widths in enumerate(self.edge_widths):
            setattr(self, f"EdgeConv_{i}",
                    EdgeConv(fin, widths, generator=g, dtype=dt))
            fin = widths[-1]

    def _transpose(self, graph: torch.Tensor):
        """The graph's transpose for the backward scatters, in a train-mode
        forward on the card that records gradients; else None."""
        if not (self.training and graph.is_cuda and torch.is_grad_enabled()):
            return None
        b, n, k = graph.shape
        return transpose(graph.reshape(b, n * k).to(torch.int32)
                         .contiguous(), n)

    def _graph(self, x: torch.Tensor, self_loop: bool, exact: bool = False):
        with span("edgeconv.kernels"):
            graph = knn(x, self.k, self_loop=self_loop,
                        recall_target=None if exact else self.knn_recall)
            return graph, self._transpose(graph)

    def _features(self, x: torch.Tensor) -> list:
        """The stem, then every EdgeConv; returns their outputs."""
        graph = tr = None
        if not self.dynamic:
            graph, tr = self._graph(x[..., :3], False)
        if self.image_feat_module:
            x = self.ImageFeatures_0(x)
        if self.spatial_transformer:
            st = (graph, tr) if graph is not None else \
                self._graph(x[..., :3], True, exact=True)
            x = self.SpatialTransformer_0(x, *st)
        feats = []
        for i in range(len(self.edge_widths)):
            if self.dynamic:
                graph, tr = self._graph(x[..., :3] if i == 0 else x, True)
            x = getattr(self, f"EdgeConv_{i}")(x, graph, tr)
            feats.append(x)
        return feats


class DGCNNSeg(DGCNNBase):
    """Point segmentation DGCNN; (B, N, in_features) -> (B, N, C) logits."""

    edge_widths = ([64, 64], [64], [64])

    def __init__(self, k: int, in_features: int, num_classes: int,
                 spatial_transformer: bool = False, dynamic: bool = True,
                 image_feat_module: bool = False, dtype=None,
                 knn_recall: float | None = None,
                 generator: torch.Generator | None = None):
        super().__init__(k, in_features, num_classes, spatial_transformer,
                         dynamic, image_feat_module, dtype, knn_recall,
                         generator)
        g, dt = generator, self.dtype
        self.SharedMLP_0 = SharedMLP(192, 1024, generator=g, dtype=dt)
        self.SharedMLP_1 = SharedMLP(192 + 1024, 256, generator=g, dtype=dt)
        self.SharedMLP_2 = SharedMLP(256, 256, generator=g, dtype=dt)
        self.SharedMLP_3 = SharedMLP(256, 128, generator=g, dtype=dt)
        self.SharedMLP_4 = SharedMLP(128, num_classes, last_layer=True,
                                     generator=g, dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        multi = torch.cat(self._features(x), dim=-1)
        g = self.SharedMLP_0(multi).amax(dim=-2, keepdim=True)
        h = torch.cat([multi, g.expand(*multi.shape[:-1], g.shape[-1])],
                      dim=-1)
        h = self.SharedMLP_1(h)
        h = self.SharedMLP_2(h)
        h = self.SharedMLP_3(h)
        return self.SharedMLP_4(h).to(torch.float32)


class DGCNNReg(DGCNNBase):
    """Global regression DGCNN; (B, N, in_features) -> (B, C) outputs."""

    edge_widths = ([64], [64], [128], [256])

    def __init__(self, k: int, in_features: int, num_classes: int,
                 spatial_transformer: bool = False, dynamic: bool = True,
                 image_feat_module: bool = False, dtype=None,
                 knn_recall: float | None = None,
                 generator: torch.Generator | None = None):
        super().__init__(k, in_features, num_classes, spatial_transformer,
                         dynamic, image_feat_module, dtype, knn_recall,
                         generator)
        g, dt = generator, self.dtype
        self.SharedMLP_0 = SharedMLP(512, 1024, generator=g, dtype=dt)
        self.SharedMLP_1 = SharedMLP(1024, 512, generator=g, dtype=dt)
        self.SharedMLP_2 = SharedMLP(512, 256, generator=g, dtype=dt)
        self.SharedMLP_3 = SharedMLP(256, num_classes, last_layer=True,
                                     generator=g, dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        multi = torch.cat(self._features(x), dim=-1)
        h = self.SharedMLP_0(multi).amax(dim=-2)          # (B, 1024)
        h = self.SharedMLP_1(h)
        h = self.SharedMLP_2(h)
        return self.SharedMLP_3(h).to(torch.float32)
