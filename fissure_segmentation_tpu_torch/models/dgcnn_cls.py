"""Classification DGCNN and its multi-head regression variant (counterpart
of models/dgcnn_cls.py: `RegressionHead`, `DGCNNCls`, `MultiHeadDGCNN`).

DGCNNCls is the PC-AE's encoder (models/folding_net.py:DGCNNClsEncoder:
four unfused EdgeMLPs [64, 64, 128, 256] with a self-loop graph, K1 on the
coordinates, the feature graphs of layers 1-3 from `ops/knn.py`, K2 with
the graph's transpose in the gather's backward on the card) followed by
global max and mean pooling and a Dense-BatchNorm-LeakyReLU head. Submodule
names are the JAX tree's, so models/weights.py maps a JAX tree one to one.

Dropout: the JAX modules' rate is 0 wherever the package builds them; a
rate above 0 raises here (it would need a mask from an explicit
generator, which nothing passes yet).
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn

from .blocks import BatchNorm, _dense, leaky_relu
from .folding_net import DGCNNClsEncoder

HEADS = ("main", "translation", "rotation", "scaling")
DEFAULT_HEAD_CHANNELS = {"translation": (512, 50, 3),
                         "rotation": (512, 50, 3),
                         "scaling": (512, 50, 3)}


def _check_dropout(rate: float) -> None:
    if rate:
        raise NotImplementedError("dropout > 0 is not ported yet")


class RegressionHead(nn.Module):
    """Dense stack with BatchNorm + LeakyReLU(0.2) between the layers; the
    first and last Dense without bias (the reference's)."""

    def __init__(self, in_features: int, out_channels: Sequence[int],
                 dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_dropout(dropout)
        chans = list(out_channels)
        self.n_layers = len(chans)
        self.Dense_0 = _dense(in_features, chans[0], False, generator)
        for i, (fin, fout) in enumerate(zip(chans[:-1], chans[1:])):
            setattr(self, f"BatchNorm_{i}", BatchNorm(fin))
            setattr(self, f"Dense_{i + 1}",
                    _dense(fin, fout, i != len(chans) - 2, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(x)
        for i in range(1, self.n_layers):
            x = leaky_relu(getattr(self, f"BatchNorm_{i - 1}")(x), 0.2)
            x = getattr(self, f"Dense_{i}")(x)
        return x


class DGCNNCls(DGCNNClsEncoder):
    """Global-feature DGCNN: (B, N, C) -> (out (B, output_channels),
    global feature (B, 2 * emb_dims)), both float32."""

    def __init__(self, k: int, output_channels: int, emb_dims: int = 1024,
                 dropout: float = 0.0, static: bool = False,
                 in_features: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__(k, emb_dims, static, in_features, generator)
        _check_dropout(dropout)
        self.Dense_0 = _dense(2 * emb_dims, 512, False, generator)
        self.BatchNorm_0 = BatchNorm(512)
        self.Dense_1 = _dense(512, 256, True, generator)
        self.BatchNorm_1 = BatchNorm(256)
        self.Dense_2 = _dense(256, output_channels, True, generator)

    def forward(self, x: torch.Tensor):
        h = self.point_features(x)                           # (B, N, emb)
        g = torch.cat([h.amax(dim=-2), h.mean(dim=-2)], dim=-1)
        y = leaky_relu(self.BatchNorm_0(self.Dense_0(g)), 0.2)
        y = leaky_relu(self.BatchNorm_1(self.Dense_1(y)), 0.2)
        return self.Dense_2(y).float(), g.float()


class MultiHeadDGCNN(nn.Module):
    """DGCNNCls plus named regression heads on its global feature.
    `active_heads` gates them: an inactive head still runs (its running
    statistics move in training, as in JAX) but its output is replaced by
    zeros (ones for "scaling"); without "main" the main output is zeros."""

    def __init__(self, k: int, output_channels_main: int,
                 head_channels: Mapping[str, Sequence[int]] | None = None,
                 emb_dims: int = 1024, dropout: float = 0.0,
                 static: bool = False, active_heads: Sequence[str] = HEADS,
                 in_features: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.active_heads = tuple(active_heads)
        self.DGCNNCls_0 = DGCNNCls(k, output_channels_main, emb_dims,
                                   dropout, static, in_features, generator)
        self.head_names = tuple(head_channels or DEFAULT_HEAD_CHANNELS)
        for name, chans in (head_channels or DEFAULT_HEAD_CHANNELS).items():
            setattr(self, f"head_{name}",
                    RegressionHead(2 * emb_dims, chans, dropout, generator))

    def forward(self, x: torch.Tensor, active_heads=None):
        active = self.active_heads if active_heads is None else active_heads
        main, g = self.DGCNNCls_0(x)
        if "main" not in active:
            main = torch.zeros_like(main)
        outs = {}
        for name in self.head_names:
            out = getattr(self, f"head_{name}")(g)
            if name not in active:
                out = (torch.ones_like(out) if name == "scaling"
                       else torch.zeros_like(out))
            outs[name] = out
        return main, outs
