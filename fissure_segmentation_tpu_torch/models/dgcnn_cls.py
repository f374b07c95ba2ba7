"""Classification DGCNN and its multi-head regression variant (counterpart
of models/dgcnn_cls.py: `RegressionHead`, `DGCNNCls`, `MultiHeadDGCNN`).

DGCNNCls is the PC-AE's encoder (models/folding_net.py:DGCNNClsEncoder:
four unfused EdgeMLPs [64, 64, 128, 256] with a self-loop graph, K1 on the
coordinates, the feature graphs of layers 1-3 from `ops/knn.py`, K2 with
the graph's transpose in the gather's backward on the card) followed by
global max and mean pooling and a Dense-BatchNorm-LeakyReLU head. Submodule
names are the JAX tree's, so models/weights.py maps a JAX tree one to one.

Dropout (`dropout` > 0; the JAX package builds every model with 0): in
training each Dropout draws its keep mask from the `generator` the forward
is given, or takes the masks passed as `keep`, in the JAX modules' order
(models/blocks.py:dropout); in eval it is the identity.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
from torch import nn

from .blocks import BatchNorm, _dense, dropout, leaky_relu
from .folding_net import DGCNNClsEncoder

HEADS = ("main", "translation", "rotation", "scaling")
DEFAULT_HEAD_CHANNELS = {"translation": (512, 50, 3),
                         "rotation": (512, 50, 3),
                         "scaling": (512, 50, 3)}


def _check_dropout(rate: float) -> None:
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1]")


def _keep(keep, i: int):
    return None if keep is None else keep[i]


class RegressionHead(nn.Module):
    """Dense stack with BatchNorm + Dropout + LeakyReLU(0.2) between the
    layers; the first and last Dense without bias (the reference's)."""

    def __init__(self, in_features: int, out_channels: Sequence[int],
                 dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_dropout(dropout)
        self.dropout = dropout
        chans = list(out_channels)
        self.n_layers = len(chans)
        self.Dense_0 = _dense(in_features, chans[0], False, generator)
        for i, (fin, fout) in enumerate(zip(chans[:-1], chans[1:])):
            setattr(self, f"BatchNorm_{i}", BatchNorm(fin))
            setattr(self, f"Dense_{i + 1}",
                    _dense(fin, fout, i != len(chans) - 2, generator))

    def forward(self, x: torch.Tensor, keep=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """`keep`: in training, the keep masks of the n_layers - 1
        Dropouts, else drawn from `generator`."""
        x = self.Dense_0(x)
        for i in range(1, self.n_layers):
            x = getattr(self, f"BatchNorm_{i - 1}")(x)
            if self.training:
                x = dropout(x, self.dropout, _keep(keep, i - 1), generator)
            x = getattr(self, f"Dense_{i}")(leaky_relu(x, 0.2))
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
        self.dropout = dropout
        self.Dense_0 = _dense(2 * emb_dims, 512, False, generator)
        self.BatchNorm_0 = BatchNorm(512)
        self.Dense_1 = _dense(512, 256, True, generator)
        self.BatchNorm_1 = BatchNorm(256)
        self.Dense_2 = _dense(256, output_channels, True, generator)

    def forward(self, x: torch.Tensor, keep=None,
                generator: torch.Generator | None = None):
        """`keep`: in training, the keep masks of the two Dropouts ((B,
        512), (B, 256)), else drawn from `generator`."""
        h = self.point_features(x)                           # (B, N, emb)
        g = torch.cat([h.amax(dim=-2), h.mean(dim=-2)], dim=-1)
        y = leaky_relu(self.BatchNorm_0(self.Dense_0(g)), 0.2)
        if self.training:
            y = dropout(y, self.dropout, _keep(keep, 0), generator)
        y = leaky_relu(self.BatchNorm_1(self.Dense_1(y)), 0.2)
        if self.training:
            y = dropout(y, self.dropout, _keep(keep, 1), generator)
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

    def forward(self, x: torch.Tensor, active_heads=None, keep=None,
                generator: torch.Generator | None = None):
        """`keep`: in training, {"DGCNNCls_0": masks, "head_<name>":
        masks} for the Dropouts, else drawn from `generator` in that
        order."""
        active = self.active_heads if active_heads is None else active_heads
        keep = keep or {}
        main, g = self.DGCNNCls_0(x, keep.get("DGCNNCls_0"), generator)
        if "main" not in active:
            main = torch.zeros_like(main)
        outs = {}
        for name in self.head_names:
            out = getattr(self, f"head_{name}")(g, keep.get(f"head_{name}"),
                                                generator)
            if name not in active:
                out = (torch.ones_like(out) if name == "scaling"
                       else torch.zeros_like(out))
            outs[name] = out
        return main, outs
