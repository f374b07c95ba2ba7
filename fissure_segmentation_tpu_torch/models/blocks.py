"""Point-wise building blocks (counterpart of models/blocks.py), eval mode.

Submodules and parameters carry the JAX package's module names (`Dense_0`, `BatchNorm_0`,
`kernel`, `scale`, ...) so that models/weights.py can map a JAX variable
tree onto them one to one. Dense layers are `nn.Linear` (weight = the JAX
Dense kernel transposed); initialization is xavier-normal weights and zero biases,
like the JAX package.

Not ported: the fused variants `FusedEdgeMLPMax` and `FusedEdgeTail`. They
are performance rewrites with the same parameter tree, and in eval mode they
reach no kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.edge import edge_mlp_pre_gather


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """The JAX package's leaky_relu: where(x >= 0, x, slope * x)."""
    return torch.where(x >= 0, x, slope * x)


class BatchNorm(nn.Module):
    """Running-statistics BatchNorm over the last axis, computed the way
    the JAX package's BatchNorm does: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("training-mode BatchNorm is not ported "
                                      "yet; call .eval() on the model")
        mul = torch.rsqrt(self.var + self.epsilon) * self.scale
        return (x - self.mean) * mul + self.bias


def _dense(fin: int, fout: int, bias: bool,
           generator: torch.Generator | None) -> nn.Linear:
    lin = nn.Linear(fin, fout, bias=bias)
    nn.init.xavier_normal_(lin.weight, generator=generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class EdgeMLP(nn.Module):
    """First shared-MLP layer of an EdgeConv, with the edge-feature build
    fissioned into a pre-gather matmul (ops/edge.py:edge_mlp_pre_gather),
    followed by BatchNorm and LeakyReLU. `kernel` is (2C, F) as in the JAX package."""

    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.kernel = nn.Parameter(torch.empty(2 * in_features, features))
        nn.init.xavier_normal_(self.kernel, generator=generator)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        z = edge_mlp_pre_gather(x, idx, self.kernel)
        return leaky_relu(self.BatchNorm_0(z), self.negative_slope)


class SharedMLP(nn.Module):
    """Dense (+ BatchNorm + LeakyReLU) applied point-wise; `last_layer`
    drops norm and activation and adds a bias."""

    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.2, last_layer: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.last_layer = last_layer
        self.Dense_0 = _dense(in_features, features, last_layer, generator)
        if not last_layer:
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.linear(x, self.Dense_0.weight, self.Dense_0.bias)
        if self.last_layer:
            return x
        return leaky_relu(self.BatchNorm_0(x), self.negative_slope)
