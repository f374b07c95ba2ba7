"""Point-wise building blocks (counterpart of models/blocks.py).

Submodules and parameters carry the JAX package's module names (`Dense_0`, `BatchNorm_0`,
`kernel`, `scale`, ...) so that models/weights.py can map a JAX variable
tree onto them one to one. Dense layers are `nn.Linear` (weight = the JAX
Dense kernel transposed); initialization is xavier-normal weights and zero biases,
like the JAX package. `.train()` / `.eval()` switch BatchNorm between batch
and running statistics, as flax's `train` argument does.

`dtype` (None or torch.bfloat16) is the compute dtype, as in the JAX
package: parameters stay float32 and are cast, with the input, to the
compute dtype before each product; BatchNorm's statistics are float32 and
its output is in the dtype of its input, which is the compute dtype (flax
`BatchNorm(dtype=...)`). None computes in the input's dtype.

Not ported: `FusedEdgeTail`. It reaches no kernel and computes the same
function as the unfused tail (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.edge import edge_mlp_pre_gather
from ..ops.fused_edge import fused_edge_eval, fused_edge_train


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """The JAX package's leaky_relu: where(x >= 0, x, slope * x)."""
    return torch.where(x >= 0, x, slope * x)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax semantics.

    Training: statistics in float32 (float64 for a float64 input, as
    flax promotes) over every axis but the last, fast
    variance E[x^2] - E[x]^2 clipped at 0, normalization with that (biased)
    batch variance, and the running update ``ra = 0.9 ra + 0.1 batch`` with
    the same biased variance (torch's own BatchNorm would store the unbiased
    one). Eval: the running statistics. Both compute
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` like flax.
    `update_stats` False skips the running update in training (a
    checkpoint's recomputation of a forward that already folded its batch
    in, models/seg_cnn.py).
    """

    momentum = 0.9  # flax's; torch's BatchNorm(momentum=0.1)
    update_stats = True

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Fold batch statistics into the running ones (no gradient)."""
        with torch.no_grad():
            self.mean.copy_(self.momentum * self.mean
                            + (1.0 - self.momentum) * mean)
            self.var.copy_(self.momentum * self.var
                           + (1.0 - self.momentum) * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            axes = tuple(range(x.ndim - 1))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            if self.update_stats:
                self.update_running(mean, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((x - mean) * mul + self.bias).to(x.dtype)


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
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(2 * in_features, features))
        nn.init.xavier_normal_(self.kernel, generator=generator)
        self.BatchNorm_0 = BatchNorm(features)

    def edge_responses(self, x: torch.Tensor, idx: torch.Tensor,
                       transposed=None) -> torch.Tensor:
        """(..., N, C), (..., N, k) -> (..., N, k, F) activated edges, in
        the compute dtype (the kernel is cast before it is split, as in
        the JAX package's EdgeMLP). `transposed`: the graph's transpose
        for the gather's backward (ops/edge.py)."""
        dt = self.dtype or x.dtype
        z = edge_mlp_pre_gather(x.to(dt), idx, self.kernel.to(dt),
                                transposed)
        return leaky_relu(self.BatchNorm_0(z), self.negative_slope)


class FusedEdgeMLPMax(EdgeMLP):
    """Single-layer EdgeConv (EdgeMLP + max over k) through the fused core
    (ops/fused_edge.py; backward K3 + K4). It is an EdgeMLP — the same
    `kernel` and `BatchNorm_0` parameters and buffers — so a JAX tree loads
    unchanged, and `edge_responses` still gives the unfused route on the
    same weights (models/blocks.py:54-89)."""

    def forward(self, x: torch.Tensor, idx: torch.Tensor,
                transposed=None) -> torch.Tensor:
        """(B, N, C), (B, N, k) -> (B, N, F), the max over k. `transposed`:
        the graph's transpose for K3 in the train-mode backward."""
        c = x.shape[-1]
        w = self.kernel
        dt = self.dtype or x.dtype
        xd = x.to(dt)
        a = xd @ w[:c].to(dt)
        cen = xd @ (w[c:] - w[:c]).to(dt)     # split in f32, then cast
        bn = self.BatchNorm_0
        if self.training:
            out, mean, var = fused_edge_train(a, cen, bn.scale, bn.bias, idx,
                                              bn.epsilon, self.negative_slope,
                                              transposed)
            bn.update_running(mean, var)
            return out
        return fused_edge_eval(a, cen, bn.scale, bn.bias, bn.mean, bn.var,
                               idx, bn.epsilon, self.negative_slope)


class SharedMLP(nn.Module):
    """Dense (+ BatchNorm + LeakyReLU) applied point-wise; `last_layer`
    drops norm and activation and adds a bias."""

    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.2, last_layer: bool = False,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.negative_slope = negative_slope
        self.last_layer = last_layer
        self.dtype = dtype
        self.Dense_0 = _dense(in_features, features, last_layer, generator)
        if not last_layer:
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        bias = self.Dense_0.bias
        x = F.linear(x.to(dt), self.Dense_0.weight.to(dt),
                     None if bias is None else bias.to(dt))
        if self.last_layer:
            return x
        return leaky_relu(self.BatchNorm_0(x), self.negative_slope)
