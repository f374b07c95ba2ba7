"""PointNet segmentation (counterpart of models/pointnet.py: `TNet`,
`PointNetSeg`).

A local shared MLP (64, 64), the optional T-Nets, a 1024-d feature
max-pooled over the points (`amax`, which splits the gradient among ties
like `jnp.max`) and broadcast back, then the segmentation MLP (256, 128, 64,
64) and a Dense to the logits. Every stack is an `MLPStack` of SharedMLPs
with LeakyReLU slope 0.01. The T-Net head is the JAX package's repair of the
reference's: a 256 -> d^2 Dense with a zero kernel and an identity bias, so
each T-Net starts as the identity.

Submodules carry the flax names, which depend on the options:
`MLPStack_0..2`, `Dense_0`, and the T-Nets in the order they run —
`TNet_0` is the input transform when `spatial_transform` is on, and the
feature transform is then `TNet_1`; without the input transform the feature
transform is `TNet_0`. So models/weights.py maps a JAX tree one to one for
each of the four combinations.

`dtype=torch.bfloat16` (or "bfloat16") is the compute dtype of the three
shared-MLP stacks only, what `--amp true` trains with; the T-Nets (their
input cast to float32) and the logits head stay float32, as in the JAX
package. Parameters are float32 throughout. A T-Net's product of the points
with its d x d matrix is a float32 matmul, at full precision as long as
TF32 stays off for matmuls (torch's default; `chip_smoke.py` sets it).

PointNet reaches no TPU kernel: its products are `torch.matmul` /
`F.linear`, as XLA computes them in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import MLPStack, _dense

LEAKY = 1e-2


def identity_head(fin: int, d: int) -> nn.Linear:
    """The T-Net's last Dense: zero kernel, bias the flattened identity."""
    lin = _dense(fin, d * d, True, None)
    with torch.no_grad():
        lin.weight.zero_()
        lin.bias.copy_(torch.eye(d).flatten())
    return lin


def apply_transform(x: torch.Tensor, head: torch.Tensor, d: int):
    """x (..., N, d) times the (..., d * d) head output as a d x d matrix
    (the einsum "...nc,...cd->...nd")."""
    mat = head.reshape(*head.shape[:-1], d, d)
    return torch.matmul(x, mat)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or in its own dtype where that is wider."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _check_dtype(dtype, who: str):
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"{who}: dtype must be None, float32 or bfloat16, "
                         f"got {dtype}")
    return None if dtype == torch.float32 else dtype


class TNet(nn.Module):
    """Input or feature transform net: (B, N, d) -> (B, N, d), float32."""

    def __init__(self, matrix_size: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = self.d = matrix_size
        self.MLPStack_0 = MLPStack(d, [64, 128, 1024], LEAKY,
                                   generator=generator)
        self.MLPStack_1 = MLPStack(1024, [512, 256], LEAKY,
                                   generator=generator)
        self.Dense_0 = identity_head(256, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.MLPStack_0(x).amax(dim=-2)        # global max over points
        t = self.Dense_0(self.MLPStack_1(t))
        return apply_transform(x, t, self.d)


class PointNetSeg(nn.Module):
    """PointNet segmentation; (B, N, in_features) -> (B, N, C) float32
    logits."""

    def __init__(self, in_features: int, num_classes: int,
                 spatial_transform: bool = False,
                 feature_transform: bool = False, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dt = _check_dtype(dtype, "PointNetSeg")
        self.spatial_transform = bool(spatial_transform)
        self.feature_transform = bool(feature_transform)
        self.config = dict(in_features=in_features, num_classes=num_classes,
                           spatial_transform=self.spatial_transform,
                           feature_transform=self.feature_transform)
        if dt is not None:   # JSON for model.pt
            self.config["dtype"] = str(dt).removeprefix("torch.")
        g = generator
        tnets = 0
        if self.spatial_transform:
            self.TNet_0 = TNet(3, g)
            tnets = 1
        self.MLPStack_0 = MLPStack(in_features, [64, 64], LEAKY, g, dt)
        self.feature_tnet = None
        if self.feature_transform:
            self.feature_tnet = f"TNet_{tnets}"
            setattr(self, self.feature_tnet, TNet(64, g))
        self.MLPStack_1 = MLPStack(64, [64, 128, 1024], LEAKY, g, dt)
        self.MLPStack_2 = MLPStack(64 + 1024, [256, 128, 64, 64], LEAKY, g,
                                   dt)
        self.Dense_0 = _dense(64, num_classes, True, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spatial_transform:
            coords = self.TNet_0(at_least_f32(x[..., :3]))
            x = torch.cat([coords, x[..., 3:].to(coords.dtype)], dim=-1)
        x_local = self.MLPStack_0(x)
        if self.feature_tnet is not None:
            x_local = getattr(self, self.feature_tnet)(at_least_f32(x_local))
        g = self.MLPStack_1(x_local).amax(dim=-2, keepdim=True)
        g = g.expand(*x_local.shape[:-1], g.shape[-1])
        h = self.MLPStack_2(torch.cat([x_local, g.to(x_local.dtype)],
                                      dim=-1))
        return self.Dense_0(at_least_f32(h))
