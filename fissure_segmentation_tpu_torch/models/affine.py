"""Rigid-registration regression models and their experiment helpers
(counterpart of models/affine.py): small networks that regress a rotation
(an so(3) log vector) and a translation from a transformed point cloud.

  AffineDGCNN      — on DGCNNReg (dynamic graph, float32)
  AffineOpenDGCNN  — on DGCNNCls (emb_dims 1024, no dropout)
  AffinePointNet   — on PointNetCls (shared MLP (64, 64, 64, 128, 1024),
                     global max, Dense(512, no bias)-BatchNorm-ReLU, Dense)

Each returns (rotation (B, 3), translation (B, 3)), zeros for a disabled
component, and records its constructor arguments in `config` for
`save_model`. Submodules carry the flax names (`DGCNNReg_0`, `DGCNNCls_0`,
`PointNetCls_0`), so models/weights.py maps a JAX tree one to one.
`random_transformation` draws from an explicit `torch.Generator` (or takes
the draws: jax.random cannot be replayed in torch, so the parity tests
inject JAX's); `rotate_around_center` applies transforms about each
cloud's centroid with data/augmentation.py's algebra.
"""
from __future__ import annotations

import torch
from torch import nn

from ..data.augmentation import (SimilarityTransform, compose_transform,
                                 transform_points)
from .blocks import BatchNorm, MLPStack, _dense, dropout
from .dgcnn import DGCNNReg
from .dgcnn_cls import DGCNNCls, _check_dropout


def _split_rot_trans(y: torch.Tensor, do_rotation: bool,
                     do_translation: bool):
    """(B, 3|6) regression output -> (rot (B, 3), trans (B, 3)), zeros for
    a disabled component."""
    zeros = torch.zeros((*y.shape[:-1], 3), dtype=y.dtype, device=y.device)
    if do_rotation and do_translation:
        return y[..., :3], y[..., 3:6]
    if do_rotation:
        return y[..., :3], zeros
    return zeros, y[..., :3]


def _outputs(do_rotation: bool, do_translation: bool) -> int:
    return 3 * bool(do_rotation) + 3 * bool(do_translation)


class AffineDGCNN(nn.Module):
    """DGCNNReg regressing an so(3) log rotation and a translation."""

    def __init__(self, k: int, in_features: int = 3, do_rotation: bool = True,
                 do_translation: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.do_rotation, self.do_translation = do_rotation, do_translation
        self.config = dict(k=k, in_features=in_features,
                           do_rotation=do_rotation,
                           do_translation=do_translation)
        self.DGCNNReg_0 = DGCNNReg(k, in_features,
                                   _outputs(do_rotation, do_translation),
                                   generator=generator)

    def forward(self, x: torch.Tensor):
        return _split_rot_trans(self.DGCNNReg_0(x), self.do_rotation,
                                self.do_translation)


class AffineOpenDGCNN(nn.Module):
    """The classification DGCNN (emb_dims 1024, dropout 0) as backbone."""

    def __init__(self, k: int, do_rotation: bool = True,
                 do_translation: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.do_rotation, self.do_translation = do_rotation, do_translation
        self.config = dict(k=k, do_rotation=do_rotation,
                           do_translation=do_translation)
        self.DGCNNCls_0 = DGCNNCls(k, _outputs(do_rotation, do_translation),
                                   emb_dims=1024, dropout=0.0,
                                   generator=generator)

    def forward(self, x: torch.Tensor):
        y, _ = self.DGCNNCls_0(x)
        return _split_rot_trans(y, self.do_rotation, self.do_translation)


class PointNetCls(nn.Module):
    """Global-feature PointNet: shared MLP (64, 64, 64, 128, emb) -> global
    max -> Dense(512, no bias) -> BatchNorm -> ReLU -> Dense(C)."""

    def __init__(self, output_channels: int, emb_dims: int = 1024,
                 dropout: float = 0.0, in_features: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_dropout(dropout)
        self.dropout = dropout
        g = generator
        self.MLPStack_0 = MLPStack(in_features, [64, 64, 64, 128, emb_dims],
                                   1e-2, generator=g)
        self.Dense_0 = _dense(emb_dims, 512, False, g)
        self.BatchNorm_0 = BatchNorm(512)
        self.Dense_1 = _dense(512, output_channels, True, g)

    def forward(self, x: torch.Tensor, keep=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """`keep`: in training, the Dropout's keep mask (B, 512), else
        drawn from `generator`."""
        h = self.MLPStack_0(x).amax(dim=-2)
        y = torch.relu(self.BatchNorm_0(self.Dense_0(h)))
        if self.training:
            y = dropout(y, self.dropout, keep, generator)
        return self.Dense_1(y)


class AffinePointNet(nn.Module):
    """PointNetCls as backbone; `k` is unused (kept, as in the JAX
    package, so every affine model takes the same arguments)."""

    def __init__(self, k: int = 40, do_rotation: bool = True,
                 do_translation: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.do_rotation, self.do_translation = do_rotation, do_translation
        self.config = dict(k=k, do_rotation=do_rotation,
                           do_translation=do_translation)
        self.PointNetCls_0 = PointNetCls(_outputs(do_rotation,
                                                  do_translation),
                                         emb_dims=1024, dropout=0.0,
                                         generator=generator)

    def forward(self, x: torch.Tensor):
        return _split_rot_trans(self.PointNetCls_0(x), self.do_rotation,
                                self.do_translation)


AFFINE_MODELS = {
    "DGCNN": AffineDGCNN,
    "OpenDGCNN": AffineOpenDGCNN,
    "PointNet": AffinePointNet,
}


def random_transformation(generator: torch.Generator | None, n_samples: int,
                          rotation: bool = True, translation: bool = True,
                          draws=None, device=None):
    """Random rigid transforms: log rotation uniform in [-2, 2]^3,
    translation uniform in [-0.2, 0.2]^3 (zeros where disabled).

    :param generator: draws the rotation's (n, 3) uniforms, then the
        translation's (on `device`, default the generator's)
    :param draws: (u_rot (n, 3), u_trans (n, 3)) uniforms in [0, 1) to use
        instead (the JAX function's `uniform(split(rng))` pair)
    :return: (SimilarityTransform, log_rot (n, 3), trans (n, 3))
    """
    if draws is None:
        device = generator.device if device is None else device
        draws = tuple(torch.rand((n_samples, 3), generator=generator,
                                 device=device) for _ in range(2))
    u_rot, u_tr = draws
    log_rot = (u_rot * 2 - 1) * 2.0
    trans = (u_tr * 2 - 1) * 0.2
    if not rotation:
        log_rot = torch.zeros_like(log_rot)
    if not translation:
        trans = torch.zeros_like(trans)
    ones = torch.ones((n_samples, 1), dtype=log_rot.dtype,
                      device=log_rot.device)
    return compose_transform(log_rot, trans, ones), log_rot, trans


def rotate_around_center(shapes: torch.Tensor,
                         t: SimilarityTransform) -> torch.Tensor:
    """Apply transforms about each cloud's centroid.

    :param shapes: (B, N, 3), or (1, N, 3) broadcast against a batch of
        transforms
    """
    center = shapes.mean(dim=-2, keepdim=True)
    return transform_points(shapes - center, t) + center
