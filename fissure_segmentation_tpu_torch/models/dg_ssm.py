"""DG-SSM (counterpart of models/dg_ssm.py: `DGSSM`,
`dgssm_ensemble_predict`): a multi-head classification DGCNN predicts the
statistical shape model's mode coefficients (multipliers of its
eigenvalues), an so(3) rotation vector, a translation and a scaling; the
shape is decoded from the SSM and similarity-transformed.

The SSM is fitted before training and passed to each call (`model(x,
ssm)`), as the JAX module takes it; `active_heads` is an attribute the
head schedule sets between epochs (the JAX entry rebuilds its module for
that).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..data.augmentation import compose_transform, transform_points
from ..shape_model.ssm import SSMParams, ssm_decode
from .dgcnn_cls import HEADS, MultiHeadDGCNN


class DGSSM(nn.Module):
    """Call: ``model(x (B, N, C), ssm)`` -> (reconstruction (B, P, 3),
    weights (B, M), affine (B, 9) = [rotation | translation | scaling])."""

    def __init__(self, k: int, in_features: int, ssm_modes: int,
                 dynamic: bool = True, predict_affine_params: bool = True,
                 only_affine: bool = False, dropout: float = 0.0,
                 active_heads: Sequence[str] = HEADS,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.k, self.in_features, self.ssm_modes = k, in_features, ssm_modes
        self.dynamic = bool(dynamic)
        self.predict_affine_params = bool(predict_affine_params)
        self.only_affine = bool(only_affine)
        self.dropout = dropout
        self.active_heads = tuple(active_heads)
        self.MultiHeadDGCNN_0 = MultiHeadDGCNN(
            k=k, output_channels_main=ssm_modes, dropout=dropout,
            static=not dynamic, in_features=in_features,
            generator=generator)

    @property
    def config(self) -> dict:
        return dict(k=self.k, in_features=self.in_features,
                    ssm_modes=self.ssm_modes, dynamic=self.dynamic,
                    predict_affine_params=self.predict_affine_params,
                    only_affine=self.only_affine, dropout=self.dropout,
                    active_heads=list(self.active_heads))

    def forward(self, x: torch.Tensor, ssm: SSMParams):
        main, heads = self.MultiHeadDGCNN_0(x, self.active_heads)
        if self.only_affine:
            weights = torch.zeros_like(main)
        else:
            weights = main * ssm.eigenvalues
        recon = ssm_decode(ssm, weights)
        if self.predict_affine_params or self.only_affine:
            rot, trans, scale = (heads["rotation"], heads["translation"],
                                 heads["scaling"])
            recon = transform_points(recon,
                                     compose_transform(rot, trans, scale))
        else:
            b = x.shape[0]
            rot = torch.zeros((b, 3), device=x.device)
            trans = torch.zeros((b, 3), device=x.device)
            scale = torch.ones((b, 3), device=x.device)
        return recon, weights, torch.cat([rot, trans, scale], dim=-1)


@torch.no_grad()
def dgssm_ensemble_predict(model: DGSSM, ssm: SSMParams, pc: torch.Tensor,
                           sample_points: int = 1024, n_runs_min: int = 50,
                           generator: torch.Generator | None = None,
                           perms: torch.Tensor | None = None):
    """Full-cloud prediction: the coefficients and affine parameters
    averaged over `n_runs_min` random subsets of `sample_points` points
    (the model in eval mode), then decoded and transformed once.

    :param pc: (B, N, C) full clouds
    :param perms: (n_runs_min, sample_points) point indices to use instead
        of the first `sample_points` of a random permutation per run
    :return: (recon (B, P, 3), weights (B, M), affine (B, 9))
    """
    b, n, _ = pc.shape
    w_acc = torch.zeros((b, ssm.num_modes), device=pc.device)
    a_acc = torch.zeros((b, 9), device=pc.device)
    for r in range(n_runs_min):
        if perms is None:
            sel = torch.randperm(n, generator=generator,
                                 device=generator.device if generator
                                 is not None else pc.device)[:sample_points]
        else:
            sel = perms[r]
        _, w, a = model(pc[:, sel.to(pc.device)], ssm)
        w_acc += w
        a_acc += a
    w = w_acc / n_runs_min
    a = a_acc / n_runs_min
    recon = transform_points(ssm_decode(ssm, w),
                             compose_transform(a[:, :3], a[:, 3:6], a[:, 6:9]))
    return recon, w, a
