"""Device-resident point-cloud store and batch sampling (counterpart of
data/store.py:20-94).

All cases of a fold are stacked once into padded tensors on the training
device; per-step subset sampling and augmentation then run there, with an
explicit device `torch.Generator`. The draws — the uniform noise that picks
the subset and the augmentation transform — can be passed in instead
(jax.random cannot be replayed in torch; the parity tests inject the JAX
draws). The point axis is padded to a multiple of 128 like the JAX store,
so an injected noise array has the same shape on both sides.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .augmentation import (SimilarityTransform, point_augmentation,
                           random_transform)


class PointCloudStore(NamedTuple):
    """Padded stack of point-cloud cases (tensors on one device)."""
    coords: torch.Tensor    # (n_cases, N_max, 3) grid coords, padded with 0
    features: torch.Tensor  # (n_cases, N_max, F) (F may be 0)
    labels: torch.Tensor    # (n_cases, N_max) int64, padding = 0
    valid: torch.Tensor     # (n_cases, N_max) bool

    @property
    def n_cases(self) -> int:
        return self.coords.shape[0]

    @property
    def n_feat(self) -> int:
        return self.features.shape[-1]


def build_store(cases, device=None) -> PointCloudStore:
    """Stack case dicts (numpy coords (N, 3), labels (N,), optional features
    (N, F)) into a PointCloudStore on `device`, padding the point axis."""
    n_max = max(c["coords"].shape[0] for c in cases)
    n_max = -(-n_max // 128) * 128
    f = cases[0].get("features")
    n_feat = 0 if f is None else f.shape[1]
    n = len(cases)
    coords = np.zeros((n, n_max, 3), np.float32)
    feats = np.zeros((n, n_max, n_feat), np.float32)
    labels = np.zeros((n, n_max), np.int64)
    valid = np.zeros((n, n_max), bool)
    for i, c in enumerate(cases):
        m = c["coords"].shape[0]
        coords[i, :m] = c["coords"]
        labels[i, :m] = c["labels"]
        valid[i, :m] = True
        if n_feat:
            feats[i, :m] = c["features"]
    return PointCloudStore(*(torch.from_numpy(a).to(device)
                             for a in (coords, feats, labels, valid)))


def sample_batch(store: PointCloudStore, case_idx: torch.Tensor,
                 sample_points: int, generator: torch.Generator | None = None,
                 augment: bool = True, binary: bool = False,
                 noise: torch.Tensor | None = None,
                 transform: SimilarityTransform | None = None,
                 rows: slice | None = None):
    """Draw a batch: the `sample_points` valid points of smallest uniform
    noise per case (ties to the lower index, like lax.top_k), then a random
    similarity augmentation of the coordinates.

    :param case_idx: (B,) int indices into the store
    :param noise: (B, N_max) uniform noise to use instead of drawing it
    :param transform: augmentation transform to use instead of drawing it
    :param rows: keep only these rows of the batch (a data-parallel rank's
        share): the noise and the transform are drawn, or taken, for the
        whole batch first, so the rows are those that the whole batch's
        draw gives them, whatever the split
    :return: x (B, S, 3+F) float32, y (B, S) int64 (B: the rows kept)
    """
    b = case_idx.shape[0]
    n_max = store.coords.shape[1]
    if noise is None:
        noise = torch.rand((b, n_max), generator=generator,
                           device=store.coords.device)
    if rows is not None:
        if augment and transform is None:
            transform = random_transform(generator, (b,),
                                         device=store.coords.device)
        case_idx, noise = case_idx[rows], noise[rows]
        if augment:
            transform = SimilarityTransform(*(t[rows] for t in transform))
        b = case_idx.shape[0]
    noise = torch.where(store.valid[case_idx], noise, 2.0)
    sel = torch.sort(noise, dim=1, stable=True).indices[:, :sample_points]

    coords = torch.gather(store.coords[case_idx], 1,
                          sel[..., None].expand(b, sample_points, 3))
    labels = torch.gather(store.labels[case_idx], 1, sel)
    if augment:
        coords, _ = point_augmentation(coords, generator, transform=transform)
    if store.n_feat:
        feats = torch.gather(store.features[case_idx], 1,
                             sel[..., None].expand(b, sample_points,
                                                   store.n_feat))
        x = torch.cat([coords, feats], dim=-1)
    else:
        x = coords
    if binary:
        labels = (labels != 0).to(torch.int64)
    return x, labels
