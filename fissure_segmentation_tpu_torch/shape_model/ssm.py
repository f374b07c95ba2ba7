"""Statistical shape model: PCA over corresponding point sets (counterpart
of shape_model/ssm.py).

The fit is a one-shot numpy SVD of the centred data matrix before
training: the "eigenvalues" are the singular values and the mode count is
the smallest whose cumulative singular-value fraction passes
`target_variance`. Encoding projects onto the eigenvectors, decoding is
mean + eigenvectors @ weights, both float32 matrix products on the
parameters' device. `ssm.npz` is the JAX package's file, so either
package reads the other's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SSMParams(NamedTuple):
    mean_shape: torch.Tensor        # (1, F)
    eigenvalues: torch.Tensor       # (1, M) singular values
    eigenvectors: torch.Tensor      # (1, F, M)
    alpha: float = 3.0
    percent_of_variance: float = 0.0

    @property
    def num_modes(self) -> int:
        return self.eigenvalues.shape[-1]

    @property
    def dim(self) -> int:
        return 3

    def to(self, device) -> "SSMParams":
        return self._replace(mean_shape=self.mean_shape.to(device),
                             eigenvalues=self.eigenvalues.to(device),
                             eigenvectors=self.eigenvectors.to(device))


def shape2vector(shapes: torch.Tensor) -> torch.Tensor:
    """(..., P, 3) -> (..., P*3)."""
    return shapes.reshape(*shapes.shape[:-2], -1)


def vector2shape(vectors: torch.Tensor, dim: int = 3) -> torch.Tensor:
    return vectors.reshape(*vectors.shape[:-1], -1, dim)


def _params(mean, evals, evecs, alpha, pov) -> SSMParams:
    return SSMParams(torch.from_numpy(np.asarray(mean, np.float32)),
                     torch.from_numpy(np.asarray(evals, np.float32)),
                     torch.from_numpy(np.asarray(evecs, np.float32)),
                     float(alpha), float(pov))


def fit_ssm(train_shapes: np.ndarray, alpha: float = 3.0,
            target_variance: float = 0.95) -> SSMParams:
    """PCA of (N, P, 3) or (N, F) training shapes, in float64 numpy."""
    x = np.asarray(train_shapes, np.float64)
    if x.ndim == 3:
        x = x.reshape(x.shape[0], -1)
    mean = x.mean(0, keepdims=True)
    _, s, vt = np.linalg.svd(x - mean, full_matrices=False)
    variance_at_sv = np.cumsum(s / s.sum())
    num_modes = min(int((variance_at_sv <= target_variance).sum()) + 1,
                    len(s))
    return _params(mean, s[None, :num_modes], vt.T[None, :, :num_modes],
                   alpha, variance_at_sv[num_modes - 1])


def ssm_project(params: SSMParams, shapes: torch.Tensor) -> torch.Tensor:
    """(B, P, 3) shapes -> (B, M) weights."""
    v = shape2vector(shapes) - params.mean_shape
    return torch.einsum("fm,bf->bm", params.eigenvectors[0], v)


def ssm_decode(params: SSMParams, weights: torch.Tensor) -> torch.Tensor:
    """(B, M) weights -> (B, P, 3) shapes."""
    rec = params.mean_shape + torch.einsum("fm,bm->bf",
                                           params.eigenvectors[0], weights)
    return vector2shape(rec)


def ssm_random_samples(params: SSMParams, n_samples: int,
                       generator: torch.Generator | None = None,
                       draws: torch.Tensor | None = None) -> torch.Tensor:
    """Uniform mode weights in +-alpha * sqrt(eigenvalue), (n, M).

    :param draws: (n, M) uniforms in [0, 1) to use instead of drawing them
    """
    ranges = params.alpha * torch.sqrt(params.eigenvalues)
    if draws is None:
        draws = torch.rand((n_samples, params.num_modes),
                           generator=generator, device=ranges.device)
    return draws.to(ranges) * 2 * ranges - ranges


def save_ssm(params: SSMParams, path: str) -> None:
    """Write the JAX package's ssm.npz layout."""
    np.savez(path, mean_shape=params.mean_shape.cpu().numpy(),
             eigenvalues=params.eigenvalues.cpu().numpy(),
             eigenvectors=params.eigenvectors.cpu().numpy(),
             alpha=params.alpha,
             percent_of_variance=params.percent_of_variance)


def load_ssm(path: str) -> SSMParams:
    with np.load(path) as z:
        return _params(z["mean_shape"], z["eigenvalues"], z["eigenvectors"],
                       z["alpha"], z["percent_of_variance"])
