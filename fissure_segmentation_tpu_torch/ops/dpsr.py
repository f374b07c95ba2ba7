"""Spectral Poisson surface reconstruction (counterpart of ops/dpsr.py).

Oriented normals are rasterized to a grid and solved in the spectral domain
(rFFT, Gaussian smoothing, divergence over the negative Laplacian folded
into one complex weight per channel), then shifted and scaled so the zero
level-set is the surface. The FFTs are torch.fft, as the JAX package leaves
them to XLA.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import host_to
from .splat import grid_interp, point_rasterize


def fftfreqs(res) -> np.ndarray:
    """(d0, d1, d2r, n_dim) frequency grid (cycles), rfft on the last dim."""
    freqs = [np.fft.fftfreq(r, d=1 / r) for r in res[:-1]]
    freqs.append(np.fft.rfftfreq(res[-1], d=1 / res[-1]))
    omega = np.stack(np.meshgrid(*freqs, indexing="ij"), axis=-1)
    return omega.astype(np.float32)


def spec_gaussian_filter(res, sig: float) -> np.ndarray:
    """exp(-0.5 (sig * 2|w| / res0)^2)."""
    omega = fftfreqs(res)
    dis = np.sqrt((omega ** 2).sum(-1))
    return np.exp(-0.5 * ((sig * 2.0 * dis / res[0]) ** 2)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _psr_weights(res, sig: float) -> np.ndarray:
    """Per-channel spectral weight W_d = g * (-i w_d) / lap, DC zeroed
    (ops/dpsr.py:_psr_weights). Read-only: the cache hands the same array
    to every caller."""
    g = spec_gaussian_filter(res, sig)                        # (d0,d1,d2r)
    omega = fftfreqs(res) * (2 * np.pi)                       # (d0,d1,d2r,3)
    lap = -(omega ** 2).sum(-1)
    w = (-1j * omega) * g[..., None] / (lap + 1e-6)[..., None]
    w[0, 0, 0, :] = 0.0                                       # zero DC
    w = w.astype(np.complex64)
    w.flags.writeable = False
    return w


def spectral_psr(v: torch.Tensor, normal_field: torch.Tensor, res,
                 sig: float = 10.0, scale: bool = True, shift: bool = True,
                 point_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Solve the spectral Poisson problem.

    :param v: (B, N, 3) points in [0, 1] (index order), for the shift
    :param normal_field: (B, 3, *res) rasterized normals
    :param point_weights: optional (B, N) weights of the shift average
    :return: (B, *res) indicator field phi (zero level-set = surface)
    """
    res = tuple(res)
    psr_w = host_to(np.array(_psr_weights(res, float(sig))),
                    normal_field.device)                      # (d0,d1,d2r,3)
    n_hat = torch.fft.rfftn(normal_field, dim=(2, 3, 4))     # (B,3,d0,d1,d2r)
    phi_hat = (n_hat * psr_w.permute(3, 0, 1, 2)[None]).sum(1)
    phi = torch.fft.irfftn(phi_hat, s=res, dim=(1, 2, 3))

    if shift:
        fv = grid_interp(phi[..., None], v)[..., 0]           # (B, N)
        if point_weights is None:
            offset = fv.mean(-1)
        else:
            w = point_weights.to(fv.dtype)
            offset = (fv * w).sum(-1) / torch.clamp(w.sum(-1), min=1e-12)
        phi = phi - offset[:, None, None, None]
    if scale:
        fv0 = phi[:, 0, 0, 0]
        phi = -phi / fv0.abs()[:, None, None, None] * 0.5
    return phi


def dpsr_forward(points: torch.Tensor, normals: torch.Tensor, res,
                 sig: float = 10.0, scale: bool = True, shift: bool = True,
                 point_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Points (B, N, 3) in grid coords [-1, 1] + normals (B, N, 3) ->
    indicator field (B, *res)."""
    v = (points + 1.0) / 2.0
    ras = point_rasterize(v, normals, tuple(res))             # (B, 3, *res)
    return spectral_psr(v, ras, res, sig, scale, shift, point_weights)
