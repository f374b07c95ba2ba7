"""Hessian-based fissure enhancement, the plateness filter (counterpart of
keypoints/hessian.py): separable Gaussian-derivative Hessian, closed-form
eigenvalues of the symmetric 3x3 field, the two of largest magnitude, and
plateness P = (|l1| - |l2|) / (|l1| + |l2|) where l1 < 0, weighted by a
Gaussian of the intensity around the fissure's.

Like the JAX package (and its reference), the Hessian is built from the raw
image, not a smoothed one.
"""
from __future__ import annotations

import math

import torch

from ..utils.filters import filter_1d, gaussian_kernel_1d


def hessian_components(img: torch.Tensor, sigma: float = 1.0) -> tuple:
    """The six unique Hessian components (h00, h11, h22, h01, h02, h12) of a
    (..., D, H, W) volume, dims ordered (D, H, W)."""
    k1 = gaussian_kernel_1d(sigma, order=1)
    k2 = gaussian_kernel_1d(sigma, order=2)
    h_diag = [filter_1d(img, k2, dim) for dim in range(3)]
    h01 = filter_1d(filter_1d(img, k1, 0), k1, 1)
    h02 = filter_1d(filter_1d(img, k1, 0), k1, 2)
    h12 = filter_1d(filter_1d(img, k1, 1), k1, 2)
    return h_diag[0], h_diag[1], h_diag[2], h01, h02, h12


def eigvalsh3(a00, a11, a22, a01, a02, a12):
    """Trigonometric method (Smith 1961); returns (e1, e2, e3) with
    e1 >= e2 >= e3 by construction of the cosine angles."""
    p1 = a01 ** 2 + a02 ** 2 + a12 ** 2
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    inv_p = 1.0 / p
    b00, b11, b22 = (a00 - q) * inv_p, (a11 - q) * inv_p, (a22 - q) * inv_p
    b01, b02, b12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    # det(B) / 2
    r = (b00 * (b11 * b22 - b12 * b12)
         - b01 * (b01 * b22 - b12 * b02)
         + b02 * (b01 * b12 - b11 * b02)) / 2.0
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    # degenerate (diagonal/isotropic) case
    is_degenerate = p2 <= 1e-30
    e1 = torch.where(is_degenerate, q, e1)
    e2 = torch.where(is_degenerate, q, e2)
    e3 = torch.where(is_degenerate, q, e3)
    return e1, e2, e3


def _top2_by_abs(e1, e2, e3):
    """The two eigenvalues of largest magnitude, descending, by three
    element-wise compare-swaps (ties keep the earlier one first)."""
    a1, a2, a3 = e1.abs(), e2.abs(), e3.abs()

    def swap(v1, va, v2, vb):
        c = va >= vb
        return (torch.where(c, v1, v2), torch.where(c, va, vb),
                torch.where(c, v2, v1), torch.where(c, vb, va))

    e1, a1, e2, a2 = swap(e1, a1, e2, a2)
    e1, a1, e3, a3 = swap(e1, a1, e3, a3)
    e2, a2, e3, a3 = swap(e2, a2, e3, a3)
    return e1, e2


def fissure_filter(img: torch.Tensor, lambda1: torch.Tensor,
                   lambda2: torch.Tensor, fissure_mu: float,
                   fissure_sigma: float) -> torch.Tensor:
    """Plateness times the intensity weighting."""
    abs1, abs2 = lambda1.abs(), lambda2.abs()
    p = torch.where(lambda1 < 0,
                    (abs1 - abs2) / torch.clamp(abs1 + abs2, min=1e-30),
                    torch.zeros_like(abs1))
    hu_w = torch.exp(-((img - fissure_mu) ** 2) / (2 * fissure_sigma ** 2))
    return hu_w * p


@torch.no_grad()
def hessian_fissure_enhancement(img: torch.Tensor, fissure_mu: float,
                                fissure_sigma: float,
                                gaussian_derivation_sigma: float = 1.0
                                ) -> torch.Tensor:
    """Fissure-enhanced volume of a (D, H, W) CT (keypoints/hessian.py:
    hessian_fissure_enhancement); `fissure_mu`/`fissure_sigma` in the
    image's intensity units."""
    h = hessian_components(img, gaussian_derivation_sigma)
    l1, l2 = _top2_by_abs(*eigvalsh3(*h))
    return fissure_filter(img, l1, l2, fissure_mu, fissure_sigma)
