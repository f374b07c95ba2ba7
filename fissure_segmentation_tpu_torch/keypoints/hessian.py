"""Closed-form eigenvalues of symmetric 3x3 fields (counterpart of
keypoints/hessian.py:eigvalsh3 — the rest of that module, the Hessian
fissure enhancement, is not ported yet)."""
from __future__ import annotations

import math

import torch


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
