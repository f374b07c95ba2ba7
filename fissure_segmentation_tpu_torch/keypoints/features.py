"""Point features: MIND / MIND-SSC descriptors, patch features and the
intensity normalization (counterpart of keypoints/features.py).

  mind                   — the 6-neighbourhood MIND or the 12-channel
                           self-similarity context, shifts as slices of the
                           edge-padded volume, Gaussian smoothing, the
                           variance normalization and exp;
  compute_point_features — the descriptor at the keypoint voxels
                           ('mind', 'mind_ssc'), or 5^3 patches of the image
                           or of the enhancement image ('image',
                           'enhancement').

Everything runs on the device of its input tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.coords import kpts_to_world
from ..utils.filters import _pad_axis, smooth
from ..utils.sampling import sample_patches_at_kpts

IMG_MIN = -1000.0  # reference data.py:30
IMG_MAX = 1500.0   # reference data.py:31

# the 6-neighbourhood offsets of MIND, in a 3^3 kernel
_SIX_NH = np.array([[0, 1, 1], [1, 1, 0], [1, 0, 1],
                    [1, 1, 2], [2, 1, 1], [1, 2, 1]])
# the final channel permutation of the SSC descriptor
_SSC_PERM = np.array([6, 8, 1, 11, 2, 10, 0, 7, 9, 4, 5, 3])


def normalize_img(img, min_val: float = IMG_MIN, max_val: float = IMG_MAX):
    """HU normalization into [-1, 1] (reference data.py:365-366)."""
    return (img - min_val) / (max_val - min_val) * 2 - 1


def _ssc_pairs() -> tuple[np.ndarray, np.ndarray]:
    """The 12 (shift1, shift2) pairs of the self-similarity context:
    ordered pairs (i > j) of 6-neighbourhood voxels at squared distance 2."""
    d = ((_SIX_NH[:, None] - _SIX_NH[None]) ** 2).sum(-1)
    x, y = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    mask = (x > y) & (d == 2)
    idx1 = _SIX_NH[np.repeat(np.arange(6), 6).reshape(6, 6)[mask]]
    idx2 = _SIX_NH[np.tile(np.arange(6), 6).reshape(6, 6)[mask]]
    return idx1, idx2


def _shifted(img_pad: torch.Tensor, off: np.ndarray, dilation: int,
             dhw) -> torch.Tensor:
    """A one-hot 3^3 kernel's convolution: a shifted slice of the padded
    volume."""
    z, y, x = (int(o) * dilation for o in off)
    d, h, w = dhw
    return img_pad[..., z:z + d, y:y + h, x:x + w]


def mind(img: torch.Tensor, dilation: int = 1, sigma: float = 0.8,
         ssc: bool = True) -> torch.Tensor:
    """MIND(-SSC) descriptor volume. Plain MIND is the intended
    6-neighbourhood descriptor (centre against shifted voxel), as in the
    JAX package, not the reference's defective branch.

    :param img: (D, H, W) volume
    :return: (12, D, H, W) for ssc, else (6, D, H, W)
    """
    dhw = tuple(img.shape[-3:])
    img_pad = img
    for axis in range(img.ndim - 3, img.ndim):
        img_pad = _pad_axis(img_pad, axis, dilation, dilation, "replicate")
    if ssc:
        idx1, idx2 = _ssc_pairs()
        diffs = [(_shifted(img_pad, o1, dilation, dhw)
                  - _shifted(img_pad, o2, dilation, dhw)) ** 2
                 for o1, o2 in zip(idx1, idx2)]
    else:
        diffs = [(img - _shifted(img_pad, o, dilation, dhw)) ** 2
                 for o in _SIX_NH]
    m = smooth(torch.stack(diffs, dim=0), sigma)
    m = m - m.amin(dim=0, keepdim=True)
    mind_var = m.mean(dim=0, keepdim=True)
    mean = mind_var.mean()
    mind_var = torch.clamp(mind_var, mean * 0.001, mean * 1000)
    m = torch.exp(-m / mind_var)
    if ssc:
        m = m[torch.as_tensor(_SSC_PERM, device=m.device)]
    return m


def descriptor_at_keypoints(desc: torch.Tensor,
                            kpts_grid: torch.Tensor) -> torch.Tensor:
    """A (C, D, H, W) descriptor at (N, 3) xyz grid coordinates, by
    truncation to voxel indices.

    :return: (N, C)
    """
    d, h, w = desc.shape[-3:]
    idx = kpts_to_world(kpts_grid, (d, h, w)).to(torch.int64)   # xyz, trunc
    hi = torch.tensor([w - 1, h - 1, d - 1], device=idx.device)
    idx = torch.minimum(torch.maximum(idx, torch.zeros_like(hi)), hi)
    return desc[:, idx[:, 2], idx[:, 1], idx[:, 0]].T


def compute_point_features(img: torch.Tensor, kpts_grid: torch.Tensor,
                           feature_mode: str = "mind",
                           enhanced_img: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Per-keypoint features on the device of `img`.

    :param img: (D, H, W) CT volume at unit spacing
    :param kpts_grid: (N, 3) xyz grid coordinates
    :return: (N, F): 6 (mind), 12 (mind_ssc) or 125 (5^3 patches)
    """
    if feature_mode in ("mind", "mind_ssc"):
        desc = mind(img, dilation=1, sigma=0.8, ssc=feature_mode == "mind_ssc")
        return descriptor_at_keypoints(desc, kpts_grid)
    if feature_mode in ("image", "enhancement"):
        src = enhanced_img if feature_mode == "enhancement" else img
        if src is None:
            raise ValueError("enhancement mode needs enhanced_img")
        patches = sample_patches_at_kpts(src, kpts_grid, patch_size=5)
        feats = patches.reshape(patches.shape[0], -1)
        if feature_mode == "image":
            feats = normalize_img(feats, max_val=0.0)
        return feats
    raise ValueError(f"no feature mode named {feature_mode}")
