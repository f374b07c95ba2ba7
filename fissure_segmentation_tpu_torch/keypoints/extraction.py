"""Keypoints from the enhancement image and from the pre-segmentation CNN
(counterpart of keypoints/extraction.py, the two modes serving uses):

  cnn          — argmax != 0 of the CNN softmax within the lung mask; a
                 uniform random subset of at most max_kpts of those voxels
  enhancement  — the Hessian plateness image smoothed (sigma 1), its top
                 max_kpts voxels above 0.2

Both give a fixed-size set: (max_kpts, 3) int32 zyx voxel indices and a
validity mask. The random draw of the cnn mode comes from a
`torch.Generator` or is injected as `scores` (jax.random cannot be replayed
in torch; the tests inject the JAX package's draw).

Not ported yet: the noisy mode, `compute_keypoints`, the cnn mode's 5^3
softmax-patch features (`want_features=True`, needs utils/sampling.py) and
`approx_top_k`.
"""
from __future__ import annotations

import torch

from ..ops.topk import masked_top_k
from ..utils.filters import smooth

MAX_KPTS = 20000


def uniform_scores(n: int, generator: torch.Generator | None,
                   device) -> torch.Tensor:
    """n uniform [0, 1) float32 draws on `device`. A generator on another
    device than `device` (serving's CPU generator for a case on the card)
    gives one 62-bit seed for a generator on `device`, so the draw is made
    where it is used; without a generator the seed is 0."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if generator.device.type == device.type:
        return torch.rand(n, generator=generator, device=device)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    local = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(n, generator=local, device=device)


def _flat_to_zyx(idx: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return torch.stack([idx // (h * w), (idx // w) % h, idx % w],
                       dim=-1).to(torch.int32)


def _random_cap(kp: torch.Tensor, valid: torch.Tensor, max_kpts: int,
                generator: torch.Generator | None = None,
                scores: torch.Tensor | None = None):
    """A uniform random subset of the valid keypoints, fixed output size
    (keypoints/extraction.py:_random_cap).

    :param scores: optional (N,) uniform draws to use instead of a draw
    """
    n = kp.shape[0]
    if n <= max_kpts:
        return kp, valid
    if scores is None:
        scores = uniform_scores(n, generator, kp.device)
    score = torch.where(valid, scores.to(kp.device), -torch.inf)
    top, idx = masked_top_k(score, max_kpts)
    # validity from the selected scores: a -inf slot is never valid
    return kp[idx], valid[idx] & torch.isfinite(top)


def get_enhancement_keypoints(enhanced: torch.Tensor,
                              min_threshold: float = 0.2,
                              max_kpts: int = MAX_KPTS):
    """Top max_kpts voxels of the smoothed enhancement image above the
    threshold, thresholded before the top-k as the JAX package does.

    :return: (kp (max_kpts, 3) int32 zyx, valid (max_kpts,) bool)
    """
    sm = smooth(enhanced, 1.0)
    score = torch.where(sm > min_threshold, sm, -torch.inf).reshape(-1)
    top, idx = masked_top_k(score, max_kpts)
    _, h, w = enhanced.shape
    return _flat_to_zyx(idx, h, w), torch.isfinite(top)


def get_cnn_keypoints(softmax_scores: torch.Tensor, lung_mask: torch.Tensor,
                      max_kpts: int = MAX_KPTS,
                      generator: torch.Generator | None = None,
                      scores: torch.Tensor | None = None,
                      want_features: bool = False):
    """Foreground argmax of the CNN softmax within the lung mask; a uniform
    random subset of at most max_kpts of them (random scores, then the exact
    top-k).

    :param softmax_scores: (D, H, W, C) from models.seg_cnn
    :param lung_mask: (D, H, W) bool
    :param generator: draws the random scores (see `uniform_scores`)
    :param scores: optional (D * H * W,) uniform draws to use instead
    :param want_features: the 5^3 softmax patches; not ported yet (raises)
    :return: (kp (max_kpts, 3) int32 zyx, valid (max_kpts,) bool, None)
    """
    if want_features:
        raise NotImplementedError("the cnn mode's softmax-patch features "
                                  "(utils/sampling.py) are not ported yet")
    d, h, w, _ = softmax_scores.shape
    fg = (softmax_scores.argmax(-1) != 0) & lung_mask.to(torch.bool)
    flat = fg.reshape(-1)
    if scores is None:
        scores = uniform_scores(flat.numel(), generator, flat.device)
    score = torch.where(flat, scores.reshape(-1).to(flat.device), -torch.inf)
    top, idx = masked_top_k(score, max_kpts)
    return _flat_to_zyx(idx, h, w), torch.isfinite(top), None
