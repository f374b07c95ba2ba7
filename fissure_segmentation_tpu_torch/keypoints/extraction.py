"""Keypoint extraction: four modes -> point-cloud case dicts (counterpart of
keypoints/extraction.py).

  foerstner    — the Förstner detector (sigma 0.5, threshold 1e-8, NMS
                 d = 5), a uniform random subset past max_kpts
  noisy        — GT fissure voxels, a random subset, + N(0, 3) jitter
  cnn          — argmax != 0 of the CNN softmax within the lung mask; a
                 uniform random subset; features: 5^3 softmax patches
  enhancement  — the Hessian plateness image smoothed (sigma 1), its top
                 max_kpts voxels above 0.2

Every mode gives a fixed-size set on the device: (max_kpts, 3) int32 zyx
voxel indices and a validity mask. `compute_keypoints` turns it into the
case dict the point datasets read. Random draws come from a
`torch.Generator`, or are injected (`scores`, `draws`): jax.random cannot
be replayed in torch, and the tests inject the JAX package's draws. The
cnn mode's selection may be approximate (`approx_top_k`: ops/approx_topk.py,
the bin kernel on the card); its scores are uniform draws, so an
approximate top-k of them is still a uniform random subset.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.approx_topk import approx_top_k as approx_max_k
from ..ops.topk import masked_top_k
from ..utils.coords import kpts_to_grid
from ..utils.device import as_device_tensor
from ..utils.filters import smooth
from ..utils.sampling import sample_patches_at_kpts

MAX_KPTS = 20000


def device_generator(generator: torch.Generator | None,
                     device) -> torch.Generator:
    """A generator on `device`: `generator` itself where it lies there;
    else one seeded with a 62-bit draw of `generator` (serving's CPU
    generator for a case on the card), so draws are made where they are
    used; without a generator, a CPU one seeded 0."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if generator.device.type == device.type:
        return generator
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=device).manual_seed(seed)


def uniform_scores(n: int, generator: torch.Generator | None,
                   device) -> torch.Tensor:
    """n uniform [0, 1) float32 draws on `device` (see device_generator)."""
    return torch.rand(n, generator=device_generator(generator, device),
                      device=device)


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


def get_noisy_keypoints(fissures: torch.Tensor, max_kpts: int = MAX_KPTS,
                        generator: torch.Generator | None = None,
                        scores: torch.Tensor | None = None,
                        noise: torch.Tensor | None = None):
    """GT fissure voxels + N(0, 3) jitter: a uniform random subset of the
    fissure voxels (random scores, exact top-k), then each slot moved by
    3 x its normal draw, rounded half to even and clipped to the volume.

    :param scores: optional (D * H * W,) uniform draws
    :param noise: optional (max_kpts, 3) standard normal draws
    :return: (kp (max_kpts, 3) int32 zyx, valid (max_kpts,) bool)
    """
    flat = (fissures != 0).reshape(-1)
    dev = flat.device
    if scores is None:
        scores = uniform_scores(flat.numel(), generator, dev)
    if noise is None:
        noise = torch.randn((max_kpts, 3), device=dev,
                            generator=device_generator(generator, dev))
    score = torch.where(flat, scores.reshape(-1).to(dev), -torch.inf)
    top, idx = masked_top_k(score, max_kpts)
    valid = torch.isfinite(top)
    d, h, w = fissures.shape
    kp = _flat_to_zyx(idx, h, w).to(torch.float32)
    kp = kp + noise.to(dev) * 3.0
    hi = torch.tensor([d - 1, h - 1, w - 1], device=dev, dtype=torch.int32)
    kp = torch.round(kp).to(torch.int32)
    return torch.minimum(torch.maximum(kp, torch.zeros_like(hi)), hi), valid


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
                      feat_patch: int = 5, max_kpts: int = MAX_KPTS,
                      generator: torch.Generator | None = None,
                      scores: torch.Tensor | None = None,
                      want_features: bool = False,
                      approx_top_k: bool = False):
    """Foreground argmax of the CNN softmax within the lung mask; a uniform
    random subset of at most max_kpts of them (random scores, then the exact
    top-k); features: the feat_patch^3 patches of every softmax channel
    around each keypoint (nearest, border padding), channel after channel.

    :param softmax_scores: (D, H, W, C) from models.seg_cnn
    :param lung_mask: (D, H, W) bool
    :param generator: draws the random scores (see `uniform_scores`)
    :param scores: optional (D * H * W,) uniform draws to use instead
    :param want_features: sample the softmax patches (JAX's default;
        here off, as serving's coordinate models never read them)
    :param approx_top_k: select the random subset with the approximate
        top-k at recall target 0.95 (`lax.approx_max_k`'s default): the
        same distribution where the foreground exceeds max_kpts; where it
        is smaller, a bin may hide a foreground voxel behind another
    :return: (kp (max_kpts, 3) int32 zyx, valid (max_kpts,) bool,
        features (max_kpts, C * feat_patch^3) float32 or None)
    """
    d, h, w, c = softmax_scores.shape
    fg = (softmax_scores.argmax(-1) != 0) & lung_mask.to(torch.bool)
    flat = fg.reshape(-1)
    if scores is None:
        scores = uniform_scores(flat.numel(), generator, flat.device)
    score = torch.where(flat, scores.reshape(-1).to(flat.device,
                                                    non_blocking=True),
                        -torch.inf)
    if approx_top_k:
        top, idx = approx_max_k(score, max_kpts)
    else:
        top, idx = masked_top_k(score, max_kpts)
    kp = _flat_to_zyx(idx, h, w)
    if not want_features:
        return kp, torch.isfinite(top), None
    grid = kpts_to_grid(kp.flip(-1).to(torch.float32), (d, h, w))
    # all channels in one gather: (C, max_kpts, p, p, p)
    patches = sample_patches_at_kpts(softmax_scores.movedim(-1, 0), grid,
                                     feat_patch)
    feats = patches.reshape(c, max_kpts, -1).transpose(0, 1)
    return kp, torch.isfinite(top), feats.reshape(max_kpts, -1)


def compute_keypoints(img, fissures, mask, kp_mode: str = "foerstner",
                      enhanced_img=None, cnn_softmax=None, lobes=None,
                      case_id: str = "case", sequence: str = "fixed",
                      max_kpts: int = MAX_KPTS, dilate_labels: int = 2,
                      feature_mode: str | None = None, device=None,
                      generator: torch.Generator | None = None,
                      draws: dict | None = None,
                      stages: dict | None = None) -> dict:
    """The keypoint pipeline of one unit-spacing case -> case dict: labels
    dilated per object (radius 2; where objects meet the lowest label
    wins), keypoints in `kp_mode`, labels and lobes read at the keypoints,
    optional features.

    :param img, fissures, mask: (D, H, W) numpy arrays or tensors; numpy
        goes to `device` (the card unless asked for the CPU)
    :param cnn_softmax: (D, H, W, C) for kp_mode="cnn"
    :param feature_mode: 'mind' / 'mind_ssc' / 'image' / 'enhancement':
        per-point features; overrides the cnn mode's softmax patches
    :param generator: draws the random scores (default: a CPU generator
        seeded 0, the JAX package's PRNGKey(0))
    :param draws: injected draws instead: "scores" ((D * H * W,) uniforms:
        foerstner, noisy and cnn) and "noise" ((max_kpts, 3) normals: noisy)
    :param stages: optional dict; the synced seconds of "keypoints" (the
        dilation, the detection, the labels) and "features" are added
    :return: dict with coords (N, 3) grid xyz, labels (N,) int32, shape,
        spacing, case_id, sequence, kp_mode, feature_mode, and lobes (N,)
        and features (N, F) where they exist
    """
    from ..utils.image_ops import multiple_objects_morphology
    from ..utils.profiling import stage
    from .foerstner import foerstner_keypoints
    from .hessian import hessian_fissure_enhancement

    draws = draws or {}
    fiss = as_device_tensor(fissures, device, "compute_keypoints").to(
        torch.int32)
    dev = fiss.device
    shape = tuple(fiss.shape)
    vol = None if img is None else as_device_tensor(
        img, dev, "compute_keypoints").to(torch.float32)
    lung = as_device_tensor(mask, dev, "compute_keypoints").to(torch.bool)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    scores = draws.get("scores")

    def enhancement():
        if enhanced_img is not None:
            return as_device_tensor(enhanced_img, dev, "compute_keypoints")
        if vol is None:
            raise ValueError("enhancement mode needs an image")
        return hessian_fissure_enhancement(vol, fissure_mu=-313.5,
                                           fissure_sigma=62.6)

    feats = None
    with stage(stages, "keypoints", dev):
        if dilate_labels > 0:
            fiss = multiple_objects_morphology(fiss, dilate_labels, "dilate")
        if kp_mode == "foerstner":
            kp, valid, _ = foerstner_keypoints(
                vol, lung, sigma=0.5, d=5, thresh=1e-8, max_kpts=max_kpts,
                generator=generator, scores=scores)
        elif kp_mode == "noisy":
            kp, valid = get_noisy_keypoints(fiss, max_kpts,
                                            generator=generator,
                                            scores=scores,
                                            noise=draws.get("noise"))
        elif kp_mode == "enhancement":
            kp, valid = get_enhancement_keypoints(enhancement(),
                                                  max_kpts=max_kpts)
        elif kp_mode == "cnn":
            if cnn_softmax is None:
                raise ValueError("cnn mode needs precomputed softmax scores")
            kp, valid, feats = get_cnn_keypoints(
                as_device_tensor(cnn_softmax, dev, "compute_keypoints"),
                lung, max_kpts=max_kpts, generator=generator, scores=scores,
                want_features=True)
        else:
            raise ValueError(f'No keypoint-mode named "{kp_mode}".')
        kp = kp[valid]
        if feats is not None:
            feats = feats[valid]
        if kp.shape[0] < 2048:
            print(f"{case_id} {sequence} has less than minimum of 2048 "
                  "kpts!")
        labels = fiss[kp[:, 0], kp[:, 1], kp[:, 2]]
        coords = kpts_to_grid(kp.flip(-1).to(torch.float32), shape)
    if feature_mode is not None:
        from .features import compute_point_features
        if vol is None:
            raise ValueError(f"feature mode '{feature_mode}' needs an image")
        with stage(stages, "features", dev):
            feats = compute_point_features(
                vol, coords, feature_mode,
                enhanced_img=enhancement() if feature_mode == "enhancement"
                else None)

    kp_np = kp.cpu().numpy()
    case = {"coords": coords.cpu().numpy(),
            "labels": labels.cpu().numpy().astype(np.int32),
            "shape": shape, "spacing": (1.0, 1.0, 1.0),
            "case_id": case_id, "sequence": sequence, "kp_mode": kp_mode,
            "feature_mode": feature_mode or
            ("cnn" if kp_mode == "cnn" else None)}
    if lobes is not None:
        lob = np.asarray(lobes.cpu() if isinstance(lobes, torch.Tensor)
                         else lobes)
        case["lobes"] = lob[kp_np[:, 0], kp_np[:, 1],
                            kp_np[:, 2]].astype(np.int32)
    if feats is not None:
        case["features"] = feats.cpu().numpy().astype(np.float32)
    return case
