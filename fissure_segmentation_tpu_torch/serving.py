"""One-call CT-case inference: keypoints -> ensemble segmentation -> fissure
meshes (counterpart of serving.py:CaseResult and segment_case).

Device half, on a CUDA card (`case_device`: the input's, or `device=`; the
CPU only when `device="cpu"` is passed): keypoints in one of three modes —
Förstner, Hessian enhancement, or the pre-segmentation CNN (its
whole-volume forward on the CT, or a given softmax volume) — then the
50 x 2048-point subset ensemble of the point model, then per-class
masked-normal spectral PSR and marching tetrahedra. Host half: one fetch of
keypoints, labels, inside grids and float triangles, then the native C++
component filter per class and the labelmap.

Not ported yet: `approx_top_k`, a bfloat16 CNN (`cnn_dtype`), the packed
transfer encodings and the pipelined `segment_cases`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .keypoints.extraction import get_cnn_keypoints, get_enhancement_keypoints
from .keypoints.foerstner import foerstner_keypoints
from .keypoints.hessian import hessian_fissure_enhancement
from .models.ensemble import ensemble_predict
from .models.seg_cnn import predict_full_volume
from .postprocess.surface_fitting import (_host_mesh_filter, batched_psr_mc,
                                          mesh_to_labelmap)
from .utils.coords import kpts_to_grid


@dataclass
class CaseResult:
    """Host-side result of one segmented CT case."""
    kpts: np.ndarray          # (n_valid, 3) int zyx voxel indices
    labels: np.ndarray        # (n_valid,) predicted class per keypoint
    meshes: list              # per foreground class: (tris (T,3,3) world xyz, valid (T,))
    labelmap: np.ndarray | None   # (D, H, W) uint8, if requested


def case_device(vol, device=None) -> torch.device:
    """Where segment_case's device half runs: `device` if given, else
    `vol`'s card if `vol` is a CUDA tensor, else the first CUDA card. It is
    the CPU only when the caller asks for it; without a card it raises."""
    if device is not None:
        return torch.device(device)
    if isinstance(vol, torch.Tensor) and vol.is_cuda:
        return vol.device
    if not torch.cuda.is_available():
        raise RuntimeError("segment_case: no CUDA card found; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda")


def _keypoints(vol, mask, generator, *, kp_mode, max_kpts, fissure_mu,
               fissure_sigma, cnn_model, cnn_dtype, kp_scores):
    """(kpts (max_kpts, 3) int32 zyx, valid, case shape) in `kp_mode`."""
    if kp_mode == "foerstner":
        kpts, valid, _ = foerstner_keypoints(vol, mask, sigma=0.5, d=5,
                                             thresh=1e-8, max_kpts=max_kpts)
        return kpts, valid, tuple(vol.shape)
    if kp_mode == "enhancement":
        enh = hessian_fissure_enhancement(vol, fissure_mu=fissure_mu,
                                          fissure_sigma=fissure_sigma)
        kpts, valid = get_enhancement_keypoints(enh, max_kpts=max_kpts)
        return kpts, valid, tuple(vol.shape)
    if kp_mode == "cnn":
        if cnn_model is not None:
            if cnn_dtype not in (None, torch.float32):
                raise NotImplementedError(
                    f"serving: CNN compute dtype {cnn_dtype} is not ported "
                    "yet (float32 only)")
            soft = predict_full_volume(cnn_model, vol, dtype=cnn_dtype)
        else:
            soft = vol
        kpts, valid, _ = get_cnn_keypoints(soft, mask, max_kpts=max_kpts,
                                           generator=generator,
                                           scores=kp_scores)
        return kpts, valid, tuple(soft.shape[:-1])
    raise ValueError(f'serving does not support kp_mode "{kp_mode}"')


@torch.no_grad()
def _device_case(vol, mask, model, generator, subsets, *, max_kpts,
                 sample_points, n_runs_min, subset_batch, grid_res, sig,
                 k_normals, max_tris, num_fg_classes, class_cap, **kp_kw):
    kpts, valid, shape = _keypoints(vol, mask, generator, max_kpts=max_kpts,
                                    **kp_kw)
    world = kpts.flip(-1).to(torch.float32)           # zyx -> xyz voxel
    coords = torch.where(valid[:, None], kpts_to_grid(world, shape), -1.0)
    probs = ensemble_predict(model, coords, sample_points=sample_points,
                             n_runs_min=n_runs_min, subset_batch=subset_batch,
                             generator=generator, subsets=subsets)
    pred = probs.argmax(-1)
    class_valid = torch.stack([valid & (pred == c)
                               for c in range(1, num_fg_classes + 1)])
    inside, tris, n_tris = batched_psr_mc(
        coords.flip(-1), class_valid, grid_res, sig, k_normals, max_tris,
        class_cap)
    return (kpts, valid, pred, inside, tris, n_tris), shape


def segment_case(vol, mask, model: Callable[[torch.Tensor], torch.Tensor],
                 generator: torch.Generator | None = None, *,
                 subsets: torch.Tensor | None = None, device=None,
                 kp_mode: str = "foerstner", max_kpts: int = 20000,
                 sample_points: int = 2048, n_runs_min: int = 50,
                 subset_batch: int = 5, grid_res=(64, 64, 64),
                 sig: float = 4.0, k_normals: int = 30,
                 max_tris: int = 24000, num_fg_classes: int = 3,
                 rights=None, center_x: float | None = None,
                 lung_mask_filter: np.ndarray | None = None,
                 mask_dilate_radius: int = 1, crop_to_bbox: bool = True,
                 make_labelmap: bool = True, approx_top_k: bool = False,
                 class_cap: int = 8192, fissure_mu: float = -313.5,
                 fissure_sigma: float = 62.6, cnn_model=None, cnn_dtype=None,
                 kp_scores: torch.Tensor | None = None) -> CaseResult:
    """Segment one CT case end to end.

    :param vol: (D, H, W) CT volume at unit spacing (array or tensor) — or,
        for ``kp_mode="cnn"`` without `cnn_model`, the (D, H, W, C) softmax
        volume of the pre-segmentation CNN (models.seg_cnn)
    :param mask: (D, H, W) bool lung mask (keypoint restriction)
    :param model: point-segmentation model in eval mode,
        (B, S, 3) grid coords -> (B, S, num_classes) logits
    :param generator: draws the ensemble subsets (models/ensemble.py)
    :param subsets: optional (R, sample_points) subset indices to use
        instead of a draw
    :param device: where the device half runs (default: `vol`'s card if
        it is a CUDA tensor, else the first CUDA card; "cpu" only when
        asked for — without a card and without `device` it raises)
    :param kp_mode: "foerstner", "enhancement" (Hessian plateness with the
        intensity weighting `fissure_mu`/`fissure_sigma`, in the image's
        units) or "cnn" (a uniform random subset of the CNN's foreground
        voxels inside `mask`)
    :param cnn_model: for ``kp_mode="cnn"``: the pre-segmentation CNN in
        eval mode on the case's device (models.MobileNetASPP); its
        whole-volume forward runs on `vol` inside the device half
    :param cnn_dtype: the CNN's compute dtype; float32 (None) only
    :param kp_scores: for ``kp_mode="cnn"``: (D * H * W,) uniform draws
        for the random keypoint subset instead of a draw from `generator`
        (tests inject the JAX package's draw)
    :param rights: per-fg-class right-lung flags for component selection
        (default [False, True, True][:num_fg_classes])
    :param center_x: left/right split plane in voxels
    :param lung_mask_filter: optional mask restricting the fitted meshes
    :param class_cap: per-class point budget of the surface fit (exact as
        long as no class holds more keypoints)
    :return: CaseResult with keypoints, labels, per-class meshes (world xyz)
        and optionally the labelmap
    """
    if approx_top_k:
        raise NotImplementedError("approx_top_k is not ported yet")
    device = case_device(vol, device)
    vol_t = torch.as_tensor(vol, dtype=torch.float32, device=device)
    mask_t = torch.as_tensor(mask, dtype=torch.bool, device=device)
    grid_res = tuple(grid_res)
    out, shape = _device_case(
        vol_t, mask_t, model, generator, subsets, max_kpts=max_kpts,
        sample_points=sample_points, n_runs_min=n_runs_min,
        subset_batch=subset_batch, grid_res=grid_res, sig=sig,
        k_normals=k_normals, max_tris=max_tris,
        num_fg_classes=num_fg_classes, class_cap=class_cap, kp_mode=kp_mode,
        fissure_mu=fissure_mu, fissure_sigma=fissure_sigma,
        cnn_model=cnn_model, cnn_dtype=cnn_dtype, kp_scores=kp_scores)
    kpts, valid, pred, inside, tris, n_tris = (t.cpu().numpy() for t in out)

    if rights is None:
        rights = ([False, True, True]
                  + [None] * num_fg_classes)[:num_fg_classes]
    world = kpts[:, ::-1].astype(np.float32)
    meshes = []
    for i in range(num_fg_classes):
        pts_c = world[valid & (pred == i + 1)]
        n = int(n_tris[i])
        if len(pts_c) < 4 or n == 0:
            meshes.append((np.zeros((0, 3, 3), np.float32),
                           np.zeros(0, bool)))
            continue
        meshes.append(_host_mesh_filter(
            inside[i], tris[i, :n], np.ones(n, bool), pts_c, shape, grid_res,
            lung_mask_filter, mask_dilate_radius, rights[i], center_x,
            crop_to_bbox))

    labelmap = mesh_to_labelmap(meshes, shape) if make_labelmap else None
    return CaseResult(kpts=kpts[valid].astype(np.int32),
                      labels=pred[valid].astype(np.int32),
                      meshes=meshes, labelmap=labelmap)
