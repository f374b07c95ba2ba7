"""One-call CT-case inference: keypoints -> ensemble segmentation -> fissure
meshes (counterpart of serving.py:CaseResult and segment_case, Förstner
mode).

Device half, on the device of the input (or `device=`): Förstner keypoints,
the 50 x 2048-point subset ensemble of the point model, then per-class
masked-normal spectral PSR and marching tetrahedra. Host half: one fetch of
keypoints, labels, inside grids and float triangles, then the native C++
component filter per class and the labelmap.

Not ported yet: the enhancement and cnn keypoint modes, `approx_top_k`, the
packed transfer encodings and the pipelined `segment_cases`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .keypoints.foerstner import foerstner_keypoints
from .models.ensemble import ensemble_predict
from .postprocess.surface_fitting import (_host_mesh_filter, batched_psr_mc,
                                          mesh_to_labelmap)


@dataclass
class CaseResult:
    """Host-side result of one segmented CT case."""
    kpts: np.ndarray          # (n_valid, 3) int zyx voxel indices
    labels: np.ndarray        # (n_valid,) predicted class per keypoint
    meshes: list              # per foreground class: (tris (T,3,3) world xyz, valid (T,))
    labelmap: np.ndarray | None   # (D, H, W) uint8, if requested


def kpts_to_grid(world_xyz: torch.Tensor, shape) -> torch.Tensor:
    """utils/coords.py:kpts_to_grid on a tensor (align_corners=False):
    the same float32 operations in the same order."""
    d, h, w = shape
    size = np.array([w, h, d], np.float32)
    s1 = torch.from_numpy(size - 1).to(world_xyz.device)
    ratio = torch.from_numpy((size - 1) / size).to(world_xyz.device)
    return (world_xyz / s1 * 2 - 1) * ratio


@torch.no_grad()
def _device_case(vol, mask, model, generator, subsets, *, max_kpts,
                 sample_points, n_runs_min, subset_batch, grid_res, sig,
                 k_normals, max_tris, num_fg_classes, class_cap):
    kpts, valid, _ = foerstner_keypoints(vol, mask, sigma=0.5, d=5,
                                         thresh=1e-8, max_kpts=max_kpts)
    world = kpts.flip(-1).to(torch.float32)           # zyx -> xyz voxel
    coords = torch.where(valid[:, None], kpts_to_grid(world, vol.shape), -1.0)
    probs = ensemble_predict(model, coords, sample_points=sample_points,
                             n_runs_min=n_runs_min, subset_batch=subset_batch,
                             generator=generator, subsets=subsets)
    pred = probs.argmax(-1)
    class_valid = torch.stack([valid & (pred == c)
                               for c in range(1, num_fg_classes + 1)])
    inside, tris, n_tris = batched_psr_mc(
        coords.flip(-1), class_valid, grid_res, sig, k_normals, max_tris,
        class_cap)
    return kpts, valid, pred, inside, tris, n_tris


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
                 class_cap: int = 8192) -> CaseResult:
    """Segment one CT case end to end.

    :param vol: (D, H, W) CT volume at unit spacing (array or tensor)
    :param mask: (D, H, W) bool lung mask (keypoint restriction)
    :param model: point-segmentation model in eval mode,
        (B, S, 3) grid coords -> (B, S, num_classes) logits
    :param generator: draws the ensemble subsets (models/ensemble.py)
    :param subsets: optional (R, sample_points) subset indices to use
        instead of a draw
    :param device: where the device half runs (default: `vol`'s device)
    :param rights: per-fg-class right-lung flags for component selection
        (default [False, True, True][:num_fg_classes])
    :param center_x: left/right split plane in voxels
    :param lung_mask_filter: optional mask restricting the fitted meshes
    :param class_cap: per-class point budget of the surface fit (exact as
        long as no class holds more keypoints)
    :return: CaseResult with keypoints, labels, per-class meshes (world xyz)
        and optionally the labelmap
    """
    if kp_mode != "foerstner":
        raise NotImplementedError(f'kp_mode "{kp_mode}" is not ported yet')
    if approx_top_k:
        raise NotImplementedError("approx_top_k is not ported yet")
    if device is None:
        device = vol.device if isinstance(vol, torch.Tensor) else "cpu"
    vol_t = torch.as_tensor(vol, dtype=torch.float32, device=device)
    mask_t = torch.as_tensor(mask, dtype=torch.bool, device=device)
    grid_res = tuple(grid_res)
    out = _device_case(vol_t, mask_t, model, generator, subsets,
                       max_kpts=max_kpts, sample_points=sample_points,
                       n_runs_min=n_runs_min, subset_batch=subset_batch,
                       grid_res=grid_res, sig=sig, k_normals=k_normals,
                       max_tris=max_tris, num_fg_classes=num_fg_classes,
                       class_cap=class_cap)
    kpts, valid, pred, inside, tris, n_tris = (t.cpu().numpy() for t in out)

    shape = tuple(vol_t.shape)
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
