"""Dense deformable image registration by Adam instance optimization
(counterpart of shape_model/adam_registration.py).

MIND-SSC and one-hot label features at half resolution, a dense
low-resolution displacement field optimized by Adam with diffusion
regularization and triple 3x3x3 box smoothing, then trilinear upsampling
and smoothing to full resolution. As in the JAX package, the field starts
at zero (or an explicit warm start) and coordinates follow
align_corners=False (delta_norm = delta_vox * 2 / size) throughout.

The Adam loop runs on the features' device and keeps its losses there
(`torch.optim.Adam`: optax's adam, epsilon outside the square root, the
same bias corrections); `jax.image.resize(..., "trilinear")` is
`F.interpolate(mode="trilinear", align_corners=False)` for upsampling.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..keypoints.features import mind
from ..utils.profiling import stage
from ..utils.sampling import grid_sample_volume

GRID_SP = 2  # low-res optimization grid spacing


def _box_smooth3(disp: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """`passes` consecutive 3x3x3 mean filters over the spatial dims of a
    (d, h, w, 3) field: avg_pool3d(k=3, stride=1, padding=1),
    count_include_pad=True."""
    x = disp.permute(3, 0, 1, 2)
    for _ in range(passes):
        x = F.avg_pool3d(x, 3, stride=1, padding=1, count_include_pad=True)
    return x.permute(1, 2, 3, 0)


def _identity_grid_xyz(dhw, device=None) -> torch.Tensor:
    """(d, h, w, 3) xyz normalized [-1,1] coords, align_corners=False."""
    d, h, w = dhw
    zz, yy, xx = torch.meshgrid(torch.arange(d, device=device),
                                torch.arange(h, device=device),
                                torch.arange(w, device=device),
                                indexing="ij")
    size_zyx = torch.tensor([d, h, w], dtype=torch.float32, device=device)
    norm = (torch.stack([zz, yy, xx], -1) + 0.5) * 2.0 / size_zyx - 1.0
    return norm.flip(-1).to(torch.float32)  # zyx -> xyz


def downsample_mean(vol: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool the trailing 3 dims by `factor` (stride = kernel,
    floor-cropped)."""
    lead = vol.shape[:-3]
    x = vol.reshape(-1, *vol.shape[-3:])
    x = F.avg_pool3d(x, factor, stride=factor)
    return x.reshape(*lead, *x.shape[-3:])


def registration_features(img_hu: torch.Tensor, lung_mask=None,
                          fissures=None, lobes=None, n_labels: int = 16,
                          grid_sp: int = GRID_SP) -> torch.Tensor:
    """The (C, d, h, w) feature volume the cost is computed on: masked
    MIND-SSC (12 channels, mean-pooled) and a one-hot of the combined
    lobes/fissures labels (nearest-downsampled). Odd volume dims are
    floor-cropped to a multiple of `grid_sp` so both groups downsample to
    one shape.

    :param img_hu: (D, H, W) CT in Hounsfield units
    :param n_labels: one-hot width for `combined = lobes + fissures +
        max(lobes)` (13 for 5 lobes and 3 fissures); labels at or above it
        get an all-zero vector, as jax.nn.one_hot gives them
    """
    m = mind(img_hu, ssc=True)                       # (12, D, H, W)
    if lung_mask is not None:
        m = m * lung_mask[None].to(m.dtype)
    feats = [downsample_mean(m, grid_sp)]
    del m
    if lobes is not None or fissures is not None:
        lob = torch.zeros_like(img_hu, dtype=torch.int32) if lobes is None \
            else lobes.to(torch.int32)
        if fissures is not None:
            fis = fissures.to(torch.int32)
            combined = lob + torch.where(fis != 0, fis + lob.max(), 0)
        else:
            combined = lob
        # strided nearest-downsample, floor-cropped like the VALID
        # mean-pool of the MIND branch on odd dims, then the one-hot
        dm, hm, wm = (s // grid_sp for s in combined.shape)
        sub = combined[:dm * grid_sp:grid_sp, :hm * grid_sp:grid_sp,
                       :wm * grid_sp:grid_sp]
        labels = torch.arange(n_labels, device=sub.device,
                              dtype=sub.dtype)[:, None, None, None]
        feats.append((sub[None] == labels).to(torch.float32))
    return torch.cat(feats, dim=0).to(torch.float32)


def _loss_fn(disp, feat_fix, feat_mov, id_xyz, lambda_weight):
    disp_s = _box_smooth3(disp)
    # disp is in low-res voxels; lambda_weight = 0.65 is the production
    # value for voxel-unit fields (the penalty stays in voxel units, only
    # the sampling grid is normalized)
    reg = sum(torch.mean(torch.square(torch.diff(disp_s, dim=a)))
              for a in range(3)) * lambda_weight
    size_zyx = torch.tensor(disp.shape[:3], dtype=torch.float32,
                            device=disp.device)
    delta_xyz = (disp_s * 2.0 / size_zyx).flip(-1)
    sampled = grid_sample_volume(feat_mov, id_xyz + delta_xyz,
                                 mode="bilinear", padding_mode="zeros")
    cost = torch.mean(torch.square(sampled - feat_fix), dim=0) * 12.0
    return torch.mean(cost) + reg


def dense_adam_registration(feat_fix: torch.Tensor, feat_mov: torch.Tensor,
                            iters: int = 50, lambda_weight: float = 0.65,
                            lr: float = 1.0, init_disp=None):
    """Optimize a (d, h, w, 3) zyx low-res-voxel displacement field so that
    `feat_mov` sampled at (identity + disp) matches `feat_fix` (Adam, lr 1,
    50 iterations, diffusion regularization, triple box smoothing inside
    the loss).

    :param feat_fix/feat_mov: (C, d, h, w) feature volumes
    :return: (disp, losses): the final smoothed displacement field and the
        (iters,) losses, on the features' device
    """
    dhw = tuple(feat_fix.shape[1:])
    dev = feat_fix.device
    id_xyz = _identity_grid_xyz(dhw, dev)
    disp = (torch.zeros((*dhw, 3), device=dev) if init_disp is None
            else init_disp.detach().to(device=dev, dtype=torch.float32)
            .clone()).requires_grad_(True)
    opt = torch.optim.Adam([disp], lr=lr)
    losses = []
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        loss = _loss_fn(disp, feat_fix, feat_mov, id_xyz, lambda_weight)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        out = _box_smooth3(disp)
    return out, (torch.stack(losses) if losses
                 else torch.zeros((0,), device=dev))


def upsample_displacement(disp_lo: torch.Tensor, out_shape,
                          grid_sp: int = GRID_SP) -> torch.Tensor:
    """Low-res zyx-voxel displacement -> full-res normalized xyz
    displacement: trilinear upsample of disp * grid_sp, then triple box
    smoothing."""
    x = (disp_lo * grid_sp).permute(3, 0, 1, 2)[None]
    hr = F.interpolate(x, size=tuple(out_shape), mode="trilinear",
                       align_corners=False)[0].permute(1, 2, 3, 0)
    hr = _box_smooth3(hr)
    size_zyx = torch.tensor(tuple(out_shape), dtype=torch.float32,
                            device=hr.device)
    return (hr * 2.0 / size_zyx).flip(-1)


def warp_volume(vol: torch.Tensor, disp_norm: torch.Tensor,
                mode: str = "bilinear") -> torch.Tensor:
    """Sample `vol` ((D,H,W) or (C,D,H,W)) at identity + normalized-xyz
    displacement, border padding."""
    id_xyz = _identity_grid_xyz(tuple(vol.shape[-3:]), vol.device)
    return grid_sample_volume(vol, id_xyz + disp_norm, mode=mode,
                              padding_mode="border")


def landmark_tre_mm(lm_fix: torch.Tensor, lm_mov: torch.Tensor,
                    disp_norm: torch.Tensor, spacing_mm) -> tuple:
    """Target registration error in mm before and after applying the
    field, which is sampled at the fixed-image landmarks.

    :param lm_fix/lm_mov: (N, 3) normalized xyz landmark coords
    :param disp_norm: (D, H, W, 3) normalized xyz displacement
    :param spacing_mm: per-axis xyz voxel spacing in mm
    :return: (tre_before, tre_after), (N,) distances in mm
    """
    dev = disp_norm.device
    shape_xyz = torch.tensor(tuple(disp_norm.shape[:3])[::-1],
                             dtype=torch.float32, device=dev)
    half_mm = shape_xyz / 2.0 * torch.as_tensor(
        [float(s) for s in spacing_mm], dtype=torch.float32, device=dev)
    d = grid_sample_volume(torch.movedim(disp_norm, -1, 0), lm_fix,
                           mode="bilinear").T          # (N, 3) xyz
    before = torch.sqrt(torch.sum(torch.square((lm_fix - lm_mov) * half_mm),
                                  -1))
    after = torch.sqrt(torch.sum(torch.square(
        (lm_fix + d - lm_mov) * half_mm), -1))
    return before, after


def register_images(img_fix_hu: torch.Tensor, img_mov_hu: torch.Tensor,
                    mask_fix=None, mask_mov=None, fissures_fix=None,
                    fissures_mov=None, lobes_fix=None, lobes_mov=None,
                    iters: int = 50, lambda_weight: float = 0.65,
                    lr: float = 1.0, grid_sp: int = GRID_SP,
                    stages: dict | None = None):
    """End-to-end pair registration on the images' device.

    :param stages: optional dict; the synced seconds of the stages
        "features", "adam", "upsample" and "warp" are added to it
    :return: dict with 'disp' (full-res normalized xyz displacement),
        'disp_lo' (low-res zyx voxel field), 'losses', 'warped' (moving
        image resampled into fixed space)
    """
    dev = img_fix_hu.device
    with stage(stages, "features", dev):
        feat_fix = registration_features(img_fix_hu, mask_fix, fissures_fix,
                                         lobes_fix, grid_sp=grid_sp)
        feat_mov = registration_features(img_mov_hu, mask_mov, fissures_mov,
                                         lobes_mov, grid_sp=grid_sp)
    with stage(stages, "adam", dev):
        disp_lo, losses = dense_adam_registration(
            feat_fix, feat_mov, iters=iters, lambda_weight=lambda_weight,
            lr=lr)
    del feat_fix, feat_mov
    with stage(stages, "upsample", dev):
        disp = upsample_displacement(disp_lo, tuple(img_fix_hu.shape),
                                     grid_sp)
    with stage(stages, "warp", dev):
        warped = warp_volume(img_mov_hu, disp)
    return {"disp": disp, "disp_lo": disp_lo, "losses": losses,
            "warped": warped}
