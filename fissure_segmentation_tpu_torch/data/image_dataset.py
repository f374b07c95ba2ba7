"""NIfTI folder index and the voxel-CNN image dataset (counterpart of
data/image_dataset.py).

NIfTI I/O and random patch cropping happen on the host (numpy: volumes
have their own shapes); the augmentation of a patch batch (elastic
deformation, rotation and scale, mirroring, noise) runs on the patches'
device inside the train step (train/image_trainer.py).

Random streams: `random_patch_crop` draws from a numpy Generator, as the
JAX package's does, so both packages crop the same patches from the same
seed. `augment_image_batch` draws from an explicit `torch.Generator` on the
patches' device, or takes the draws (`draw_augmentation`'s) from the caller:
jax.random cannot be replayed in torch, so the parity tests inject the JAX
package's. `map_coordinates` is jax.scipy.ndimage.map_coordinates with
mode "nearest": order 1 weights the two neighbours by the unclamped
coordinate and clamps the indices, order 0 rounds half away from zero
(`torch.round` rounds half to even).
"""
from __future__ import annotations

import csv
import math
import os
from glob import glob

import numpy as np
import torch

from ..keypoints.features import normalize_img
from ..utils.image_ops import (multiple_objects_morphology, resize,
                               resample_equal_spacing)
from ..utils.nifti import load_nifti
from .augmentation import so3_exp_map
from .dataset import compute_class_weights


class LungDataIndex:
    """Index of a reference-layout image folder.

    For each `{case}_img_{sequence}.nii.gz` records the companion files
    (None when absent): `_fissures_`, `_lobes_`, `_mask_`, `_masklr_`,
    `_fissures_enhanced_`, `_lms_*.csv` landmarks and the
    `{case}_mesh_{sequence}/` fissure/lobe mesh directories.
    """

    def __init__(self, folder: str):
        self.folder = folder
        self.images = sorted(glob(os.path.join(folder, "*_img_*.nii.gz")))
        self.ids, self.fissures, self.lobes, self.lung_masks = [], [], [], []
        self.left_right_masks, self.fissures_enhanced, self.landmarks = [], [], []
        self.fissure_meshes, self.lobe_meshes = [], []
        for img in self.images:
            def _companion(tag, ext=None):
                p = img.replace("_img_", tag)
                if ext is not None:
                    p = p.replace(".nii.gz", ext)
                return p if os.path.exists(p) else None
            self.fissures.append(_companion("_fissures_"))
            self.lobes.append(_companion("_lobes_"))
            self.lung_masks.append(_companion("_mask_"))
            self.left_right_masks.append(_companion("_masklr_"))
            self.fissures_enhanced.append(_companion("_fissures_enhanced_"))
            self.landmarks.append(_companion("_lms_", ".csv"))
            case, _, sequence = os.path.basename(img).split("_")
            sequence = sequence.split(".")[0]
            self.ids.append((case, sequence))
            mesh_dir = os.path.join(folder, f"{case}_mesh_{sequence}")
            fm = sorted(glob(os.path.join(mesh_dir, f"{case}_fissure*_{sequence}.obj")))
            lm = sorted(glob(os.path.join(mesh_dir, f"{case}_lobe*_{sequence}.obj")))
            self.fissure_meshes.append(fm or None)
            self.lobe_meshes.append(lm or None)

    def __len__(self):
        return len(self.images)

    def get_index(self, case: str, sequence: str) -> int:
        return self.ids.index((case, sequence))

    def get_image(self, item: int):
        return load_nifti(self.images[item])

    def _load(self, lst, item):
        return None if lst[item] is None else load_nifti(lst[item])

    def get_fissures(self, item: int):
        return self._load(self.fissures, item)

    def get_lobes(self, item: int):
        return self._load(self.lobes, item)

    def get_lung_mask(self, item: int):
        return self._load(self.lung_masks, item)

    def get_left_right_mask(self, item: int):
        return self._load(self.left_right_masks, item)

    def get_enhanced_fissures(self, item: int):
        return self._load(self.fissures_enhanced, item)

    def get_landmarks(self, item: int):
        if self.landmarks[item] is None:
            return None
        with open(self.landmarks[item]) as fh:
            return np.asarray([[float(v) for v in row]
                               for row in csv.reader(fh)], np.float32)


def random_patch_crop(rng: np.random.Generator, img: np.ndarray,
                      label: np.ndarray, patch_size) -> tuple[np.ndarray, np.ndarray]:
    """Random (host-side) crop of a matching image/label patch; pads with the
    minimum HU / background when the volume is smaller than the patch."""
    ps = np.asarray(patch_size)
    shape = np.asarray(img.shape)
    pad = np.maximum(ps - shape, 0)
    if pad.any():
        pw = [(p // 2, p - p // 2) for p in pad]
        img = np.pad(img, pw, constant_values=float(img.min()))
        label = np.pad(label, pw, constant_values=0)
        shape = np.asarray(img.shape)
    start = np.asarray([rng.integers(0, s - p + 1) for s, p in zip(shape, ps)])
    sl = tuple(slice(st, st + p) for st, p in zip(start, ps))
    return img[sl], label[sl]


def _round_half_away(c: torch.Tensor) -> torch.Tensor:
    """lax.round's rounding: ties away from zero (exact in float32)."""
    fl = torch.floor(c)
    frac = c - fl
    return fl + ((frac > 0.5) | ((frac == 0.5) & (c > 0))).to(c.dtype)


def map_coordinates(vol: torch.Tensor, coords: torch.Tensor,
                    order: int) -> torch.Tensor:
    """jax.scipy.ndimage.map_coordinates(vol[b], coords[b], order,
    mode="nearest") for each b.

    :param vol: (B, D, H, W) float32
    :param coords: (B, ..., 3) float32 zyx index coordinates
    :param order: 1 (linear) or 0 (nearest)
    :return: (B, ...) float32
    """
    b = vol.shape[0]
    sizes = vol.shape[1:]
    flat = vol.reshape(b, -1)
    pts = coords.reshape(b, -1, 3)
    if order == 0:
        nodes = [[(_round_half_away(pts[..., a]).to(torch.int64), None)]
                 for a in range(3)]
    elif order == 1:
        nodes = []
        for a in range(3):
            lower = torch.floor(pts[..., a])
            upper_w = pts[..., a] - lower
            idx = lower.to(torch.int64)
            nodes.append([(idx, 1 - upper_w), (idx + 1, upper_w)])
    else:
        raise ValueError(f"map_coordinates: order {order} (0 or 1 only)")
    out = None
    # JAX's order: the product over the corners, dimension 0 outermost;
    # weights multiplied left to right, contributions summed left to right
    for iz, wz in nodes[0]:
        for iy, wy in nodes[1]:
            for ix, wx in nodes[2]:
                lin = ((iz.clamp(0, sizes[0] - 1) * sizes[1]
                        + iy.clamp(0, sizes[1] - 1)) * sizes[2]
                       + ix.clamp(0, sizes[2] - 1))
                val = torch.gather(flat, 1, lin)
                if wz is not None:
                    val = wz * wy * wx * val
                out = val if out is None else out + val
    return out.reshape(coords.shape[:-1])


_ELASTIC_SIGMA = 12.0  # voxels; midpoint of batchgenerators' default sigma=(10., 13.)


def elastic_grid(patch_shape) -> tuple:
    """The coarse control grid of the elastic field (spacing ~sigma)."""
    return tuple(max(2, round(s / _ELASTIC_SIGMA) + 1) for s in patch_shape)


def elastic_displacement_field(noise: torch.Tensor, patch_shape,
                               alpha: torch.Tensor) -> torch.Tensor:
    """Random smooth displacement fields (B, D, H, W, 3) in voxels: the
    standard normal control points `noise` (B, 3, *elastic_grid) scaled to
    the std batchgenerators' SpatialTransform gives with `alpha` (B,), and
    upsampled linearly (jax.image.resize's weights, image_ops.resize)."""
    target_std = alpha * math.sqrt(1.0 / 3.0) \
        * (2.0 * _ELASTIC_SIGMA * math.sqrt(math.pi)) ** -1.5
    # trilinear interpolation of unit i.i.d. noise keeps on average
    # (E[t^2+(1-t)^2])^3 = (2/3)^3 of the variance between control points
    ctrl_std = target_std / (2.0 / 3.0) ** 1.5
    field = resize(noise * ctrl_std[:, None, None, None, None],
                   tuple(patch_shape), "linear")
    return torch.movedim(field, 1, -1)


def _warp_coords(draws: dict, patch_shape, rotation_amount: float = 0.26,
                 scale_amount: float = 0.15, elastic_alpha=None):
    """Random (elastic+)rotation+scale index-coordinate fields (B, D, H, W,
    3), zyx around the patch centre, from the batch's draws; the elastic
    offsets are added to the centred mesh first, then rotated and scaled
    (batchgenerators' augment_spatial order)."""
    dev = draws["rot_axis"].device
    v = draws["rot_axis"] * 2 - 1
    axis = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-8)
    angle = (draws["rot_angle"] * 2 - 1) * rotation_amount
    rot = so3_exp_map(axis * angle[:, None])
    scale = 1.0 + (draws["scale"] * 2 - 1) * scale_amount
    d, h, w = patch_shape
    zz, yy, xx = torch.meshgrid(torch.arange(d, device=dev),
                                torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
    center = torch.tensor([(d - 1) / 2, (h - 1) / 2, (w - 1) / 2],
                          dtype=torch.float32, device=dev)
    pts = torch.stack([zz, yy, xx], -1).to(torch.float32) - center
    pts = pts.expand(v.shape[0], d, h, w, 3)
    if elastic_alpha is not None:
        pts = pts + elastic_displacement_field(draws["elastic"], patch_shape,
                                               elastic_alpha)
    warped = torch.bmm(pts.reshape(v.shape[0], -1, 3), rot) \
        * scale[:, None, None] + center
    return warped.reshape(v.shape[0], d, h, w, 3)


def draw_augmentation(generator: torch.Generator | None, shape,
                      device=None) -> dict:
    """The draws of `augment_image_batch` for patches of `shape` (B, D, H,
    W) from `generator` on `device`: uniforms in [0, 1) "alpha", "gate",
    "rot_angle", "scale" (B,), "rot_axis", "flip" (B, 3); standard normals
    "elastic" (B, 3, *elastic_grid((D, H, W))) and "noise" (B, D, H, W)."""
    b = shape[0]

    def u(*s):
        return torch.rand(s, generator=generator, device=device)

    def n(*s):
        return torch.randn(s, generator=generator, device=device)
    return {"alpha": u(b), "gate": u(b), "rot_axis": u(b, 3),
            "rot_angle": u(b), "scale": u(b),
            "elastic": n(b, 3, *elastic_grid(shape[1:])),
            "flip": u(b, 3), "noise": n(*shape)}


def augment_image_batch(generator: torch.Generator | None,
                        imgs: torch.Tensor, labels: torch.Tensor,
                        mirror_axes=(0, 1, 2), p_rotscale: float = 0.4,
                        noise_std: float = 0.02,
                        elastic_alpha: tuple | None = (0.0, 1000.0),
                        draws: dict | None = None):
    """Spatial and intensity augmentation of an image/label patch batch (B,
    D, H, W) on its device: batchgenerators' SpatialTransform (elastic +
    rotation + scale; labels warped order 0, the image order 1, the whole
    warp gated per sample with `p_rotscale`), mirroring consistent between
    image and label, and Gaussian noise.

    :param elastic_alpha: per-sample deformation magnitude drawn U(lo, hi);
        None disables elastic deformation
    :param draws: `draw_augmentation`'s draws to use instead of drawing
        from `generator`
    """
    if draws is None:
        draws = draw_augmentation(generator, imgs.shape, imgs.device)
    if elastic_alpha is not None:
        lo, hi = elastic_alpha
        alphas = torch.clamp(draws["alpha"] * (hi - lo) + lo, min=lo)
    coords = _warp_coords(draws, imgs.shape[1:],
                          elastic_alpha=alphas if elastic_alpha is not None
                          else None)
    gates = (draws["gate"] < p_rotscale)[:, None, None, None]
    img_w = map_coordinates(imgs, coords, 1)
    lbl_w = map_coordinates(labels.to(torch.float32), coords, 0)
    imgs = torch.where(gates, img_w, imgs)
    labels = torch.where(gates, lbl_w.to(labels.dtype), labels)
    flips = draws["flip"] < 0.5
    for ax in mirror_axes:
        f = flips[:, ax, None, None, None]
        imgs = torch.where(f, torch.flip(imgs, (ax + 1,)), imgs)
        labels = torch.where(f, torch.flip(labels, (ax + 1,)), labels)
    return imgs + draws["noise"] * noise_std, labels


class ImageDataset:
    """Voxel-CNN dataset: preprocessed full volumes and random patch
    batches.

    Volumes are resampled to `resample_spacing` (on the CPU), fissure
    labels dilated to survive downsampling, intensities normalized to
    [-1, 1]. `sample_batch` crops random patches on the host and augments
    them on `device`.
    """

    def __init__(self, images: list[np.ndarray], labels: list[np.ndarray],
                 ids: list, spacings: list | None = None,
                 resample_spacing: float = 1.5, patch_size=(128, 128, 128),
                 exclude_rhf: bool = False, binary: bool = False,
                 do_augmentation: bool = True, preprocessed: bool = False):
        assert len(images) == len(labels) == len(ids)
        self.patch_size = tuple(patch_size)
        self.resample_spacing = resample_spacing
        self.exclude_rhf = exclude_rhf
        self.binary = binary
        self.do_augmentation = do_augmentation
        self.ids = list(ids)
        self.images, self.labels = [], []
        spacings = spacings or [(1.0, 1.0, 1.0)] * len(images)
        for img, lbl, sp in zip(images, labels, spacings):
            if not preprocessed:
                img, lbl = self._preprocess(img, lbl, sp)
            self.images.append(np.asarray(img, np.float32))
            self.labels.append(np.asarray(lbl, np.int32))

    def _preprocess(self, img: np.ndarray, lbl: np.ndarray, spacing):
        """Remap labels, dilate them by the radius that compensates the
        downsampling factor, resample both, normalize the image."""
        lbl = np.asarray(lbl, np.int32)
        if self.binary:
            lbl = (lbl != 0).astype(np.int32)
        elif self.exclude_rhf:
            lbl = np.where(lbl == 3, 0, lbl)
        factors = [sp / self.resample_spacing for sp in spacing]
        radius = max(0, round(1 / min(factors) - 1))
        lblt = torch.from_numpy(lbl)
        if radius > 0:
            lblt = multiple_objects_morphology(lblt, radius=radius,
                                               mode="dilate")
        imgt = resample_equal_spacing(
            torch.from_numpy(np.asarray(img, np.float32)), tuple(spacing),
            self.resample_spacing)
        lblt = resample_equal_spacing(lblt, tuple(spacing),
                                      self.resample_spacing,
                                      use_nearest_neighbor=True)
        return normalize_img(imgt).numpy(), lblt.numpy()

    @classmethod
    def from_folder(cls, folder: str, copd: bool = False, **kwargs) -> "ImageDataset":
        index = LungDataIndex(folder)
        images, labels, ids, spacings = [], [], [], []
        for i in range(len(index)):
            if index.fissures[i] is None:
                continue
            if copd and "COPD" not in index.ids[i][0]:
                continue
            img = index.get_image(i)
            fis = index.get_fissures(i)
            images.append(img.array)
            labels.append(fis.array)
            spacings.append(img.spacing)
            ids.append(index.ids[i])
        return cls(images, labels, ids, spacings, **kwargs)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i: int):
        return self.images[i], self.labels[i]

    @property
    def num_classes(self) -> int:
        if self.binary:
            return 2
        return int(max(lbl.max() for lbl in self.labels)) + 1

    def get_class_weights(self) -> np.ndarray:
        freq = np.zeros(self.num_classes)
        for lbl in self.labels:
            freq += np.bincount(lbl.ravel(), minlength=self.num_classes)[:self.num_classes]
        return compute_class_weights(freq)

    def crop_batch(self, rng_np: np.random.Generator, indices, device=None):
        """Random patches of the cases `indices`, cropped on the host in
        order: (B, D, H, W) float32 images and int32 labels on `device`."""
        imgs, lbls = zip(*(random_patch_crop(rng_np, self.images[i],
                                             self.labels[i], self.patch_size)
                           for i in indices))
        return (torch.from_numpy(np.stack(imgs)).to(device),
                torch.from_numpy(np.stack(lbls)).to(device))

    def sample_batch(self, rng_np: np.random.Generator,
                     generator: torch.Generator | None, indices,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, D, H, W) float32 patches and int32 label patches, augmented
        on `device` with `generator` where the dataset augments."""
        imgs, lbls = self.crop_batch(rng_np, indices, device)
        if self.do_augmentation:
            imgs, lbls = augment_image_batch(generator, imgs, lbls)
        return imgs, lbls

    def split_data_set(self, split: dict):
        def _subset(idset, aug):
            sel = [i for i, cid in enumerate(self.ids)
                   if list(cid) in idset or cid[0] in idset]
            return ImageDataset([self.images[i] for i in sel],
                                [self.labels[i] for i in sel],
                                [self.ids[i] for i in sel],
                                resample_spacing=self.resample_spacing,
                                patch_size=self.patch_size,
                                binary=self.binary, do_augmentation=aug,
                                preprocessed=True)

        def norm(xs):
            return [list(x) if isinstance(x, (list, tuple)) else x
                    for x in xs]
        return (_subset(norm(split["train"]), self.do_augmentation),
                _subset(norm(split["val"]), False))
