"""Label-space preprocessing: lobes <-> fissures, lung masks, GT meshes
(counterpart of preprocess/labels.py).

  `find_fissures` — fissures as the overlap of cross-dilated lobe one-hot
      channels;
  `generate_lung_mask`, `binary_lung_mask_to_left_right` (the `mask_lr`
      of the point pipeline's image files);
  `find_lobes` — fissures -> lobes by morphology, connected components,
      anatomical relabelling and the random-walk fill;
  `label_to_mesh` — a labelled object's surface by marching tetrahedra on
      a smoothed indicator.

Morphology, the one-hot dilations, the smoothing and marching run on the
device of the input tensor (numpy inputs go to `device`: the card unless
the caller asks for the CPU). Connected components and the centroid sort
run on the host (scipy and the native runtime), as in the JAX package.

One repair against the JAX package: `fissures_between_lobes` reads a lobe
channel only where the labelmap has it. JAX indexes the dilated channels
3, 4 and 5 whatever the number of lobes, and its static out-of-range
index clamps to the last channel, so a labelmap with 2 or 3 lobes gets a
left oblique fissure over its whole last lobe (ROADMAP Queue 3, F13). With
4 or 5 lobes both give the same labels.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import as_device_tensor, resolve_device
from ..utils.filters import filter_1d, max_pool_same, smooth
from ..utils.profiling import stage


def one_hot_channels(labels: torch.Tensor, n: int) -> torch.Tensor:
    """(n, *labels.shape) float32 one-hot, channel first; a label outside
    [0, n) gives a zero column, as jax.nn.one_hot does (torch's raises)."""
    ids = torch.arange(n, device=labels.device).reshape(
        n, *([1] * labels.ndim))
    return (labels[None].to(torch.int64) == ids).to(torch.float32)


def binary_morphology(mask: torch.Tensor, radius: int,
                      mode: str) -> torch.Tensor:
    """Binary dilate/erode/open/close with a box of half-width `radius`
    (max_pool_same pads by replication, so the volume's border neither
    erodes nor dilates a mask that touches it)."""
    m = mask.to(torch.float32)
    k = 2 * radius + 1
    if mode == "dilate":
        return max_pool_same(m, k) > 0.5
    if mode == "erode":
        return max_pool_same(1.0 - m, k) < 0.5
    if mode == "open":
        return binary_morphology(binary_morphology(mask, radius, "erode"),
                                 radius, "dilate")
    if mode == "close":
        return binary_morphology(binary_morphology(mask, radius, "dilate"),
                                 radius, "erode")
    raise ValueError(f"unknown morphology mode {mode}")


def _cross_dilate_one_hot(labels: torch.Tensor,
                          n_labels: int) -> torch.Tensor:
    """One-hot of a labelmap (n_labels + 1 channels) with each channel
    dilated by the 6-neighbourhood cross: (n_labels + 1, D, H, W) bool."""
    one_hot = one_hot_channels(labels, n_labels + 1)
    k = np.asarray([1.0, 1.0, 1.0], np.float32)
    acc = one_hot
    for d in range(3):
        acc = acc + filter_1d(one_hot, k, d, padding_mode="constant")
    return acc > 0.5


def fissures_between_lobes(lobes: torch.Tensor,
                           n_lobes: int | None = None) -> torch.Tensor:
    """Fissure labels where the cross-dilated channels of adjacent lobes
    overlap.

    Lobe labels: 1 RLL, 2 RUL, 3 LLL, 4 LUL, 5 RML (optional).
    Fissures: 1 = left oblique (3 & 4), 2 = right oblique (1 & 2, and
    1 & 5), 3 = right horizontal (2 & 5).
    :return: (D, H, W) uint8
    """
    if n_lobes is None:
        n_lobes = int(lobes.max())
    dil = _cross_dilate_one_hot(lobes, n_lobes)
    zero = torch.zeros((), dtype=torch.uint8, device=lobes.device)
    fissures = torch.zeros(lobes.shape, dtype=torch.uint8,
                           device=lobes.device)
    if n_lobes >= 4:
        fissures = torch.where(dil[3] & dil[4], zero + 1, fissures)
    if n_lobes >= 2:
        rof = dil[1] & dil[2]
        if n_lobes >= 5:
            rof = rof | (dil[1] & dil[5])
        fissures = torch.where(rof, zero + 2, fissures)
    if n_lobes >= 5:
        fissures = torch.where(dil[2] & dil[5], zero + 3, fissures)
    return fissures


# the preprocessing-time name (complete lobe GT in, no random-walk fill)
find_fissures = fissures_between_lobes


def generate_lung_mask(lobes: torch.Tensor) -> torch.Tensor:
    return lobes > 0


def check_left_right_lung_plausible(component_sizes,
                                    max_volume_ratio: float = 10.0) -> bool:
    """At least two components, the biggest at most `max_volume_ratio`
    times the second."""
    sizes = sorted(component_sizes, reverse=True)
    if len(sizes) < 2:
        return False
    return sizes[0] / sizes[1] <= max_volume_ratio


def binary_lung_mask_to_left_right(lung_mask: np.ndarray, left_label: int = 1,
                                   right_label: int = 2,
                                   max_volume_ratio: float = 10.0,
                                   max_opening_radius: int = 13,
                                   device=None) -> np.ndarray:
    """Binary lung mask -> left (1) / right (2) mask: connected components
    (native 26-connectivity); while the two biggest are implausible
    (merged lungs), open the mask on `device` with radius 3, 5, ... up to
    `max_opening_radius`; keep the two biggest, the one with the smaller
    centroid x being the right lung; voxels lost to an opening go to the
    nearest kept half (Euclidean distance transform) inside the mask.

    :param lung_mask: (D, H, W) zyx binary mask
    :return: (D, H, W) int32 labelmap {0, left_label, right_label}
    """
    from scipy.ndimage import distance_transform_edt

    from ..native import cc_label_3d

    mask0 = np.asarray(lung_mask) > 0
    mask = mask0
    opened = False
    radius = 3
    while True:
        comp, n = cc_label_3d(mask)
        sizes = np.bincount(comp.ravel(), minlength=n + 1)[1:]
        if check_left_right_lung_plausible(sizes, max_volume_ratio) \
                or radius > max_opening_radius or n == 0:
            break
        dev = resolve_device(device, "binary_lung_mask_to_left_right")
        mask = binary_morphology(torch.as_tensor(mask, device=dev), radius,
                                 "open").cpu().numpy()
        radius += 2
        opened = True

    if n == 0:
        return np.zeros(mask0.shape, np.int32)
    biggest = np.argsort(sizes)[::-1][:2] + 1  # component ids of 2 largest
    out = np.zeros(mask0.shape, np.int32)
    xs = [np.nonzero(comp == b)[2].mean() if (comp == b).any() else np.inf
          for b in biggest]
    if len(biggest) == 1 or not np.isfinite(xs[-1]):
        out[comp == biggest[0]] = left_label
        labels_present = (left_label,)
    else:
        right_comp, left_comp = biggest[np.argsort(xs)]
        out[comp == left_comp] = left_label
        out[comp == right_comp] = right_label
        labels_present = (left_label, right_label)

    if opened:
        dist = np.stack([distance_transform_edt(out != lbl)
                         for lbl in labels_present])
        nearest = np.asarray(labels_present)[np.argmin(dist, axis=0)]
        out = np.where(mask0, np.where(out != 0, out, nearest), 0)
    return out.astype(np.int32)


def find_non_zero_range(mask, axis: int = 0, open_radius: int = 2,
                        device=None) -> tuple[int, int]:
    """[lo, hi) index range along `axis` holding non-zero voxels, after a
    binary opening of radius `open_radius` on `device` that ignores
    specks (0: the raw range)."""
    if open_radius == 0:
        m = np.asarray(mask) != 0
    else:
        t = as_device_tensor(mask, device, "find_non_zero_range")
        m = binary_morphology(t != 0, open_radius, "open").cpu().numpy()
    proj = m.any(axis=tuple(a for a in range(m.ndim) if a != axis))
    nz = np.nonzero(proj)[0]
    if len(nz) == 0:
        return 0, np.asarray(mask).shape[axis]
    return int(nz[0]), int(nz[-1]) + 1


def label_to_mesh(labelmap, label: int, mask=None, sigma: float = 1.0,
                  max_tris: int = 200_000, device=None):
    """Surface of one labelled object: marching tetrahedra on the smoothed
    indicator, 0.5 - smooth(labelmap == label), with the z-order
    truncation at `max_tris`.

    :return: (tris (max_tris, 3, 3) world xyz float32, valid (max_tris,)
        bool), numpy
    """
    from ..ops.marching import marching_tetrahedra
    lab = as_device_tensor(labelmap, device, "label_to_mesh")
    ind = (lab == label).to(torch.float32)
    if mask is not None:
        m = as_device_tensor(mask, lab.device, "label_to_mesh")
        ind = torch.where(m.to(torch.bool), ind, 0.0)
    phi = 0.5 - smooth(ind[None], sigma)[0] if sigma else 0.5 - ind
    tris, valid, _ = marching_tetrahedra(phi, max_tris=max_tris)
    # zyx voxel -> world xyz
    return tris.flip(-1).cpu().numpy(), valid.cpu().numpy()


def find_lobes(fissures, lung_mask, exclude_rhf: bool = False,
               fill: bool = True, cg_iters: int = 500,
               erode_radius: int | None = None,
               close_radius: int | None = None,
               dilate_radius: int | None = None,
               open_radius: int | None = None, device=None,
               stages: dict | None = None):
    """Fissure segmentation -> lobe labelmap.

    Erode the lung mask, cut it by the (closed, dilated) fissures, open
    the rest, keep the 4 (exclude_rhf) or 5 largest 6-connected components
    (scipy), relabel them by centroid (x: the body half, z: lower/upper),
    then fill the lung mask with the random walk on the device. The radii
    default to 2/2/2/4 at 256 voxels and above, scaled down for smaller
    volumes (at least 1).

    :param fissures, lung_mask: (D, H, W) numpy or tensors; numpy goes to
        `device` (the card unless asked for the CPU)
    :param stages: optional dict; the synced seconds of
        "find_lobes:morphology", "find_lobes:components" and
        "find_lobes:random_walk" are added to it
    :return: (lobes (D, H, W) int32 numpy, success bool)
    """
    from scipy import ndimage
    fis = as_device_tensor(fissures, device, "find_lobes")
    dev = fis.device
    lung_in = as_device_tensor(lung_mask, dev, "find_lobes") > 0
    scale = min(1.0, max(min(fis.shape) / 256.0, 0.25))
    if erode_radius is None:
        erode_radius = max(int(round(2 * scale)), 1)
    if close_radius is None:
        close_radius = max(int(round(2 * scale)), 1)
    if dilate_radius is None:
        dilate_radius = max(int(round(2 * scale)), 1)
    if open_radius is None:
        open_radius = max(int(round(4 * scale)), 1)
    num_target = 4 if exclude_rhf else 5

    with stage(stages, "find_lobes:morphology", dev):
        if exclude_rhf:
            fis = torch.where(fis == 3, 0, fis)
        lung = binary_morphology(lung_in, erode_radius, "erode")
        not_lobes = (~lung) | (fis > 0)
        not_lobes = binary_morphology(not_lobes, close_radius, "close")
        not_lobes = binary_morphology(not_lobes, dilate_radius, "dilate")
        lobes_mask = binary_morphology(~not_lobes, open_radius,
                                       "open").cpu().numpy()

    with stage(stages, "find_lobes:components", dev):
        comp, n = ndimage.label(lobes_mask)
        if n < num_target:
            return np.asarray(comp, np.int32), False
        sizes = ndimage.sum_labels(np.ones_like(comp), comp,
                                   np.arange(1, n + 1))
        keep = np.argsort(sizes)[::-1][:num_target] + 1
        centroids = np.asarray(ndimage.center_of_mass(
            np.ones_like(comp), comp, keep))  # (num_target, 3) zyx

        # smaller x is the subject's right
        sort_by_x = np.argsort(centroids[:, 2])
        num_right = 2 if exclude_rhf else 3
        right, left = sort_by_x[:num_right], sort_by_x[num_right:]
        new_label = np.zeros(num_target, np.int32)
        left_by_z = left[np.argsort(centroids[left, 0])]
        new_label[left_by_z[0]] = 3   # left lower
        new_label[left_by_z[1]] = 4   # left upper
        right_by_z = right[np.argsort(centroids[right, 0])]
        new_label[right_by_z[0]] = 1  # right lower
        new_label[right_by_z[-1]] = 2  # right upper
        if not exclude_rhf:
            new_label[right_by_z[1]] = 5  # right middle

        lobes = np.zeros(comp.shape, np.int32)
        for i, lbl in enumerate(keep):
            lobes[comp == lbl] = new_label[i]

    if fill:
        from ..postprocess.random_walk import fill_lobes
        with stage(stages, "find_lobes:random_walk", dev):
            lobes = fill_lobes(torch.as_tensor(lobes, device=dev), lung_in,
                               n_objects=num_target,
                               cg_iters=cg_iters).cpu().numpy()
    return lobes.astype(np.int32), True
