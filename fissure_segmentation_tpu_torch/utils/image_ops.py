"""Volume resampling, morphology and masking (counterpart of
utils/image_ops.py; the port's own copy, held equal to the original in
tests/test_torch_repairs.py).

`resize` is `jax.image.resize` on (..., D, H, W) tensors for the two
methods the package uses:
  * "trilinear": JAX's scale-and-translate with the triangle kernel, which
    widens the kernel by 1/scale when downsampling (antialiasing; torch's
    3-D `F.interpolate` does not). Each axis's weight matrix is built as
    JAX builds it, in float32 with numpy (`resize_weights`), and the axes
    are contracted one after another.
  * "nearest": source index floor((i + 0.5) * in / out) in float32, as
    JAX's compiled `_resize_nearest` picks it: XLA folds ``* in / out``
    into one multiply by in * float32(1 / out) rounded to float32 (0.8 is
    0.79999995 for 20 -> 25), which moves some indices by one.
An axis whose size does not change is left as it is, as JAX leaves it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .filters import max_pool_same


def get_resample_factors(current_spacing, target_spacing: float = 1.0):
    return [c / target_spacing for c in current_spacing]


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of JAX's triangle-kernel resize of one
    axis (`jax._src.image.scale.compute_weight_mat`, antialiased, no
    translation)."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.0) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """JAX's nearest source index of each output of one axis."""
    f32 = np.float32
    ratio = f32(f32(n_in) * (f32(1) / f32(n_out)))
    off = (np.arange(n_out, dtype=f32) + f32(0.5)) * ratio
    return np.floor(off).astype(np.int64)


def resize(img: torch.Tensor, shape, method: str) -> torch.Tensor:
    """jax.image.resize of the last len(shape) axes of `img` to `shape`
    ("trilinear"/"linear" in float32, or "nearest" in any dtype)."""
    lead = img.ndim - len(shape)
    for axis, n_out in enumerate(shape, start=lead):
        n_in = img.shape[axis]
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = torch.as_tensor(nearest_indices(n_in, n_out),
                                  device=img.device)
            img = img.index_select(axis, idx)
        elif method in ("trilinear", "linear"):
            w = torch.as_tensor(resize_weights(n_in, n_out),
                                device=img.device)
            img = torch.movedim(torch.tensordot(img, w, dims=([axis], [0])),
                                -1, axis)
        else:
            raise ValueError(f"unsupported resize method {method!r}")
    return img


def resample_equal_spacing(img: torch.Tensor, spacing=(1.0, 1.0, 1.0),
                           target_spacing: float = 1.0,
                           use_nearest_neighbor: bool = False):
    """Resample a (D, H, W) volume with xyz `spacing` to isotropic
    `target_spacing`: new size = round(size * spacing / target); trilinear
    (float32, antialiased when downsampling) or nearest (the input's
    dtype), as the JAX package's."""
    d, h, w = img.shape
    sx, sy, sz = spacing
    new_shape = (int(round(d * sz / target_spacing)),
                 int(round(h * sy / target_spacing)),
                 int(round(w * sx / target_spacing)))
    if use_nearest_neighbor:
        return resize(img, new_shape, "nearest")
    return resize(img.to(torch.float32), new_shape, "trilinear")


def multiple_objects_morphology(labelmap: torch.Tensor, radius: int,
                                mode: str = "dilate"):
    """Per-object binary morphology on an int labelmap with a box
    structuring element of half-width `radius`; where objects meet after a
    dilation the lowest label wins."""
    n = int(labelmap.max()) + 1
    one_hot = F.one_hot(labelmap.to(torch.int64), n).movedim(-1, 0).to(
        torch.float32)
    k = 2 * radius + 1
    if mode == "dilate":
        morphed = max_pool_same(one_hot, k) > 0.5
    elif mode == "erode":
        morphed = max_pool_same(1.0 - one_hot, k) < 0.5
    else:
        raise ValueError(f"unknown morphology mode {mode}")
    obj = torch.argmax(morphed[1:].to(torch.uint8), dim=0) + 1
    any_obj = morphed[1:].any(0)
    return torch.where(any_obj, obj, 0).to(labelmap.dtype)


def apply_mask(img: torch.Tensor, mask: torch.Tensor):
    """Zero voxels outside the mask (in-mask values and the dtype kept)."""
    return torch.where(mask.to(torch.bool), img,
                       torch.zeros((), dtype=img.dtype, device=img.device))
