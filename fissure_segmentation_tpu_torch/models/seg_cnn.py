"""3-D segmentation CNN: MobileNetV2-style backbone + ASPP head, and
whole-volume and sliding-window inference (counterpart of models/seg_cnn.py).

Layout is NDHWC at every public function, as in the JAX package. Inside:

  * 1x1x1 convolutions are products over the last axis (`F.linear`);
  * dense 3x3x3 convolutions (the stride-2 stem, the ASPP's atrous branches,
    the decoder's 64 -> 64) are `F.conv3d` on the (B, C, D, H, W) permute
    of the NDHWC tensor, which is the `channels_last_3d` memory format, so
    cuDNN takes it without a copy;
  * the depthwise layers are K6 (kernels/depthwise.py), the hand-written
    CUDA kernel on a card: stride 1 in blocks 0-4 and 6-7, stride 2 in
    block 5.

Submodules carry flax's names (`MobileNet3D_0/Checkpoint_InvertedResidual_i/
Conv_0..2, BatchNorm_0..2`, `CheckpointASPP_0/Conv_0..6, BatchNorm_0..6`,
top-level `Conv_0..2`, `BatchNorm_0..1`), so a JAX tree loads strictly
through models/weights.py. Convolution weights are torch's (out, in, kd, kh,
kw), block 5's stride-2 depthwise weight too ((C, 1, 3, 3, 3), permuted to
K6's taps in its forward); a stride-1 depthwise weight is K6's (3, 3, 3, C).
Initialisation is kaiming-normal over fan-out, as the JAX package's
`kaiming_out`.

The modules are built in eval mode, as the JAX package applies them with
``train=False`` by default; `.train()` switches every BatchNorm to batch
statistics and turns the ASPP's Dropout(0.5) on (train/image_trainer.py,
float32; a bfloat16 compute dtype raises). In training with autograd on,
each inverted residual and the ASPP are checkpointed
(`torch.utils.checkpoint`), where the JAX package uses `nn.remat`. Two
things differ from flax's functional remat and are handled here: the
recomputation runs `forward` again, so BatchNorm's running update is
skipped there (`_remat`), and checkpointing replays only the default
generator, so the dropout mask is drawn (or passed in) outside the
recomputed region.
"""
from __future__ import annotations

import contextlib
import copy
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.depthwise import depthwise_conv3_cuda
from ..utils.filters import _pad_axis
from .blocks import BatchNorm


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def _kaiming_out(weight: torch.Tensor, generator) -> None:
    """variance_scaling(2.0, "fan_out", "normal") of a torch conv weight
    (out, in / groups, kd, kh, kw): fan-out = out x kd kh kw, as flax
    counts it for the kernel (kd, kh, kw, in / groups, out)."""
    nn.init.kaiming_normal_(weight, mode="fan_out", nonlinearity="relu",
                            generator=generator)


@contextlib.contextmanager
def _frozen_stats(module: nn.Module):
    """BatchNorm's running update off inside `module` for the block."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            del bn.update_stats


def _remat(module: nn.Module, *args):
    """``module(*args)``, checkpointed in training with autograd on (flax
    ``nn.remat``): the first run updates BatchNorm's running statistics,
    the recomputation in the backward does not, so a batch is folded in
    once, as flax's functional remat folds it. Nothing random runs
    inside."""
    if not (module.training and torch.is_grad_enabled()):
        return module(*args)
    ran = []

    def run(*a):
        if ran:
            with _frozen_stats(module):
                return module(*a)
        ran.append(True)
        return module(*a)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


class Conv(nn.Conv3d):
    """flax `nn.Conv` on NDHWC tensors, with torch's weight layout."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 bias: bool = False, generator=None):
        super().__init__(cin, cout, kernel, stride, padding, dilation, groups,
                         bias)
        _kaiming_out(self.weight, generator)
        if bias:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel_size == (1, 1, 1) and self.stride == (1, 1, 1):
            return F.linear(x, self.weight.flatten(1), self.bias)
        return _ndhwc(F.conv3d(_ncdhw(x), self.weight, self.bias, self.stride,
                               self.padding, self.dilation, self.groups))


class DepthwiseConv3(nn.Module):
    """3x3x3 depthwise convolution, stride 1, SAME padding, through K6.
    `kernel` is (3, 3, 3, C): the flax kernel (3, 3, 3, 1, C) squeezed."""

    def __init__(self, channels: int, generator=None):
        super().__init__()
        w = torch.empty(channels, 1, 3, 3, 3)
        _kaiming_out(w, generator)
        self.kernel = nn.Parameter(w[:, 0].permute(1, 2, 3, 0).contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depthwise_conv3_cuda(x.contiguous(), self.kernel)


class DepthwiseConv3Stride2(Conv):
    """3x3x3 depthwise convolution, stride 2, padding 1 (ceil(n / 2)
    outputs an axis), through K6's stride-2 mode. The weight stays the
    grouped convolution's (C, 1, 3, 3, 3), as the JAX tree and the `.fst`
    files name and shape it; the forward permutes it to K6's (3, 3, 3, C)
    under autograd, so its gradient lands in `weight`."""

    def __init__(self, channels: int, generator=None):
        super().__init__(channels, channels, 3, stride=2, padding=1,
                         groups=channels, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight[:, 0].permute(1, 2, 3, 0).contiguous()
        return depthwise_conv3_cuda(x.contiguous(), w, stride=2)


class _InvertedResidual(nn.Module):
    """1x1 expand (3x3x3 stride 2 in the first block) -> 3x3x3 depthwise ->
    1x1 project, with the residual where shapes allow."""

    def __init__(self, cin: int, mid: int, out: int, stride: int = 1,
                 first: bool = False, generator=None):
        super().__init__()
        self.residual = cin == out and stride == 1 and not first
        self.Conv_0 = (Conv(cin, mid, 3, stride=2, padding=1,
                            generator=generator) if first
                       else Conv(cin, mid, 1, generator=generator))
        self.BatchNorm_0 = BatchNorm(mid)
        self.Conv_1 = (DepthwiseConv3(mid, generator) if stride == 1
                       else DepthwiseConv3Stride2(mid, generator))
        self.BatchNorm_1 = BatchNorm(mid)
        self.Conv_2 = Conv(mid, out, 1, generator=generator)
        self.BatchNorm_2 = BatchNorm(out)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = relu6(self.BatchNorm_0(self.Conv_0(x)))
        h = relu6(self.BatchNorm_1(self.Conv_1(h)))
        h = self.BatchNorm_2(self.Conv_2(h))
        return h + x if self.residual else h


# (mid, out, stride, first) of the eight blocks (models/seg_cnn.py:68-71)
_SPECS = ((32, 16, 1, True), (96, 24, 1, False), (144, 24, 1, False),
          (144, 32, 1, False), (192, 32, 1, False), (192, 32, 2, False),
          (192, 64, 1, False), (384, 64, 1, False))


class MobileNet3D(nn.Module):
    """The backbone; returns (x1 at 1/2 with 16 channels, x2 at 1/4 with
    64 channels)."""

    def __init__(self, in_channels: int = 1, generator=None):
        super().__init__()
        cin = in_channels
        for i, (mid, out, stride, first) in enumerate(_SPECS):
            setattr(self, f"Checkpoint_InvertedResidual_{i}",
                    _InvertedResidual(cin, mid, out, stride, first, generator))
            cin = out
        self.eval()

    def forward(self, x: torch.Tensor):
        h = _remat(self.Checkpoint_InvertedResidual_0, x)
        x1 = h
        for i in range(1, len(_SPECS)):
            h = _remat(getattr(self, f"Checkpoint_InvertedResidual_{i}"), h)
        return x1, h


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, one dilated 3x3x3
    branch per rate, a global-pooling branch, then a 1x1 projection and
    Dropout(0.5): in training, flax's ``where(mask, h / 0.5, 0)`` with the
    keep mask the caller passes; the identity in eval."""

    keep_prob = 0.5

    def __init__(self, in_channels: int, atrous_rates: Sequence[int],
                 out_channels: int = 256, generator=None):
        super().__init__()
        self.n_rates = len(atrous_rates)
        convs = [Conv(in_channels, out_channels, 1, generator=generator)]
        convs += [Conv(in_channels, out_channels, 3, padding=r, dilation=r,
                       generator=generator) for r in atrous_rates]
        convs += [Conv(in_channels, out_channels, 1, generator=generator),
                  Conv(out_channels * (self.n_rates + 2), out_channels, 1,
                       generator=generator)]
        for i, conv in enumerate(convs):
            setattr(self, f"Conv_{i}", conv)
            setattr(self, f"BatchNorm_{i}", BatchNorm(out_channels))
        self.eval()

    def _branch(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(getattr(self, f"BatchNorm_{i}")(
            getattr(self, f"Conv_{i}")(x)))

    def forward(self, x: torch.Tensor,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        res = [self._branch(i, x) for i in range(self.n_rates + 1)]
        g = self._branch(self.n_rates + 1, x.mean((1, 2, 3), keepdim=True))
        res.append(g.expand_as(res[0]))
        h = self._branch(self.n_rates + 2, torch.cat(res, -1))
        if not self.training:
            return h
        return torch.where(keep, h / self.keep_prob,
                           torch.zeros((), dtype=h.dtype, device=h.device))


def _resize(x: torch.Tensor, scale: int, method: str) -> torch.Tensor:
    """jax.image.resize of (B, D, H, W, C) by an integer factor: "nearest"
    takes input floor((i + 0.5) / scale) ("nearest-exact"); "trilinear"
    samples at half-pixel centres with the edge clamped (align_corners
    False), which is what JAX's renormalised triangle kernel gives when
    upsampling."""
    if method == "nearest":
        y = F.interpolate(_ncdhw(x), scale_factor=scale, mode="nearest-exact")
    elif method == "trilinear":
        y = F.interpolate(_ncdhw(x), scale_factor=scale, mode="trilinear",
                          align_corners=False)
    else:
        raise ValueError(f"unsupported resize method {method!r}")
    return _ndhwc(y)


class MobileNetASPP(nn.Module):
    """Pre-segmentation CNN: (B, D, H, W, 1) CT -> (B, D, H, W,
    num_classes) logits; D, H, W multiples of 4."""

    def __init__(self, num_classes: int,
                 patch_size: Sequence[int] = (128, 128, 128),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = {"num_classes": num_classes,
                       "patch_size": list(patch_size)}
        self.num_classes = num_classes
        self.patch_size = tuple(patch_size)
        self.MobileNet3D_0 = MobileNet3D(1, generator)
        self.CheckpointASPP_0 = ASPP(64, (2, 4, 8, 16), 128, generator)
        self.Conv_0 = Conv(16 + 128, 64, 1, generator=generator)
        self.BatchNorm_0 = BatchNorm(64)
        self.Conv_1 = Conv(64, 64, 3, padding=1, generator=generator)
        self.BatchNorm_1 = BatchNorm(64)
        self.Conv_2 = Conv(64, num_classes, 1, bias=True, generator=generator)
        self.eval()

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """
        :param x: (B, D, H, W, 1)
        :param keep: in training, the ASPP dropout's keep mask (B, D/4,
            H/4, W/4, 128) bool; drawn from `generator` (x's device)
            when None (the tests inject JAX's)
        """
        x1, x2 = self.MobileNet3D_0(x)
        if self.training and keep is None:
            shape = (*x2.shape[:-1], self.CheckpointASPP_0.Conv_0.out_channels)
            keep = torch.rand(shape, generator=generator,
                              device=x.device) < ASPP.keep_prob
        y = _remat(self.CheckpointASPP_0, x2, keep)
        y = torch.cat([x1, _resize(y, 2, "nearest")], -1)
        y = torch.relu(self.BatchNorm_0(self.Conv_0(y)))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y)))
        return _resize(self.Conv_2(y), 2, "trilinear")


# ---------------- whole-volume and sliding-window inference ----------------

def get_patch_starts(img_size, min_overlap, patch_size):
    """Minimal-overlap tiling start indices per dimension
    (models/seg_cnn.py:get_patch_starts)."""
    starts = []
    for dim, patch in zip(img_size, patch_size):
        if patch >= dim:
            starts.append([0])
        else:
            steps = math.ceil((dim - patch * min_overlap)
                              / (patch - patch * min_overlap))
            actual_overlap = (steps * patch - dim) / (steps - 1)
            starts.append([math.floor(s * (patch - actual_overlap) + 0.5)
                           for s in range(steps)])
    return starts


def gaussian_importance_map(patch_size, sigma_scale=1 / 4.0) -> np.ndarray:
    """Gaussian-blurred dirac at the patch centre
    (models/seg_cnn.py:gaussian_importance_map)."""
    from scipy.ndimage import gaussian_filter
    w = np.zeros(patch_size)
    w[tuple(p // 2 for p in patch_size)] = 1
    w = gaussian_filter(w, sigma=[p * sigma_scale for p in patch_size],
                        mode="constant", cval=0)
    w[w == 0] = w[w != 0].min()
    return w.astype(np.float32)


def _check_dtype(dtype) -> None:
    if dtype not in (None, torch.float32):
        raise NotImplementedError(f"CNN compute dtype {dtype} is not ported "
                                  "yet (float32 only)")


def _edge_pad(img: torch.Tensor, pad) -> torch.Tensor:
    """Edge padding of a (D, H, W) volume, (q // 2 + q % 2) low and q // 2
    high on each axis, as jnp.pad(mode="edge") with the JAX split."""
    for axis, q in enumerate(pad):
        if q:
            img = _pad_axis(img, axis, q // 2 + q % 2, q // 2, "replicate")
    return img


def _softmax_forward(model, vol: torch.Tensor) -> torch.Tensor:
    """(D, H, W) volume -> (D, H, W, C) softmax of the model's logits."""
    logits = model(vol[None, ..., None])[0]
    return torch.softmax(logits.to(torch.float32), dim=-1)


@torch.no_grad()
def predict_full_volume(model, img: torch.Tensor, dtype=None) -> torch.Tensor:
    """Whole-volume CNN inference in one forward pass
    (models/seg_cnn.py:predict_full_volume): edge padding to a multiple of
    the backbone stride 4, softmax of the logits, crop.

    :param model: MobileNetASPP (or any NDHWC model of the same contract)
    :param img: (D, H, W) float32 volume on the device to run on
    :param dtype: compute dtype: float32 (None) or bfloat16. In bfloat16 a
        copy of the model with every parameter and buffer cast runs on the
        cast volume (the JAX package casts every float32 leaf of its
        variables and the input), so the depthwise layers run K6 in
        bfloat16; the softmax is taken in float32.
    :return: (D, H, W, num_classes) softmax
    """
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise NotImplementedError(f"CNN compute dtype {dtype} is not ported "
                                  "yet (float32 or bfloat16)")
    dhw = tuple(img.shape)
    pad = [(-s) % 4 for s in dhw]
    vol = _edge_pad(img.to(torch.float32), pad)
    if dtype == torch.bfloat16:
        model, vol = copy.deepcopy(model).to(dtype), vol.to(dtype)
    out = _softmax_forward(model, vol)
    lo = [q // 2 + q % 2 for q in pad]
    return out[lo[0]:lo[0] + dhw[0], lo[1]:lo[1] + dhw[1],
               lo[2]:lo[2] + dhw[2]]


@torch.no_grad()
def predict_all_patches(model, img: torch.Tensor, num_classes: int,
                        patch_size=(128, 128, 128), min_overlap: float = 0.5,
                        use_gaussian: bool = True, dtype=None) -> torch.Tensor:
    """Sliding-window inference with Gaussian blending and a second softmax
    (models/seg_cnn.py:predict_all_patches, the reference protocol).

    :param img: (D, H, W) float32 volume on the device to run on
    :return: (D, H, W, num_classes) softmax
    """
    _check_dtype(dtype)
    dhw = tuple(img.shape)
    dev = img.device
    starts = get_patch_starts(dhw, min_overlap, patch_size)
    gmap = (torch.as_tensor(gaussian_importance_map(patch_size), device=dev)
            if use_gaussian else
            torch.ones(tuple(patch_size), dtype=torch.float32, device=dev))
    gmap = gmap[..., None]
    pad = [max(0, p - s) for s, p in zip(dhw, patch_size)]
    img_p = _edge_pad(img.to(torch.float32), pad)
    out = torch.zeros((*img_p.shape, num_classes), dtype=torch.float32,
                      device=dev)
    norm = torch.zeros((*img_p.shape, 1), dtype=torch.float32, device=dev)
    for sz in starts[0]:
        for sy in starts[1]:
            for sx in starts[2]:
                sl = (slice(sz, sz + patch_size[0]),
                      slice(sy, sy + patch_size[1]),
                      slice(sx, sx + patch_size[2]))
                out[sl] += _softmax_forward(model, img_p[sl]) * gmap
                norm[sl] += gmap
    out = out / norm
    lo = [q // 2 + q % 2 for q in pad]
    out = out[lo[0]:lo[0] + dhw[0], lo[1]:lo[1] + dhw[1],
              lo[2]:lo[2] + dhw[2]]
    return torch.softmax(out, dim=-1)
