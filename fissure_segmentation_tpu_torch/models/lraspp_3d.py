"""LR-ASPP on a MobileNetV3-large backbone in 3-D, the segmentation CNN
"v3" (counterpart of models/lraspp_3d.py).

The backbone's inverted residuals (1x1 expand, depthwise, squeeze-excite,
1x1 project) follow torchvision's MobileNetV3-large table with the last
stage dilated instead of strided; hardswish is LeakyReLU(0.01), as the
reference replaces it. The head: a 1x1 conv-BN-ReLU on the high-level
feature (stride 16, 960 channels) gated by a sigmoid of its global mean,
upsampled trilinearly to the low-level feature (stride 8, 40 channels),
then the two 1x1 classifiers summed and upsampled to the input.

Layout and weights as in models/seg_cnn.py: NDHWC, flax's module names
(`MobileNetV3Large3D_0/CheckpointInvertedResidualV3_i/Conv_j,
BatchNorm_j, SqueezeExcite_0`, `LRASPPHead_0`), torch's conv weights. The
3x3x3 stride-1 undilated depthwise layers (table rows 0, 2 and 7-11) are
K6 (kernels/depthwise.py); the 5x5x5, the stride-2 and the dilated
depthwise layers are grouped `F.conv3d`. Each inverted residual is
checkpointed in training (`seg_cnn._remat`, the JAX package's
`nn.remat`). Built in eval mode; float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm, leaky_relu
from .seg_cnn import Conv, DepthwiseConv3, _ncdhw, _ndhwc, _remat, relu6


def _act(x: torch.Tensor, hs: bool) -> torch.Tensor:
    return leaky_relu(x, 0.01) if hs else torch.relu(x)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """flax's hard_sigmoid: relu6(x + 3) / 6."""
    return relu6(x + 3.0) / 6.0


def resize_to(x: torch.Tensor, size) -> torch.Tensor:
    """jax.image.resize(x, (B, *size, C), "trilinear") of an NDHWC tensor
    when upsampling (or keeping) every axis: half-pixel centres, the edge
    clamped (F.interpolate with align_corners False)."""
    if any(s < t for s, t in zip(size, x.shape[1:4])):
        raise ValueError(f"resize_to upsamples only: {tuple(x.shape)} -> "
                         f"{tuple(size)}")
    return _ndhwc(F.interpolate(_ncdhw(x), size=tuple(size),
                                mode="trilinear", align_corners=False))


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, generator=None):
        super().__init__()
        squeeze = max(channels // 4, 8)
        self.Conv_0 = Conv(channels, squeeze, 1, bias=True,
                           generator=generator)
        self.Conv_1 = Conv(squeeze, channels, 1, bias=True,
                           generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(self.Conv_0(x.mean((1, 2, 3), keepdim=True)))
        return x * hard_sigmoid(self.Conv_1(s))


class InvertedResidualV3(nn.Module):
    """[1x1 expand ->] kxkxk depthwise [-> squeeze-excite] -> 1x1
    project, with the residual where shapes allow. Submodules are named in
    flax's order of creation (no expand: the depthwise layer is Conv_0)."""

    def __init__(self, cin: int, exp: int, out: int, kernel: int,
                 stride: int, use_se: bool, hs: bool, dilation: int = 1,
                 generator=None):
        super().__init__()
        self.hs, self.use_se = hs, use_se
        self.residual = stride == 1 and cin == out
        self.expand = exp != cin
        n = 0
        if self.expand:
            self.Conv_0 = Conv(cin, exp, 1, generator=generator)
            self.BatchNorm_0 = BatchNorm(exp)
            n = 1
        if kernel == 3 and stride == 1 and dilation == 1:
            dw = DepthwiseConv3(exp, generator)
        else:
            dw = Conv(exp, exp, kernel, stride=stride,
                      padding=dilation * (kernel // 2), dilation=dilation,
                      groups=exp, generator=generator)
        setattr(self, f"Conv_{n}", dw)
        setattr(self, f"BatchNorm_{n}", BatchNorm(exp))
        if use_se:
            self.SqueezeExcite_0 = SqueezeExcite(exp, generator)
        setattr(self, f"Conv_{n + 1}", Conv(exp, out, 1, generator=generator))
        setattr(self, f"BatchNorm_{n + 1}", BatchNorm(out))
        self.n = n
        self.eval()

    def _conv_bn(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(h))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand:
            h = _act(self._conv_bn(0, h), self.hs)
        h = _act(self._conv_bn(self.n, h), self.hs)
        if self.use_se:
            h = self.SqueezeExcite_0(h)
        h = self._conv_bn(self.n + 1, h)
        return h + x if self.residual else h


# (kernel, exp, out, SE, hardswish, stride): torchvision MobileNetV3-large
_V3_LARGE = (
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),   # the low-level feature (40 ch, stride 8)
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),   # dilated in segmentation mode
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
)
_LOW_INDEX = 5


class MobileNetV3Large3D(nn.Module):
    """The backbone; returns (low at stride 8 with 40 channels, high at
    stride 16 with 960 channels)."""

    def __init__(self, generator=None):
        super().__init__()
        self.Conv_0 = Conv(1, 16, 3, stride=2, padding=1, generator=generator)
        self.BatchNorm_0 = BatchNorm(16)
        cin, dilation = 16, 1
        for i, (k, exp, out, se, hs, stride) in enumerate(_V3_LARGE):
            if i == len(_V3_LARGE) - 3 and stride == 2:
                stride, dilation = 1, 2     # keep stride 16: dilate instead
            setattr(self, f"CheckpointInvertedResidualV3_{i}",
                    InvertedResidualV3(cin, exp, out, k, stride, se, hs,
                                       dilation, generator))
            cin = out
        self.Conv_1 = Conv(cin, 960, 1, generator=generator)
        self.BatchNorm_1 = BatchNorm(960)
        self.eval()

    def forward(self, x: torch.Tensor):
        h = _act(self.BatchNorm_0(self.Conv_0(x)), True)
        low = None
        for i in range(len(_V3_LARGE)):
            h = _remat(getattr(self, f"CheckpointInvertedResidualV3_{i}"), h)
            if i == _LOW_INDEX:
                low = h
        return low, _act(self.BatchNorm_1(self.Conv_1(h)), True)


class LRASPPHead(nn.Module):
    def __init__(self, num_classes: int, low_channels: int = 40,
                 high_channels: int = 960, inter_channels: int = 128,
                 generator=None):
        super().__init__()
        self.Conv_0 = Conv(high_channels, inter_channels, 1,
                           generator=generator)
        self.BatchNorm_0 = BatchNorm(inter_channels)
        self.Conv_1 = Conv(high_channels, inter_channels, 1,
                           generator=generator)
        self.Conv_2 = Conv(low_channels, num_classes, 1, bias=True,
                           generator=generator)
        self.Conv_3 = Conv(inter_channels, num_classes, 1, bias=True,
                           generator=generator)
        self.eval()

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.BatchNorm_0(self.Conv_0(high)))
        s = torch.sigmoid(self.Conv_1(high.mean((1, 2, 3), keepdim=True)))
        x = resize_to(x * s, low.shape[1:4])
        return self.Conv_2(low) + self.Conv_3(x)


class LRASPPMobileNetV33D(nn.Module):
    """Segmentation CNN v3: (B, D, H, W, 1) CT -> (B, D, H, W, num_classes)
    logits."""

    def __init__(self, num_classes: int,
                 patch_size: Sequence[int] = (128, 128, 128),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = {"num_classes": num_classes,
                       "patch_size": list(patch_size)}
        self.num_classes = num_classes
        self.patch_size = tuple(patch_size)
        self.MobileNetV3Large3D_0 = MobileNetV3Large3D(generator)
        self.LRASPPHead_0 = LRASPPHead(num_classes, generator=generator)
        self.eval()

    def forward(self, x: torch.Tensor, keep=None,
                generator=None) -> torch.Tensor:
        """`keep` and `generator` are MobileNetASPP's dropout arguments,
        taken so that the trainer drives both CNNs alike; this one has no
        dropout."""
        low, high = self.MobileNetV3Large3D_0(x)
        return resize_to(self.LRASPPHead_0(low, high), x.shape[1:4])
