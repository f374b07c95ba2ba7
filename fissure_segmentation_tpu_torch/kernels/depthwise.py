"""K6: 3x3x3 depthwise convolution, stride 1, SAME zero padding, channel-last
— wrapper of csrc/depthwise.cu and its plain PyTorch version.

Replaces fissure_segmentation_tpu/ops/pallas/depthwise.py:depthwise_conv3
and depthwise_conv3_ring (the same function, two TPU formulations). For x
(B, D, H, W, C) and w (3, 3, 3, C), both float32 or both bfloat16, it
returns y of x's shape and dtype:

    y[b, z, y, x, c] = sum_{dz, dy, dx} x[b, z+dz-1, y+dy-1, x+dx-1, c]
                                        * w[dz, dy, dx, c]

with out-of-range taps read as zero, the 27 products summed in float32 from
0 in the order (dz, dy, dx) and rounded once to x's dtype, as `_dw_kernel`
does. It is the depthwise layer of MobileNetASPP's stride-1 inverted
residuals (models/seg_cnn.py).

`depthwise_conv3_cuda` launches the kernel for a CUDA tensor and runs
`depthwise_conv3_plain` for a CPU tensor; there is no fallback from one to
the other. Both round every operation identically (no FMA contraction on
either side), so they agree bit for bit. There is no gradient: the JAX
package has no backward kernel for it, and the wrapper raises when autograd
would record through it. Why the kernel is shaped as it is, and what bounds
it: see the head of csrc/depthwise.cu.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def depthwise_conv3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6: pad once with zeros, then 27 shifted
    multiply-adds in float32 in the order (dz, dy, dx).

    :param x: (B, D, H, W, C) float32 or bfloat16
    :param w: (3, 3, 3, C), x's dtype
    :return: (B, D, H, W, C), x's dtype
    """
    _, d, h, ww, _ = x.shape
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = w.to(torch.float32)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                tap = xp[:, dz:dz + d, dy:dy + h, dx:dx + ww, :]
                acc = acc + tap * wf[dz, dy, dx]
    return acc.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"depthwise_conv3: x and w must both be float32 or "
                        f"both bfloat16, got {x.dtype} and {w.dtype}")
    if x.ndim != 5:
        raise ValueError(f"depthwise_conv3: x must be (B, D, H, W, C), got "
                         f"{tuple(x.shape)}")
    if tuple(w.shape) != (3, 3, 3, x.shape[-1]):
        raise ValueError(f"depthwise_conv3: w must be (3, 3, 3, "
                         f"{x.shape[-1]}), got {tuple(w.shape)}")
    if x.numel() == 0:
        raise ValueError(f"depthwise_conv3: empty x {tuple(x.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("depthwise_conv3: x and w must be contiguous")
    if x.device != w.device:
        raise ValueError("depthwise_conv3: x and w on different devices")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("depthwise_conv3 has no gradient; call it under "
                           "torch.no_grad()")


def depthwise_conv3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K6 on the input's device: the CUDA kernel for a CUDA tensor,
    `depthwise_conv3_plain` for a CPU tensor. Each kernel launch adds one
    to ``depthwise_conv3_cuda.launches``.

    :param x: (B, D, H, W, C) float32 or bfloat16, contiguous
    :param w: (3, 3, 3, C), x's dtype, contiguous
    :return: (B, D, H, W, C), x's dtype
    """
    _check(x, w)
    if x.device.type == "cpu":
        return depthwise_conv3_plain(x, w)
    if not x.is_cuda:
        raise ValueError(f"depthwise_conv3: unsupported device {x.device}")
    from ._build import load
    lib = load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fseg_depthwise_conv3(x.data_ptr(), w.data_ptr(),
                                       out.data_ptr(), *x.shape,
                                       _DTYPES[x.dtype],
                                       ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"depthwise_conv3 kernel launch failed: "
                           f"cudaError_t {err}")
    depthwise_conv3_cuda.launches += 1
    return out


depthwise_conv3_cuda.launches = 0
