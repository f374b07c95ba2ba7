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
either side), so they agree bit for bit. Why the kernel is shaped as it is,
and what bounds it: see the head of csrc/depthwise.cu.

The gradient (float32 only, as the CNN trains; a bfloat16 backward raises).
Where autograd records, the wrapper runs `_DepthwiseConv3`, whose backward
computes
  * dgrad: dx = K6(dy, w[::-1, ::-1, ::-1, :]), the forward kernel itself
    with the taps flipped (bit-equal to the plain version on the same
    inputs);
  * wgrad: dw[dz, dy, dx, c] = sum_{b, z, y, x} x[b, z+dz-1, y+dy-1,
    x+dx-1, c] * dy[b, z, y, x, c], out-of-range taps zero, by the
    hand-written kernel `fseg_depthwise_wgrad` (csrc/depthwise.cu) on a
    card, `depthwise_conv3_wgrad_plain` (27 shifted products, each reduced
    with `sum`) on the CPU. The kernel sums in another order than the
    plain version; `wgrad_plan` gives its depth, and the result lies within
    gamma_depth * sum |x dy| of the exact sum.
The JAX package computes these layers with XLA's grouped convolution and
has no Pallas backward, so the backward is held against XLA's gradient
(tests/test_torch_cnn_train.py). Launches are counted by role:
``depthwise_conv3_cuda.roles`` {"forward", "dgrad"} (a checkpoint's
recomputation is a forward) and ``depthwise_conv3_wgrad_cuda.launches``.
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


def _k6(x: torch.Tensor, w: torch.Tensor, role: str) -> torch.Tensor:
    """One K6 call, no autograd: the kernel on a card (counted under
    `role`), the plain version on the CPU."""
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
    depthwise_conv3_cuda.roles[role] += 1
    return out


def depthwise_conv3_dgrad(gy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of K6: K6 on the output gradient with the taps flipped."""
    return _k6(gy, w.flip((0, 1, 2)).contiguous(), "dgrad")


class _DepthwiseConv3(torch.autograd.Function):
    """K6 with its backward: dgrad through K6, wgrad through its own
    kernel (float32 only)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _k6(x, w, "forward")

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        if x.dtype != torch.float32:
            raise TypeError(f"depthwise_conv3: the backward is float32 "
                            f"only, got {x.dtype}")
        gy = gy.contiguous()
        dx = depthwise_conv3_dgrad(gy, w) if ctx.needs_input_grad[0] \
            else None
        dw = depthwise_conv3_wgrad_cuda(x, gy) if ctx.needs_input_grad[1] \
            else None
        return dx, dw


def depthwise_conv3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K6 on the input's device: the CUDA kernel for a CUDA tensor,
    `depthwise_conv3_plain` for a CPU tensor; differentiable (float32)
    where autograd records. Each kernel launch adds one to
    ``depthwise_conv3_cuda.launches`` and to its role's count in
    ``depthwise_conv3_cuda.roles``.

    :param x: (B, D, H, W, C) float32 or bfloat16, contiguous
    :param w: (3, 3, 3, C), x's dtype, contiguous
    :return: (B, D, H, W, C), x's dtype
    """
    _check(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if x.dtype != torch.float32:
            raise TypeError(f"depthwise_conv3: the backward is float32 "
                            f"only, got {x.dtype}")
        return _DepthwiseConv3.apply(x, w)
    return _k6(x, w, "forward")


depthwise_conv3_cuda.launches = 0
depthwise_conv3_cuda.roles = {"forward": 0, "dgrad": 0}


# ---- the weight gradient --------------------------------------------------

WG_CH, WG_ROWS = 32, 8        # csrc/depthwise.cu: channels, thread rows
WG_TARGET_BLOCKS = 1056       # blocks of pass 1 to aim for (8 an SM)


def depthwise_conv3_wgrad_plain(x: torch.Tensor,
                                gy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch wgrad: pad x once with zeros, then for each tap
    (dz, dy, dx) the product of the shifted x with gy, reduced with `sum`
    over (B, D, H, W), in x's dtype (float32, or float64 for the oracle).

    :param x: (B, D, H, W, C)
    :param gy: (B, D, H, W, C), x's dtype
    :return: (3, 3, 3, C), x's dtype
    """
    _, d, h, ww, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    taps = [(xp[:, dz:dz + d, dy:dy + h, dx:dx + ww, :] * gy).sum((0, 1, 2, 3))
            for dz in range(3) for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, x.shape[-1])


def wgrad_plan(shape) -> tuple[int, int, int]:
    """(rows per block, blocks along the rows, depth) of the wgrad kernel
    for x of `shape`: enough blocks of WG_CH channels x a run of (b, z, y)
    rows to fill the card; depth = the additions a term passes through (a
    thread's rows x W, the block's WG_ROWS, the second pass's n_parts)."""
    b, d, h, w, c = shape
    rows = b * d * h
    groups = -(-c // WG_CH)
    want = max(1, -(-WG_TARGET_BLOCKS // groups))
    per_block = -(-rows // want)
    per_block = -(-per_block // WG_ROWS) * WG_ROWS
    n_parts = -(-rows // per_block)
    return per_block, n_parts, per_block // WG_ROWS * w + WG_ROWS + n_parts


def gamma(depth: int) -> float:
    """gamma_n = n u / (1 - n u) of float32 (u = 2^-24): the relative
    bound of a sum whose terms each pass through n roundings."""
    u = 2.0 ** -24
    return depth * u / (1 - depth * u)


def depthwise_conv3_wgrad_cuda(x: torch.Tensor,
                               gy: torch.Tensor) -> torch.Tensor:
    """wgrad on the input's device: the kernel for CUDA tensors (each
    launch of its two passes adds one to
    ``depthwise_conv3_wgrad_cuda.launches``), `depthwise_conv3_wgrad_plain`
    for CPU tensors.

    :param x: (B, D, H, W, C) float32, contiguous
    :param gy: (B, D, H, W, C) float32, contiguous
    :return: (3, 3, 3, C) float32
    """
    if x.dtype != torch.float32 or gy.dtype != torch.float32:
        raise TypeError(f"depthwise_conv3_wgrad: float32 only, got "
                        f"{x.dtype} and {gy.dtype}")
    if x.ndim != 5 or gy.shape != x.shape:
        raise ValueError(f"depthwise_conv3_wgrad: x and gy must be one "
                         f"(B, D, H, W, C) shape, got {tuple(x.shape)} and "
                         f"{tuple(gy.shape)}")
    if x.numel() == 0:
        raise ValueError(f"depthwise_conv3_wgrad: empty x {tuple(x.shape)}")
    if not (x.is_contiguous() and gy.is_contiguous()):
        raise ValueError("depthwise_conv3_wgrad: x and gy must be contiguous")
    if x.device != gy.device:
        raise ValueError("depthwise_conv3_wgrad: x and gy on different "
                         "devices")
    if x.device.type == "cpu":
        return depthwise_conv3_wgrad_plain(x, gy)
    if not x.is_cuda:
        raise ValueError(f"depthwise_conv3_wgrad: unsupported device "
                         f"{x.device}")
    from ._build import load
    lib = load()
    c = x.shape[-1]
    per_block, n_parts, _ = wgrad_plan(x.shape)
    dw = torch.empty((3, 3, 3, c), dtype=torch.float32, device=x.device)
    part = torch.empty((n_parts, 27, c), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fseg_depthwise_wgrad(x.data_ptr(), gy.data_ptr(),
                                       dw.data_ptr(), part.data_ptr(),
                                       *x.shape, per_block, n_parts,
                                       ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"depthwise_conv3_wgrad kernel launch failed: "
                           f"cudaError_t {err}")
    depthwise_conv3_wgrad_cuda.launches += 1
    return dw


depthwise_conv3_wgrad_cuda.launches = 0
