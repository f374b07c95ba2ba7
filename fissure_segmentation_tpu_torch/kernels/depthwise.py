"""K6: 3x3x3 depthwise convolution, stride 1 or 2, zero padding 1,
channel-last — wrapper of csrc/depthwise.cu and its plain PyTorch version.

Replaces fissure_segmentation_tpu/ops/pallas/depthwise.py:depthwise_conv3
and depthwise_conv3_ring (the stride-1 function, two TPU formulations). For
x (B, D, H, W, C) and w (3, 3, 3, C), both float32 or both bfloat16, and
the stride s (1 or 2), it returns y (B, ceil(D/s), ceil(H/s), ceil(W/s), C)
in x's dtype:

    y[b, z, y, x, c] = sum_{dz, dy, dx} x[b, s z+dz-1, s y+dy-1, s x+dx-1, c]
                                        * w[dz, dy, dx, c]

with out-of-range taps read as zero, the 27 products summed in float32 from
0 in the order (dz, dy, dx) and rounded once to x's dtype, as `_dw_kernel`
does. Stride 1 is the depthwise layer of MobileNetASPP's stride-1 inverted
residuals and of LR-ASPP's stride-1 3x3x3 rows; stride 2 is block 5's and
LR-ASPP's stride-2 3x3x3 rows, which the JAX package computes with XLA's
grouped convolution (`nn.Conv(strides=2, padding=1,
feature_group_count=C)`: torch's `padding=1, stride=2`, ceil(n/2) outputs
at odd and even n alike, not flax's "SAME").

`depthwise_conv3_cuda` launches the kernel for a CUDA tensor and runs
`depthwise_conv3_plain` for a CPU tensor; there is no fallback from one to
the other. Both round every operation identically (no FMA contraction on
either side), so they agree bit for bit. Why the kernel is shaped as it is,
and what bounds it: see the head of csrc/depthwise.cu.

The gradient (float32 only, as the CNN trains; a bfloat16 backward raises).
Where autograd records, the wrapper runs `_DepthwiseConv3`, whose backward
computes
  * dgrad: dx = K6(dy, w[::-1, ::-1, ::-1, :]) at stride 1, the forward
    kernel itself with the taps flipped; at stride 2 the same on dy
    stuffed (`stuff`: dy[o] written at position 2o of a zero tensor of x's
    shape), since dx[i] = sum_t w[t] dy[(i+1-t)/2] over the even i+1-t.
    Bit-equal to the plain version on the same (stuffed) input;
  * wgrad: dw[dz, dy, dx, c] = sum_{b, z, y, x} x[b, s z+dz-1, s y+dy-1,
    s x+dx-1, c] * dy[b, z, y, x, c], out-of-range taps zero, by the
    hand-written kernel `fseg_depthwise_wgrad` (csrc/depthwise.cu) on a
    card, `depthwise_conv3_wgrad_plain` (27 shifted products, each reduced
    with `sum`) on the CPU. The kernel sums in another order than the
    plain version; `wgrad_plan` gives its depth, and the result lies within
    gamma_depth * sum |x dy| of the exact sum.
The JAX package computes these layers with XLA's grouped convolution and
has no Pallas backward, so the backward is held against XLA's gradient
(tests/test_torch_cnn_train.py). Launches are counted by role:
``depthwise_conv3_cuda.roles`` {"forward" (stride 1), "stride2" (the
stride-2 forward), "dgrad" (both strides': each a stride-1 launch)}, a
checkpoint's recomputation counting as a forward; the wgrad kernel's in
``depthwise_conv3_wgrad_cuda.launches`` and, the same way,
``depthwise_conv3_wgrad_cuda.roles`` {"stride1", "stride2"}.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STRIDES = (1, 2)


def out_shape(shape, stride: int = 1) -> tuple:
    """The output's (B, ceil(D/s), ceil(H/s), ceil(W/s), C) for x of
    `shape` at stride s."""
    b, d, h, w, c = shape
    return (b, *(-(-n // stride) for n in (d, h, w)), c)


def depthwise_conv3_plain(x: torch.Tensor, w: torch.Tensor,
                          stride: int = 1) -> torch.Tensor:
    """Plain PyTorch K6: pad once with zeros, then 27 shifted
    multiply-adds in float32 in the order (dz, dy, dx); at stride 2 the
    stride-1 result at every other output (exact: each output is computed
    on its own).

    :param x: (B, D, H, W, C) float32 or bfloat16
    :param w: (3, 3, 3, C), x's dtype
    :param stride: 1 or 2
    :return: `out_shape(x.shape, stride)`, x's dtype
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
    if stride == 2:
        acc = acc[:, ::2, ::2, ::2]
    return acc.to(x.dtype)


def _check_stride(stride: int) -> None:
    if stride not in STRIDES:
        raise ValueError(f"depthwise_conv3: stride must be 1 or 2, got "
                         f"{stride!r}")


def _check(x: torch.Tensor, w: torch.Tensor, stride: int) -> None:
    _check_stride(stride)
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


def _k6(x: torch.Tensor, w: torch.Tensor, role: str,
        stride: int = 1) -> torch.Tensor:
    """One K6 call, no autograd: the kernel on a card (counted under
    `role`), the plain version on the CPU."""
    if x.device.type == "cpu":
        return depthwise_conv3_plain(x, w, stride)
    if not x.is_cuda:
        raise ValueError(f"depthwise_conv3: unsupported device {x.device}")
    from ._build import load
    lib = load()
    out = torch.empty(out_shape(x.shape, stride), dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fseg_depthwise_conv3(x.data_ptr(), w.data_ptr(),
                                       out.data_ptr(), *x.shape, stride,
                                       _DTYPES[x.dtype],
                                       ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"depthwise_conv3 kernel launch failed: "
                           f"cudaError_t {err}")
    depthwise_conv3_cuda.launches += 1
    depthwise_conv3_cuda.roles[role] += 1
    return out


def stuff(gy: torch.Tensor, shape) -> torch.Tensor:
    """gy (B, ceil(D/2), ceil(H/2), ceil(W/2), C) written at the even
    positions of a zero tensor of x's `shape`: the stride-2 dgrad's input
    to the stride-1 K6 (one write at x's size)."""
    z = gy.new_zeros(shape)
    z[:, ::2, ::2, ::2] = gy
    return z


def depthwise_conv3_dgrad(gy: torch.Tensor, w: torch.Tensor,
                          stride: int = 1, shape=None) -> torch.Tensor:
    """dx of K6: K6 at stride 1 with the taps flipped, on the output
    gradient (stride 1) or on it stuffed to x's `shape` (stride 2)."""
    if stride == 2:
        gy = stuff(gy, shape)
    return _k6(gy, w.flip((0, 1, 2)).contiguous(), "dgrad")


class _DepthwiseConv3(torch.autograd.Function):
    """K6 with its backward: dgrad through K6, wgrad through its own
    kernel (float32 only)."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return _k6(x, w, "forward" if stride == 1 else "stride2", stride)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        if x.dtype != torch.float32:
            raise TypeError(f"depthwise_conv3: the backward is float32 "
                            f"only, got {x.dtype}")
        gy = gy.contiguous()
        dx = depthwise_conv3_dgrad(gy, w, ctx.stride, x.shape) \
            if ctx.needs_input_grad[0] else None
        dw = depthwise_conv3_wgrad_cuda(x, gy, ctx.stride) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None


def depthwise_conv3_cuda(x: torch.Tensor, w: torch.Tensor,
                         stride: int = 1) -> torch.Tensor:
    """K6 on the input's device: the CUDA kernel for a CUDA tensor,
    `depthwise_conv3_plain` for a CPU tensor; differentiable (float32)
    where autograd records. Each kernel launch adds one to
    ``depthwise_conv3_cuda.launches`` and to its role's count in
    ``depthwise_conv3_cuda.roles``.

    :param x: (B, D, H, W, C) float32 or bfloat16, contiguous
    :param w: (3, 3, 3, C), x's dtype, contiguous
    :param stride: 1 or 2
    :return: `out_shape(x.shape, stride)`, x's dtype
    """
    _check(x, w, stride)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if x.dtype != torch.float32:
            raise TypeError(f"depthwise_conv3: the backward is float32 "
                            f"only, got {x.dtype}")
        return _DepthwiseConv3.apply(x, w, stride)
    return _k6(x, w, "forward" if stride == 1 else "stride2", stride)


depthwise_conv3_cuda.launches = 0
depthwise_conv3_cuda.roles = {"forward": 0, "stride2": 0, "dgrad": 0}


# ---- the weight gradient --------------------------------------------------

class WgradPlan(NamedTuple):
    """The wgrad kernel's launch: `tiled` (the tiled kernel, else the
    simple one), `run` (g planes a D run, or g rows (b, z, y) a block),
    `n_parts` (rows of the partial workspace) and `depth` (the roundings a
    term passes through at most)."""
    tiled: bool
    run: int
    n_parts: int
    depth: int


def depthwise_conv3_wgrad_plain(x: torch.Tensor, gy: torch.Tensor,
                                stride: int = 1) -> torch.Tensor:
    """Plain PyTorch wgrad: pad x once with zeros, then for each tap
    (dz, dy, dx) the product of the shifted (and at stride 2 subsampled) x
    with gy, reduced with `sum` over (B, D, H, W), in x's dtype (float32,
    or float64 for the oracle).

    :param x: (B, D, H, W, C)
    :param gy: `out_shape(x.shape, stride)`, x's dtype
    :return: (3, 3, 3, C), x's dtype
    """
    _, d, h, ww, _ = gy.shape
    s = stride
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    taps = [(xp[:, dz:dz + s * (d - 1) + 1:s, dy:dy + s * (h - 1) + 1:s,
                dx:dx + s * (ww - 1) + 1:s, :] * gy).sum((0, 1, 2, 3))
            for dz in range(3) for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, 3, x.shape[-1])


def wgrad_plan(shape, stride: int = 1, aligned: bool = True) -> WgradPlan:
    """The wgrad kernel's launch for x of `shape` at `stride`, x and gy
    16-byte aligned or not (`aligned`), as csrc/depthwise.cu plans it
    (fseg_depthwise_wgrad_plan, which owns the tiles and the split: the
    tiled kernel where the channel rows are 16-byte multiples and x and gy
    aligned, its D split into runs until the blocks fill the card; else the
    simple kernel over runs of g's rows). Raises without a card."""
    _check_stride(stride)
    from ._build import load
    out = (ctypes.c_longlong * 4)()
    err = load().fseg_depthwise_wgrad_plan(*shape, stride, int(aligned), out)
    if err != 0:
        raise ValueError(f"depthwise_conv3_wgrad: no plan for x "
                         f"{tuple(shape)} at stride {stride}: cudaError_t "
                         f"{err}")
    return WgradPlan(bool(out[0]), *out[1:])


def gamma(depth: int) -> float:
    """gamma_n = n u / (1 - n u) of float32 (u = 2^-24): the relative
    bound of a sum whose terms each pass through n roundings."""
    u = 2.0 ** -24
    return depth * u / (1 - depth * u)


def depthwise_conv3_wgrad_cuda(x: torch.Tensor, gy: torch.Tensor,
                               stride: int = 1) -> torch.Tensor:
    """wgrad on the input's device: the kernel for CUDA tensors (each
    launch of its two passes adds one to
    ``depthwise_conv3_wgrad_cuda.launches`` and to
    ``depthwise_conv3_wgrad_cuda.roles[f"stride{stride}"]``),
    `depthwise_conv3_wgrad_plain` for CPU tensors.

    :param x: (B, D, H, W, C) float32, contiguous
    :param gy: `out_shape(x.shape, stride)` float32, contiguous
    :param stride: 1 or 2
    :return: (3, 3, 3, C) float32
    """
    _check_stride(stride)
    if x.dtype != torch.float32 or gy.dtype != torch.float32:
        raise TypeError(f"depthwise_conv3_wgrad: float32 only, got "
                        f"{x.dtype} and {gy.dtype}")
    if x.ndim != 5 or tuple(gy.shape) != out_shape(x.shape, stride):
        raise ValueError(f"depthwise_conv3_wgrad: x must be (B, D, H, W, "
                         f"C) and gy the output's shape at stride {stride}; "
                         f"got x {tuple(x.shape)}, gy {tuple(gy.shape)}")
    if x.numel() == 0:
        raise ValueError(f"depthwise_conv3_wgrad: empty x {tuple(x.shape)}")
    if not (x.is_contiguous() and gy.is_contiguous()):
        raise ValueError("depthwise_conv3_wgrad: x and gy must be contiguous")
    if x.device != gy.device:
        raise ValueError("depthwise_conv3_wgrad: x and gy on different "
                         "devices")
    if x.device.type == "cpu":
        return depthwise_conv3_wgrad_plain(x, gy, stride)
    if not x.is_cuda:
        raise ValueError(f"depthwise_conv3_wgrad: unsupported device "
                         f"{x.device}")
    from ._build import load
    lib = load()
    c = x.shape[-1]
    plan = wgrad_plan(x.shape, stride, (x.data_ptr() | gy.data_ptr()) % 16
                      == 0)
    dw = torch.empty((3, 3, 3, c), dtype=torch.float32, device=x.device)
    part = torch.empty((plan.n_parts, 27, c), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fseg_depthwise_wgrad(x.data_ptr(), gy.data_ptr(),
                                       dw.data_ptr(), part.data_ptr(),
                                       *x.shape, stride, plan.n_parts,
                                       ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"depthwise_conv3_wgrad kernel launch failed: "
                           f"cudaError_t {err}")
    depthwise_conv3_wgrad_cuda.launches += 1
    depthwise_conv3_wgrad_cuda.roles[f"stride{stride}"] += 1
    return dw


depthwise_conv3_wgrad_cuda.launches = 0
depthwise_conv3_wgrad_cuda.roles = {"stride1": 0, "stride2": 0}
