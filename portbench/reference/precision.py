"""The lower precisions a reference computation can run at.

`rounded(x, quant)`: None keeps float32; "bfloat16" rounds to bfloat16;
"float8" rounds to float8 e4m3 with one scale a tensor (its largest
magnitude mapped to e4m3's largest finite value, 448, as a scaled fp8
product would take it). The value stays float32; in a backward pass the
gradient flowing back through it is rounded the same way, so a training
step computes both passes at that precision.
TF32, the control of a float32 configuration, is not emulated: the
reference then runs with `torch.backends.{cuda.matmul,cudnn}.allow_tf32`
on (reference/serving.py).
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _round(x: torch.Tensor, quant: str) -> torch.Tensor:
    if quant == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    if quant == "float8":
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = E4M3_MAX / amax
        return ((x * scale).to(torch.float8_e4m3fn).to(x.dtype)) / scale
    raise ValueError(f"unknown precision {quant!r}")


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, quant):
        ctx.quant = quant
        return _round(x, quant)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, ctx.quant), None


def rounded(x: torch.Tensor, quant: str | None) -> torch.Tensor:
    if quant is None:
        return x
    return _Rounded.apply(x, quant)
