"""Fused single-layer EdgeConv (counterpart of ops/fused_edge.py): gather ->
+center -> BatchNorm -> LeakyReLU -> max over k without the (B, N, k, C)
edge tensor in the backward.

Per channel the pointwise tail is monotone in the gathered feature
(increasing iff the BatchNorm scale gamma_c >= 0), so the max over k of the
activation is the tail of the max (or, for gamma_c < 0, the min) of the
gathered features, and the exact train-mode BatchNorm statistics come from
per-(n, c) sums and sums of squares. The backward routes dL/dout to ONE edge
per (n, c) — the FIRST extremal slot (`torch.argmax`/`argmin` return the
first occurrence, like `jnp.argmax`) — plus two dense per-channel BatchNorm
terms, whose gather transpose is K3 (kernels/scatter.py:scatter_routed) and
a degree-weighted pointwise term with the in-degree from K4
(scatter_count). The derivation is in the JAX module's docstring.

The forward's gather-reduce (per-(n, c) max, min, their first slots, and
the f32 sum and sum of squares over k) is `kernels/gather_reduce.py`: one
CUDA kernel for CUDA tensors (the counterpart of the Pallas probe
scripts/prof/prof_fused_gather.py, P5), its plain version for CPU tensors;
the (B, N, k, C) neighbour tensor is never built on the card. `a` and `cen`
may be float32 or bfloat16 (the bf16 compute dtype); the statistics are
float32 and the output is in a's dtype, as in the JAX package.

`fused_edge_enabled` reads FSEG_FUSED_EDGE=1/0 at every EdgeConv call, like
the JAX package. Without it the fused route is off on the CPU (as off-TPU
in the JAX package) and, on CUDA, set by `CUDA_DEFAULT`, for training and
eval alike: on an H100 the fused route was faster both in the canonical
DGCNNSeg train step (B=32, N=2048, k=40, f32) and in the serving
ensemble's eval forwards (PERF.md, the fused-or-unfused measurements).
"""
from __future__ import annotations

import os

import torch

from ..kernels.gather_reduce import gather_reduce
from ..kernels.scatter import scatter_count, scatter_routed

_ENV_FLAG = "FSEG_FUSED_EDGE"
CUDA_DEFAULT = True


def fused_edge_enabled(device) -> bool:
    """Route single-layer EdgeConvs through the fused core on `device`?"""
    env = os.environ.get(_ENV_FLAG)
    if env is not None:
        return env not in ("0", "false", "False")
    return torch.device(device).type == "cuda" and CUDA_DEFAULT


def _gather_reduce(a: torch.Tensor, idx: torch.Tensor):
    """One pass over the gathered features -> per-(n, c) max, min, argmax,
    argmin (first occurrence, int32), and the f32 sum and sum of squares."""
    return gather_reduce(a.contiguous(), idx.to(torch.int32).contiguous(),
                         "all")


def _stats(s1, s2, cen, kk: int):
    """Exact BatchNorm train statistics over the virtual (B, N, k) edge set
    (flax semantics: f32, fast variance, clipped at 0)."""
    cenf = cen.to(torch.float32)
    e_tot = s1.shape[0] * s1.shape[1] * kk
    mean = (s1.sum((0, 1)) + kk * cenf.sum((0, 1))) / e_tot
    ez2 = (s2.sum((0, 1)) + 2.0 * (cenf * s1).sum((0, 1))
           + kk * (cenf * cenf).sum((0, 1))) / e_tot
    var = torch.clamp(ez2 - mean * mean, min=0.0)
    return mean, var


def _tail(sel, cen, mean, sigma, gamma, beta):
    """The pointwise tail at the routed edge: (pre-activation u, xhat)."""
    xhat = ((sel + cen).to(torch.float32) - mean) / sigma
    return gamma * xhat + beta, xhat


class _FusedEdgeTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, cen, gamma, beta, idx, eps, slope):
        kk = idx.shape[-1]
        mx, mn, am, amn, s1, s2 = _gather_reduce(a, idx)
        mean, var = _stats(s1, s2, cen, kk)
        sigma = torch.sqrt(var + eps)
        pos = gamma >= 0
        sel = torch.where(pos, mx, mn)
        kstar = torch.where(pos, am, amn)
        u, _ = _tail(sel, cen, mean, sigma, gamma, beta)
        out = torch.where(u >= 0, u, slope * u).to(a.dtype)
        ctx.save_for_backward(a, cen, gamma, beta, idx, sel, kstar, s1, mean,
                              sigma)
        ctx.slope = slope
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        a, cen, gamma, beta, idx, sel, kstar, s1, mean, sigma = \
            ctx.saved_tensors
        b, n, kk = idx.shape
        c = a.shape[-1]
        e_tot = b * n * kk
        u, xhat_star = _tail(sel, cen, mean, sigma, gamma, beta)
        du = g.to(torch.float32) * torch.where(u >= 0, 1.0, ctx.slope)

        dbeta = du.sum((0, 1))
        dgamma = (du * xhat_star).sum((0, 1))
        # the BatchNorm train backward means over the virtual edge set
        # collapse to (B, N, C) reductions (dxhat is nonzero only at kstar)
        mean_dxh = gamma * dbeta / e_tot                  # E[dxhat]
        mean_dxh_xh = gamma * dgamma / e_tot              # E[dxhat * xhat]
        cenf = cen.to(torch.float32)

        s_payload = (gamma * du / sigma).to(a.dtype)
        p_payload = (-mean_dxh / sigma - (mean_dxh_xh / (sigma * sigma))
                     * (cenf - mean)).to(a.dtype)
        idx32 = idx.to(torch.int32).contiguous()
        routed = scatter_routed(idx32, kstar.contiguous(),
                                s_payload.contiguous(),
                                p_payload.contiguous(), n)
        deg = scatter_count(idx32.reshape(b, n * kk), n)
        da = (routed[..., :c] + routed[..., c:]
              - (mean_dxh_xh / (sigma * sigma)) * deg[..., None]
              * a.to(torch.float32))

        sum_xh_k = (s1 + kk * (cenf - mean)) / sigma
        dcen = (gamma * du - kk * mean_dxh - mean_dxh_xh * sum_xh_k) / sigma
        return (da.to(a.dtype), dcen.to(cen.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), None, None, None)


def fused_edge_train(a: torch.Tensor, cen: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, idx: torch.Tensor, eps: float,
                     slope: float):
    """Train-mode fused EdgeConv core.

    :param a: (B, N, C) neighbor-projected features (``x @ w_d``)
    :param cen: (B, N, C) center-projected features (``x @ (w_c - w_d)``)
    :param gamma: (C,) BatchNorm scale; :param beta: (C,) BatchNorm bias
    :param idx: (B, N, K) int neighbor indices (no gradient)
    :return: (out (B, N, C) in a.dtype, batch mean (C,) f32, batch var (C,)
        f32) — mean and var feed the running-statistics update and take no
        gradient
    """
    return _FusedEdgeTrain.apply(a, cen, gamma, beta, idx, eps, slope)


def fused_edge_eval(a, cen, gamma, beta, ra_mean, ra_var, idx,
                    eps: float, slope: float) -> torch.Tensor:
    """Eval-mode fused EdgeConv core: normalize with the running statistics,
    so the layer is the gather-reduce (max and min) plus (B, N, C)
    pointwise math. No gradient: call it under torch.no_grad() (the
    gather-reduce raises where autograd would record through it)."""
    mx, mn = gather_reduce(a.contiguous(), idx.to(torch.int32).contiguous(),
                           "extrema")
    sel = torch.where(gamma >= 0, mx, mn)
    sigma = torch.sqrt(ra_var + eps)
    u = gamma * (((sel + cen).to(torch.float32) - ra_mean) / sigma) + beta
    return torch.where(u >= 0, u, slope * u).to(a.dtype)
