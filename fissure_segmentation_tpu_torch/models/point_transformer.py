"""PointTransformer segmentation network (counterpart of
models/point_transformer.py); `.train()` for the train step, `.eval()` for
inference.

A 5-stage encoder with farthest-point downsampling (ops/fps.py, K5 for CUDA
tensors), vector self-attention over nsample neighbours with positional
encoding and share_planes grouping, and a symmetric decoder with
inverse-distance interpolation (ops/pointops.py). Submodules carry flax's
auto-names in call order (`Dense_0`, `BatchNorm_0`, `TransitionDown_0`,
`PointTransformerBlock_12`, ...), so models/weights.py maps a JAX tree onto
them one to one. BatchNorm is models/blocks.py's (flax semantics); the
attention softmax runs over the neighbour axis in float32; the max-pool of
TransitionDown is `amax`, which splits the gradient among ties like
`jnp.max`.

`dtype=torch.bfloat16` (or "bfloat16") is the JAX model's compute dtype:
parameters stay float32; every Dense casts its input and parameters to
bf16 and every BatchNorm (float32 statistics) gives its output in bf16,
as flax's `Dense(dtype=)` and `BatchNorm(dtype=)` do, while coordinates,
FPS (K5), `knn_query`, the grouping offsets, the attention softmax, the
stage outputs and the logits' Dense stay float32, cast where the JAX
module casts them. None or float32 computes in float32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fps import farthest_point_sampling
from ..ops.pointops import interpolate, knn_query, query_and_group
from .blocks import BatchNorm, _dense
from .pointnet import _check_dtype


def _linear(lin: nn.Linear, x: torch.Tensor, dt=None) -> torch.Tensor:
    """flax Dense(dtype=dt): input, kernel and bias cast to dt (None: as
    they are)."""
    if dt is None:
        return F.linear(x, lin.weight, lin.bias)
    bias = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), bias)


def _bn(bn: BatchNorm, x: torch.Tensor, dt=None) -> torch.Tensor:
    """flax BatchNorm(dtype=dt): float32 statistics, the output in dt."""
    y = bn(x)
    return y if dt is None else y.to(dt)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


class PointTransformerLayer(nn.Module):
    """Vector self-attention among nsample neighbours (seg_model.py:17-53)."""

    def __init__(self, planes: int, share_planes: int = 8, nsample: int = 16,
                 generator: torch.Generator | None = None, dtype=None):
        super().__init__()
        c, s, g = planes, share_planes, generator
        self.share_planes, self.nsample, self.dtype = s, nsample, dtype
        self.Dense_0 = _dense(c, c, True, g)        # query
        self.Dense_1 = _dense(c, c, True, g)        # key
        self.Dense_2 = _dense(c, c, True, g)        # value
        self.Dense_3 = _dense(3, 3, True, g)        # positional encoding
        self.BatchNorm_0 = BatchNorm(3)
        self.Dense_4 = _dense(3, c, True, g)
        self.BatchNorm_1 = BatchNorm(c)             # linear_w
        self.Dense_5 = _dense(c, c // s, True, g)
        self.BatchNorm_2 = BatchNorm(c // s)
        self.Dense_6 = _dense(c // s, c // s, True, g)

    def forward(self, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x_q = _linear(self.Dense_0, x, dt)
        x_k = _linear(self.Dense_1, x, dt)
        x_v = _linear(self.Dense_2, x, dt)
        idx, _ = knn_query(p, p, self.nsample)
        # the float32 offsets promote the grouped keys to float32 (as
        # jnp.concatenate does)
        k_grp, _ = query_and_group(p, p, x_k, self.nsample, idx=idx)
        v_grp, _ = query_and_group(p, p, x_v, self.nsample, idx=idx,
                                   use_xyz=False)
        p_r, x_k = k_grp[..., :3], k_grp[..., 3:]
        pe = F.relu(_bn(self.BatchNorm_0, _linear(self.Dense_3, p_r, dt),
                        dt))
        pe = _linear(self.Dense_4, pe, dt)                # (B, N, ns, c)
        w = x_k - x_q[..., None, :] + pe
        w = F.relu(_bn(self.BatchNorm_1, w, dt))
        w = F.relu(_bn(self.BatchNorm_2, _linear(self.Dense_5, w, dt), dt))
        w = _linear(self.Dense_6, w, dt)
        w = torch.softmax(_f32(w), dim=-2)                # over neighbours
        b, n, ns, c = v_grp.shape
        s = self.share_planes
        v = _f32(v_grp + pe).reshape(b, n, ns, s, c // s)
        return (v * w[..., None, :]).sum(dim=2).reshape(b, n, c)


class PointTransformerBlock(nn.Module):
    """Residual block (seg_model.py:122-142)."""

    def __init__(self, planes: int, share_planes: int = 8, nsample: int = 16,
                 generator: torch.Generator | None = None, dtype=None):
        super().__init__()
        g = generator
        self.dtype = dtype
        self.Dense_0 = _dense(planes, planes, False, g)
        self.BatchNorm_0 = BatchNorm(planes)
        self.PointTransformerLayer_0 = PointTransformerLayer(
            planes, share_planes, nsample, g, dtype)
        self.BatchNorm_1 = BatchNorm(planes)
        self.Dense_1 = _dense(planes, planes, False, g)
        self.BatchNorm_2 = BatchNorm(planes)

    def forward(self, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = F.relu(_bn(self.BatchNorm_0, _linear(self.Dense_0, x, dt), dt))
        h = self.PointTransformerLayer_0(p, h)
        h = F.relu(_bn(self.BatchNorm_1, h, dt))
        h = _bn(self.BatchNorm_2, _linear(self.Dense_1, h, dt), dt)
        return F.relu(_f32(h) + _f32(x))


class TransitionDown(nn.Module):
    """FPS downsample + local grouping + max-pool (seg_model.py:56-84);
    stride 1 is a point-wise Dense + BatchNorm + ReLU."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 nsample: int = 16, generator: torch.Generator | None = None,
                 dtype=None):
        super().__init__()
        self.stride, self.nsample, self.dtype = stride, nsample, dtype
        fin = in_planes if stride == 1 else 3 + in_planes
        self.Dense_0 = _dense(fin, out_planes, False, generator)
        self.BatchNorm_0 = BatchNorm(out_planes)

    def forward(self, p: torch.Tensor, x: torch.Tensor):
        dt = self.dtype
        if self.stride == 1:
            return p, _f32(F.relu(_bn(self.BatchNorm_0,
                                      _linear(self.Dense_0, x, dt), dt)))
        b, n, _ = p.shape
        idx = farthest_point_sampling(p, n // self.stride).to(torch.int64)
        new_p = torch.gather(p, 1, idx[..., None].expand(-1, -1, 3))
        grouped, _ = query_and_group(p, new_p, x, self.nsample)
        h = F.relu(_bn(self.BatchNorm_0, _linear(self.Dense_0, grouped, dt),
                       dt))
        return new_p, _f32(h.amax(dim=-2))


class TransitionUp(nn.Module):
    """Interpolation upsample + skip fusion (seg_model.py:87-118).

    `out_planes=None` is the summit head (per-cloud mean mixed back in) on
    `in_planes` channels; otherwise x1 (`in_planes`) and the coarser x2
    (`coarse_planes`) are projected to `out_planes` and summed."""

    def __init__(self, in_planes: int, out_planes: int | None = None,
                 coarse_planes: int | None = None,
                 generator: torch.Generator | None = None, dtype=None):
        super().__init__()
        g = generator
        self.dtype = dtype
        self.summit = out_planes is None
        if self.summit:
            c = in_planes
            self.Dense_0 = _dense(c, c, True, g)
            self.Dense_1 = _dense(2 * c, c, True, g)
            self.BatchNorm_0 = BatchNorm(c)
        else:
            self.Dense_0 = _dense(in_planes, out_planes, True, g)
            self.BatchNorm_0 = BatchNorm(out_planes)
            self.Dense_1 = _dense(coarse_planes, out_planes, True, g)
            self.BatchNorm_1 = BatchNorm(out_planes)

    def forward(self, p1, x1, p2=None, x2=None):
        dt = self.dtype
        if self.summit:
            g = F.relu(_linear(self.Dense_0, x1.mean(dim=-2, keepdim=True),
                               dt))
            h = torch.cat([x1.to(g.dtype),
                           g.expand(*x1.shape[:-1], g.shape[-1])], -1)
            return _f32(F.relu(_bn(self.BatchNorm_0,
                                   _linear(self.Dense_1, h, dt), dt)))
        h1 = _f32(F.relu(_bn(self.BatchNorm_0, _linear(self.Dense_0, x1, dt),
                             dt)))
        h2 = _f32(F.relu(_bn(self.BatchNorm_1, _linear(self.Dense_1, x2, dt),
                             dt)))
        return h1 + interpolate(p2, p1, h2)


class PointTransformerSeg(nn.Module):
    """(seg_model.py:145-211 + PointTransformerCompatibility:215-231).

    Input (B, N, in_features) with coords first; returns (B, N,
    num_classes) logits."""

    def __init__(self, in_features: int, num_classes: int,
                 blocks: Sequence[int] = (2, 3, 4, 6, 3),
                 planes: Sequence[int] = (32, 64, 128, 256, 512),
                 strides: Sequence[int] = (1, 4, 4, 4, 4),
                 nsamples: Sequence[int] = (8, 16, 16, 16, 16),
                 share_planes: int = 8, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dt = _check_dtype(dtype, type(self).__name__)
        self.config = dict(in_features=in_features, num_classes=num_classes,
                           blocks=list(blocks), planes=list(planes),
                           strides=list(strides), nsamples=list(nsamples),
                           share_planes=share_planes)
        if dt is not None:   # JSON for model.pt
            self.config["dtype"] = str(dt).removeprefix("torch.")
        g = generator
        self.stages = []          # (TransitionDown name, [block names])
        n_blocks, fin = 0, in_features
        for i, (pl, blk, st, ns) in enumerate(zip(planes, blocks, strides,
                                                  nsamples)):
            setattr(self, f"TransitionDown_{i}",
                    TransitionDown(fin, pl, st, ns, g, dt))
            names = []
            for _ in range(1, blk):
                name = f"PointTransformerBlock_{n_blocks}"
                setattr(self, name,
                        PointTransformerBlock(pl, share_planes, ns, g, dt))
                names.append(name)
                n_blocks += 1
            self.stages.append((f"TransitionDown_{i}", names))
            fin = pl
        self.decoder = []         # (TransitionUp name, block name)
        for j, i in enumerate((4, 3, 2, 1, 0)):
            up = (TransitionUp(planes[4], generator=g, dtype=dt) if i == 4
                  else TransitionUp(planes[i], planes[i], planes[i + 1], g,
                                    dt))
            setattr(self, f"TransitionUp_{j}", up)
            name = f"PointTransformerBlock_{n_blocks}"
            setattr(self, name, PointTransformerBlock(
                planes[i], share_planes, nsamples[i], g, dt))
            self.decoder.append((f"TransitionUp_{j}", name))
            n_blocks += 1
        self.Dense_0 = _dense(planes[0], planes[0], True, g)
        self.BatchNorm_0 = BatchNorm(planes[0])
        self.Dense_1 = _dense(planes[0], num_classes, True, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, h = x[..., :3], x
        ps, xs = [], []
        for down, names in self.stages:
            p, h = getattr(self, down)(p, h)
            for name in names:
                h = getattr(self, name)(p, h)
            ps.append(p)
            xs.append(h)
        for j, (up, name) in enumerate(self.decoder):
            i = 4 - j
            if j == 0:
                h = getattr(self, up)(ps[4], xs[4])
            else:
                h = getattr(self, up)(ps[i], xs[i], ps[i + 1], h)
            h = getattr(self, name)(ps[i], h)
        dt = self.dtype
        out = F.relu(_bn(self.BatchNorm_0, _linear(self.Dense_0, h, dt), dt))
        return _linear(self.Dense_1, _f32(out))
