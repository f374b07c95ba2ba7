"""K5: masked farthest-point sampling — wrapper of csrc/fps.cu and its plain
PyTorch version.

Replaces fissure_segmentation_tpu/ops/pallas/fps.py:fps_pallas. For points
(B, N, C) float32 with C <= 8 and a validity mask (B, N) it returns (B, m)
int32 indices: the first valid point (0 if none is valid), then m - 1 times
the first index of the largest score, where score = valid ? min_d : -inf and
min_d is each point's running minimum of d = sum_c (p_c - p_last,c)^2,
summed in channel order. With fewer valid points than m the selections
repeat.

`fps_cuda` launches the kernel for a CUDA tensor and runs `fps_plain` for a
CPU tensor; there is no fallback from one to the other. Both round every
operation identically (no FMA contraction on either side), so they agree
bit for bit, ties included. Why the kernel is shaped as it is, and what
bounds it: see the head of csrc/fps.cu.
"""
from __future__ import annotations

import ctypes

import torch

MAX_C = 8              # csrc/fps.cu FPS_MAX_C
MAX_N = 32 * 1024      # csrc/fps.cu: a cluster of 8 blocks holds 32768


def fps_plain(points: torch.Tensor, m: int,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K5: m - 1 steps of distance update and first-occurrence
    `torch.argmax`, one batch of small launches per step.

    :param points: (B, N, C) float32
    :param valid: optional (B, N) bool
    :return: (B, m) int32
    """
    b, n, c = points.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=points.device)
    last = valid.to(torch.uint8).argmax(-1)
    out = [last]
    min_d = torch.full((b, n), float("inf"), device=points.device)
    neg = torch.tensor(float("-inf"), device=points.device)
    for _ in range(m - 1):
        lp = points.gather(1, last[:, None, None].expand(b, 1, c))
        d = None
        for ch in range(c):
            diff = points[..., ch] - lp[..., ch]
            sq = diff * diff
            d = sq if d is None else d + sq
        min_d = torch.minimum(min_d, d)
        last = torch.where(valid, min_d, neg).argmax(-1)
        out.append(last)
    return torch.stack(out, -1).to(torch.int32)


def _check(points: torch.Tensor, m: int, valid: torch.Tensor | None) -> None:
    if points.dtype != torch.float32:
        raise TypeError(f"fps: points must be float32, got {points.dtype}")
    if points.ndim != 3:
        raise ValueError(f"fps: points must be (B, N, C), got "
                         f"{tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError("fps: points must be contiguous")
    b, n, c = points.shape
    if not 1 <= c <= MAX_C:
        raise ValueError(f"fps: C={c} outside 1..{MAX_C}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"fps: N={n} outside 1..{MAX_N}")
    if m < 1:
        raise ValueError(f"fps: m={m} < 1")
    if valid is not None:
        if valid.dtype != torch.bool or tuple(valid.shape) != (b, n):
            raise ValueError(f"fps: valid must be ({b}, {n}) bool, got "
                             f"{tuple(valid.shape)} {valid.dtype}")
        if valid.device != points.device:
            raise ValueError("fps: points and valid on different devices")


def fps_cuda(points: torch.Tensor, m: int,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """K5 on the points' device: the CUDA kernel for a CUDA tensor,
    `fps_plain` for a CPU tensor. Each kernel launch adds one to
    ``fps_cuda.launches`` and to ``fps_cuda.calls`` under
    "{B}x{N}x{C}_m{m}".

    :param points: (B, N, C) float32, contiguous, C <= 8, N <= 32768
    :param valid: optional (B, N) bool
    :return: (B, m) int32
    """
    _check(points, m, valid)
    if points.device.type == "cpu":
        return fps_plain(points, m, valid)
    if not points.is_cuda:
        raise ValueError(f"fps: unsupported device {points.device}")
    from ._build import load
    lib = load()
    b, n, c = points.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=points.device)
    flags = valid.contiguous().view(torch.uint8)
    out = torch.empty((b, m), dtype=torch.int32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.fseg_fps_f32(points.data_ptr(), flags.data_ptr(),
                               out.data_ptr(), b, n, c, m,
                               ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fps kernel launch failed: cudaError_t {err}")
    fps_cuda.launches += 1
    key = f"{b}x{n}x{c}_m{m}"
    fps_cuda.calls[key] = fps_cuda.calls.get(key, 0) + 1
    return out


fps_cuda.launches = 0
fps_cuda.calls = {}
