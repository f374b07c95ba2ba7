"""K1: fused kNN — wrapper of csrc/knn.cu and its plain PyTorch version.

Replaces fissure_segmentation_tpu/ops/pallas/knn.py:knn_pallas. For x
(B, N, C) float32 with C <= 8 it returns, for every point, the kk nearest
points of its own cloud by d = sum_c (q_c - k_c)^2 summed in channel order,
ascending, ties to the lower index; `self_loop=False` computes kk = k + 1
and drops column 0 (the point itself, or a lower-index duplicate of it —
the same rule as knn_pallas).

`knn_cuda` launches the kernel for a CUDA tensor and runs `knn_plain` for a
CPU tensor; there is no fallback from one to the other. The kernel and the
plain version round every operation identically (no FMA contraction on
either side), so they agree bit for bit, ties included. Why the kernel is
shaped as it is, and what bounds it: see the head of csrc/knn.cu.
"""
from __future__ import annotations

import ctypes

import torch

MAX_C = 8      # csrc/knn.cu KNN_MAX_C
MAX_KK = 128   # csrc/knn.cu KNN_MAX_KK


def _kk(k: int, self_loop: bool) -> int:
    return k if self_loop else k + 1


def _finish(idx, dist, self_loop: bool):
    if not self_loop:
        idx, dist = idx[..., 1:], dist[..., 1:]
    return idx, dist


def knn_plain(x: torch.Tensor, k: int, self_loop: bool = False,
              query_chunk: int | None = None):
    """Plain PyTorch K1: materialize the (B, N, N) distances — or, with
    `query_chunk`, (B, query_chunk, N) at a time — and stable-sort them.
    Each distance is the same operations either way, so the chunks select
    exactly what the whole matrix does.

    :param x: (B, N, C) float32
    :return: (idx (B, N, k) int32, dist (B, N, k) float32)
    """
    kk = _kk(k, self_loop)
    n = x.shape[-2]
    if kk > n:
        raise ValueError(f"kk={kk} exceeds N={n}")
    qc = n if query_chunk is None else min(query_chunk, n)
    idx, dist = [], []
    for start in range(0, n, qc):
        q = x[..., start:start + qc, :]
        d = None
        for ch in range(x.shape[-1]):
            diff = q[..., :, None, ch] - x[..., None, :, ch]
            sq = diff * diff
            d = sq if d is None else d + sq
        dc, ic = torch.sort(d, dim=-1, stable=True)
        idx.append(ic[..., :kk].to(torch.int32))
        dist.append(dc[..., :kk])
    return _finish(torch.cat(idx, -2), torch.cat(dist, -2), self_loop)


def _check(x: torch.Tensor, kk: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"knn: x must be float32, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"knn: x must be (B, N, C), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("knn: x must be contiguous")
    b, n, c = x.shape
    if not 1 <= c <= MAX_C:
        raise ValueError(f"knn: C={c} outside 1..{MAX_C}")
    if not 1 <= kk <= MAX_KK:
        raise ValueError(f"knn: kk={kk} outside 1..{MAX_KK}")
    if kk > n:
        raise ValueError(f"knn: kk={kk} exceeds N={n}")


def knn_cuda(x: torch.Tensor, k: int, self_loop: bool = False,
             query_chunk: int | None = None):
    """K1 on x's device: the CUDA kernel for a CUDA tensor, `knn_plain` for
    a CPU tensor. Each kernel launch adds one to ``knn_cuda.launches`` and
    to ``knn_cuda.calls`` under "{B}x{N}x{C}_kk{kk}".

    :param x: (B, N, C) float32, contiguous, C <= 8, kk <= 128
    :param query_chunk: the plain version's rows of distances at a time
        (the kernel keeps no distance matrix, so it ignores it)
    :return: (idx (B, N, k) int32, dist (B, N, k) float32)
    """
    kk = _kk(k, self_loop)
    _check(x, kk)
    if x.device.type == "cpu":
        return knn_plain(x, k, self_loop, query_chunk)
    if not x.is_cuda:
        raise ValueError(f"knn: unsupported device {x.device}")
    from ._build import load
    lib = load()
    b, n, c = x.shape
    idx = torch.empty((b, n, kk), dtype=torch.int32, device=x.device)
    dist = torch.empty((b, n, kk), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fseg_knn_f32(x.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                               b, n, c, kk, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"knn kernel launch failed: cudaError_t {err}")
    knn_cuda.launches += 1
    key = f"{b}x{n}x{c}_kk{kk}"
    knn_cuda.calls[key] = knn_cuda.calls.get(key, 0) + 1
    return _finish(idx, dist, self_loop)


knn_cuda.launches = 0
knn_cuda.calls = {}
