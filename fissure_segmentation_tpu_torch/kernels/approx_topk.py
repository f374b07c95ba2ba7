"""The approximate top-k's bin pass — wrapper of csrc/approx_topk.cu and its
plain PyTorch version.

No TPU kernel is replaced: the JAX package's approximate selections
(`lax.approx_max_k` in keypoints/foerstner.py and keypoints/extraction.py,
`lax.approx_min_k` in ops/knn.py's `recall_target` path) are XLA's
ApproxTopK, which the TPU runs as a PartialReduce. This is its first stage:
rows of n scores are split into L bins, element i into bin i mod L (the row
padded to L * R with -inf for the maximum, +inf for the minimum, read as an
(R, L) matrix and reduced over its first axis), and each bin keeps its
extremum and the index of that value's first occurrence. ops/approx_topk.py
chooses L and R and takes the exact top-k of the winners.

`bin_extrema` launches the kernel for a CUDA tensor and runs
`bin_extrema_plain` for a CPU tensor; there is no fallback from one to the
other. The scores must hold no NaN (the kernel never lets a NaN replace a
winner, `argmax` would pick it): the callers' scores are finite or +-inf.
The kernel stores each winner's own bits, so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

DTYPES = (torch.float32, torch.bfloat16)


def bin_extrema_plain(x: torch.Tensor, n_bins: int, reduction: int,
                      largest: bool = True):
    """Each bin's extremum and its first index, by a reshape.

    :param x: (rows, n) float32 or bfloat16, n <= n_bins * reduction
    :param n_bins: L; :param reduction: R = 2^r, the elements a bin holds
    :return: (vals (rows, L) in x's dtype, idx (rows, L) int32 row indices)
    """
    rows, n = x.shape
    pad = n_bins * reduction - n
    if pad < 0:
        raise ValueError(f"bin_extrema: {n} scores exceed {n_bins} bins of "
                         f"{reduction}")
    if pad:
        fill = -torch.inf if largest else torch.inf
        x = torch.cat([x, x.new_full((rows, pad), fill)], dim=1)
    xr = x.reshape(rows, reduction, n_bins)
    j = (xr.argmax(dim=1) if largest else xr.argmin(dim=1))[:, None]
    vals = xr.gather(1, j)[:, 0]
    bins = torch.arange(n_bins, device=x.device)
    return vals, (j[:, 0] * n_bins + bins).to(torch.int32)


def _check(x: torch.Tensor, n_bins: int, reduction: int) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"bin_extrema: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"bin_extrema: x must be (rows, n), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("bin_extrema: x must be contiguous")
    rows, n = x.shape
    if rows < 1 or n < 1 or n >= 2 ** 31:
        raise ValueError(f"bin_extrema: shape {tuple(x.shape)} outside "
                         "1 <= rows, 1 <= n < 2^31")
    if n_bins < 1 or reduction < 1 or n_bins * reduction < n:
        raise ValueError(f"bin_extrema: {n} scores exceed {n_bins} bins of "
                         f"{reduction}")


def bin_extrema(x: torch.Tensor, n_bins: int, reduction: int,
                largest: bool = True):
    """The bin pass on x's device: the CUDA kernel for a CUDA tensor,
    `bin_extrema_plain` for a CPU tensor. Each kernel launch adds one to
    ``bin_extrema.launches`` and to ``bin_extrema.calls`` under
    "{rows}x{n}_L{L}_{dtype}".

    :param x: (rows, n) float32 or bfloat16, contiguous
    :return: (vals (rows, L) in x's dtype, idx (rows, L) int32)
    """
    _check(x, n_bins, reduction)
    if x.device.type == "cpu":
        return bin_extrema_plain(x, n_bins, reduction, largest)
    if not x.is_cuda:
        raise ValueError(f"bin_extrema: unsupported device {x.device}")
    from ._build import load
    lib = load()
    rows, n = x.shape
    vals = torch.empty((rows, n_bins), dtype=x.dtype, device=x.device)
    idx = torch.empty((rows, n_bins), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fseg_bin_extrema(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, n, n_bins,
            reduction, int(largest), int(x.dtype == torch.bfloat16),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"bin_extrema kernel launch failed: cudaError_t "
                           f"{err}")
    bin_extrema.launches += 1
    key = f"{rows}x{n}_L{n_bins}_{str(x.dtype).removeprefix('torch.')}"
    bin_extrema.calls[key] = bin_extrema.calls.get(key, 0) + 1
    return vals, idx


bin_extrema.launches = 0
bin_extrema.calls = {}
