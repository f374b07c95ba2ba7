"""The approximate top-k's kernels — wrappers of csrc/approx_topk.cu and
their plain PyTorch versions.

No TPU kernel is replaced: the JAX package's approximate selections
(`lax.approx_max_k` in keypoints/foerstner.py and keypoints/extraction.py,
`lax.approx_min_k` in ops/knn.py's `recall_target` path) are XLA's
ApproxTopK, which the TPU runs as a PartialReduce, and its exact feature
graph is `lax.top_k`. The algorithm: rows of n scores are split into L
bins, element i into bin i mod L (the row padded to L * R with -inf for
the maximum, +inf for the minimum, read as an (R, L) matrix and reduced
over its first axis); each bin keeps its extremum and the index of that
value's first occurrence; the result is the exact top-k of the L winners
keyed on (value, index). At R = 1 (L = n) it is the exact top-k with
stable ties. ops/approx_topk.py chooses L and R.

Two kernels, each with its plain version:

- `select_rows` (k <= MAX_K): the whole selection in one pass, one warp a
  row keeping the k best winners in registers; k values and indices a row
  come out. Its plain version `select_rows_plain` is `bin_extrema_plain`
  then `aggregate`.
- `bin_extrema` (any k; ops/approx_topk.py takes it for k > MAX_K): every
  bin's winner, which `aggregate` then sorts.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version for a CPU tensor; there is no fallback from one to the other, and
a failed launch raises. The scores must hold no NaN (the kernels never let
a NaN replace a winner, `argmax` would pick it): the callers' scores are
finite or +-inf. -0.0 and +0.0 are one value to the selection, as to the
comparisons of the bin pass. The kernels store each winner's own bits, so
each agrees with its plain version bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

DTYPES = (torch.float32, torch.bfloat16)
MAX_K = 128   # csrc/approx_topk.cu SEL_MAX_K


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


def aggregate(vals: torch.Tensor, idx: torch.Tensor, k: int,
              largest: bool):
    """The exact top-k of the winners keyed on (value, index): values in
    descending order (ascending for the minimum), ties to the lower index.
    The winners come in bin order, so they are put in index order first and
    then sorted by value with a stable sort; -0.0 sorts as +0.0 (`vals +
    0.0`) on every device.

    :param vals: (rows, L) winners; :param idx: (rows, L) their indices
    :return: (values (rows, k) in vals' dtype, indices (rows, k) int64)
    """
    if k > vals.shape[-1]:
        raise ValueError(f"approx_top_k: k={k} exceeds the {vals.shape[-1]} "
                         "bins")
    order = torch.argsort(idx, dim=-1)
    vals, idx = vals.gather(-1, order), idx.gather(-1, order)
    pos = torch.sort(vals + 0.0, dim=-1, descending=largest,
                     stable=True)[1][..., :k]
    return vals.gather(-1, pos), idx.gather(-1, pos).to(torch.int64)


def select_rows_plain(x: torch.Tensor, n_bins: int, reduction: int, k: int,
                      largest: bool = True):
    """The fused row selection by its parts: `bin_extrema_plain`, then
    `aggregate`.

    :return: (values (rows, k) in x's dtype, indices (rows, k) int64)
    """
    return aggregate(*bin_extrema_plain(x, n_bins, reduction, largest), k,
                     largest)


def _check(x: torch.Tensor, n_bins: int, reduction: int,
           name: str = "bin_extrema") -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"{name}: x must be (rows, n), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    rows, n = x.shape
    if rows < 1 or n < 1 or n >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(x.shape)} outside "
                         "1 <= rows, 1 <= n < 2^31")
    if n_bins < 1 or reduction < 1 or n_bins * reduction < n:
        raise ValueError(f"{name}: {n} scores exceed {n_bins} bins of "
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


def select_rows(x: torch.Tensor, n_bins: int, reduction: int, k: int,
                largest: bool = True, index_dtype: torch.dtype = torch.int64):
    """The fused row selection on x's device: the CUDA kernel for a CUDA
    tensor, `select_rows_plain` for a CPU tensor. Each kernel launch adds
    one to ``select_rows.launches`` and to ``select_rows.calls`` under
    "{rows}x{n}_L{L}_k{k}_{dtype}".

    :param x: (rows, n) float32 or bfloat16, contiguous, without NaN
    :param n_bins: L; :param reduction: R, with L * R >= n (R = 1, L = n:
        the exact top-k)
    :param k: 1 <= k <= min(MAX_K, n, L)
    :param index_dtype: torch.int64 or torch.int32
    :return: (values (rows, k) in x's dtype, indices (rows, k)), each row
        ordered by (value, index)
    """
    _check(x, n_bins, reduction, "select_rows")
    rows, n = x.shape
    if not 1 <= k <= min(MAX_K, n, n_bins):
        raise ValueError(f"select_rows: k={k} outside 1 <= k <= "
                         f"min({MAX_K}, {n} scores, {n_bins} bins)")
    if index_dtype not in (torch.int64, torch.int32):
        raise TypeError(f"select_rows: index_dtype {index_dtype}")
    if x.device.type == "cpu":
        vals, idx = select_rows_plain(x, n_bins, reduction, k, largest)
        return vals, idx.to(index_dtype)
    if not x.is_cuda:
        raise ValueError(f"select_rows: unsupported device {x.device}")
    from ._build import load
    lib = load()
    vals = torch.empty((rows, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((rows, k), dtype=index_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fseg_select_rows(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, n, n_bins,
            reduction, k, int(largest), int(x.dtype == torch.bfloat16),
            int(index_dtype == torch.int64), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"select_rows kernel launch failed: cudaError_t "
                           f"{err}")
    select_rows.launches += 1
    key = (f"{rows}x{n}_L{n_bins}_k{k}_"
           f"{str(x.dtype).removeprefix('torch.')}")
    select_rows.calls[key] = select_rows.calls.get(key, 0) + 1
    return vals, idx


select_rows.launches = 0
select_rows.calls = {}
