"""The fused EdgeConv neighbour gather-reduce — wrapper of
csrc/gather_reduce.cu and its plain PyTorch version.

Replaces scripts/prof/prof_fused_gather.py:pallas_gather_max (P5:
``out[b, n, f] = max_k a[b, idx[b, n, k], f]`` without storing the
(B, N, k, F) neighbour tensor) and the gather + reductions of the JAX
package's fused EdgeConv (ops/fused_edge.py:_gather_reduce,
fused_edge_eval). For a (B, N, C) table `a` (float32 or bfloat16, C <= 256)
and neighbour indices (B, N, K) int32 it returns, reduced over k in order
0 .. K - 1, by `want`:

  "max"      (max,)
  "extrema"  (max, min)
  "all"      (max, min, argmax, argmin, s1, s2)

max and min in a's dtype; argmax and argmin int32, the FIRST slot of the
extremum (the fused backward routes its gradient there); s1 and s2 the
float32 sum and sum of squares, each added from 0 in k order with one
rounding per multiply and per add. A NaN propagates (the first one wins),
as jnp.max and jnp.argmax do.

Out-of-range indices: the row of a neighbour is the flat index
f = b * N + idx, with f += B * N once if f < 0 and then clamped into
[0, B * N) — what the JAX package's flat gather ``x.reshape(B*N, C)[f]``
does (`flat_rows`). ops/edge.py's gather uses the same rows.

`gather_reduce` launches the kernel for a CUDA tensor and runs
`gather_reduce_plain` for a CPU tensor; there is no fallback from one to
the other. Both compare and round identically (no FMA contraction on
either side), so they agree bit for bit in every output. Clouds of up to
`STAGED_MAX_N` points whose clouds x channel slices keep the SMs busy
take the kernel that stages a channel slice of the cloud in shared
memory (`staged_parts`), the others the kernel that reads device memory;
both add in k order. There is no
gradient: the fused EdgeConv's backward is K3 + K4 (ops/fused_edge.py), and
the wrapper raises when autograd would record through it. Why the kernel is
shaped as it is, and what bounds it: see the head of csrc/gather_reduce.cu.
"""
from __future__ import annotations

import ctypes

import torch

MAX_C = 256   # csrc/gather_reduce.cu GR_MAX_C
# csrc/gather_reduce.cu GS_MAX_N: clouds of up to this many points take the
# kernel that stages a channel slice of the cloud in shared memory; larger
# ones the kernel that reads every neighbour row from device memory
STAGED_MAX_N = 3200
WANTS = ("max", "extrema", "all")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flat_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ..., ) neighbour indices into clouds of n points -> int64 rows of
    the flat (B * n, C) table: b * n + idx, plus B * n once if negative,
    clamped into [0, B * n) (the JAX package's flat-gather semantics)."""
    b = idx.shape[0]
    total = b * n
    offs = torch.arange(b, device=idx.device, dtype=torch.int64) * n
    f = idx.to(torch.int64) + offs.view(b, *([1] * (idx.ndim - 1)))
    f = f + (f < 0).to(torch.int64) * total
    return f.clamp_(0, total - 1)


def gather_reduce_plain(a: torch.Tensor, idx: torch.Tensor,
                        want: str = "all") -> tuple:
    """Plain PyTorch gather-reduce: one (B, N, C) row gather per k and the
    kernel's comparisons and float32 adds, in k order.

    :param a: (B, N, C) float32 or bfloat16
    :param idx: (B, N, K) int32
    :return: the tuple `want` names (see the module docstring)
    """
    b, n, c = a.shape
    kk = idx.shape[-1]
    table = a.reshape(b * n, c)
    rows = flat_rows(idx, n)
    shape, dev = (b, n, c), a.device
    mx = torch.full(shape, float("-inf"), device=dev)
    mn = torch.full(shape, float("inf"), device=dev)
    am = torch.zeros(shape, dtype=torch.int32, device=dev)
    amn = torch.zeros(shape, dtype=torch.int32, device=dev)
    s1 = torch.zeros(shape, device=dev)
    s2 = torch.zeros(shape, device=dev)
    for k in range(kk):
        v = table.index_select(0, rows[..., k].reshape(-1)).reshape(shape)
        v = v.to(torch.float32)
        up = (v > mx) | (v.isnan() & ~mx.isnan())
        mx = torch.where(up, v, mx)
        am.masked_fill_(up, k)
        if want == "max":
            continue
        up = (v < mn) | (v.isnan() & ~mn.isnan())
        mn = torch.where(up, v, mn)
        amn.masked_fill_(up, k)
        if want == "all":
            s1 = s1 + v
            s2 = s2 + v * v
    mx, mn = mx.to(a.dtype), mn.to(a.dtype)
    return {"max": (mx,), "extrema": (mx, mn),
            "all": (mx, mn, am, amn, s1, s2)}[want]


def _check(a: torch.Tensor, idx: torch.Tensor, want: str) -> None:
    if want not in WANTS:
        raise ValueError(f"gather_reduce: want must be one of {WANTS}, got "
                         f"{want!r}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"gather_reduce: a must be float32 or bfloat16, got "
                        f"{a.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"gather_reduce: idx must be int32, got {idx.dtype}")
    if a.ndim != 3 or idx.ndim != 3 or tuple(idx.shape[:2]) != \
            tuple(a.shape[:2]):
        raise ValueError(f"gather_reduce: a must be (B, N, C) and idx "
                         f"(B, N, K), got {tuple(a.shape)} and "
                         f"{tuple(idx.shape)}")
    b, n, c = a.shape
    if b * n == 0 or idx.shape[-1] < 1:
        raise ValueError(f"gather_reduce: empty a {tuple(a.shape)} or idx "
                         f"{tuple(idx.shape)}")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"gather_reduce: C={c} outside 1..{MAX_C}")
    if a.device != idx.device:
        raise ValueError("gather_reduce: a and idx on different devices")
    if torch.is_grad_enabled() and a.requires_grad:
        raise RuntimeError("gather_reduce has no gradient; call it under "
                           "torch.no_grad() or inside a custom backward")


def gather_reduce(a: torch.Tensor, idx: torch.Tensor,
                  want: str = "all") -> tuple:
    """The gather-reduce on the inputs' device: the CUDA kernel for CUDA
    tensors, `gather_reduce_plain` for CPU tensors. Each kernel launch adds
    one to ``gather_reduce.launches`` and to ``gather_reduce.calls`` under
    its call, "{want}_{dtype}_{B}x{N}x{K}x{C}" (a shape's time prices only
    its own launches).

    :param a: (B, N, C) float32 or bfloat16, contiguous, C <= 256
    :param idx: (B, N, K) int32, contiguous
    :param want: "max", "extrema" or "all"
    :return: the tuple `want` names (see the module docstring)
    """
    _check(a, idx, want)
    if a.device.type == "cpu":
        return gather_reduce_plain(a, idx, want)
    if not a.is_cuda:
        raise ValueError(f"gather_reduce: unsupported device {a.device}")
    if not (a.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_reduce: a and idx must be contiguous")
    from ._build import load
    b, n, c = a.shape
    mode = WANTS.index(want)
    mx = torch.empty_like(a)
    mn = torch.empty_like(a) if mode >= 1 else None
    if mode == 2:
        am = torch.empty((b, n, c), dtype=torch.int32, device=a.device)
        amn = torch.empty_like(am)
        s1 = torch.empty((b, n, c), dtype=torch.float32, device=a.device)
        s2 = torch.empty_like(s1)
    else:
        am = amn = s1 = s2 = None

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = load().fseg_gather_reduce(
            a.data_ptr(), idx.data_ptr(), mx.data_ptr(), ptr(mn), ptr(am),
            ptr(amn), ptr(s1), ptr(s2), b, n, idx.shape[-1], c, mode,
            _DTYPES[a.dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"gather_reduce kernel launch failed: "
                           f"cudaError_t {err}")
    gather_reduce.launches += 1
    key = call_key(a, idx, want)
    gather_reduce.calls[key] = gather_reduce.calls.get(key, 0) + 1
    return {0: (mx,), 1: (mx, mn), 2: (mx, mn, am, amn, s1, s2)}[mode]


def staged_parts(b: int, n: int, c: int, dtype: torch.dtype) -> int:
    """On the card: the blocks each cloud slice of a (b, n, c) table is
    split into by the kernel that stages the slice in shared memory, 0
    where the kernel that reads device memory runs instead (csrc/
    gather_reduce.cu fseg_gather_reduce_parts). Raises without a card."""
    from ._build import load
    parts = load().fseg_gather_reduce_parts(b, n, c, _DTYPES[dtype])
    if parts < 0:
        raise RuntimeError(f"gather_reduce: device query failed: "
                           f"cudaError_t {-parts}")
    return parts


def call_key(a: torch.Tensor, idx: torch.Tensor, want: str) -> str:
    """The name a call's launches are counted under in
    ``gather_reduce.calls``: "{want}_{dtype}_{B}x{N}x{K}x{C}"."""
    b, n, c = a.shape
    return f"{want}_{str(a.dtype)[6:]}_{b}x{n}x{idx.shape[-1]}x{c}"


gather_reduce.launches = 0
gather_reduce.calls = {}
