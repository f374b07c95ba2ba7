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
either side), so they agree bit for bit in every output. `route` names
the kernel a call takes on the card: clouds of up to `STAGED_MAX_N` points
stage a channel slice of the cloud in shared memory, "staged" (each block
stages the slice for itself) where clouds x slices keep the SMs busy, and
where they are too few (the serving ensemble's 5 clouds) "staged" at more
blocks a slice or "cluster" (a thread-block cluster of up to 16 blocks
shares each staged slice), whichever the kernel's model finds faster;
larger clouds take the "unstaged" kernel, which reads device memory.
Every route adds in k order. There is no
gradient: the fused EdgeConv's backward is K3 + K4 (ops/fused_edge.py), and
the wrapper raises when autograd would record through it. Why the kernel is
shaped as it is, and what bounds it: see the head of csrc/gather_reduce.cu.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

MAX_C = 256   # csrc/gather_reduce.cu GR_MAX_C
# csrc/gather_reduce.cu GS_MAX_N: clouds of up to this many points take a
# kernel that stages a channel slice of the cloud in shared memory; larger
# ones the kernel that reads every neighbour row from device memory
STAGED_MAX_N = 3200
ROUTES = ("unstaged", "staged", "cluster")
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


class Route(NamedTuple):
    """The kernel a call takes: `kind` one of ROUTES; `parts` the blocks a
    64-byte channel slice (0 unstaged); `cluster` the blocks a thread-block
    cluster (1 staged, 0 unstaged)."""
    kind: str
    parts: int
    cluster: int


_lib = None
# (device index, B, N, K, C, dtype, want) -> (call_key, (route, parts,
# cluster)): a shape's name and route, found at its first call
_shapes: dict = {}


def _library():
    global _lib
    if _lib is None:
        from ._build import load
        _lib = load()
    return _lib


def _route_args(b: int, n: int, k: int, c: int, dtype: torch.dtype,
                want: str) -> tuple:
    """csrc/gather_reduce.cu fseg_gather_reduce_route on the current
    device: (route, parts, cluster)."""
    import ctypes
    out = (ctypes.c_int * 3)()
    err = _library().fseg_gather_reduce_route(b, n, k, c, WANTS.index(want),
                                              _DTYPES[dtype], out)
    if err != 0:
        raise RuntimeError(f"gather_reduce: route query failed: "
                           f"cudaError_t {err}")
    return tuple(out)


def route(b: int, n: int, k: int, c: int, dtype: torch.dtype,
          want: str = "extrema") -> Route:
    """On the card (the current device): the kernel a (b, n, k, c) call of
    `want` takes, from the model in csrc/gather_reduce.cu
    (fseg_gather_reduce_route). Raises without a card."""
    r, parts, cluster = _route_args(b, n, k, c, dtype, want)
    return Route(ROUTES[r], parts, cluster)


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
    b, n, c = a.shape
    kk = idx.shape[-1]
    mode = WANTS.index(want)
    dev = a.device.index
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(a, idx, want, b, n, kk, c, mode, dev)
    return _launch(a, idx, want, b, n, kk, c, mode, dev)


def _launch(a, idx, want, b, n, kk, c, mode, dev) -> tuple:
    """The launch on the current device, `dev`."""
    shape = (dev, b, n, kk, c, a.dtype, want)
    known = _shapes.get(shape)
    if known is None:
        known = _shapes[shape] = (call_key(a, idx, want),
                                  _route_args(b, n, kk, c, a.dtype, want))
    key, args = known
    mx = torch.empty_like(a)
    mn = torch.empty_like(a) if mode >= 1 else None
    if mode == 2:
        am = torch.empty((b, n, c), dtype=torch.int32, device=a.device)
        amn = torch.empty_like(am)
        s1 = torch.empty((b, n, c), dtype=torch.float32, device=a.device)
        s2 = torch.empty_like(s1)
        ptrs = (mn.data_ptr(), am.data_ptr(), amn.data_ptr(), s1.data_ptr(),
                s2.data_ptr())
    else:
        ptrs = (None if mn is None else mn.data_ptr(), None, None, None,
                None)
    err = _library().fseg_gather_reduce(
        a.data_ptr(), idx.data_ptr(), mx.data_ptr(), *ptrs, b, n, kk, c,
        mode, _DTYPES[a.dtype], *args,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_reduce kernel launch failed: "
                           f"cudaError_t {err}")
    gather_reduce.launches += 1
    gather_reduce.calls[key] = gather_reduce.calls.get(key, 0) + 1
    if mode == 0:
        return (mx,)
    if mode == 1:
        return mx, mn
    return mx, mn, am, amn, s1, s2


def call_key(a: torch.Tensor, idx: torch.Tensor, want: str) -> str:
    """The name a call's launches are counted under in
    ``gather_reduce.calls``: "{want}_{dtype}_{B}x{N}x{K}x{C}"."""
    b, n, c = a.shape
    return f"{want}_{str(a.dtype)[6:]}_{b}x{n}x{idx.shape[-1]}x{c}"


gather_reduce.launches = 0
gather_reduce.calls = {}
