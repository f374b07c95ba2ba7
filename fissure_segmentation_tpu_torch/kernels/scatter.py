"""K2-K4: the EdgeConv scatter kernels — wrappers of csrc/scatter.cu and
their plain PyTorch versions.

  K2 `scatter_rows`    out[b, idx[b, e], :] += g[b, e, :]; replaces
       ops/pallas/scatter.py:scatter_add_mm2 (K2a) and scatter_add_mm (K2b),
       f32 or bf16 payloads, f32 output;
  K3 `scatter_routed`  out[b, idx[b, n, kstar[b, n, c]], c] += s[b, n, c] and
       out[b, idx[b, n, k], C + c] += p[b, n, c] for every k; replaces
       scatter_add_routed;
  K4 `scatter_count`   out[b, m] = #{e : idx[b, e] == m}; replaces
       scatter_count.

Targets outside [0, n_rows) are dropped, as JAX's scatter drops them; the
wrappers mask them without a synchronisation. Each wrapper launches its
kernel for a CUDA tensor and runs the plain version for a CPU tensor; there
is no fallback from one to the other. K2 and K3 first build the transposed
graph with a stable sort (`_transpose`): the kernels then sum every output
row's incoming edges in ascending edge order, one thread per output
element, so they are deterministic. The plain versions are `index_add_`
(K2, K3 after materialising the routed payload) and `bincount` (K4); on the
card `index_add_` sums in another order, so kernel and plain version agree
within float32 rounding, not bit for bit (K4 is exact on both).
"""
from __future__ import annotations

import ctypes

import torch

MAX_C = 256  # csrc/scatter.cu SCATTER_MAX_C
_PAYLOAD = (torch.float32, torch.bfloat16)


def _flat_targets(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(B, E) targets -> flat row ids b * n_rows + idx, out-of-range targets
    mapped to the sentinel B * n_rows (one past the last row)."""
    b = idx.shape[0]
    t = idx.to(torch.int64)
    valid = (t >= 0) & (t < n_rows)
    offs = torch.arange(b, device=idx.device, dtype=torch.int64)[:, None]
    return torch.where(valid, t + offs * n_rows, b * n_rows).reshape(-1)


def _transpose(idx: torch.Tensor, n_rows: int):
    """The graph's transpose as (order, ptr): flat edge ids sorted by target
    row, ties in ascending edge order, and the (B * n_rows + 1) offsets of
    each row's range in `order`. Dropped targets sort past the last row."""
    key = _flat_targets(idx, n_rows)
    skey, order = torch.sort(key, stable=True)
    rows = torch.arange(idx.shape[0] * n_rows + 1, device=idx.device,
                        dtype=torch.int64)
    return order, torch.searchsorted(skey, rows)


def _check_idx(idx: torch.Tensor, ndim: int, what: str,
               name: str = "idx") -> None:
    if idx.dtype != torch.int32:
        raise TypeError(f"{what}: {name} must be int32, got {idx.dtype}")
    if idx.ndim != ndim:
        raise ValueError(f"{what}: {name} must have {ndim} dims, got "
                         f"{tuple(idx.shape)}")


def _check_payload(x: torch.Tensor, shape, what: str, name: str) -> None:
    if x.dtype not in _PAYLOAD:
        raise TypeError(f"{what}: {name} must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} shape {tuple(x.shape)} != "
                         f"{tuple(shape)}")
    if not 1 <= shape[-1] <= MAX_C:
        raise ValueError(f"{what}: C={shape[-1]} outside 1..{MAX_C}")


def _launch(what: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def _on_device(tensors, what: str) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version); raises for mixed or other devices and for
    non-contiguous CUDA inputs."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: inputs on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    return True


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


# ---- K2 -------------------------------------------------------------------

def scatter_rows_plain(idx: torch.Tensor, g: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """Plain K2: f32 `index_add_` into the flattened (B * n_rows, C) output;
    dropped targets go to one extra row that is cut off."""
    b, e = idx.shape
    c = g.shape[-1]
    out = torch.zeros((b * n_rows + 1, c), dtype=torch.float32,
                      device=g.device)
    out.index_add_(0, _flat_targets(idx, n_rows),
                   g.reshape(b * e, c).to(torch.float32))
    return out[:-1].reshape(b, n_rows, c)


def scatter_rows(idx: torch.Tensor, g: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """K2 on the inputs' device. Each kernel launch adds one to
    ``scatter_rows.launches``.

    :param idx: (B, E) int32 target rows
    :param g: (B, E, C) float32 or bfloat16 payload rows, C <= 256
    :return: (B, n_rows, C) float32
    """
    what = "scatter_rows"
    _check_idx(idx, 2, what)
    _check_payload(g, (*idx.shape, g.shape[-1]), what, "g")
    if not _on_device((idx, g), what):
        return scatter_rows_plain(idx, g, n_rows)
    from ._build import load
    b, e = idx.shape
    c = g.shape[-1]
    out = torch.empty((b, n_rows, c), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    order, ptr = _transpose(idx, n_rows)
    with torch.cuda.device(g.device):
        _launch(what, load().fseg_scatter_rows, g.data_ptr(),
                order.data_ptr(), ptr.data_ptr(), out.data_ptr(), b * n_rows,
                c, int(g.dtype == torch.bfloat16), _stream(g.device))
    scatter_rows.launches += 1
    return out


scatter_rows.launches = 0


# ---- K3 -------------------------------------------------------------------

def scatter_routed_plain(idx: torch.Tensor, kstar: torch.Tensor,
                         s: torch.Tensor, p: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """Plain K3: materialise the routed (B, N, K, 2C) payload — s where the
    slot is kstar, p at every slot — and scatter it with plain K2."""
    b, n, kk = idx.shape
    c = s.shape[-1]
    slot = torch.arange(kk, device=idx.device)[None, None, :, None]
    hit = kstar[:, :, None, :].to(torch.int64) == slot
    sparse = torch.where(hit, s[:, :, None, :].to(torch.float32), 0.0)
    dense = p[:, :, None, :].to(torch.float32).expand(b, n, kk, c)
    pay = torch.cat([sparse, dense], dim=-1).reshape(b, n * kk, 2 * c)
    return scatter_rows_plain(idx.reshape(b, n * kk), pay, n_rows)


def scatter_routed(idx: torch.Tensor, kstar: torch.Tensor, s: torch.Tensor,
                   p: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K3 on the inputs' device. Each kernel launch adds one to
    ``scatter_routed.launches``.

    :param idx: (B, N, K) int32 neighbour indices
    :param kstar: (B, N, C) int32 routing slot in [0, K) per (node, channel)
    :param s: (B, N, C) sparse payload, float32 or bfloat16
    :param p: (B, N, C) dense (k-replicated) payload, the dtype of s
    :return: (B, n_rows, 2C) float32 — [..., :C] sparse, [..., C:] dense
    """
    what = "scatter_routed"
    _check_idx(idx, 3, what)
    b, n, kk = idx.shape
    c = s.shape[-1]
    _check_payload(s, (b, n, c), what, "s")
    _check_payload(p, (b, n, c), what, "p")
    if p.dtype != s.dtype:
        raise TypeError(f"{what}: s is {s.dtype} but p is {p.dtype}")
    _check_idx(kstar, 3, what, "kstar")
    if tuple(kstar.shape) != (b, n, c):
        raise ValueError(f"{what}: kstar shape {tuple(kstar.shape)} != "
                         f"{(b, n, c)}")
    if not _on_device((idx, kstar, s, p), what):
        return scatter_routed_plain(idx, kstar, s, p, n_rows)
    from ._build import load
    out = torch.empty((b, n_rows, 2 * c), dtype=torch.float32,
                      device=s.device)
    if out.numel() == 0:
        return out
    order, ptr = _transpose(idx.reshape(b, n * kk), n_rows)
    with torch.cuda.device(s.device):
        _launch(what, load().fseg_scatter_routed, kstar.data_ptr(),
                s.data_ptr(), p.data_ptr(), order.data_ptr(), ptr.data_ptr(),
                out.data_ptr(), b * n_rows, kk, c,
                int(s.dtype == torch.bfloat16), _stream(s.device))
    scatter_routed.launches += 1
    return out


scatter_routed.launches = 0


# ---- K4 -------------------------------------------------------------------

def scatter_count_plain(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain K4: `bincount` over the flattened row ids."""
    b = idx.shape[0]
    cnt = torch.bincount(_flat_targets(idx, n_rows), minlength=b * n_rows + 1)
    return cnt[:b * n_rows].to(torch.float32).reshape(b, n_rows)


def scatter_count(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K4 on idx's device: the in-degree of every row. Each kernel launch
    adds one to ``scatter_count.launches``.

    :param idx: (B, E) int32 targets
    :return: (B, n_rows) float32 counts
    """
    what = "scatter_count"
    _check_idx(idx, 2, what)
    if not _on_device((idx,), what):
        return scatter_count_plain(idx, n_rows)
    from ._build import load
    b, e = idx.shape
    out = torch.empty((b, n_rows), dtype=torch.float32, device=idx.device)
    if out.numel() == 0:
        return out
    if e == 0:
        return out.zero_()
    cnt = torch.empty((b, n_rows), dtype=torch.int32, device=idx.device)
    with torch.cuda.device(idx.device):
        _launch(what, load().fseg_scatter_count, idx.data_ptr(),
                cnt.data_ptr(), out.data_ptr(), b, e, n_rows,
                _stream(idx.device))
    scatter_count.launches += 1
    return out


scatter_count.launches = 0
