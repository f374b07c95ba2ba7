"""K2-K4: the EdgeConv scatter kernels — wrappers of csrc/scatter.cu and
their plain PyTorch versions.

  K2 `scatter_rows`    out[b, idx[b, e], :] += g[b, e, :]; replaces
       ops/pallas/scatter.py:scatter_add_mm2 (K2a) and scatter_add_mm (K2b),
       f32 or bf16 payloads, f32 output;
  K3 `scatter_routed`  out[b, idx[b, n, kstar[b, n, c]], c] += s[b, n, c] and
       out[b, idx[b, n, k], C + c] += p[b, n, c] for every k; replaces
       scatter_add_routed;
  K4 `scatter_count`   out[b, m] = #{e : idx[b, e] == m}; replaces
       scatter_count. Given the transpose, the differences of its row
       offsets (`count_from_ptr`); without it, a one-launch histogram of idx
       in shared memory (the counters in device memory above
       `HIST_MAX_ROWS` rows).

Targets outside [0, n_rows) are dropped, as JAX's scatter drops them; the
wrappers mask them without a synchronisation. Each wrapper launches its
kernel for a CUDA tensor and runs the plain version for a CPU tensor; there
is no fallback from one to the other.

K2 and K3 walk the transposed graph (`transpose`: int32 (order, ptr), the
edge ids sorted by target row with ties in ascending id, built on the card
by a counting-sort kernel and equal to the stable sort of
`transpose_plain`); they then sum every output row's incoming edges in
ascending edge order, one thread per output element, so they are
deterministic. A caller that scatters over one graph several times (the
DGCNN train step: EdgeConv_0's gather backward, the fused EdgeConvs' K3)
builds the transpose once and passes it as `transposed`; without it each
wrapper builds its own. K3 reads its node fields from shared memory
where a cloud's channel slices fit (`ROUTED_STAGED_MAX_N`, K <= 255) and
from device memory otherwise; both kernels sum in the same order, so
they agree bit for bit. The plain versions are `index_add_` (K2, K3 after
materialising the routed payload) and `bincount` (K4; given the transpose,
the difference of its row offsets); on the card
`index_add_` sums in another order, so kernel and plain version agree
within float32 rounding, not bit for bit (K4 is exact on both).
"""
from __future__ import annotations

import ctypes

import torch

MAX_C = 256  # csrc/scatter.cu SCATTER_MAX_C
# csrc/scatter.cu: K3 stages a channel slice of a cloud's p, s and kstar in
# shared memory where n * (64 + SC) <= RS_SMEM_MAX (SC = 8 float32 or 16
# bfloat16 channels) and K <= 255; the largest such n by payload dtype
ROUTED_STAGED_MAX_N = {torch.float32: 220 * 1024 // 72,
                       torch.bfloat16: 220 * 1024 // 80}
ROUTED_STAGED_MAX_K = 255
# csrc/scatter.cu: K4's histogram keeps n_rows int32 counters in shared
# memory up to HIST_SMEM_MAX bytes, in device memory above
HIST_MAX_ROWS = 200 * 1024 // 4
_PAYLOAD = (torch.float32, torch.bfloat16)


def _flat_targets(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(B, E) targets -> flat row ids b * n_rows + idx, out-of-range targets
    mapped to the sentinel B * n_rows (one past the last row)."""
    b = idx.shape[0]
    t = idx.to(torch.int64)
    valid = (t >= 0) & (t < n_rows)
    offs = torch.arange(b, device=idx.device, dtype=torch.int64)[:, None]
    return torch.where(valid, t + offs * n_rows, b * n_rows).reshape(-1)


def transpose_plain(idx: torch.Tensor, n_rows: int):
    """Plain transpose: a stable sort of the flat targets and a
    searchsorted of the row ids, cast to int32."""
    key = _flat_targets(idx, n_rows)
    skey, order = torch.sort(key, stable=True)
    rows = torch.arange(idx.shape[0] * n_rows + 1, device=idx.device,
                        dtype=torch.int64)
    return (order.to(torch.int32),
            torch.searchsorted(skey, rows).to(torch.int32))


def transpose(idx: torch.Tensor, n_rows: int):
    """The graph's transpose as int32 (order, ptr): the B * E flat edge ids
    b * E + e sorted by target row b * n_rows + idx[b, e], ties in ascending
    edge id, dropped targets after the last row, and the B * n_rows + 1
    offsets of each row's range in `order`. The counting-sort kernel for a
    CUDA tensor (each launch adds one to ``transpose.launches``),
    `transpose_plain` for a CPU tensor.

    :param idx: (B, E) int32 targets
    """
    what = "transpose"
    _check_idx(idx, 2, what)
    if not _on_device((idx,), what):
        return transpose_plain(idx, n_rows)
    b, e = idx.shape
    if n_rows < 1 or b * e >= 2 ** 31 or b * n_rows + b >= 2 ** 31:
        raise ValueError(f"{what}: B={b}, E={e}, n_rows={n_rows} outside "
                         "the int32 transpose (1 <= n_rows, B * E and "
                         "B * (n_rows + 1) below 2^31)")
    from ._build import load
    lib = load()
    dev = idx.device
    i32 = torch.int32
    cnt = torch.empty(lib.fseg_transpose_scratch(b, e, n_rows), dtype=i32,
                      device=dev)
    deg = torch.empty(b * n_rows + b, dtype=i32, device=dev)
    ptr = torch.empty(b * n_rows + b + 1, dtype=i32, device=dev)
    order = torch.empty(b * e, dtype=i32, device=dev)
    with torch.cuda.device(dev):
        _launch(what, lib.fseg_graph_transpose, idx.data_ptr(),
                cnt.data_ptr(), deg.data_ptr(), ptr.data_ptr(),
                order.data_ptr(), b, e, n_rows, _stream(dev))
    transpose.launches += 1
    return order, ptr[:b * n_rows + 1]


transpose.launches = 0


def _check_transposed(transposed, idx: torch.Tensor, n_rows: int,
                      what: str) -> None:
    """A caller's (order, ptr) must have the shapes and dtype of
    `transpose(idx, n_rows)` and lie on idx's device."""
    order, ptr = transposed
    b, e = idx.shape[0], idx.shape[1:].numel()
    if (order.dtype != torch.int32 or ptr.dtype != torch.int32
            or tuple(order.shape) != (b * e,)
            or tuple(ptr.shape) != (b * n_rows + 1,)):
        raise ValueError(f"{what}: transposed must be int32 order ({b * e},) "
                         f"and ptr ({b * n_rows + 1},), got {order.dtype} "
                         f"{tuple(order.shape)}, {ptr.dtype} "
                         f"{tuple(ptr.shape)}")
    if order.device != idx.device or ptr.device != idx.device:
        raise ValueError(f"{what}: transposed not on idx's device")


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


def scatter_rows(idx: torch.Tensor, g: torch.Tensor, n_rows: int,
                 transposed=None) -> torch.Tensor:
    """K2 on the inputs' device. Each kernel launch adds one to
    ``scatter_rows.launches`` and to ``scatter_rows.calls`` under
    "{B}x{E}x{C}_rows{n_rows}_{dtype}".

    :param idx: (B, E) int32 target rows
    :param g: (B, E, C) float32 or bfloat16 payload rows, C <= 256
    :param transposed: `transpose(idx, n_rows)`, if the caller has it (the
        plain version does not need it)
    :return: (B, n_rows, C) float32
    """
    what = "scatter_rows"
    _check_idx(idx, 2, what)
    _check_payload(g, (*idx.shape, g.shape[-1]), what, "g")
    if transposed is not None:
        _check_transposed(transposed, idx, n_rows, what)
    if not _on_device((idx, g), what):
        return scatter_rows_plain(idx, g, n_rows)
    from ._build import load
    b, e = idx.shape
    c = g.shape[-1]
    out = torch.empty((b, n_rows, c), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    order, ptr = (transposed if transposed is not None
                  else transpose(idx, n_rows))
    with torch.cuda.device(g.device):
        _launch(what, load().fseg_scatter_rows, g.data_ptr(),
                order.data_ptr(), ptr.data_ptr(), out.data_ptr(), b * n_rows,
                c, int(g.dtype == torch.bfloat16), _stream(g.device))
    scatter_rows.launches += 1
    key = f"{b}x{e}x{c}_rows{n_rows}_{str(g.dtype)[6:]}"
    scatter_rows.calls[key] = scatter_rows.calls.get(key, 0) + 1
    return out


scatter_rows.launches = 0
scatter_rows.calls = {}


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
                   p: torch.Tensor, n_rows: int,
                   transposed=None) -> torch.Tensor:
    """K3 on the inputs' device. Each kernel launch adds one to
    ``scatter_routed.launches`` and to ``scatter_routed.calls`` under
    "{B}x{N}x{K}x{C}_{dtype}".

    :param idx: (B, N, K) int32 neighbour indices
    :param kstar: (B, N, C) int32 routing slot in [0, K) per (node, channel)
    :param s: (B, N, C) sparse payload, float32 or bfloat16
    :param p: (B, N, C) dense (k-replicated) payload, the dtype of s
    :param transposed: `transpose(idx.reshape(B, N * K), n_rows)`, if the
        caller has it (the plain version does not need it)
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
    if transposed is not None:
        _check_transposed(transposed, idx, n_rows, what)
    if not _on_device((idx, kstar, s, p), what):
        return scatter_routed_plain(idx, kstar, s, p, n_rows)
    from ._build import load
    out = torch.empty((b, n_rows, 2 * c), dtype=torch.float32,
                      device=s.device)
    if out.numel() == 0:
        return out
    order, ptr = (transposed if transposed is not None
                  else transpose(idx.reshape(b, n * kk), n_rows))
    with torch.cuda.device(s.device):
        _launch(what, load().fseg_scatter_routed, kstar.data_ptr(),
                s.data_ptr(), p.data_ptr(), order.data_ptr(), ptr.data_ptr(),
                out.data_ptr(), b, n, n_rows, kk, c,
                int(s.dtype == torch.bfloat16), _stream(s.device))
    scatter_routed.launches += 1
    key = f"{b}x{n}x{kk}x{c}_{str(s.dtype).removeprefix('torch.')}"
    scatter_routed.calls[key] = scatter_routed.calls.get(key, 0) + 1
    return out


scatter_routed.launches = 0
scatter_routed.calls = {}


# ---- K4 -------------------------------------------------------------------

def scatter_count_plain(idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain K4: `bincount` over the flattened row ids."""
    b = idx.shape[0]
    cnt = torch.bincount(_flat_targets(idx, n_rows), minlength=b * n_rows + 1)
    return cnt[:b * n_rows].to(torch.float32).reshape(b, n_rows)


def count_from_ptr_plain(ptr: torch.Tensor, b: int,
                         n_rows: int) -> torch.Tensor:
    """Plain K4 from the transpose: row r's in-degree is ptr[r + 1] -
    ptr[r] (a batch's last row ends where the next batch's rows start, the
    last batch's at its first dropped edge)."""
    return (ptr[1:] - ptr[:-1]).to(torch.float32).reshape(b, n_rows)


def scatter_count(idx: torch.Tensor, n_rows: int,
                  transposed=None) -> torch.Tensor:
    """K4 on idx's device: the in-degree of every row. Given `transposed`
    it reads the in-degrees from its row offsets (`count_from_ptr`, idx is
    not read); without it it histograms idx. Each kernel launch adds one to
    ``scatter_count.launches`` and to ``scatter_count.calls`` under its
    call, "ptr_{B}x{n_rows}" or "hist_{B}x{E}_rows{n_rows}".

    :param idx: (B, E) int32 targets
    :param transposed: `transpose(idx, n_rows)`, if the caller has it
    :return: (B, n_rows) float32 counts
    """
    what = "scatter_count"
    _check_idx(idx, 2, what)
    b, e = idx.shape
    if transposed is not None:
        _check_transposed(transposed, idx, n_rows, what)
    ptr = None if transposed is None else transposed[1]
    if not _on_device((idx,) if ptr is None else (idx, ptr), what):
        if ptr is None:
            return scatter_count_plain(idx, n_rows)
        return count_from_ptr_plain(ptr, b, n_rows)
    from ._build import load
    out = torch.empty((b, n_rows), dtype=torch.float32, device=idx.device)
    if out.numel() == 0:
        return out
    lib = load()
    with torch.cuda.device(idx.device):
        if ptr is not None:
            _launch(what, lib.fseg_count_from_ptr, ptr.data_ptr(),
                    out.data_ptr(), b * n_rows, _stream(idx.device))
            key = f"ptr_{b}x{n_rows}"
        elif e == 0:
            return out.zero_()
        else:   # int32 counters in device memory only above HIST_MAX_ROWS
            cnt = (torch.empty((b, n_rows), dtype=torch.int32,
                               device=idx.device)
                   if n_rows > HIST_MAX_ROWS else None)
            _launch(what, lib.fseg_scatter_count, idx.data_ptr(),
                    None if cnt is None else cnt.data_ptr(), out.data_ptr(),
                    b, e, n_rows, _stream(idx.device))
            key = f"hist_{b}x{e}_rows{n_rows}"
    scatter_count.launches += 1
    scatter_count.calls[key] = scatter_count.calls.get(key, 0) + 1
    return out


scatter_count.launches = 0
scatter_count.calls = {}
