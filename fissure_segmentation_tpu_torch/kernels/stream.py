"""Streaming column sums — wrappers of csrc/stream.cu and their plain
PyTorch version: the card's counterparts of the Pallas streaming probes
under scripts/prof/ (P1 `k_stream`, P2 `stream_floor`, P3
`pallas_blockspec` and `manual_reduce`, P4 `stream`), which measure how fast
a chip streams the scatter's payload.

  `stream_sum(g2d)`                    a grid the card holds at once, each
                                       thread 8 streaming 16-byte loads in
                                       flight
  `stream_sum_async(g2d, chunk, nbuf)` each block's `chunk`-row tiles
                                       brought into shared memory by an
                                       nbuf-deep ring of bulk asynchronous
                                       copies that one producer warp keeps
                                       full (cp.async.bulk + a full and an
                                       empty mbarrier a slot)

Both return the (L,) float32 column sums of a contiguous (R, L) float32 or
bfloat16 view in one kernel launch, deterministically (a fixed order of
additions; see the head of csrc/stream.cu); with `total=True` they also
return the sum of those L sums from the same launch. The plain version is
the exact sum (float64) rounded once to float32. In a kernel each value
meets at most `depth` float32 additions on its way to its column sum, so the
kernel is within gamma_depth * sum|g| of the exact sum (gamma_n = n u /
(1 - n u), u = 2^-24); `rounding_bound` adds the plain version's own
rounding. `replay` repeats a kernel's additions in numpy, in its order, and
counts the most additions a value meets. On a payload of small positive
integers (`exact_payload`) every partial sum is exact, so there kernel and
plain version are equal, and a dropped or repeated row shows.

The blocks add their partial rows themselves, through tickets in a work
area of each (device, stream) whose counters the finishing blocks set back
to 0: calls on one stream run one after another and share it, calls on two
streams never do.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; there is no fallback from one to the other. L must
be a multiple of the 16-byte vector (4 float32 or 8 bfloat16 values) with
L / vector dividing 256, and the ring at most 200 KB.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256            # csrc/stream.cu ST_THREADS: the threads that add
GROUP = 16               # ST_GROUP: blocks a first-level finisher adds
COUNTERS = 256           # ST_COUNTERS: ints of a stream's ticket array
MAX_NBUF = 16            # ST_MAX_NBUF
MAX_RING = 200 * 1024    # bytes of shared memory the ring may take
EPS32 = 2.0 ** -24

_grid: dict = {}         # (device, dtype, L, chunk, nbuf) -> resident blocks
_work: dict = {}         # (device, stream) -> int32 tickets (all 0) + scratch
_fns: dict = {}          # name -> the library's entry point


def stream_sum_plain(g2d: torch.Tensor) -> torch.Tensor:
    """Plain column sums: (R, L) -> (L,) float32, the exact sums (float64)
    rounded once."""
    return g2d.double().sum(0).float()


def stream_total_plain(g2d: torch.Tensor) -> torch.Tensor:
    """Plain total: the exact sum of every value (float64) rounded once to
    a float32 scalar."""
    return g2d.double().sum().float()


def grid_blocks(g2d: torch.Tensor, chunk: int | None = None,
                nbuf: int | None = None) -> int:
    """The blocks `stream_sum` (chunk None) or `stream_sum_async(g2d,
    chunk, nbuf)` launches on g2d's card: as many as its SMs hold at once
    (the library's occupancy query, with the ring's shared memory), at
    most one a unit of work."""
    bf16 = _DTYPES[g2d.dtype]
    key = (g2d.device, bf16, g2d.shape[1], chunk or 0, nbuf or 0)
    full = _grid.get(key)
    if full is None:
        from ._build import load
        with torch.cuda.device(g2d.device):
            per_sm = load().fseg_stream_occupancy(g2d.shape[1], bf16,
                                                  chunk or 0, nbuf or 0)
        if per_sm < 1:
            raise RuntimeError(f"stream kernels: no block fits an SM "
                               f"(L={g2d.shape[1]}, chunk={chunk}, "
                               f"nbuf={nbuf}; cudaError_t {-per_sm})")
        full = _grid[key] = per_sm * torch.cuda.get_device_properties(
            g2d.device).multi_processor_count
    rows, lanes = g2d.shape
    if chunk is None:                   # 4 KB units (ST_THREADS vectors)
        return min(full, max(1, rows * lanes * g2d.element_size() // 16
                             // THREADS))
    return min(full, -(-rows // chunk))     # tiles


def depth(rows: int, lanes: int, elem: int, blocks: int,
          chunk: int | None = None, total: bool = False) -> int:
    """Most float32 additions a value meets in the kernel: its thread's own
    sequence (its block's 4 KB units, dealt in turn, and the vectors past
    the last whole unit, or its rows of each of its block's tiles), the
    butterfly over a warp's row lanes, the warps, its group's blocks, the
    groups; with `total`, the 32 lanes' sums over the columns and their
    butterfly."""
    groups = lanes // (16 // elem)            # 16-byte column groups
    if chunk is None:
        own = -(-(rows * groups // THREADS) // blocks) + 1
    else:
        row_lanes = THREADS // groups
        own = -(-(-(-rows // chunk)) // blocks) * -(-chunk // row_lanes)
    shuffle = (32 // groups).bit_length() - 1 if groups < 32 else 0
    warps = THREADS // 32 if groups <= 32 else THREADS // groups
    n = own + shuffle + warps + min(GROUP, blocks) + -(-blocks // GROUP)
    if total:
        n += -(-lanes // 32) + 5
    return n


def sum_bound(g2d: torch.Tensor, n: int) -> torch.Tensor:
    """(L,) float64: gamma_n * sum|g| per column, the worst-case distance of
    a float32 sum from the exact one when no value meets more than n
    additions."""
    nu = n * EPS32
    return nu / (1.0 - nu) * g2d.double().abs().sum(0)


def rounding_bound(g2d: torch.Tensor, chunk: int | None = None,
                   nbuf: int | None = None) -> torch.Tensor:
    """(L,) float64 tolerance between a kernel's column sums of a card
    tensor and the plain version's: the kernel's worst case at its depth,
    plus the plain version's rounding of the exact sum (2^-24 |sum|) and
    float64's own (under 2^-24 sum|g| for R < 2^29): two more additions'
    worth."""
    n = depth(g2d.shape[0], g2d.shape[1], g2d.element_size(),
              grid_blocks(g2d, chunk, nbuf), chunk)
    return sum_bound(g2d, n + 2)


def total_bound(g2d: torch.Tensor, chunk: int | None = None,
                nbuf: int | None = None) -> float:
    """Tolerance between a kernel's total and `stream_total_plain`: every
    value meets at most depth(total=True) additions, plus two for the plain
    version's roundings, so gamma of that times sum|g|."""
    n = depth(g2d.shape[0], g2d.shape[1], g2d.element_size(),
              grid_blocks(g2d, chunk, nbuf), chunk, total=True) + 2
    return float(n * EPS32 / (1.0 - n * EPS32)
                 * g2d.double().abs().sum().item())


def replay(g: np.ndarray, elem: int, blocks: int, chunk: int | None = None):
    """The kernel's additions in its order, in numpy float32: `g` (R, L) the
    values (float32, or bfloat16 values widened), `elem` their bytes on the
    card (4 or 2), `blocks` the grid, `chunk` None for stream_sum or the
    ring's tile. Returns (column sums (L,), total, the most additions a
    value met on its way to a column sum, ... to the total)."""
    g = np.ascontiguousarray(g, dtype=np.float32)
    rows, lanes = g.shape
    v = 16 // elem
    ngr = lanes // v
    vec = g.reshape(-1, v)                      # vector j: (j // ngr, j % ngr)
    n_vec = vec.shape[0]
    tid = np.arange(THREADS)
    acc = np.zeros((blocks, THREADS, v), np.float32)
    met = np.zeros((blocks, THREADS), np.int64)

    def add(j, ok):                             # j, ok: (blocks, THREADS)
        x = vec[np.where(ok, j, 0)]
        acc[:] = np.where(ok[..., None], acc + x, acc)
        met[:] = met + ok

    b = np.arange(blocks)[:, None]
    if chunk is None:
        units = n_vec // THREADS
        for k in range(-(-units // blocks)):
            u = b + k * blocks
            add(u * THREADS + tid, u < units)
        last = (b == blocks - 1) & (units * THREADS + tid < n_vec)
        add(units * THREADS + tid + 0 * b, last)
    else:
        tiles = -(-rows // chunk)
        for i in range(-(-tiles // blocks)):
            r0 = (b + i * blocks) * chunk
            n = np.clip(rows - r0, 0, chunk) * ngr
            for k in range(-(-chunk * ngr // THREADS)):
                j = tid + k * THREADS
                add(r0 * ngr + j, j < n)
    # the butterfly over a warp's row lanes, then the warps in order
    off = 16
    while off >= ngr:
        acc[:] = acc + acc[:, tid ^ off]
        met[:] = np.maximum(met, met[:, tid ^ off]) + 1
        off //= 2
    col = np.arange(lanes)
    cg, e = col // v, col % v
    part = np.zeros((blocks, lanes), np.float32)
    mpart = np.zeros((blocks, lanes), np.int64)
    for w in range(THREADS // 32):
        holds = (w * 32) % ngr == (cg & ~31)
        t = w * 32 + (cg & 31)
        part = np.where(holds, part + acc[:, t, e], part)
        mpart = np.where(holds, np.maximum(mpart, met[:, t]) + 1, mpart)

    def ordered(rows_, m_):                     # a sum from 0, in row order
        s = np.zeros(lanes, np.float32)
        m = np.zeros(lanes, np.int64)
        for r, mr in zip(rows_, m_):
            s, m = s + r, np.maximum(m, mr) + 1
        return s, m

    grp = [ordered(part[q:q + GROUP], mpart[q:q + GROUP])
           for q in range(0, blocks, GROUP)]
    sums, msum = ordered([s for s, _ in grp], [m for _, m in grp])
    # the total: lane t adds columns t, t + 32, ...; then a butterfly
    s32 = np.zeros(32, np.float32)
    m32 = np.zeros(32, np.int64)
    for c in range(0, lanes, 32):
        n = min(32, lanes - c)
        s32[:n] = s32[:n] + sums[c:c + n]
        m32[:n] = np.maximum(m32[:n], msum[c:c + n]) + 1
    off = 16
    while off >= 1:
        p = np.arange(32) ^ off
        s32, m32 = s32 + s32[p], np.maximum(m32, m32[p]) + 1
        off //= 2
    return sums, s32[0], int(msum.max()), int(m32[0])


def exact_payload(g2d: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Integers 1..4 in g2d's shape, dtype and device: every partial column
    sum is an integer below 2^24, exact in float32 in any order, and every
    row adds at least 1 to every column."""
    if 4 * g2d.shape[0] >= 2 ** 24:
        raise ValueError(f"exact_payload: {g2d.shape[0]} rows could sum past "
                         "2^24")
    gen = torch.Generator(device=g2d.device).manual_seed(seed)
    return torch.randint(1, 5, tuple(g2d.shape), generator=gen,
                         device=g2d.device).to(g2d.dtype)


def _check(g2d: torch.Tensor, what: str) -> None:
    if g2d.dtype not in _DTYPES:
        raise TypeError(f"{what}: g must be float32 or bfloat16, got "
                        f"{g2d.dtype}")
    if g2d.ndim != 2 or g2d.numel() == 0:
        raise ValueError(f"{what}: g must be a non-empty (R, L) view, got "
                         f"{tuple(g2d.shape)}")


def _on_card(g2d: torch.Tensor, what: str) -> bool:
    """True: launch the kernel (after checking the view); False: CPU."""
    if g2d.device.type == "cpu":
        return False
    if not g2d.is_cuda:
        raise ValueError(f"{what}: unsupported device {g2d.device}")
    v = 16 // g2d.element_size()
    lanes = g2d.shape[1]
    if lanes % v or THREADS % (lanes // v) or lanes < v:
        raise ValueError(f"{what}: L={lanes} must be a multiple of {v} with "
                         f"{THREADS} % (L / {v}) == 0")
    if not g2d.is_contiguous() or g2d.data_ptr() % 16:
        raise ValueError(f"{what}: g must be contiguous and 16-byte aligned")
    return True


def _plain(g2d: torch.Tensor, total: bool):
    sums = stream_sum_plain(g2d)
    return (sums, stream_total_plain(g2d)) if total else sums


def _workspace(dev: torch.device, stream: int, floats: int) -> int:
    """The address of the stream's work area: COUNTERS int32 tickets (0
    between calls) and then at least `floats` float32 of scratch for the
    blocks' and groups' rows. Calls on one stream run one after another, so
    they share it; another stream has its own."""
    ws = _work.get((dev, stream))
    if ws is None or ws.numel() < COUNTERS + floats:
        ws = _work[(dev, stream)] = torch.zeros(COUNTERS + floats,
                                                dtype=torch.int32, device=dev)
    return ws.data_ptr()


def _run(what: str, name: str, g2d: torch.Tensor, blocks: int,
         total: bool, *extra):
    """One launch into the output (L sums, then the total where asked);
    the host's part is kept short, as it is paid on every call."""
    fn = _fns.get(name)
    if fn is None:
        from ._build import load
        fn = _fns[name] = getattr(load(), name)
    rows, lanes = g2d.shape
    dev = g2d.device
    buf = torch.empty(lanes + total, dtype=torch.float32, device=dev)
    out = buf.data_ptr()
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        ws = _workspace(dev, stream, (blocks + -(-blocks // GROUP)) * lanes)
        err = fn(g2d.data_ptr(), ws + 4 * COUNTERS, ws, out,
                 out + 4 * lanes if total else None, rows, lanes,
                 _DTYPES[g2d.dtype], *extra, blocks, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")
    return (buf[:lanes], buf[lanes]) if total else buf


def stream_sum(g2d: torch.Tensor, total: bool = False):
    """Column sums on g2d's device; each kernel launch adds one to
    ``stream_sum.launches``.

    :param g2d: (R, L) float32 or bfloat16, contiguous
    :param total: also return the sum of the column sums (a float32
        scalar) from the same launch
    :return: (L,) float32, or ((L,), ()) with `total`
    """
    _check(g2d, "stream_sum")
    if not _on_card(g2d, "stream_sum"):
        return _plain(g2d, total)
    out = _run("stream_sum", "fseg_stream_sum", g2d, grid_blocks(g2d), total)
    stream_sum.launches += 1
    return out


stream_sum.launches = 0


def stream_sum_async(g2d: torch.Tensor, chunk: int = 64, nbuf: int = 4,
                     total: bool = False):
    """Column sums on g2d's device through an nbuf-deep ring of `chunk`-row
    tiles in shared memory; each kernel launch adds one to
    ``stream_sum_async.launches``.

    :param g2d: (R, L) float32 or bfloat16, contiguous
    :param total: also return the sum of the column sums from the same
        launch
    :return: (L,) float32, or ((L,), ()) with `total`
    """
    _check(g2d, "stream_sum_async")
    if not _on_card(g2d, "stream_sum_async"):
        return _plain(g2d, total)
    ring = nbuf * chunk * g2d.shape[1] * g2d.element_size()
    if not (1 <= nbuf <= MAX_NBUF and chunk >= 1 and ring <= MAX_RING):
        raise ValueError(f"stream_sum_async: chunk={chunk}, nbuf={nbuf} "
                         f"({ring} B of ring) outside nbuf 1..{MAX_NBUF}, "
                         f"ring <= {MAX_RING} B")
    out = _run("stream_sum_async", "fseg_stream_sum_async", g2d,
               grid_blocks(g2d, chunk, nbuf), total, chunk, nbuf)
    stream_sum_async.launches += 1
    return out


stream_sum_async.launches = 0
