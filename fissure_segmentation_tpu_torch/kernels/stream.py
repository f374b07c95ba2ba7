"""Streaming column sums — wrappers of csrc/stream.cu and their plain
PyTorch version: the card's counterparts of the Pallas streaming probes
under scripts/prof/ (P1 `k_stream`, P2 `stream_floor`, P3
`pallas_blockspec` and `manual_reduce`, P4 `stream`), which measure how fast
a chip streams the scatter's payload.

  `stream_sum(g2d)`                    16-byte vector loads, grid-stride
  `stream_sum_async(g2d, chunk, nbuf)` each block's `chunk`-row tiles
                                       brought into shared memory by an
                                       nbuf-deep ring of bulk asynchronous
                                       copies (cp.async.bulk + mbarrier)

Both return the (L,) float32 column sums of a contiguous (R, L) float32 or
bfloat16 view, deterministically (a fixed order of additions; see the head
of csrc/stream.cu). The plain version is the exact sum (float64) rounded
once to float32. In a kernel each value meets at most `depth` float32
additions on its way to its column sum (its thread's own sequence, one per
row lane of its block, one per block), so the kernel is within
gamma_depth * sum|g| of the exact sum (gamma_n = n u / (1 - n u),
u = 2^-24); `rounding_bound` adds the plain version's own rounding. On a
payload of small positive integers (`exact_payload`) every partial sum is
exact, so there kernel and plain version are equal, and a dropped or
repeated row shows.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; there is no fallback from one to the other. L must
be a multiple of the 16-byte vector (4 float32 or 8 bfloat16 values) with
L / vector dividing 256, and the ring at most 200 KB.
"""
from __future__ import annotations

import ctypes

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256            # csrc/stream.cu ST_THREADS
MAX_NBUF = 16            # ST_MAX_NBUF
MAX_RING = 200 * 1024    # bytes of shared memory the ring may take
SM_BYTES = 220 * 1024    # what one SM's blocks may take together
EPS32 = 2.0 ** -24


def stream_sum_plain(g2d: torch.Tensor) -> torch.Tensor:
    """Plain column sums: (R, L) -> (L,) float32, the exact sums (float64)
    rounded once."""
    return g2d.double().sum(0).float()


def grid_blocks(g2d: torch.Tensor, chunk: int | None = None,
                nbuf: int | None = None) -> int:
    """The blocks `stream_sum` (chunk None) or `stream_sum_async(g2d,
    chunk, nbuf)` launches on g2d's card."""
    sms = torch.cuda.get_device_properties(g2d.device).multi_processor_count
    if chunk is None:
        return 8 * sms                  # 8 blocks of 256 threads fill an SM
    ring = nbuf * chunk * g2d.shape[1] * g2d.element_size()
    # the static shared memory (barriers and the reduction buffer) is under
    # 9 KB a block; at most 8 blocks of 256 threads an SM
    return max(1, min(8, SM_BYTES // (ring + 9 * 1024))) * sms


def depth(rows: int, lanes: int, elem: int, blocks: int,
          chunk: int | None = None) -> int:
    """Most float32 additions a value meets in the kernel: its thread's own
    sequence (grid-stride rows, or its rows of each of its block's tiles),
    then one per row lane of the block, then one per block."""
    row_lanes = THREADS // (lanes // (16 // elem))
    if chunk is None:
        own = -(-rows // (blocks * row_lanes))
    else:
        own = -(-(-(-rows // chunk)) // blocks) * -(-chunk // row_lanes)
    return own + row_lanes + blocks


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


def _run(what: str, fn, g2d: torch.Tensor, blocks: int, *extra):
    from ._build import load
    lanes = g2d.shape[1]
    part = torch.empty((blocks, lanes), dtype=torch.float32,
                       device=g2d.device)
    out = torch.empty(lanes, dtype=torch.float32, device=g2d.device)
    with torch.cuda.device(g2d.device):
        stream = torch.cuda.current_stream(g2d.device).cuda_stream
        err = getattr(load(), fn)(g2d.data_ptr(), part.data_ptr(),
                                  out.data_ptr(), g2d.shape[0], lanes,
                                  _DTYPES[g2d.dtype], *extra, blocks,
                                  ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")
    return out


def stream_sum(g2d: torch.Tensor) -> torch.Tensor:
    """Column sums on g2d's device; each kernel launch adds one to
    ``stream_sum.launches``.

    :param g2d: (R, L) float32 or bfloat16, contiguous
    :return: (L,) float32
    """
    _check(g2d, "stream_sum")
    if not _on_card(g2d, "stream_sum"):
        return stream_sum_plain(g2d)
    out = _run("stream_sum", "fseg_stream_sum", g2d, grid_blocks(g2d))
    stream_sum.launches += 1
    return out


stream_sum.launches = 0


def stream_sum_async(g2d: torch.Tensor, chunk: int = 64,
                     nbuf: int = 4) -> torch.Tensor:
    """Column sums on g2d's device through an nbuf-deep ring of `chunk`-row
    tiles in shared memory; each kernel launch adds one to
    ``stream_sum_async.launches``.

    :param g2d: (R, L) float32 or bfloat16, contiguous
    :return: (L,) float32
    """
    _check(g2d, "stream_sum_async")
    if not _on_card(g2d, "stream_sum_async"):
        return stream_sum_plain(g2d)
    ring = nbuf * chunk * g2d.shape[1] * g2d.element_size()
    if not (1 <= nbuf <= MAX_NBUF and chunk >= 1 and ring <= MAX_RING):
        raise ValueError(f"stream_sum_async: chunk={chunk}, nbuf={nbuf} "
                         f"({ring} B of ring) outside nbuf 1..{MAX_NBUF}, "
                         f"ring <= {MAX_RING} B")
    out = _run("stream_sum_async", "fseg_stream_sum_async", g2d,
               grid_blocks(g2d, chunk, nbuf), chunk, nbuf)
    stream_sum_async.launches += 1
    return out


stream_sum_async.launches = 0
