"""Port parity of the streaming probes (kernels/stream.py, prof/probes.py):
the counterparts of the Pallas probes P1-P4 under scripts/prof/.

The TPU scripts run their full-size JAX work when imported, so each Pallas
kernel body is reproduced here at a small size and run in interpret mode on
the CPU (as the JAX package's own tests run its kernels): P4's `k_sum`
(prof_stream_bw.py:28) and P2's `k_stream` (prof_scatter_clean.py:56). On
the CPU the port's wrappers run their plain versions, the exact column sums
rounded once to float32. Tolerance: gamma_n * sum|g| per column
(`sum_bound`), n being the most float32 additions a value meets on the
Pallas side (its grid's steps plus a tile's rows) plus two for the plain
version's rounding.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fissure_segmentation_tpu_torch.kernels import scatter as ks
from fissure_segmentation_tpu_torch.kernels.stream import (
    GROUP, THREADS, depth, exact_payload, replay, stream_sum,
    stream_sum_async, stream_sum_plain, stream_total_plain, sum_bound)
from fissure_segmentation_tpu_torch.prof import probes

B, E, C = 2, 4096, 64          # a small payload of the probes' layout


def _payload(seed, dtype=jnp.bfloat16):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(B, E, C)).astype(np.float32)
    return np.array(jnp.asarray(g).astype(dtype).astype(jnp.float32)), \
        rng.integers(0, 2048, (B, E)).astype(np.int32)


def _torch(g, dtype):
    return torch.from_numpy(g).to(dtype)


def _p4_stream(g, rows, lanes, tile):
    """P4's `stream` (prof_stream_bw.py:35-46) on (B, rows, lanes) blocks
    (1, tile, lanes), body `k_sum`, in interpret mode -> (1, 1, lanes)."""
    def k_sum(g_ref, out_ref):
        @pl.when((pl.program_id(0) == 0) & (pl.program_id(1) == 0))
        def _():
            out_ref[...] = jnp.zeros_like(out_ref)
        out_ref[0, 0] += g_ref[0].astype(jnp.float32).sum(axis=0)
    return pl.pallas_call(
        k_sum, grid=(B, rows // tile),
        in_specs=[pl.BlockSpec((1, tile, lanes), lambda bi, ei: (bi, ei, 0))],
        out_specs=pl.BlockSpec((1, 1, lanes), lambda bi, ei: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, 1, lanes), jnp.float32),
        interpret=True)(g)


def _p2_stream_floor(g, lanes, tile):
    """P2's `stream_floor` (prof_scatter_clean.py:65-81), body `k_stream`
    with the 1e-20 * s side input (s = 0 here), in interpret mode ->
    (1, 128): the first 128 column sums, zero-padded below 128 lanes."""
    def k_stream(g_ref, s_ref, out_ref, *, lanes):
        @pl.when((pl.program_id(0) == 0) & (pl.program_id(1) == 0))
        def _():
            out_ref[...] = s_ref[...] * 1e-20
        out_ref[0, :] += g_ref[0].astype(jnp.float32).sum(axis=0)[:128] \
            if lanes >= 128 else jnp.pad(
                g_ref[0].astype(jnp.float32).sum(axis=0), (0, 128 - lanes))
    rows = B * E * C // lanes
    g2 = g.reshape(B, rows // B, lanes)
    return pl.pallas_call(
        functools.partial(k_stream, lanes=lanes),
        grid=(B, rows // B // tile),
        in_specs=[pl.BlockSpec((1, tile, lanes), lambda bi, ei: (bi, ei, 0)),
                  pl.BlockSpec((1, 128), lambda bi, ei: (0, 0))],
        out_specs=pl.BlockSpec((1, 128), lambda bi, ei: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, 128), jnp.float32),
        interpret=True)(g2, jnp.zeros((1, 128), jnp.float32))


@pytest.mark.parametrize("lanes", [64, 128, 512, 1024])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_stream_sum_matches_p4(lanes, dt):
    """stream_sum of the (R, L) view against P4's Pallas column sums."""
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[dt]
    g, _ = _payload(lanes, jdt)
    rows = E * C // lanes
    tile = min(rows, 256)
    want = np.asarray(_p4_stream(jnp.asarray(g).astype(jdt).reshape(
        B, rows, lanes), rows, lanes, tile=tile))[0, 0]
    view = _torch(g, tdt).view(-1, lanes)
    got = stream_sum(view)
    assert got.dtype == torch.float32 and got.shape == (lanes,)
    bound = sum_bound(view, B * rows // tile + tile + 2).numpy()
    assert (np.abs(got.numpy().astype(np.float64) - want) <= bound).all()
    assert torch.equal(stream_sum_async(view, 8, 2), stream_sum_plain(view))


@pytest.mark.parametrize("lanes", [64, 256])
def test_stream_sum_matches_p2(lanes):
    """stream_sum against P2's `stream_floor` output (1, 128)."""
    g, _ = _payload(3 + lanes)
    want = np.asarray(_p2_stream_floor(jnp.asarray(g).astype(jnp.bfloat16),
                                       lanes, tile=128))[0]
    view = _torch(g, torch.bfloat16).view(-1, lanes)
    got = np.pad(stream_sum(view).numpy(), (0, max(0, 128 - lanes)))[:128]
    steps = view.shape[0] // 128                  # B * (rows / B) / tile
    bound = np.pad(sum_bound(view, steps + 128 + 2).numpy(),
                   (0, max(0, 128 - lanes)))[:128]
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()


def test_p1_k_dot_matches_scatter_rows_plain():
    """P1's k_dot function, one-hot(idx mod 512)^T g per batch (numpy, in
    float64), against the port's K2 at 512 rows, which the probe times in
    its place: within the float32 rounding of a sum of each row's terms."""
    g, idx = _payload(7)
    lo = idx % probes.N_LO
    onehot = (lo[..., None] == np.arange(probes.N_LO)).astype(np.float64)
    want = np.einsum("ber,bec->brc", onehot, g.astype(np.float64))
    got = ks.scatter_rows_plain(torch.from_numpy(lo),
                                _torch(g, torch.bfloat16), probes.N_LO)
    deg = onehot.sum(1)[..., None]
    bound = deg * 2.0 ** -24 * np.einsum("ber,bec->brc", onehot, np.abs(g))
    assert got.shape == (B, probes.N_LO, C)
    assert (np.abs(got.numpy() - want) <= bound).all()


def test_p1_k_onehot_matches_numpy():
    """P1's k_onehot function: counts of idx mod 512 over every batch plus
    the zero-padded column sums of the payload, as the probe computes it
    (K4 + stream_sum), against numpy."""
    g, idx = _payload(9)
    lo = idx % probes.N_LO
    want = np.bincount(lo.ravel(), minlength=probes.N_LO).astype(np.float64)
    want[:C] += g.reshape(-1, C).astype(np.float64).sum(0)
    view = _torch(g, torch.bfloat16).view(-1, C)
    got = (ks.scatter_count(torch.from_numpy(lo), probes.N_LO).sum(0)
           + torch.nn.functional.pad(stream_sum(view), (0, probes.N_LO - C)))
    # the plain sums' rounding, float64's, and the add of the exact counts
    bound = np.pad(sum_bound(view, 4).numpy(), (0, probes.N_LO - C))
    assert (np.abs(got.numpy() - want) <= bound).all()


def test_rounding_bound_covers_a_sequential_sum():
    """The bound holds for the worst order: one sequential float32 sum, R
    additions from zero; the plain version is within one rounding."""
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3000, 8)).astype(np.float32))
    seq = torch.zeros(8)
    for row in g:
        seq = seq + row
    exact = g.double().sum(0)
    assert ((seq.double() - exact).abs() <= sum_bound(g, g.shape[0])).all()
    assert ((stream_sum_plain(g).double() - exact).abs()
            <= sum_bound(g, 1)).all()


def _kernel_order(g, elem, blocks, chunk=None):
    """csrc/stream.cu's order of float32 additions, written out thread by
    thread: stream_sum_kernel (chunk None: 256-vector unit u to block
    u % blocks, the last block also the vectors past the last whole unit)
    or stream_async_kernel (tile t to block t % blocks, thread tid
    its vectors tid, tid + 256, ... of the tile); then the butterfly inside
    each warp, the warps in order, groups of GROUP blocks, the groups, and
    the total over 32 lanes. `g` holds the values as float32. Returns (sums,
    total, most additions a value met to a column sum, to the total)."""
    rows, lanes = g.shape
    v = 16 // elem
    ngr = lanes // v
    vec = g.reshape(-1, v)
    seqs = [[[] for _ in range(THREADS)] for _ in range(blocks)]
    if chunk is None:
        units = len(vec) // THREADS
        for u in range(units):
            for t in range(THREADS):
                seqs[u % blocks][t].append(u * THREADS + t)
        for t in range(len(vec) - units * THREADS):
            seqs[blocks - 1][t].append(units * THREADS + t)
    else:
        for tile in range(-(-rows // chunk)):
            n = min(chunk, rows - tile * chunk) * ngr
            for j in range(n):
                seqs[tile % blocks][j % THREADS].append(tile * chunk * ngr + j)
    part, mpart = [], []
    for b in range(blocks):
        acc = np.zeros((THREADS, v), np.float32)
        met = np.zeros(THREADS, np.int64)
        for t in range(THREADS):
            for j in seqs[b][t]:
                acc[t] = acc[t] + vec[j]
                met[t] += 1
        off = 16
        while off >= ngr:                   # the warp's row lanes
            p = np.arange(THREADS) ^ off
            acc, met = acc + acc[p], np.maximum(met, met[p]) + 1
            off //= 2
        row, mrow = np.zeros(lanes, np.float32), np.zeros(lanes, np.int64)
        for col in range(lanes):
            cg, e = divmod(col, v)
            for w in range(THREADS // 32):  # one lane of each warp that has cg
                ts = [t for t in range(32 * w, 32 * w + 32) if t % ngr == cg]
                if ts:
                    row[col] = row[col] + acc[ts[0], e]
                    mrow[col] = max(mrow[col], met[ts[0]]) + 1
        part.append(row)
        mpart.append(mrow)

    def in_order(rs, ms):
        s, m = np.zeros(lanes, np.float32), np.zeros(lanes, np.int64)
        for r, mr in zip(rs, ms):
            s, m = s + r, np.maximum(m, mr) + 1
        return s, m
    grp = [in_order(part[q:q + GROUP], mpart[q:q + GROUP])
           for q in range(0, blocks, GROUP)]
    sums, msum = in_order([x for x, _ in grp], [m for _, m in grp])
    lane_s, lane_m = np.zeros(32, np.float32), np.zeros(32, np.int64)
    for col in range(lanes):
        lane_s[col % 32] = lane_s[col % 32] + sums[col]
        lane_m[col % 32] = max(lane_m[col % 32], msum[col]) + 1
    off = 16
    while off >= 1:
        p = np.arange(32) ^ off
        lane_s, lane_m = lane_s + lane_s[p], np.maximum(lane_m, lane_m[p]) + 1
        off //= 2
    return sums, lane_s[0], int(msum.max()), int(lane_m[0])


def _check_order(g, elem, blocks, chunk=None):
    """The written-out order against kernels/stream.py's vectorised
    `replay` (bit for bit) and `depth`; the bound at that depth covers the
    sums and the total."""
    sums, total, met, met_total = _kernel_order(g, elem, blocks, chunk)
    got = replay(g, elem, blocks, chunk)
    assert np.array_equal(got[0], sums) and got[1] == total
    assert got[2:] == (met, met_total)
    rows, lanes = g.shape
    n = depth(rows, lanes, elem, blocks, chunk)
    n_total = depth(rows, lanes, elem, blocks, chunk, total=True)
    assert met <= n and met_total <= n_total
    exact = g.astype(np.float64).sum(0)
    assert (np.abs(sums - exact) <= sum_bound(torch.from_numpy(g), n).numpy()
            ).all()
    gamma = n_total * 2.0 ** -24 / (1 - n_total * 2.0 ** -24)
    assert abs(float(total) - exact.sum()) <= gamma * np.abs(g).sum()


@pytest.mark.parametrize("rows,lanes,blocks", [(300, 8, 3), (1000, 64, 4),
                                               (5, 16, 2)])
def test_depth_counts_stream_sums_additions(rows, lanes, blocks):
    """`depth` is never below the additions a value meets in stream_sum's
    order (float32, written out in numpy), and that order's sums are within
    `sum_bound` at that depth."""
    g = np.random.default_rng(rows).normal(size=(rows, lanes)).astype(
        np.float32)
    _check_order(g, 4, blocks)


@pytest.mark.parametrize("rows,lanes,elem,blocks,chunk", [
    (600, 128, 2, 37, None),       # two levels of groups, bfloat16
    (1001, 8, 2, 1, None),         # vectors past the last whole unit
    (7, 4, 4, 1, None),            # fewer vectors than a unit
    (70, 1024, 4, 5, None),        # L past the 256 threads
    (1000, 64, 4, 5, 16),          # the ring: rows off the tile
    (333, 128, 2, 21, 32),         # the ring, bfloat16, two levels
    (50, 512, 4, 3, 7)])           # the ring: tiles of 7 rows at L = 512
def test_depth_counts_both_kernels_orders(rows, lanes, elem, blocks, chunk):
    """The same for bfloat16 values, both kernels and the finish's two
    levels of groups: the written-out order equals `replay`, `depth` covers
    it, and the bound covers its sums and its total."""
    g = np.random.default_rng(rows + lanes).normal(size=(rows, lanes))
    if elem == 2:                              # bfloat16 values, widened
        g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    _check_order(g.astype(np.float32), elem, blocks, chunk)


def test_stream_sums_total_on_the_cpu():
    """With `total=True` both wrappers also return the total; on the CPU
    each is the plain version's, the exact sums rounded once."""
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=(300, 16)).astype(np.float32)).to(torch.bfloat16)
    for sums, total in (stream_sum(g, total=True),
                        stream_sum_async(g, 32, 2, total=True)):
        assert torch.equal(sums, stream_sum_plain(g))
        assert total.shape == () and total.dtype == torch.float32
        assert torch.equal(total, stream_total_plain(g))
        assert float(total) == np.float32(g.double().sum().item())


def test_exact_payload_sums_exactly():
    """Integers 1..4: float32 sums in any order equal the exact sum; a
    payload whose sums could pass 2^24 is refused."""
    ints = exact_payload(torch.empty((5000, 8), dtype=torch.bfloat16))
    assert set(torch.unique(ints.float()).tolist()) == {1.0, 2.0, 3.0, 4.0}
    f = ints.float()
    fwd, back = torch.zeros(8), torch.zeros(8)
    for i in range(f.shape[0]):
        fwd, back = fwd + f[i], back + f[-1 - i]
    assert torch.equal(fwd, stream_sum_plain(ints))
    assert torch.equal(back, stream_sum_plain(ints))
    with pytest.raises(ValueError, match="2\\^24"):
        exact_payload(torch.empty((2 ** 22, 1)))


def test_probes_need_a_card():
    """The probe entry point raises without a card instead of timing the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        probes.main([])
    with pytest.raises(RuntimeError, match="NVIDIA card"):
        probes.run(reps=1)
