"""Port parity: the fused EdgeConv gather-reduce (kernels/gather_reduce.py,
the counterpart of the Pallas probe scripts/prof/prof_fused_gather.py, P5)
against the JAX package's `_gather_reduce` and P5's XLA function, and the
port's flat gather's out-of-range semantics against JAX's.

On the CPU the wrapper runs its plain version. Tolerances: max, min and
their slots are exact (every side compares the same values); s1 and s2 are
float32 sums of K terms in another order than XLA's, so each is held
within K * 2^-24 * sum|term| of the JAX value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.ops.edge import _flat_gather as jflat_gather
from fissure_segmentation_tpu.ops.edge import gather_neighbors as jgather
from fissure_segmentation_tpu.ops.fused_edge import \
    _gather_reduce as jgather_reduce
from fissure_segmentation_tpu.ops.fused_edge import \
    fused_edge_eval as jfused_edge_eval
from fissure_segmentation_tpu_torch.kernels.gather_reduce import (
    flat_rows, gather_reduce, gather_reduce_plain)
from fissure_segmentation_tpu_torch.ops.edge import (_flat_gather,
                                                     gather_neighbors)
from fissure_segmentation_tpu_torch.ops.fused_edge import fused_edge_eval

B, N, K, C = 3, 96, 11, 20
EPS32 = 2.0 ** -24
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _case(seed, ties=False, b=B, n=N, k=K, c=C):
    rng = np.random.default_rng(seed)
    if ties:   # an integer lattice: maxima and minima tie between slots
        a = rng.integers(0, 3, (b, n, c)).astype(np.float32)
    else:
        a = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    return a, idx


def _out_of_range(idx, n):
    """Indices past both ends: -1 (the last row of the flat table), n + 3
    (clamped or the next cloud's row), and far below -B * n (row 0)."""
    idx = idx.copy()
    idx[:, ::5, 0] = -1
    idx[:, 2::7, 3] = n + 3
    idx[-1, :, 4] = -50 * n
    return idx


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("ties", [False, True], ids=["generic", "ties"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gather_reduce_matches_jax(dt, ties):
    """Every output of want="all" against the JAX package's _gather_reduce
    on the same inputs (bf16 tables are the same bf16 values on both
    sides); on the lattice the slots must be the first extremal ones."""
    tdt, jdt = DTYPES[dt]
    a, idx = _case(3 + ties, ties)
    ta = _to_torch(a, tdt)
    ja = jnp.asarray(a).astype(jdt)
    mx, mn, am, amn, s1, s2 = gather_reduce(ta, torch.from_numpy(idx))
    jmx, jmn, jam, jamn, js1, js2 = (np.asarray(v) for v in
                                     jgather_reduce(ja, jnp.asarray(idx)))
    assert mx.dtype == tdt and am.dtype == torch.int32
    np.testing.assert_array_equal(mx.float().numpy(), jmx.astype(np.float32))
    np.testing.assert_array_equal(mn.float().numpy(), jmn.astype(np.float32))
    np.testing.assert_array_equal(am.numpy(), jam)
    np.testing.assert_array_equal(amn.numpy(), jamn)
    g = np.asarray(jflat_gather(ja, jnp.asarray(idx))).astype(np.float32)
    bound1 = K * EPS32 * np.abs(g).sum(2)
    bound2 = K * EPS32 * (g * g).sum(2)
    assert (np.abs(s1.numpy() - js1) <= bound1).all()
    assert (np.abs(s2.numpy() - js2) <= bound2).all()


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gather_reduce_max_matches_p5(dt):
    """want="max" against P5's XLA reference, `xla_gather_max` of
    scripts/prof/prof_fused_gather.py (reproduced here at a small size: the
    script runs its full-size JAX work when imported), with K > 32 slots:
    equal."""
    tdt, jdt = DTYPES[dt]
    b, n, k, f = 2, 64, 40, 16
    a, idx = _case(7, b=b, n=n, k=k, c=f)

    def xla_gather_max(idx, a):
        offs = jnp.arange(b, dtype=idx.dtype)[:, None, None] * n
        g = a.reshape(b * n, f)[(idx + offs).reshape(-1)].reshape(b, n, k, f)
        return g.max(-2)
    want = np.asarray(xla_gather_max(jnp.asarray(idx),
                                     jnp.asarray(a).astype(jdt)))
    (got,) = gather_reduce(_to_torch(a, tdt), torch.from_numpy(idx), "max")
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_gather_reduce_wants_agree():
    """"max" and "extrema" are the leading outputs of "all"."""
    a, idx = _case(9)
    ta, ti = torch.from_numpy(a), torch.from_numpy(idx)
    full = gather_reduce(ta, ti, "all")
    for want, n_out in (("max", 1), ("extrema", 2)):
        got = gather_reduce(ta, ti, want)
        assert len(got) == n_out
        for x, y in zip(got, full):
            assert torch.equal(x, y)


def test_gather_reduce_propagates_nan_like_jax():
    """A NaN among the slots is the max and the min, at the slot of the
    first NaN, as jnp.max / jnp.argmax give it."""
    a, idx = _case(11)
    a[0, 5] = np.nan
    a[1, 7, :3] = np.nan
    idx[0, :, 2] = 5
    idx[0, :, 6] = 5
    idx[1, :8, 1] = 7
    got = gather_reduce(torch.from_numpy(a), torch.from_numpy(idx))
    want = jgather_reduce(jnp.asarray(a), jnp.asarray(idx))
    for g_, w_ in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gather_reduce_out_of_range_matches_jax(dt):
    """Indices out of range read the rows JAX's flat gather reads (a
    negative flat index counts once from the end, then the index is
    clamped): every output as in test_gather_reduce_matches_jax."""
    tdt, jdt = DTYPES[dt]
    a, idx = _case(13)
    idx = _out_of_range(idx, N)
    ja = jnp.asarray(a).astype(jdt)
    got = gather_reduce(_to_torch(a, tdt), torch.from_numpy(idx))
    want = [np.asarray(v) for v in jgather_reduce(ja, jnp.asarray(idx))]
    for g_, w_ in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g_.float().numpy(),
                                      w_.astype(g_.float().numpy().dtype))
    g = np.asarray(jflat_gather(ja, jnp.asarray(idx))).astype(np.float32)
    assert (np.abs(got[4].numpy() - want[4])
            <= K * EPS32 * np.abs(g).sum(2)).all()


def test_flat_gather_clamps_like_jax():
    """The port's flat gather (`_flat_gather`, the `_GatherRows` forward
    through `gather_neighbors`) reads the rows JAX's reads for indices out
    of range, where index_select would raise: equal."""
    a, idx = _case(17)
    idx = _out_of_range(idx, N)
    want = np.asarray(jflat_gather(jnp.asarray(a), jnp.asarray(idx)))
    ta, ti = torch.from_numpy(a), torch.from_numpy(idx)
    np.testing.assert_array_equal(_flat_gather(ta, ti).numpy(), want)
    np.testing.assert_array_equal(gather_neighbors(ta, ti).numpy(),
                                  np.asarray(jgather(jnp.asarray(a),
                                                     jnp.asarray(idx))))
    rows = flat_rows(ti, N).numpy()
    assert rows.min() >= 0 and rows.max() < B * N
    assert (rows[:, ::5, 0] == np.arange(B)[:, None] * N - 1
            + (np.arange(B)[:, None] == 0) * B * N).all()


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fused_edge_eval_matches_jax(dt):
    """The eval-mode fused EdgeConv core (gather-reduce "extrema", then the
    pointwise tail) against the JAX function: f32 within 1e-5; in bf16 the
    output is rounded to bf16 once on both sides, so within 2^-8 of the
    largest magnitude."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(19)
    a, idx = _case(19)
    cen = rng.normal(size=a.shape).astype(np.float32)
    gamma = (rng.normal(size=C) + 0.3).astype(np.float32)
    beta = (rng.normal(size=C) * 0.2).astype(np.float32)
    ra_mean = (rng.normal(size=C) * 0.1).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, C).astype(np.float32)
    want = np.asarray(jfused_edge_eval(
        jnp.asarray(a).astype(jdt), jnp.asarray(cen).astype(jdt),
        gamma, beta, ra_mean, ra_var, jnp.asarray(idx), 1e-5, 0.2)
    ).astype(np.float32)
    with torch.no_grad():
        got = fused_edge_eval(_to_torch(a, tdt), _to_torch(cen, tdt),
                              *(torch.from_numpy(v) for v in
                                (gamma, beta, ra_mean, ra_var)),
                              torch.from_numpy(idx), 1e-5, 0.2)
    assert got.dtype == tdt
    tol = 1e-5 if dt == "f32" else 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_gather_reduce_checks_input():
    a = torch.zeros((2, 8, 4))
    idx = torch.zeros((2, 8, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="want"):
        gather_reduce(a, idx, "sum")
    with pytest.raises(TypeError, match="int32"):
        gather_reduce(a, idx.long())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gather_reduce(a.double(), idx)
    with pytest.raises(ValueError, match="C=300"):
        gather_reduce(torch.zeros((2, 8, 300)), idx)
    with pytest.raises(RuntimeError, match="no gradient"):
        gather_reduce(a.requires_grad_(), idx)
    with torch.no_grad():
        assert len(gather_reduce(a, idx, "extrema")) == 2
    assert gather_reduce_plain(a.detach(), idx, "max")[0].shape == (2, 8, 4)


def _define(source: str, name: str) -> int:
    """The integer value of `#define name <int>` in a kernel source."""
    import os
    import re
    import fissure_segmentation_tpu_torch.kernels as kernels
    path = os.path.join(os.path.dirname(kernels.__file__), "csrc", source)
    with open(path) as f:
        m = re.search(rf"^#define {name} \(?(\d+)", f.read(), re.M)
    return int(m.group(1))


def test_staged_threshold_matches_the_kernel_source():
    """STAGED_MAX_N is csrc/gather_reduce.cu's GS_MAX_N, and the staged
    kernel's shared memory at that N (the slice's 64-byte rows and the
    staged slots of the most warps a block takes) fits the 232 448 bytes a
    Hopper block may take."""
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import \
        STAGED_MAX_N
    assert STAGED_MAX_N == _define("gather_reduce.cu", "GS_MAX_N")
    row = _define("gather_reduce.cu", "GS_ROW")
    slots = (_define("gather_reduce.cu", "GS_MAX_WARPS")
             * _define("gather_reduce.cu", "GS_PPW")
             * _define("gather_reduce.cu", "GS_IDX_PITCH") * 4)
    assert _define("gather_reduce.cu", "GS_IDX_PITCH") >= \
        _define("gather_reduce.cu", "GS_SLOTS")
    assert STAGED_MAX_N * row + slots <= 232448


def test_cluster_route_fits_the_kernel_source():
    """The cluster route's shared memory at GS_MAX_N fits the 232 448 bytes
    a Hopper block may take, at the 64-byte slices of the source (GS_LPP
    lanes a point) and at the 32- and 16-byte ones the few-cloud sweep
    builds: the slice's rows (rounded up to whole tensor-map boxes), the
    staged slots of the most warps a block takes (32 / lanes points a
    warp), its two mbarriers and a flag for each block of the cluster. Its
    clusters have at most 16 blocks, and where they may have more than 8
    the source allows non-portable cluster sizes; the route numbers are the
    wrapper's ROUTES."""
    import os
    import fissure_segmentation_tpu_torch.kernels as kernels
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import (
        ROUTES, STAGED_MAX_N)
    with open(os.path.join(os.path.dirname(kernels.__file__), "csrc",
                           "gather_reduce.cu")) as f:
        src = f.read()
    lanes = _define("gather_reduce.cu", "GS_LPP")
    assert _define("gather_reduce.cu", "GS_ROW") == 16 * lanes
    assert _define("gather_reduce.cu", "GS_PPW") == 32 // lanes
    warps = _define("gather_reduce.cu", "GS_MAX_WARPS")
    pitch = _define("gather_reduce.cu", "GS_IDX_PITCH")
    bar = _define("gather_reduce.cu", "GC_BAR_BYTES")
    most = _define("gather_reduce.cu", "GC_MAX_P")
    assert bar >= 16 + 4 * most    # two mbarriers, a flag a block
    box = _define("gather_reduce.cu", "GC_BOX")
    rows = -(-STAGED_MAX_N // box) * box   # whole boxes
    for lpp in (4, 2, 1):
        slots = warps * (32 // lpp) * pitch * 4
        assert rows * 16 * lpp + slots + bar <= 232448
    assert 2 <= most <= 16
    if most > 8:
        assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in src
    for i, kind in enumerate(ROUTES):
        assert f"route {i}, the {kind}" in src


def test_cpu_calls_are_not_counted_as_launches():
    """On the CPU the wrapper runs the plain version: no launch and no call
    is counted; call_key names a call by want, dtype and shape."""
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import call_key
    a, idx = _case(7)
    a, idx = torch.from_numpy(a), torch.from_numpy(idx)
    before, calls = gather_reduce.launches, dict(gather_reduce.calls)
    gather_reduce(a, idx, "all")
    assert gather_reduce.launches == before and gather_reduce.calls == calls
    assert call_key(a.bfloat16(), idx, "max") == f"max_bfloat16_{B}x{N}x{K}x{C}"
