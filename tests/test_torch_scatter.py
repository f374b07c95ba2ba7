"""Port parity: the scatter kernels' plain versions (K2-K4, K4 also from the
transpose's row offsets; kernels/scatter.py) against the JAX package's
Pallas kernels, the gather backward (`_GatherRows`) and the fused
EdgeConv's train backward against jax.grad, with and without a shared
graph transpose, and the transpose's plain version against numpy's
stable argsort.

On the CPU the Pallas kernels run in interpret mode (ops/_config.py) and the
port's wrappers run their plain versions. Inputs are made from a numpy seed
and cover an edge count that is no multiple of any tile, rows with no
incoming edge and hub rows that take a third of all edges.

Tolerances, on values scaled by the reference's largest magnitude (the
form of tests/test_pallas_kernels.py:96-141):
  * 1e-6 where both sides accumulate the exact payload in float32 — the
    port, JAX's `exact=True` f32 one-hot matmul, and bf16 payloads (exact in
    bf16 one-hot matmuls);
  * 2e-5 against JAX's default float32 path, which splits each payload into
    hi + lo bf16 halves (~16 mantissa bits);
  * K4 counts are integers: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.ops.edge import gather_neighbors as jgather
from fissure_segmentation_tpu.ops.fused_edge import \
    fused_edge_train as jfused_edge_train
from fissure_segmentation_tpu.ops.pallas.scatter import (scatter_add_mm,
                                                         scatter_add_mm2,
                                                         scatter_add_routed,
                                                         scatter_count as
                                                         jscatter_count)
from fissure_segmentation_tpu_torch.kernels import scatter as ks
from fissure_segmentation_tpu_torch.ops.edge import gather_neighbors
from fissure_segmentation_tpu_torch.ops.fused_edge import fused_edge_train

B, N, K, C = 2, 96, 5, 16
E = N * K + 37               # ragged: no multiple of 128 / 256 / 1024


def _targets(rng, b, e, n):
    """Targets with a hub row (0 takes a third of the edges) and eight rows
    that no edge reaches."""
    idx = rng.integers(1, n - 8, (b, e))
    idx[rng.random((b, e)) < 1 / 3] = 0
    return idx.astype(np.int32)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _payload(rng, shape, dtype):
    g = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    return g


def _torch(a, dtype):
    t = torch.tensor(np.asarray(a))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("jax_fn,dtype,tol", [
    ("mm_exact", "float32", 1e-6),
    ("mm", "float32", 2e-5),
    ("mm", "bfloat16", 1e-6),
    ("mm2", "float32", 2e-5),
    ("mm2", "bfloat16", 1e-6),
])
def test_scatter_rows_matches_pallas(jax_fn, dtype, tol):
    rng = np.random.default_rng(0)
    idx = _targets(rng, B, E, N)
    g = _payload(rng, (B, E, C), dtype)
    jg = jnp.asarray(g, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    if jax_fn == "mm2":
        want = scatter_add_mm2(jnp.asarray(idx), jg, N, tile_e=256)
    else:
        want = scatter_add_mm(jnp.asarray(idx), jg, N, tile_e=256,
                              exact=jax_fn == "mm_exact")
    got = ks.scatter_rows(torch.from_numpy(idx), _torch(g, dtype), N)
    assert got.dtype == torch.float32 and got.shape == (B, N, C)
    _close(got.numpy(), want, tol)
    assert not got[:, N - 8:].any()          # rows with no incoming edge


def test_scatter_rows_drops_out_of_range_targets():
    """Targets >= n_rows and < 0 contribute nothing, as in the Pallas kernel
    (and JAX's scatter for targets >= n_rows)."""
    rng = np.random.default_rng(1)
    idx = _targets(rng, B, E, N)
    idx[:, ::7] = N + 3
    idx[:, 3::11] = -2
    g = rng.standard_normal((B, E, C)).astype(np.float32)
    want = scatter_add_mm(jnp.asarray(idx), jnp.asarray(g), N, tile_e=256,
                          exact=True)
    got = ks.scatter_rows(torch.from_numpy(idx), torch.from_numpy(g), N)
    _close(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 1e-6)])
def test_scatter_routed_matches_pallas(dtype, tol):
    rng = np.random.default_rng(2)
    n, kk, c = 64, 7, 24
    idx = _targets(rng, B, n * kk, n).reshape(B, n, kk)
    kstar = rng.integers(0, kk, (B, n, c)).astype(np.int32)
    s = _payload(rng, (B, n, c), dtype)
    p = _payload(rng, (B, n, c), dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = scatter_add_routed(jnp.asarray(idx), jnp.asarray(kstar),
                              jnp.asarray(s, jdt), jnp.asarray(p, jdt), n)
    got = ks.scatter_routed(torch.from_numpy(idx), torch.from_numpy(kstar),
                            _torch(s, dtype), _torch(p, dtype), n)
    assert got.shape == (B, n, 2 * c)
    _close(got.numpy()[..., :c], np.asarray(want)[..., :c], tol)
    _close(got.numpy()[..., c:], np.asarray(want)[..., c:], tol)


@pytest.mark.parametrize("e,n", [(N * K, N), (1000, 64), (E, N)])
def test_scatter_count_equals_pallas(e, n):
    rng = np.random.default_rng(3)
    idx = _targets(rng, B, e, n)
    want = np.asarray(jscatter_count(jnp.asarray(idx), n))
    got = ks.scatter_count(torch.from_numpy(idx), n)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, 0].min() > e / 4 and not got[:, n - 8:].any()


def _count_case(name):
    """(B, E) int32 targets and n_rows: K4's hard cases."""
    rng = np.random.default_rng(len(name) + 11)
    if name == "dropped":                  # above n_rows and negative
        return rng.integers(-40, 1040, (2, 7001)).astype(np.int32), 1000
    if name == "hub":                      # row 7 takes 1250 of 5000 edges
        idx = rng.integers(0, 2000, (2, 5000))
        idx[:, ::4] = 7
        return idx.astype(np.int32), 2000
    if name == "n_rows_1":
        return rng.integers(-1, 2, (4, 999)).astype(np.int32), 1
    if name == "b_1":
        return _targets(rng, 1, N * K, N), N
    return _targets(rng, B, 4 * 97 + 3, N), N   # E no multiple of 4


@pytest.mark.parametrize("name", ["dropped", "hub", "n_rows_1", "b_1",
                                  "ragged_e"])
def test_scatter_count_from_transpose_equals_pallas(name):
    """K4 given the transpose (the differences of its row offsets) equals
    JAX's K4 in interpret mode and the plain histogram, exactly; the CPU
    wrapper launches nothing."""
    idx, n_rows = _count_case(name)
    want = np.asarray(jscatter_count(jnp.asarray(idx), n_rows))
    it = torch.from_numpy(idx)
    tr = ks.transpose_plain(it, n_rows)
    before = ks.scatter_count.launches
    got = ks.scatter_count(it, n_rows, tr)
    assert ks.scatter_count.launches == before
    assert got.dtype == torch.float32 and got.shape == idx.shape[:1] + (
        n_rows,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ks.scatter_count_plain(it, n_rows))
    assert torch.equal(got, ks.count_from_ptr_plain(tr[1], idx.shape[0],
                                                    n_rows))
    if name == "hub":
        assert (got[:, 7] >= 1250).all()


def test_scatter_count_checks_the_transpose():
    """A transpose of another graph size or dtype is refused before
    anything runs."""
    idx = torch.zeros((2, 6), dtype=torch.int32)
    order, ptr = ks.transpose(idx, 4)
    for bad, n_rows in (((order, ptr), 5), ((order.long(), ptr), 4),
                        ((order, ptr.long()), 4), ((order[:-1], ptr), 4)):
        with pytest.raises(ValueError, match="transposed"):
            ks.scatter_count(idx, n_rows, bad)
    with pytest.raises(ValueError, match="transposed"):
        ks.scatter_count(idx.reshape(3, 4), 4, (order, ptr))


def test_hist_max_rows_matches_the_kernel_source():
    """HIST_MAX_ROWS: the most n_rows whose int32 counters fit
    HIST_SMEM_MAX in csrc/scatter.cu, which fits a Hopper block's 232 448
    bytes of shared memory."""
    smem = _define("HIST_SMEM_MAX")
    assert smem <= 232448
    assert ks.HIST_MAX_ROWS * 4 <= smem < (ks.HIST_MAX_ROWS + 1) * 4


def test_gather_rows_backward_matches_jax_grad():
    """_GatherRows' backward (K2) equals jax.grad of gather_neighbors, with
    duplicate neighbours and hub rows; both sum exact f32 payloads, so the
    1e-6 scaled tolerance applies."""
    rng = np.random.default_rng(4)
    b, n, k, c = 2, 64, 6, 12
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = _targets(rng, b, n * k, n).reshape(b, n, k)
    w = rng.standard_normal((b, n, k, c)).astype(np.float32)

    def jloss(x):
        return jnp.sum(jgather(x, jnp.asarray(idx)) * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = gather_neighbors(xt, torch.from_numpy(idx))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jgather(jnp.asarray(x),
                                                     jnp.asarray(idx))))
    (out * torch.from_numpy(w)).sum().backward()
    _close(xt.grad.numpy(), want, 1e-6)


def test_wrappers_check_inputs():
    idx = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ks.scatter_rows(idx.long(), torch.zeros((1, 4, 3)), 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ks.scatter_rows(idx, torch.zeros((1, 4, 3), dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="shape"):
        ks.scatter_rows(idx, torch.zeros((1, 5, 3)), 2)
    with pytest.raises(ValueError, match="C=300"):
        ks.scatter_rows(idx, torch.zeros((1, 4, 300)), 2)
    with pytest.raises(ValueError, match="kstar shape"):
        ks.scatter_routed(torch.zeros((1, 2, 2), dtype=torch.int32),
                          torch.zeros((1, 2, 4), dtype=torch.int32),
                          torch.zeros((1, 2, 3)), torch.zeros((1, 2, 3)), 2)
    before = (ks.scatter_rows.launches, ks.scatter_routed.launches,
              ks.scatter_count.launches)
    ks.scatter_count(idx, 2)
    ks.scatter_rows(idx, torch.zeros((1, 4, 3)), 2)
    assert (ks.scatter_rows.launches, ks.scatter_routed.launches,
            ks.scatter_count.launches) == before   # CPU: plain versions


def _transpose_case(name):
    """(B, E) int32 targets and n_rows: the transpose's hard cases."""
    rng = np.random.default_rng(len(name))
    if name == "hub":                      # row 7 takes 1250 of 5000 edges
        idx = rng.integers(0, 2000, (2, 5000))
        idx[:, ::4] = 7
        return idx.astype(np.int32), 2000
    if name == "one_row":
        return np.full((3, 400), 5, np.int32), 10
    if name == "empty_rows":
        return rng.integers(0, 50, (2, 300)).astype(np.int32), 4096
    if name == "dropped":                  # below 0 and past the last row
        return rng.integers(-40, 1040, (2, 700)).astype(np.int32), 1000
    if name == "n_rows_1":
        return rng.integers(-1, 2, (4, 99)).astype(np.int32), 1
    return np.zeros((2, 0), np.int32), 10  # no edges


@pytest.mark.parametrize("name", ["hub", "one_row", "empty_rows", "dropped",
                                  "n_rows_1", "no_edges"])
def test_transpose_plain_matches_numpy_stable_argsort(name):
    """order: the flat edge ids by target row (b * n_rows + idx, dropped
    targets after the last row), ties in ascending id, as numpy's stable
    argsort orders them; ptr: each row's first position. int32, and the
    CPU wrapper is the plain version (no launch)."""
    idx, n_rows = _transpose_case(name)
    b, e = idx.shape
    key = np.where((idx >= 0) & (idx < n_rows),
                   idx + n_rows * np.arange(b)[:, None], b * n_rows)
    key = key.reshape(-1)
    want_order = np.argsort(key, kind="stable")
    want_ptr = np.searchsorted(key[want_order], np.arange(b * n_rows + 1))
    before = ks.transpose.launches
    order, ptr = ks.transpose(torch.from_numpy(idx), n_rows)
    assert ks.transpose.launches == before
    assert order.dtype == ptr.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(ptr.numpy(), want_ptr)
    order_p, ptr_p = ks.transpose_plain(torch.from_numpy(idx), n_rows)
    assert torch.equal(order, order_p) and torch.equal(ptr, ptr_p)


def test_gather_rows_backward_with_shared_transpose_matches_jax_grad():
    """The gradient of gather_neighbors given the graph's transpose (what
    DGCNNSeg's train forward shares between its EdgeConvs) equals jax.grad,
    as without it (test_gather_rows_backward_matches_jax_grad)."""
    rng = np.random.default_rng(4)
    b, n, k, c = 2, 64, 6, 12
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = _targets(rng, b, n * k, n).reshape(b, n, k)
    w = rng.standard_normal((b, n, k, c)).astype(np.float32)

    def jloss(x):
        return jnp.sum(jgather(x, jnp.asarray(idx)) * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tr = ks.transpose(torch.from_numpy(idx).reshape(b, n * k), n)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = gather_neighbors(xt, torch.from_numpy(idx), tr)
    (out * torch.from_numpy(w)).sum().backward()
    _close(xt.grad.numpy(), want, 1e-6)


def test_fused_edge_train_with_shared_transpose_matches_jax(monkeypatch):
    """fused_edge_train given the graph's transpose: forward and the four
    gradients against the JAX function, with test_torch_train.py's
    tolerances (the JAX backward splits f32 payloads into hi + lo bf16
    halves: 2e-4 for the gradients, 1e-5 for the forward)."""
    monkeypatch.setenv("FSEG_FUSED_EDGE", "1")
    monkeypatch.delenv("FSEG_FUSED_EDGE_TAIL", raising=False)
    rng = np.random.default_rng(6)
    b, n, kk, c = 2, 64, 7, 24
    a = rng.normal(size=(b, n, c)).astype(np.float32)
    cen = rng.normal(size=(b, n, c)).astype(np.float32)
    gamma = (rng.normal(size=c) + 0.3).astype(np.float32)   # some < 0
    beta = (rng.normal(size=c) * 0.2).astype(np.float32)
    idx = _targets(rng, b, n * kk, n).reshape(b, n, kk)
    w = rng.normal(size=a.shape).astype(np.float32)

    def jloss(a, cen, gamma, beta):
        out, _, _ = jfused_edge_train(a, cen, gamma, beta, jnp.asarray(idx),
                                      1e-5, 0.2)
        return jnp.sum(out * w), out

    (_, out_j), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(a, cen, gamma, beta)
    ins = [torch.from_numpy(v).requires_grad_(True)
           for v in (a, cen, gamma, beta)]
    tr = ks.transpose(torch.from_numpy(idx).reshape(b, n * kk), n)
    out, _, _ = fused_edge_train(*ins, torch.from_numpy(idx), 1e-5, 0.2, tr)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=1e-5,
                               atol=1e-5)
    for t, g, name in zip(ins, grads_j, ("a", "cen", "gamma", "beta")):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_fused_edge_train_without_transpose_equals_with_it(monkeypatch):
    """fused_edge_train's backward called with transposed=None builds the
    transpose itself, once for K3 and K4: the same forward and the same
    four gradients as given the caller's transpose."""
    monkeypatch.setenv("FSEG_FUSED_EDGE", "1")
    rng = np.random.default_rng(7)
    b, n, kk, c = 2, 64, 7, 24
    a = rng.normal(size=(b, n, c)).astype(np.float32)
    cen = rng.normal(size=(b, n, c)).astype(np.float32)
    gamma = (rng.normal(size=c) + 0.3).astype(np.float32)   # some < 0
    beta = (rng.normal(size=c) * 0.2).astype(np.float32)
    idx = torch.from_numpy(_targets(rng, b, n * kk, n).reshape(b, n, kk))
    w = torch.from_numpy(rng.normal(size=a.shape).astype(np.float32))
    runs = []
    for tr in (None, ks.transpose(idx.reshape(b, n * kk), n)):
        ins = [torch.from_numpy(v).requires_grad_(True)
               for v in (a, cen, gamma, beta)]
        out, _, _ = fused_edge_train(*ins, idx, 1e-5, 0.2, tr)
        (out * w).sum().backward()
        runs.append([out.detach()] + [t.grad for t in ins])
    for x, y, name in zip(*runs, ("out", "a", "cen", "gamma", "beta")):
        assert torch.equal(x, y), name


def test_shared_transpose_is_checked():
    """A transpose of another graph size or dtype is refused, on the CPU
    too, before anything runs."""
    idx = torch.zeros((2, 6), dtype=torch.int32)
    g = torch.zeros((2, 6, 3))
    order, ptr = ks.transpose(idx, 4)
    with pytest.raises(ValueError, match="transposed"):
        ks.scatter_rows(idx, g, 5, (order, ptr))
    with pytest.raises(ValueError, match="transposed"):
        ks.scatter_rows(idx, g, 4, (order.long(), ptr))
    with pytest.raises(ValueError, match="transposed"):
        ks.scatter_routed(idx.reshape(2, 3, 2),
                          torch.zeros((2, 3, 3), dtype=torch.int32),
                          torch.zeros((2, 3, 3)), torch.zeros((2, 3, 3)), 3,
                          (order, ptr))
    assert torch.equal(ks.scatter_rows(idx, g, 4, (order, ptr)),
                       ks.scatter_rows(idx, g, 4))


def _define(name: str) -> int:
    """The integer value of `#define name <int>` in csrc/scatter.cu."""
    import os
    import re
    path = os.path.join(os.path.dirname(ks.__file__), "csrc", "scatter.cu")
    with open(path) as f:
        m = re.search(rf"^#define {name} \(?(\d+)( \* (\d+))?", f.read(), re.M)
    return int(m.group(1)) * int(m.group(3) or 1)


def test_routed_staged_thresholds_match_the_kernel_source():
    """ROUTED_STAGED_MAX_N: the largest N whose staged p, s (32-byte rows)
    and uint8 kstar slices fit RS_SMEM_MAX in csrc/scatter.cu, which fits
    the 232 448 bytes a Hopper block may take."""
    smem, row = _define("RS_SMEM_MAX"), _define("RS_SROW")
    assert smem <= 232448
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        n = ks.ROUTED_STAGED_MAX_N[dtype]
        per_node = 2 * row + row // size
        assert n * per_node <= smem < (n + 1) * per_node


@pytest.mark.parametrize("kk", [1, 2, 3, 5, 7, 40, 41, 64, 127, 128, 200,
                                254, 255])
def test_routed_edge_quotient_from_a_float_product(kk):
    """The staged K3 turns a cloud-local edge id fl = node * kk + slot into
    (node, slot) by a float32 product with 1 / kk, truncated, corrected by
    one: numpy's float32 does the same roundings (round to nearest, the
    reciprocal correctly rounded); every id of the largest staged cloud
    comes out as divmod."""
    n = max(ks.ROUTED_STAGED_MAX_N.values())
    fl = np.arange(n * kk, dtype=np.int64)
    inv_k = np.float32(1.0) / np.float32(kk)
    q = np.trunc(fl.astype(np.float32) * inv_k).astype(np.int64)
    r = fl - q * kk
    q = np.where(r < 0, q - 1, np.where(r >= kk, q + 1, q))
    r = np.where(r < 0, r + kk, np.where(r >= kk, r - kk, r))
    assert np.array_equal(q, fl // kk) and np.array_equal(r, fl % kk)
    assert q.max() < 2 ** 24 and r.max() < 256       # node << 8 | slot
