"""Port parity: the scatter kernels' plain versions (K2-K4,
kernels/scatter.py) against the JAX package's Pallas kernels, and the
gather backward (`_GatherRows`) against jax.grad.

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
from fissure_segmentation_tpu.ops.pallas.scatter import (scatter_add_mm,
                                                         scatter_add_mm2,
                                                         scatter_add_routed,
                                                         scatter_count as
                                                         jscatter_count)
from fissure_segmentation_tpu_torch.kernels import scatter as ks
from fissure_segmentation_tpu_torch.ops.edge import gather_neighbors

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
