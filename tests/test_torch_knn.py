"""Port parity for K1 (kNN): the plain PyTorch version of the kernel
(kernels/knn.py:knn_plain) against the JAX package's Pallas kernel
(ops/pallas/knn.py:knn_pallas, in interpret mode on the CPU) and its XLA
path (ops/knn.py:knn).

Exact comparisons use coordinates that are multiples of 1/16 (or 1/8):
every difference, square and sum is then exact in float32, so the distance
bits do not depend on how a compiler fuses `d + diff * diff` (XLA's CPU
backend contracts it to an FMA for some shapes and not others), and the
clouds are full of exact ties, which pins the lowest-index-first order.
On generic float inputs the test states a tolerance instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.ops.knn import knn as jknn
from fissure_segmentation_tpu.ops.pallas.knn import knn_pallas
from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda, knn_plain
from fissure_segmentation_tpu_torch.ops.knn import knn


def _dyadic(rng, shape, lo=-24, hi=24, denom=16.0):
    return (rng.integers(lo, hi + 1, shape) / denom).astype(np.float32)


def _lattice_with_duplicates(rng, b, n):
    """Integer-lattice points (heavy distance ties), with a block of exact
    duplicates at (-1, -1, -1) like serving's invalid keypoints."""
    x = rng.integers(0, 5, (b, n, 3)).astype(np.float32)
    x[:, : n // 5] = -1.0
    return x


CASES = [
    # (name, cloud maker, k, Pallas tile sizes)
    ("single_tile_ragged", lambda r: _dyadic(r, (2, 150, 3)), 7, {}),
    ("multi_tile_ragged", lambda r: _dyadic(r, (2, 150, 3)), 7,
     dict(tq=64, tk=64)),
    ("lattice_ties", lambda r: _lattice_with_duplicates(r, 2, 200), 10,
     dict(tq=64, tk=64)),
    ("lattice_ties_single", lambda r: _lattice_with_duplicates(r, 1, 130), 12,
     {}),
    ("channels_5", lambda r: _dyadic(r, (1, 100, 5), denom=8.0), 6,
     dict(tq=64, tk=64)),
]


@pytest.mark.parametrize("self_loop", [False, True])
@pytest.mark.parametrize("name,make,k,tiles", CASES,
                         ids=[c[0] for c in CASES])
def test_knn_plain_equals_knn_pallas(name, make, k, tiles, self_loop):
    """Indices and distances bit-equal (tolerance 0)."""
    x = make(np.random.default_rng(0))
    i_j, d_j = knn_pallas(jnp.asarray(x), k, self_loop=self_loop,
                          return_dist=True, **tiles)
    i_t, d_t = knn_plain(torch.from_numpy(x), k, self_loop)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("self_loop", [False, True])
def test_knn_plain_generic_floats_close_to_knn_pallas(self_loop):
    """Generic floats: distances within 1 ulp-ish (rtol 1e-6) of the Pallas
    kernel's (whose sum XLA may contract to an FMA); indices equal wherever
    the distance is not a near-tie."""
    x = np.random.default_rng(1).standard_normal((2, 150, 3)).astype(np.float32)
    i_j, d_j = knn_pallas(jnp.asarray(x), 7, self_loop=self_loop,
                          return_dist=True, tq=64, tk=64)
    i_t, d_t = knn_plain(torch.from_numpy(x), 7, self_loop)
    i_j, d_j = np.asarray(i_j), np.asarray(d_j)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-6, atol=1e-7)
    mism = i_t.numpy() != i_j
    np.testing.assert_allclose(d_t.numpy()[mism], d_j[mism], rtol=1e-6)


@pytest.mark.parametrize("self_loop", [False, True])
def test_knn_plain_matches_xla_knn_distances(self_loop):
    """Against the XLA path (|x|^2 - 2x.y + |y|^2, another formula):
    sorted distances within 1e-5."""
    x = np.random.default_rng(2).standard_normal((2, 90, 3)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        _, d_j = jknn(jnp.asarray(x), 9, self_loop=self_loop,
                      return_dist=True, use_pallas=False)
    _, d_t = knn_plain(torch.from_numpy(x), 9, self_loop)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-5)


def test_ops_knn_dispatch_on_cpu():
    """ops.knn: C <= 8 routes to K1 (its plain version on a CPU tensor), a
    wider cloud to the torch pairwise path; 2-D input works."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_dyadic(rng, (2, 60, 3)))
    before = knn_cuda.launches
    idx, dist = knn(x, 5, return_dist=True)
    assert knn_cuda.launches == before       # no kernel launch on the CPU
    i_p, d_p = knn_plain(x, 5)
    assert torch.equal(idx, i_p) and torch.equal(dist, d_p)
    assert torch.equal(knn(x[0], 5), i_p[0])
    wide = torch.from_numpy(_dyadic(rng, (1, 40, 12), denom=8.0))
    i_w, d_w = knn(wide, 4, self_loop=True, return_dist=True)
    assert i_w.shape == (1, 40, 4)
    np.testing.assert_allclose(d_w.numpy(), knn_plain(wide, 4, True)[1].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_knn_wrapper_checks_its_input():
    x = torch.zeros(1, 20, 3)
    with pytest.raises(TypeError):
        knn_cuda(x.double(), 3)
    with pytest.raises(ValueError, match="C="):
        knn_cuda(torch.zeros(1, 20, 9), 3)
    with pytest.raises(ValueError, match="kk="):
        knn_cuda(torch.zeros(1, 200, 3), 128)
    with pytest.raises(ValueError, match="exceeds"):
        knn_cuda(x, 20)
    with pytest.raises(ValueError, match="contiguous"):
        knn_cuda(torch.zeros(1, 3, 20).transpose(1, 2), 3)
