"""The approximate top-k's routes on the CPU: the fused row selection
(kernels/approx_topk.py:select_rows, k <= MAX_K) and the bin pass with its
aggregation (k > MAX_K), which ops/approx_topk.py and ops/knn.py choose
between; the plain version of the fused selection against the plain
selection it replaces and against a stable sort at one element a bin; the
feature graph's CPU path against JAX's `lax.top_k(-d, kk)` graph.

The kernels themselves run only on the card (tests/test_torch_cuda.py holds
them against these plain versions there).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.ops.knn import knn as jknn
from fissure_segmentation_tpu_torch.keypoints import extraction, foerstner
from fissure_segmentation_tpu_torch.kernels.approx_topk import (
    MAX_K, aggregate, select_rows, select_rows_plain)
from fissure_segmentation_tpu_torch.models import DGCNNSeg
from fissure_segmentation_tpu_torch.ops import approx_topk as ops_topk
from fissure_segmentation_tpu_torch.ops import knn as ops_knn
from fissure_segmentation_tpu_torch.ops.approx_topk import (
    approx_top_k, approx_top_k_plain, reduction_output_size, route)


@pytest.fixture
def routes(monkeypatch):
    """Record every selection ops/approx_topk.py and ops/knn.py make, as
    (route, n, k), and pass it on."""
    seen = []

    def wrap(name, fn, module):
        def rec(x, *args, **kw):
            k = args[2] if name == "fused" else None
            seen.append((name, x.shape[-1], k))
            return fn(x, *args, **kw)
        monkeypatch.setattr(module, fn.__name__, rec)

    wrap("fused", ops_topk.select_rows, ops_topk)
    wrap("bins", ops_topk.bin_extrema, ops_topk)
    orig = ops_knn.feature_knn

    def feature(x, kk):
        seen.append(("feature", x.shape[-2], kk))
        return orig(x, kk)
    monkeypatch.setattr(ops_knn, "feature_knn", feature)
    return seen


def _scores(rows, n, seed, dtype=torch.float32, largest=True):
    """Integer-valued scores full of ties, with signed zeros and a masked
    share at -inf (+inf for the minimum)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-6, 7, (rows, n), generator=g).to(dtype)
    x[x == 0] = torch.where(torch.rand(int((x == 0).sum()), generator=g)
                            < 0.5, -0.0, 0.0).to(dtype)
    x[torch.rand((rows, n), generator=g) < 0.2] = \
        -torch.inf if largest else torch.inf
    return x


@pytest.mark.parametrize("k,want", [(1, "fused"), (40, "fused"),
                                    (41, "fused"), (128, "fused"),
                                    (129, "bins"), (20_000, "bins")])
def test_route_by_k(k, want, routes):
    """k <= MAX_K takes the fused row selection, above it the bin pass;
    both give the plain selection's result on the CPU."""
    assert MAX_K == 128 and route(k) == want
    x = torch.rand((2, 30_000), generator=torch.Generator().manual_seed(k))
    got = approx_top_k(x, k, 0.95)
    assert routes == [(want, 30_000, k if want == "fused" else None)]
    for a, b in zip(got, approx_top_k_plain(x, k, 0.95)):
        assert torch.equal(a, b)


def test_call_sites_take_their_routes(routes):
    """The detectors (k = 20 000) take the bin pass; the approximate static
    and dynamic graphs the fused selection; the exact feature graphs ask
    for kk <= MAX_K, which the fused selection serves for a CUDA tensor
    (`feature_route`)."""
    g = torch.Generator().manual_seed(1)
    vol = torch.randn((32, 32, 32), generator=g)
    mask = torch.ones(vol.shape, dtype=torch.bool)
    foerstner.foerstner_keypoints(vol, mask, sigma=0.5, d=3,
                                  approx_top_k=True)
    soft = torch.rand((32, 32, 32, 4), generator=g)
    extraction.get_cnn_keypoints(soft, mask, generator=g, approx_top_k=True)
    assert routes == [("bins", 32 ** 3, None)] * 2
    routes.clear()
    x = torch.rand((2, 256, 3), generator=g)
    for dynamic in (False, True):
        model = DGCNNSeg(k=20, in_features=3, num_classes=4, dynamic=dynamic,
                         knn_recall=0.9, generator=g).eval()
        with torch.no_grad():
            model(x)
    # static: one graph without self-loop; dynamic: three with it
    assert routes == [("fused", 256, 20)] * 4
    routes.clear()
    with torch.no_grad():
        DGCNNSeg(k=20, in_features=3, num_classes=4, dynamic=True,
                 generator=g).eval()(x)
    assert routes == [("feature", 256, 20)] * 2
    for dt in (torch.float32, torch.bfloat16):
        card = types.SimpleNamespace(is_cuda=True, dtype=dt)
        assert ops_knn.feature_route(card, 20) == "fused"
        assert ops_knn.feature_route(card, 41) == "fused"
        assert ops_knn.feature_route(card, 129) == "sort"
    assert ops_knn.feature_route(torch.zeros(3, 3), 20) == "sort"
    card64 = types.SimpleNamespace(is_cuda=True, dtype=torch.float64)
    assert ops_knn.feature_route(card64, 20) == "sort"


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_rows_plain_equals_the_plain_selection(dtype, largest):
    """The fused selection's plain version equals approx_top_k_plain at the
    bins XLA's formula gives (n off L * R, n = L, r > 0), on scores full of
    ties; the CPU wrapper returns it in either index type."""
    for n, k, target in ((2048, 40, 0.9), (5000, 41, 0.9), (1000, 128, 0.95),
                         (4096, 1, 0.9), (129, 20, 0.9)):
        x = _scores(5, n, n + k, dtype, largest)
        n_bins, r = reduction_output_size(n, 2, k, target)
        want = approx_top_k_plain(x, k, target, largest)
        got = select_rows_plain(x, n_bins, 1 << r, k, largest)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (n, k)
        v, i = select_rows(x, n_bins, 1 << r, k, largest,
                           index_dtype=torch.int32)
        assert i.dtype == torch.int32 and torch.equal(i.long(), want[1])
        assert torch.equal(v, want[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_element_a_bin_is_the_stable_sort(dtype):
    """At R = 1 (L = n) the selection is the exact top-k: the first kk of a
    stable ascending sort, as feature_knn takes it, indices and values;
    -0.0 and +0.0 are one value, each kept with its own bits."""
    x = _scores(7, 300, 3, dtype, largest=False)
    for kk in (1, 40, 41, 128):
        v, i = select_rows_plain(x, 300, 1, kk, largest=False)
        sv, si = torch.sort(x, dim=-1, stable=True)
        assert torch.equal(i, si[:, :kk]) and torch.equal(v, sv[:, :kk])
        assert torch.equal(torch.signbit(v), torch.signbit(sv[:, :kk]))
    z = torch.tensor([[-0.0, 0.0, -0.0, 1.0]], dtype=dtype)
    v, i = aggregate(z, torch.arange(4, dtype=torch.int32)[None], 3, True)
    assert i.tolist() == [[3, 0, 1]]
    assert torch.signbit(v).tolist() == [[False, True, False]]


def test_select_rows_checks_its_arguments():
    x = torch.zeros((2, 300))
    with pytest.raises(ValueError, match="outside"):
        select_rows(x, 300, 1, 129)
    with pytest.raises(ValueError, match="outside"):
        select_rows(x, 300, 1, 0)
    with pytest.raises(ValueError, match="outside"):
        select_rows(x, 10, 30, 20)          # k above the bins
    with pytest.raises(ValueError, match="exceed"):
        select_rows(x, 10, 5, 3)            # bins too few for the row
    with pytest.raises(TypeError):
        select_rows(x, 300, 1, 5, index_dtype=torch.int16)
    with pytest.raises(TypeError):
        select_rows(x.double(), 300, 1, 5)


@pytest.mark.parametrize("kk", [20, 41])
def test_feature_knn_cpu_equals_lax_top_k(kk):
    """feature_knn's CPU path (a stable sort) against the JAX package's
    exact graph at C = 64 (`lax.top_k(-d, kk)`, ops/knn.py:104-112), on
    generic float32 features, where no two distances of a row tie: the
    indices equal, the distances within float32 rounding of the matmul."""
    rng = np.random.default_rng(kk)
    x = rng.normal(size=(2, 300, 64)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        ij, dj = jknn(jnp.asarray(x), kk, self_loop=True, return_dist=True,
                      use_pallas=False)
    it, dt = ops_knn.feature_knn(torch.from_numpy(x), kk)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-4)
