"""The approximate top-k (ops/approx_topk.py, the bin pass in
kernels/approx_topk.py) and the graphs built with it (ops/knn.py's
`recall_target`, DGCNNSeg's `knn_recall`) against the JAX package on the
CPU.

XLA's ApproxTopK bins on the TPU only; on the CPU `lax.approx_max_k` and
`lax.approx_min_k` return `lax.top_k`'s result. So JAX is the comparand
where the port's bins hold one element each (L >= n, r = 0), and at the
real bin counts the port is held to the recall target instead. The bin
count is held to XLA's own formula, read through jax's private binding.
"""
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lib import _jax as jax_lib

from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu.ops.knn import knn as jknn
from fissure_segmentation_tpu_torch.kernels.approx_topk import (
    aggregate, bin_extrema, bin_extrema_plain)
from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                   load_jax_variables,
                                                   load_model, save_model)
from fissure_segmentation_tpu_torch.models.io import load_fst, save_fst
from fissure_segmentation_tpu_torch.ops.approx_topk import (
    approx_top_k, approx_top_k_plain, reduction_output_size)
from fissure_segmentation_tpu_torch.ops.knn import knn
from fissure_segmentation_tpu_torch.ops.topk import masked_top_k

BF16_STEP = 0.01     # rows with one distance a bf16 step off, at most

# every call site's (n, k, recall) and a grid around them
SITES = [(2048, 40, 0.9), (2048, 41, 0.9), (2048, 40, 0.95),
         (16_777_216, 20_000, 0.95), (2_097_152, 20_000, 0.95),
         (262_144, 20_000, 0.95), (65_536, 41, 0.9)]
GRID = [(n, k, r) for n, k, r in itertools.product(
    (1, 100, 128, 129, 257, 1000, 1024, 1025, 2047, 2048, 4096, 5000,
     20_000, 100_000, 3 * 2 ** 20 + 7),
    (1, 2, 10, 40, 41, 128, 1000, 20_000), (0.3, 0.5, 0.9, 0.95, 0.99, 1.0))
    if k <= n]


def _recall(got: np.ndarray, want: np.ndarray) -> float:
    """Mean share of each row's exact top-k that the selection found."""
    got, want = got.reshape(-1, got.shape[-1]), want.reshape(-1,
                                                             want.shape[-1])
    return float(np.mean([len(set(g) & set(w)) / len(w)
                          for g, w in zip(got.tolist(), want.tolist())]))


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_reduction_output_size_equals_xla(rank):
    """The port's copy of XLA's bin count (L, r) equals XLA's, read
    through jax's binding, at every call site and over a grid."""
    for n, k, r in SITES + GRID:
        want = tuple(jax_lib.approx_top_k_reduction_output_size(
            n, rank, k, r, False))
        assert reduction_output_size(n, rank, k, r) == want, (n, k, r)


def test_call_site_bin_counts():
    """The bin counts the paths run at: the kNN rows (rank 3), the 256^3,
    128^3 and 64^3 detectors (rank 1)."""
    assert reduction_output_size(2048, 3, 41, 0.9) == (512, 2)
    assert reduction_output_size(2048, 3, 40, 0.95) == (1024, 1)
    assert reduction_output_size(256 ** 3, 1, 20_000, 0.95) == (524_288, 5)
    assert reduction_output_size(128 ** 3, 1, 20_000, 0.95) == (524_288, 2)
    assert reduction_output_size(64 ** 3, 1, 20_000, 0.95) == (64 ** 3, 0)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_element_bins_equal_lax(largest, dtype):
    """Where L >= n (r = 0) the selection is exact. With integer-valued
    scores full of ties and a masked share it equals lax.top_k, values and
    indices (ties to the lower index). On tie-free scores it also equals
    JAX's approx_max_k / approx_min_k, exact on the CPU (among ties the
    CPU's approx_min_k follows no index order)."""
    rng = np.random.default_rng(0)
    fill = -np.inf if largest else np.inf
    tied = rng.integers(0, 50, (6, 1000)).astype(np.float32)
    tied[rng.random(tied.shape) < 0.3] = fill
    # 1024 numbers exact in bf16, no two equal
    distinct = np.array([2.0 ** e * (1 + m / 128) for e in range(-4, 4)
                         for m in range(128)], np.float32)
    free = np.stack([rng.permutation(distinct)[:1000] for _ in range(6)])
    k = 40
    assert reduction_output_size(1000, 2, k, 0.95) == (1000, 0)
    for x, approx in ((tied, False), (free, True)):
        xj = jnp.asarray(x).astype(dtype)
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        tv, ti = approx_top_k(xt, k, 0.95, largest=largest)
        if approx:
            fn = jax.lax.approx_max_k if largest else jax.lax.approx_min_k
            v, i = fn(xj, k, recall_target=0.95)
        elif largest:
            v, i = jax.lax.top_k(xj, k)
        else:
            v, i = jax.lax.top_k(-xj, k)
            v = -v
        np.testing.assert_array_equal(ti.numpy(), np.asarray(i))
        np.testing.assert_array_equal(tv.float().numpy(),
                                      np.asarray(v.astype(jnp.float32)))


def test_single_element_bins_equal_masked_top_k():
    """r = 0 gives masked_top_k's output exactly (a flat 64^3 score
    volume, 20 000 of them: the rank-1 tiling keeps one element a bin)."""
    g = torch.Generator().manual_seed(1)
    x = torch.rand(64 ** 3, generator=g)
    x[x < 0.7] = -torch.inf
    x[:5000] = 0.75                       # ties
    v, i = approx_top_k(x, 20_000)
    mv, mi = masked_top_k(x, 20_000)
    assert torch.equal(v, mv) and torch.equal(i, mi)


@pytest.mark.parametrize("case", ["knn_rows", "detector_2m"])
def test_recall_at_real_bins(case):
    """At the real bin counts (r > 0) the exact top-k's share found is at
    least the target on seeded random rows (readings: 0.971 for the kNN
    rows at 0.9; 0.986 for 2^21 scores at 0.95)."""
    g = torch.Generator().manual_seed(2)
    if case == "knn_rows":
        x, k, target, largest = torch.rand(64, 2048, generator=g), 41, 0.9, \
            False
    else:
        x, k, target, largest = torch.rand(2 ** 21, generator=g), 20_000, \
            0.95, True
    assert reduction_output_size(x.shape[-1], x.ndim, k, target)[1] > 0
    _, got = approx_top_k(x, k, target, largest=largest)
    _, want = torch.topk(x, k, largest=largest)
    assert _recall(got.numpy(), want.numpy()) >= target


def test_bins_and_ties():
    """A bin keeps its extremum's first occurrence; the aggregation orders
    the winners by (value, original index), which a stable sort over bin
    order does not: bins (i mod 4) of [1, 5, 5, 0, 5, 1, 1, 1] win 5 @ 4,
    5 @ 1, 5 @ 2, 1 @ 7, and the top 2 are 5 @ 1 and 5 @ 2."""
    x = torch.tensor([[1.0, 5, 5, 0, 5, 1, 1, 1]])
    vals, idx = bin_extrema_plain(x, 4, 2)
    assert vals.tolist() == [[5.0, 5.0, 5.0, 1.0]]
    assert idx.tolist() == [[4, 1, 2, 7]]
    top, at = aggregate(vals, idx, 2, True)
    assert top.tolist() == [[5.0, 5.0]] and at.tolist() == [[1, 2]]
    # ties inside a bin go to the lower index, for the minimum too
    x = torch.tensor([[3.0, 2, 3, 2, 1, 9]])     # bins {0, 2, 4}, {1, 3, 5}
    vals, idx = bin_extrema_plain(x, 2, 3)
    assert idx.tolist() == [[0, 5]] and vals.tolist() == [[3.0, 9.0]]
    vals, idx = bin_extrema_plain(x, 2, 3, largest=False)
    assert idx.tolist() == [[4, 1]] and vals.tolist() == [[1.0, 2.0]]
    # the wrapper takes the plain version for a CPU tensor
    w = bin_extrema(x, 2, 3)
    assert w[1].tolist() == [[0, 5]] and w[1].dtype == torch.int32


@pytest.mark.parametrize("largest", [True, False])
def test_masks(largest):
    """Masked entries (-inf for the maximum, +inf for the minimum) come out
    non-finite with in-range indices, after every finite entry; a row of
    masks only still gives k in-range slots; padding (n off L * R) never
    wins."""
    fill = -torch.inf if largest else torch.inf
    x = torch.full((2, 5000), fill)
    x[0, [7, 4000, 4999]] = torch.tensor([1.0, 2.0, 3.0])
    n_bins, r = reduction_output_size(5000, 2, 10, 0.9)
    assert r > 0 and n_bins * (1 << r) > 5000
    v, i = approx_top_k(x, 10, 0.9, largest=largest)
    assert torch.isfinite(v[0, :3]).all() and not torch.isfinite(v[0, 3:]).any()
    assert set(i[0, :3].tolist()) == {7, 4000, 4999}
    assert not torch.isfinite(v[1]).any()
    assert ((i >= 0) & (i < 5000)).all()
    with pytest.raises(ValueError, match="exceeds"):
        approx_top_k(x, 5001)


def test_plain_entry_equals_wrapper_on_the_cpu():
    x = torch.rand(3, 4096, generator=torch.Generator().manual_seed(3))
    for a, b in zip(approx_top_k(x, 40, 0.9), approx_top_k_plain(x, 40, 0.9)):
        assert torch.equal(a, b)


# ---- the graphs --------------------------------------------------------------

@pytest.mark.parametrize("self_loop", [True, False])
def test_knn_recall_keeps_self_in_slot_0(self_loop):
    """self_loop: the point itself is pinned to -1, always found, in slot 0
    with distance 0; without it, never found. The rest finds at least 0.9
    of the exact graph's neighbours (reading 0.97)."""
    x = torch.rand(4, 2048, 3, generator=torch.Generator().manual_seed(4))
    idx, dist = knn(x, 40, self_loop=self_loop, return_dist=True,
                    recall_target=0.9)
    assert idx.shape == (4, 2048, 40) and idx.dtype == torch.int32
    rows = torch.arange(2048)[None, :]
    if self_loop:
        assert torch.equal(idx[..., 0], rows.expand(4, -1).to(torch.int32))
        assert (dist[..., 0] == 0).all() and (dist >= 0).all()
    else:
        assert (idx != rows[..., None]).all()
    exact = knn(x, 40, self_loop=self_loop)
    assert _recall(idx.numpy(), exact.numpy()) >= 0.9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knn_recall_equals_jax_where_bins_are_single(dtype):
    """N = 100 <= the 128-lane tiling: one element a bin, so the port's
    graph is JAX's recall graph (exact on the CPU): indices equal on
    generic floats (f32). In bf16 distances tie often and JAX's CPU
    approx_min_k orders ties arbitrarily, so the selected distances are
    compared: equal as sorted lists in every row but a share BF16_STEP of
    them, where one distance may be a bf16 step off (the norms round as
    tests/test_torch_dynamic.py says; readings 1.000 with and without the
    self loop, where the index sets agree in 0.87 and 0.84 of the rows)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 100, 64)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    for self_loop in (True, False):
        with jax.default_matmul_precision("float32"):
            ij, dj = jknn(xj, 10, self_loop=self_loop, return_dist=True,
                          recall_target=0.9)
        it, dt = knn(xt, 10, self_loop=self_loop, return_dist=True,
                     recall_target=0.9)
        if dtype == "float32":
            np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        else:
            same = (np.sort(dt.float().numpy(), -1) == np.sort(
                np.asarray(dj.astype(jnp.float32)), -1)).all(-1)
            assert same.mean() >= 1 - BF16_STEP, same.mean()


def _jax_model(knn_recall, dynamic, seed=6):
    jm = JDGCNNSeg(k=8, in_features=3, num_classes=4, dynamic=dynamic,
                   knn_recall=knn_recall)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 3)), train=False))
    tm = load_jax_variables(DGCNNSeg(k=8, in_features=3, num_classes=4,
                                     dynamic=dynamic, knn_recall=knn_recall),
                            variables)
    return jm, variables, tm.eval()


@pytest.mark.parametrize("dynamic", [False, True])
def test_dgcnn_knn_recall_equals_jax_where_bins_are_single(dynamic):
    """DGCNNSeg(knn_recall=0.9) at N = 96 (one element a bin on every
    graph): eval logits equal JAX's within float32 rounding (the tolerance
    of tests/test_torch_dynamic.py's f32 model), on generic coordinates,
    where no two distances tie (JAX's CPU approx_min_k orders ties
    arbitrarily)."""
    rng = np.random.default_rng(7)
    jm, variables, tm = _jax_model(0.9, dynamic)
    x = rng.normal(size=(2, 96, 3)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jm.apply(variables, x, train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dynamic", [False, True])
def test_dgcnn_knn_recall_holds_the_recall(dynamic):
    """At N = 2048 (L = 512: four elements a bin) every graph the model
    builds finds at least 0.9 of the exact graph's neighbours (readings
    about 0.97); the spatial transformer's own graph stays exact."""
    model = DGCNNSeg(k=20, in_features=3, num_classes=4, dynamic=dynamic,
                     knn_recall=0.9, spatial_transformer=True,
                     generator=torch.Generator().manual_seed(8)).eval()
    x = torch.rand(2, 2048, 3, generator=torch.Generator().manual_seed(9))
    built = []
    orig = model._graph

    def record(feats, self_loop, exact=False):
        graph, tr = orig(feats, self_loop, exact)
        built.append((feats.detach(), self_loop, exact, graph))
        return graph, tr
    model._graph = record
    with torch.no_grad():
        model(x)
    assert len(built) == (4 if dynamic else 1)
    assert [b[2] for b in built] == ([True, False, False, False] if dynamic
                                     else [False])
    for feats, self_loop, exact, graph in built:
        want = knn(feats, 20, self_loop=self_loop)
        share = _recall(graph.numpy(), want.numpy())
        assert share == 1.0 if exact else share >= 0.9


def test_knn_recall_round_trips(tmp_path):
    """knn_recall is part of the config: model.pt and .fst keep it, and the
    .fst header holds it where the JAX module's field is."""
    model = DGCNNSeg(k=8, in_features=3, num_classes=4, dynamic=False,
                     knn_recall=0.9,
                     generator=torch.Generator().manual_seed(10))
    assert model.config["knn_recall"] == 0.9
    save_model(model, str(tmp_path / "model.pt"))
    assert load_model(str(tmp_path / "model.pt")).knn_recall == 0.9
    save_fst(model, str(tmp_path / "model.fst"))
    header = json.loads((tmp_path / "model.fst").read_bytes().split(
        b"\x00fst\x00", 1)[0])
    assert header["config"]["knn_recall"] == 0.9
    back = load_fst(str(tmp_path / "model.fst"))
    assert back.knn_recall == 0.9 and back.config == model.config
    assert "knn_recall" not in DGCNNSeg(k=8, in_features=3,
                                        num_classes=4).config
