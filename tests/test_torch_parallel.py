"""The port's parallel layer (fissure_segmentation_tpu_torch/parallel/)
against the JAX package's `shard_map` functions on a virtual 2-device CPU
mesh, on the same numpy inputs: the halo pairs, the ring kNN, the ring
gather, the edge features, the z-slab sliding window and the sharded
subset ensemble. The port runs on a 2-rank gloo group (one spawn for the
file, tests/torch_parallel_ranks.py:modules_rank).

Tolerances: the halo functions move rows and add them in the JAX order
(equal); the ring kNN's indices are equal on these generic floats and its
sorted distances within atol 1e-4 (tests/test_point_sharding.py's); the
gather and the edge features equal on JAX's indices (1e-6: a subtraction
in another order); the sliding window within atol 2e-5
(tests/test_spatial_sharding.py's, with the CNN's logits 2e-6 apart,
tests/test_torch_seg_cnn.py); the ensemble's probabilities within 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu.models import MobileNetASPP as JMobileNetASPP
from fissure_segmentation_tpu.models.ensemble import \
    build_subsets as jbuild_subsets
from fissure_segmentation_tpu.parallel import make_mesh as jmake_mesh
from fissure_segmentation_tpu.parallel import spatial as jspatial
from fissure_segmentation_tpu.parallel.ensemble import \
    sharded_ensemble_predict as jsharded_ensemble
from fissure_segmentation_tpu.parallel.points import (
    sharded_edge_features as jedge, sharded_gather_neighbors as jgather,
    sharded_knn as jknn)
from fissure_segmentation_tpu_torch.parallel import spawn

import torch_parallel_ranks

N_DEV = 2
HALO, HOPS, SLAB = 2, 2, 8
K = 8


def _jmesh():
    return jmake_mesh(("data",), devices=jax.devices()[:N_DEV])


def _shmap(fn):
    return jax.jit(functools.partial(
        jax.shard_map, mesh=_jmesh(), in_specs=P("data"),
        out_specs=P("data"))(fn))


def _tree(v):
    return jax.tree_util.tree_map(np.asarray, dict(v))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    inp = dict(halo=HALO, hops=HOPS, k=K, sample_points=64, subset_batch=2)
    inp["x"] = rng.normal(size=(N_DEV * SLAB, 3)).astype(np.float32)
    inp["y_ext"] = rng.normal(
        size=(N_DEV * (SLAB + 2 * HALO), 3)).astype(np.float32)
    inp["y_down"] = rng.normal(
        size=(N_DEV * (1 + HOPS) * SLAB, 3)).astype(np.float32)
    inp["pts"] = rng.normal(size=(N_DEV * 64, 3)).astype(np.float32)
    inp["feats"] = rng.normal(size=(N_DEV * 64, 5)).astype(np.float32)

    jm = JMobileNetASPP(num_classes=3, patch_size=(8, 12, 12))
    inp["cnn_vars"] = _tree(jm.init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 8, 8, 8, 1)), train=False))
    inp["img"] = rng.normal(size=(13, 16, 16)).astype(np.float32)

    js = JDGCNNSeg(k=6, in_features=4, num_classes=4, dynamic=False)
    inp["seg_vars"] = _tree(js.init(jax.random.PRNGKey(2),
                                    jnp.zeros((1, 64, 4)), train=False))
    inp["pc"] = rng.normal(size=(300, 4)).astype(np.float32)
    # 5 subsets pad to 8 over 2 ranks x 2: the padding's repeats count
    ens_rng = jax.random.PRNGKey(3)
    inp["subsets"] = np.asarray(jbuild_subsets(ens_rng, 300, 64, 5))
    assert inp["subsets"].shape == (5, 64)

    want = {}
    with jax.default_matmul_precision("float32"):
        want["halo_exchange"] = _shmap(
            lambda x: jspatial.halo_exchange(x, HALO, "data"))(inp["x"])
        want["halo_reduce"] = _shmap(
            lambda y: jspatial.halo_reduce(y, HALO, "data"))(inp["y_ext"])
        want["halo_exchange_down"] = _shmap(
            lambda x: jspatial.halo_exchange_down(x, HOPS, "data"))(inp["x"])
        want["halo_reduce_down"] = _shmap(
            lambda y: jspatial.halo_reduce_down(y, HOPS, SLAB, "data"))(
                inp["y_down"])
        want["ppermute_partial"] = _shmap(
            lambda x: jax.lax.ppermute(x, "data", [(0, 1)]))(inp["x"])
        for self_loop in (False, True):
            want[f"knn_{self_loop}"] = jknn(jnp.asarray(inp["pts"]), K,
                                            _jmesh(), self_loop=self_loop,
                                            return_dist=True)
        inp["gather_idx"] = np.asarray(want["knn_False"][0])
        want["gather"] = jgather(jnp.asarray(inp["feats"]),
                                 jnp.asarray(inp["gather_idx"]), _jmesh())
        want["edge"] = jedge(jnp.asarray(inp["pts"]), K, _jmesh())
        want["window"] = jspatial.sharded_predict_all_patches(
            jm.apply, inp["cnn_vars"], jnp.asarray(inp["img"]), 3, _jmesh(),
            patch_size=(8, 12, 12), min_overlap=0.4)
        want["ensemble"] = jsharded_ensemble(
            js.apply, inp["seg_vars"], jnp.asarray(inp["pc"]), ens_rng,
            _jmesh(), sample_points=64, n_runs_min=5, subset_batch=2)
    want = jax.tree_util.tree_map(np.asarray, want)
    got = spawn(torch_parallel_ranks.modules_rank, N_DEV, args=(inp,),
                threads=1)
    return inp, want, got


def _cat(got, key):
    return np.concatenate([g[key] for g in got])


@pytest.mark.parametrize("name", ["halo_exchange", "halo_reduce",
                                  "halo_exchange_down", "halo_reduce_down",
                                  "ppermute_partial"])
def test_halo_functions_equal_jax(case, name):
    """Each rank's result, concatenated in rank order, equals JAX's
    shard_map output (the rows a device receives, the edge replication at
    the mesh's ends, the folded partial sums, zeros where a device
    receives nothing)."""
    _, want, got = case
    np.testing.assert_array_equal(_cat(got, name), want[name])


@pytest.mark.parametrize("self_loop", [False, True])
def test_ring_knn_equals_jax(case, self_loop):
    """Indices equal, sorted distances within atol 1e-4."""
    _, want, got = case
    idx = np.concatenate([g[f"knn_{self_loop}"][0] for g in got])
    dist = np.concatenate([g[f"knn_{self_loop}"][1] for g in got])
    want_idx, want_dist = want[f"knn_{self_loop}"]
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(np.sort(dist, -1), np.sort(want_dist, -1),
                               atol=1e-4)
    if self_loop:
        assert (idx[:, 0] == np.arange(len(idx))).all()


@pytest.mark.parametrize("name", ["gather", "edge"])
def test_ring_gather_and_edge_features_equal_jax(case, name):
    _, want, got = case
    np.testing.assert_allclose(_cat(got, name), want[name], rtol=0,
                               atol=1e-6)


def test_sliding_window_equals_jax(case):
    """The 13-row volume pads to 14 over two slabs of 7; 8-row patches take
    two hops. Every rank returns the whole volume."""
    _, want, got = case
    assert want["window"].shape == (13, 16, 16, 3)
    for g in got:
        np.testing.assert_allclose(g["window"], want["window"], rtol=0,
                                   atol=2e-5)


def test_sharded_ensemble_equals_jax(case):
    """JAX's subsets injected: 5 subsets pad to 8 with the first three, so
    the sharded result is JAX's sharded function's, not the single-device
    ensemble's (the repeats weigh their points twice)."""
    _, want, got = case
    for g in got:
        np.testing.assert_allclose(g["ensemble"], want["ensemble"], rtol=0,
                                   atol=1e-5)
    assert np.abs(got[0]["ensemble"] - got[0]["ensemble_single"]).max() > 1e-4


def test_replicate_gives_every_rank_rank_0s_tensor(case):
    """replicate: rank 0's slab on every rank (JAX's `replicate` places one
    array on every device)."""
    inp, _, got = case
    for g in got:
        np.testing.assert_array_equal(g["replicate"], inp["x"][:SLAB])


def test_parallel_layer_takes_explicit_meshes():
    """The layer's functions take the mesh (its group and device)
    explicitly; shard_along refuses a size that does not divide."""
    from fissure_segmentation_tpu_torch.parallel import Mesh, shard_along
    mesh = Mesh(group=None, size=3, rank=1, device=torch.device("cpu"),
                backend="gloo")
    assert shard_along(torch.arange(9), mesh).tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="divisible"):
        shard_along(torch.arange(10), mesh)
    assert mesh.staged == ()
    cuda_mesh = Mesh(None, 2, 0, torch.device("cuda", 0), "gloo")
    assert cuda_mesh.staged == ("send", "recv")
    assert Mesh(None, 2, 0, torch.device("cuda", 0), "nccl").staged == ()
