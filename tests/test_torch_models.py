"""Port parity: DGCNNSeg, the JAX-variable loader and the subset ensemble.

The same numpy-seeded inputs and the same weights go through the JAX
package (matmuls at float32 precision, as tests/test_golden_parity_models.py
runs them) and through fissure_segmentation_tpu_torch on the CPU.
Coordinates are multiples of 1/16 so every kNN distance is exact in float32:
both sides then build the same neighbor graph, ties included, and the only
differences left are matmul summation orders (hence rtol = atol = 2e-4, the
precedent of test_golden_parity_models.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu.models.ensemble import (build_subsets as
                                                      jbuild_subsets)
from fissure_segmentation_tpu.models.ensemble import (ensemble_predict as
                                                      jensemble_predict)
from fissure_segmentation_tpu_torch.models import (DGCNNSeg, MobileNetASPP,
                                                   PointTransformerSeg,
                                                   ensemble_predict,
                                                   export_jax_variables,
                                                   load_jax_variables)
from fissure_segmentation_tpu_torch.models.ensemble import build_subsets
from fissure_segmentation_tpu_torch.ops.knn import knn
from fissure_segmentation_tpu_torch.serving import segment_case

TOL = dict(rtol=2e-4, atol=2e-4)


def _dyadic_cloud(rng, shape):
    return (rng.integers(-16, 17, shape) / 16.0).astype(np.float32)


def _jax_model(rng, k=6, in_features=3, num_classes=4):
    """A JAX DGCNNSeg with numpy-randomized BN scale/bias/mean/var."""
    jm = JDGCNNSeg(k=k, in_features=in_features, num_classes=num_classes,
                   dynamic=False)
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 32, in_features), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def randomize(path, leaf):
        name = jax.tree_util.keystr(path)
        if "BatchNorm" not in name:
            return leaf
        if "var" in name:
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.3, leaf.shape).astype(np.float32) + \
            (1.0 if "scale" in name else 0.0)

    return jm, jax.tree_util.tree_map_with_path(randomize, variables)


def _port(variables, k=6, in_features=3, num_classes=4):
    tm = DGCNNSeg(k=k, in_features=in_features, num_classes=num_classes,
                  dynamic=False)
    return load_jax_variables(tm, variables).eval()


@pytest.mark.parametrize("in_features", [3, 5])
def test_dgcnn_seg_logits_match_jax(in_features):
    rng = np.random.default_rng(0)
    jm, variables = _jax_model(rng, in_features=in_features)
    x = _dyadic_cloud(rng, (2, 64, in_features))
    with jax.default_matmul_precision("float32"):
        out_j = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    tm = _port(variables, in_features=in_features)
    with torch.no_grad():
        out_t = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out_t, out_j, **TOL)


def test_load_jax_variables_is_strict():
    rng = np.random.default_rng(1)
    _, variables = _jax_model(rng)
    extra = {"params": dict(variables["params"], Stray_0={"kernel":
                                                          np.zeros((3, 3))}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="Stray_0"):
        _port(extra)
    missing = {"params": variables["params"]}
    with pytest.raises(KeyError, match="not set"):
        _port(missing)
    wrong = jax.tree_util.tree_map(lambda a: a, variables)
    wrong["params"]["SharedMLP_4"]["Dense_0"]["bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="shape"):
        _port(wrong)


def test_export_jax_variables_round_trip():
    """JAX init -> port -> export gives the original tree back, leaf by
    leaf and bit for bit, for both routes' module layouts."""
    jm = JDGCNNSeg(k=6, in_features=4, num_classes=3, dynamic=False)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 32, 4), jnp.float32)))
    tm = load_jax_variables(DGCNNSeg(k=6, in_features=4, num_classes=3,
                                     dynamic=False),
                            variables)
    back = export_jax_variables(tm)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(variables)
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(variables),
            jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    with pytest.raises(ValueError, match="no gradient"):
        export_jax_variables(tm, grad=True)


@pytest.mark.parametrize("call,raises", [
    (lambda: DGCNNSeg(k=4, in_features=3, num_classes=4, knn_recall=0.9),
     True),
    (lambda: DGCNNSeg(k=4, in_features=3, num_classes=4,
                      spatial_transformer=True), False),
    (lambda: DGCNNSeg(k=4, in_features=5, num_classes=4,
                      image_feat_module=True), False),
    (lambda: PointTransformerSeg(in_features=3, num_classes=4,
                                 dtype=torch.bfloat16), True),
    (lambda: knn(torch.zeros((1, 8, 3)), 2, recall_target=0.9), True),
    (lambda: segment_case(np.zeros((8, 8, 8), np.float32),
                          np.ones((8, 8, 8), bool), None, kp_mode="cnn",
                          cnn_model=MobileNetASPP(num_classes=4),
                          cnn_dtype=torch.bfloat16, device="cpu"), True),
    (lambda: segment_case(np.zeros((8, 8, 8), np.float32),
                          np.ones((8, 8, 8), bool), None, approx_top_k=True),
     True),
], ids=["knn_recall", "spatial_transformer", "image_feat_module",
        "bf16", "knn_recall_target", "kp_mode_cnn", "approx_top_k"])
def test_unported_options_raise(call, raises):
    """Options still unported raise NotImplementedError. The spatial
    transformer and the image-feature module are ported: their models
    build, and a forward gives finite logits of the input's shape."""
    if raises:
        with pytest.raises(NotImplementedError):
            call()
        return
    model = call().eval()
    x = torch.randn(2, 32, model.config["in_features"],
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(x)
    assert out.shape == (2, 32, 4) and torch.isfinite(out).all()


def test_ensemble_with_injected_subsets_matches_jax():
    """The JAX draw of subsets is injected into the port (jax.random cannot
    be replayed in torch); R=5 is padded to a multiple of subset_batch=2 on
    both sides. Tolerance as for the logits (softmax is 1-Lipschitz)."""
    rng = np.random.default_rng(2)
    jm, variables = _jax_model(rng)
    pc = _dyadic_cloud(rng, (100, 3))
    key = jax.random.PRNGKey(3)
    subsets = np.asarray(jbuild_subsets(key, 100, 32, n_runs_min=5))
    with jax.default_matmul_precision("float32"):
        pj = np.asarray(jensemble_predict(jm.apply, variables,
                                          jnp.asarray(pc), key,
                                          sample_points=32, n_runs_min=5,
                                          subset_batch=2))
    tm = _port(variables)
    pt = ensemble_predict(tm, torch.from_numpy(pc), sample_points=32,
                          n_runs_min=5, subset_batch=2,
                          subsets=torch.from_numpy(subsets)).numpy()
    np.testing.assert_allclose(pt, pj, **TOL)
    np.testing.assert_array_equal(pt.argmax(-1), pj.argmax(-1))


def test_build_subsets_covers_every_point():
    g = torch.Generator().manual_seed(0)
    s = build_subsets(1000, 128, n_runs_min=12, generator=g)
    assert s.shape == (12, 128)
    assert set(s[:8].reshape(-1).tolist()) == set(range(1000))
    again = build_subsets(1000, 128, 12, torch.Generator().manual_seed(0))
    assert torch.equal(s, again)
