"""Port parity for the random walk (postprocess/random_walk.py), the
label-map regularization (postprocess/surface_fitting.py:
poisson_reconstruction) and the "lobes" label space of the test half
(train/evaluation.py: lobe_points_to_fissure_labels, test_pipeline), each
against the JAX package on the same numpy-seeded inputs at 32^3.

Tolerances, each where it is used:
  * edge weights and L x: the same float32 operations in the same order,
    but XLA and torch may round exp differently: within 1e-6 relative
    (XLA flushes exp's subnormal results to 0: atol 1e-37);
  * the random walk at 10 CG iterations: probabilities within 5e-5
    absolute (reading: 2.4e-6 binary, 2.2e-5 intensity). alpha and beta
    are sums over every voxel of every channel, which XLA and torch add in
    other orders, and CG carries the difference on;
  * at 500 iterations the labels (argmax): equal wherever JAX's top two
    probabilities differ by more than RW_MARGIN, and equal on at least
    RW_SHARE of the graph's voxels (readings: 1.000 binary, 0.995
    intensity; the intensity weights leave voxels whose probabilities tie
    at 0);
  * fill_lobes, lobes_to_fissures and lobe_points_to_fissure_labels, on the
    binary weights: equal;
  * poisson_reconstruction: the normals' kNN is K1's sum of squared
    differences (its plain version here) in the port and JAX's matmul
    formula. A whole voxel cloud is a lattice: 41 % of label 1's points
    have their 30th and 31st neighbours at one distance, and the two
    formulas break those ties apart, so neighbourhoods, normals and the
    PSR grid differ a little everywhere. The meshes are held by their
    triangle counts (within 2 %), the mean point-to-mesh gap (under 0.05
    voxel; readings 0.008-0.021) and its largest value (under 0.5 voxel;
    readings 0.03-0.31), the labelmaps equal on at least 0.998 of the
    voxels (reading 0.99927);
  * test_pipeline in the lobes label space: predictions and Dice equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.data import dataset as jdataset
from fissure_segmentation_tpu.models.ensemble import \
    build_subsets as jbuild_subsets
from fissure_segmentation_tpu.postprocess import random_walk as jrw
from fissure_segmentation_tpu.postprocess import surface_fitting as jsf
from fissure_segmentation_tpu.preprocess import labels as jlabels
from fissure_segmentation_tpu.train import evaluation as jevaluation
from fissure_segmentation_tpu_torch import native
from fissure_segmentation_tpu_torch.data import dataset, synthetic
from fissure_segmentation_tpu_torch.postprocess import random_walk as trw
from fissure_segmentation_tpu_torch.postprocess import surface_fitting as tsf
from fissure_segmentation_tpu_torch.train import evaluation
from fissure_segmentation_tpu_torch.utils.coords import kpts_to_grid

SHAPE = (32, 32, 32)
RW_MARGIN = 1e-3
RW_SHARE = 0.99
SEED = 42


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    c = synthetic.make_synthetic_image_case(0, shape=SHAPE)
    rng = np.random.default_rng(0)
    # sparse seeds: 5 % of the lobe voxels
    c["seeds"] = np.where(rng.random(SHAPE) < 0.05, c["lobes"], 0).astype(
        np.int32)
    c["hu"] = c["image"] * 1000.0
    return c


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("edge_weights", ["binary", "intensity"])
def test_edge_weights_and_laplacian_match_jax(case, edge_weights):
    im, mask = case["hu"], case["lung_mask"]
    wj = jrw._edge_weights(jnp.asarray(im), edge_weights, jnp.asarray(mask))
    wt = trw._edge_weights(_t(im), edge_weights, _t(mask))
    for a, b in zip(wt, wj):
        # XLA flushes subnormal results to 0, torch keeps them
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-37)
    deg = np.random.default_rng(1).random(SHAPE).astype(np.float32)
    x = np.random.default_rng(2).normal(size=(2, *SHAPE)).astype(np.float32)
    lj = jrw._laplacian_matvec(jnp.asarray(x), wj, jnp.asarray(deg))
    lt = trw._laplacian_matvec(_t(x), wt, _t(deg))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("edge_weights", ["binary", "intensity"])
@pytest.mark.parametrize("iters", [10, 500])
def test_random_walk_matches_jax(case, edge_weights, iters):
    im, seeds, mask = case["hu"], case["seeds"], case["lung_mask"]
    pj = np.asarray(jrw.random_walk(
        jnp.asarray(im), jnp.asarray(seeds), 5, edge_weights=edge_weights,
        graph_mask=jnp.asarray(mask), cg_iters=iters))
    pt = trw.random_walk(_t(im), _t(seeds), 5, edge_weights=edge_weights,
                         graph_mask=_t(mask), cg_iters=iters).numpy()
    assert pt.shape == pj.shape == (*SHAPE, 5)
    assert (pt[~mask] == 0).all()
    if iters == 10:
        np.testing.assert_allclose(pt, pj, rtol=0, atol=5e-5)
        return
    top2 = np.sort(pj, -1)
    clear = (top2[..., -1] - top2[..., -2] > RW_MARGIN) & mask
    same = pt.argmax(-1) == pj.argmax(-1)
    assert same[clear].all()
    assert same[mask].mean() >= RW_SHARE, same[mask].mean()


def test_random_walk_seed_labels_out_of_range(case):
    """Seeds above n_objects (and none at all for an object) give a zero
    one-hot row, as jax.nn.one_hot does; torch's one_hot would raise."""
    seeds = case["seeds"].copy()
    seeds[seeds == 5] = 7
    args = dict(edge_weights="binary", cg_iters=10)
    pj = np.asarray(jrw.random_walk(jnp.asarray(case["hu"]),
                                    jnp.asarray(seeds), 4, **args))
    pt = trw.random_walk(_t(case["hu"]), _t(seeds), 4, **args).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=5e-5)


def test_fill_lobes_and_lobes_to_fissures_match_jax(case):
    seeds, mask = case["seeds"], case["lung_mask"]
    fj = np.asarray(jrw.fill_lobes(jnp.asarray(seeds), jnp.asarray(mask),
                                   cg_iters=500))
    ft = trw.fill_lobes(_t(seeds), _t(mask), cg_iters=500).numpy()
    np.testing.assert_array_equal(ft, fj)
    assert set(np.unique(ft[mask])) == {1, 2, 3, 4, 5}
    assert (ft[~mask] == 0).all()
    fis_j, filled_j = jrw.lobes_to_fissures(jnp.asarray(seeds),
                                            jnp.asarray(mask), cg_iters=500)
    fis_t, filled_t = trw.lobes_to_fissures(_t(seeds), _t(mask),
                                            cg_iters=500)
    np.testing.assert_array_equal(filled_t.numpy(), np.asarray(filled_j))
    np.testing.assert_array_equal(fis_t.numpy(), np.asarray(fis_j))
    assert set(np.unique(fis_t.numpy())) == {0, 1, 2, 3}


def test_lobe_points_to_fissure_labels_matches_jax(case):
    rng = np.random.default_rng(3)
    idx = np.argwhere(case["lung_mask"])
    idx = idx[rng.choice(len(idx), 900, replace=False)]
    pred = case["lobes"][idx[:, 0], idx[:, 1], idx[:, 2]]
    got, fmap = evaluation.lobe_points_to_fissure_labels(
        pred, idx, case["lung_mask"], device="cpu")
    want, jmap = jevaluation.lobe_points_to_fissure_labels(
        pred, idx, case["lung_mask"])
    np.testing.assert_array_equal(fmap, np.asarray(jmap))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.dtype == np.int32 and (got > 0).any()


def test_poisson_reconstruction_matches_jax(case):
    """The whole voxel cloud of each GT fissure label, masked by the lung;
    K1 through its plain version, JAX's kNN as its tests run it."""
    fissures = np.asarray(jlabels.find_fissures(jnp.asarray(case["lobes"])))
    kw = dict(grid_res=(32, 32, 32))
    lt, mt = tsf.poisson_reconstruction(fissures, case["lung_mask"],
                                        device="cpu", **kw)
    with jax.default_matmul_precision("float32"):
        lj, mj = jsf.poisson_reconstruction(fissures, case["lung_mask"],
                                            **kw)
    assert lt.dtype == np.uint8 and lt.shape == SHAPE
    assert len(mt) == len(mj) == 3
    for (tt, vt), (tj, vj) in zip(mt, mj):
        tj, vj = np.asarray(tj), np.asarray(vj)
        n_t, n_j = int(vt.sum()), int(vj.sum())
        assert n_j > 50 and abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
        a, b = tt[vt].reshape(-1, 3), tj[vj].reshape(-1, 3)
        faces_a = np.arange(len(a)).reshape(-1, 3)
        faces_b = np.arange(len(b)).reshape(-1, 3)
        gaps = [native.point_mesh_distance(b, faces_b, a),
                native.point_mesh_distance(a, faces_a, b)]
        assert max(g.mean() for g in gaps) < 0.05
        assert max(g.max() for g in gaps) < 0.5
    assert (lt == np.asarray(lj)).mean() >= 0.998
    assert set(np.unique(lt)) == {0, 1, 2, 3}


# ---- test_pipeline in the lobes label space ---------------------------------

def _lobe_cases(n=2):
    """Point cases of synthetic CTs: every GT fissure voxel and 500 random
    lung voxels, lobe labels, their fissure labels and the lung mask."""
    cases = []
    for i in range(n):
        c = synthetic.make_synthetic_image_case(i, shape=SHAPE)
        fis = np.asarray(jlabels.find_fissures(jnp.asarray(c["lobes"])))
        rng = np.random.default_rng(10 + i)
        lung = np.argwhere(c["lung_mask"])
        idx = np.unique(np.concatenate(
            [np.argwhere(fis > 0),
             lung[rng.choice(len(lung), 500, replace=False)]]), axis=0)
        coords = kpts_to_grid(idx[:, ::-1].astype(np.float32), SHAPE)
        at = (idx[:, 0], idx[:, 1], idx[:, 2])
        cases.append({
            "coords": coords, "labels": fis[at].astype(np.int32),
            "fissure_labels": fis[at].astype(np.int32),
            "lobes": c["lobes"][at].astype(np.int32),
            "lung_mask": c["lung_mask"], "shape": SHAPE,
            "spacing": (1.0, 1.0, 1.0), "case_id": c["case_id"],
            "sequence": "fixed"})
    return cases


def _lookup(cases, scale=5.0):
    """A 'model' whose logits are the GT lobe's one-hot at the case point
    each input point equals: both packages predict the same lobes."""
    table = np.concatenate([c["coords"] for c in cases])
    onehot = np.eye(6, dtype=np.float32)[
        np.concatenate([c["lobes"] for c in cases])] * scale

    def japply(v, x, train=False):
        d = ((x[..., None, :] - jnp.asarray(table)) ** 2).sum(-1)
        return jnp.asarray(onehot)[jnp.argmin(d, -1)]

    def tmodel(x):
        d = ((x[..., None, :] - _t(table)) ** 2).sum(-1)
        return _t(onehot)[d.argmin(-1)]
    return japply, tmodel


def test_test_pipeline_lobes_matches_jax(tmp_path):
    cases = _lobe_cases()
    ds = dataset.PointDataset([dict(c) for c in cases], sample_points=128,
                              lobes=True)
    jds = jdataset.PointDataset([dict(c) for c in cases], sample_points=128,
                                lobes=True)
    japply, tmodel = _lookup(cases)
    kw = dict(sample_points=128, n_runs_min=4, grid_res=(32, 32, 32),
              seed=SEED, label_space="lobes", export_artifacts=False)
    rng = jax.random.PRNGKey(SEED)
    draws = []
    for c in ds.cases:
        rng, r = jax.random.split(rng)
        n = c["coords"].shape[0]
        draws.append({"subsets": _t(jbuild_subsets(r, n, 128, 4))})
    seen = {"jax": [], "torch": []}
    jeval, teval = jevaluation.evaluate_case, evaluation.evaluate_case

    def record(key, fn):
        def run(pred, *a, **k):
            seen[key].append(np.asarray(pred))
            return fn(pred, *a, **k)
        return run
    jevaluation.evaluate_case = record("jax", jeval)
    evaluation.evaluate_case = record("torch", teval)
    try:
        with jax.default_matmul_precision("float32"):
            want = jevaluation.test_pipeline(jds, japply, None,
                                             str(tmp_path / "jax"), **kw)
        got = evaluation.test_pipeline(ds, tmodel, str(tmp_path / "torch"),
                                       device="cpu", draws=draws, **kw)
    finally:
        jevaluation.evaluate_case, evaluation.evaluate_case = jeval, teval
    for pj, pt in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(pt, pj)
    assert set(np.unique(np.concatenate(seen["torch"]))) == {0, 1, 2, 3}
    assert got["dice"].shape == (4,)
    np.testing.assert_array_equal(got["dice"], want["dice"])
    np.testing.assert_array_equal(got["missing"], want["missing"])
    assert np.isfinite(got["dice"]).all() and got["dice"][1:].min() > 0.3


def test_lobes_label_space_needs_fissure_labels_in_both(tmp_path):
    """A case without `fissure_labels` (what either preprocess_dataset
    writes: ROADMAP Queue 3, F14) raises KeyError in both packages."""
    cases = _lobe_cases(1)
    for c in cases:
        del c["fissure_labels"]
    japply, tmodel = _lookup(cases)
    kw = dict(sample_points=128, n_runs_min=2, label_space="lobes",
              export_artifacts=False)
    with pytest.raises(KeyError, match="fissure_labels"):
        jevaluation.test_pipeline(
            jdataset.PointDataset([dict(c) for c in cases], lobes=True,
                                  sample_points=128),
            japply, None, str(tmp_path / "jax"), **kw)
    with pytest.raises(KeyError, match="fissure_labels"):
        evaluation.test_pipeline(
            dataset.PointDataset([dict(c) for c in cases], lobes=True,
                                 sample_points=128),
            tmodel, str(tmp_path / "torch"), device="cpu", **kw)
