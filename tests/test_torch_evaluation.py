"""Port parity for the testing half of train_point_seg: metrics.py, the
surface sampling, the single-cloud surface fit, evaluate_case,
test_pipeline and the CSV writers, each against the JAX package on the same
numpy-seeded inputs, with the JAX package's random draws injected
(jax.random cannot be replayed in torch).

Tolerances, each where it is used:
  * the labels, every count and the pipeline's Dice (one case a batch):
    equal; the batch mean of Dice, recall and precision over B > 1: one
    float32 ulp (the mean rounds in another order);
  * distances and the ASSD family from equal inputs: rtol 1e-5 (float32
    sums in other orders; the dense path's |x|^2 - 2 x.y + |y|^2 rounds
    by up to 4 ulp of the largest squared norm, hence atol 1e-4 voxel
    there);
  * the surface fit: the normals' kNN is K1's sum of squared differences
    in the port and the matmul formula in JAX's CPU path, so near-ties can
    take another neighbour and the PSR grid moves by rounding: the fitted
    meshes are held by their triangle count (within 2 %; reading: equal)
    and by the symmetric point-to-mesh distance between them (below 1e-3
    voxel; reading 1.5e-5), and the ASSD family of evaluate_case and the
    pipeline within MESH_RTOL relative (reading: at most 8.1e-5, ASSD).
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu import metrics as jmetrics
from fissure_segmentation_tpu import native as jnative
from fissure_segmentation_tpu.data import dataset as jdataset
from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu.models.ensemble import \
    build_subsets as jbuild_subsets
from fissure_segmentation_tpu.ops import marching as jmarching
from fissure_segmentation_tpu.postprocess import surface_fitting as jsf
from fissure_segmentation_tpu.train import evaluation as jevaluation
from fissure_segmentation_tpu_torch import metrics, native
from fissure_segmentation_tpu_torch.data import dataset, synthetic
from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                   load_jax_variables)
from fissure_segmentation_tpu_torch.ops import marching
from fissure_segmentation_tpu_torch.postprocess import surface_fitting as tsf
from fissure_segmentation_tpu_torch.train import evaluation

DIST_TOL = dict(rtol=1e-5, atol=1e-5)
MESH_RTOL = 1e-3
SEED = 42


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- label metrics ----------------------------------------------------------

@pytest.mark.parametrize("shape,n_labels", [((2, 500), 4), ((3, 7, 9), 3)])
def test_label_metrics_match_jax(shape, n_labels):
    rng = np.random.default_rng(0)
    pred = rng.integers(0, n_labels, shape).astype(np.int32)
    targ = rng.integers(0, n_labels, shape).astype(np.int32)
    targ[0] = 0                       # a batch element without foreground
    got = metrics.batch_dice(_t(pred), _t(targ), n_labels)
    want = jmetrics.batch_dice(jnp.asarray(pred), jnp.asarray(targ), n_labels)
    assert got.dtype == torch.float32
    # the batch mean rounds in another order: one float32 ulp (at B = 1,
    # the pipeline's, Dice is equal: test_pipeline_predictions_and_dice...)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7,
                               atol=0)
    for name in ("binary_recall", "binary_precision"):
        got = getattr(metrics, name)(_t(pred), _t(targ)).numpy()
        want = np.asarray(getattr(jmetrics, name)(jnp.asarray(pred),
                                                  jnp.asarray(targ)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


# ---- distances --------------------------------------------------------------

def _mesh(rng, n_tris=60):
    verts = rng.uniform(0, 10, (n_tris + 2, 3)).astype(np.float32)
    tris = np.stack([np.arange(n_tris), np.arange(1, n_tris + 1),
                     np.arange(2, n_tris + 2)], -1).astype(np.int32)
    return verts, tris


def test_point_surface_distance_matches_jax():
    """The exact point-to-triangle distance (chunked, a ragged last chunk)
    against JAX's XLA version and against both packages' native BVH."""
    rng = np.random.default_rng(1)
    verts, tris = _mesh(rng)
    q = rng.uniform(-2, 12, (700, 3)).astype(np.float32)
    want = np.asarray(jmetrics.point_surface_distance(
        jnp.asarray(q), jnp.asarray(verts), jnp.asarray(tris), chunk=256))
    got = metrics.point_surface_distance(_t(q), _t(verts), _t(tris),
                                         chunk=256).numpy()
    np.testing.assert_allclose(got, want, **DIST_TOL)
    host = native.point_mesh_distance(verts, tris, q)
    np.testing.assert_array_equal(host, jnative.point_mesh_distance(
        verts, tris, q))
    np.testing.assert_allclose(host, want, rtol=1e-4, atol=1e-4)
    assert np.isinf(native.point_mesh_distance(
        verts, np.zeros((0, 3), np.int32), q[:3])).all()
    with pytest.raises(ValueError, match="indexes no vertex"):
        native.point_mesh_distance(verts, tris + 5, q)


def test_assd_statistics_match_jax():
    """Population standard deviation (ddof 0) and the linear quantile, as
    jnp.std and jnp.quantile; an unbiased std would miss."""
    rng = np.random.default_rng(2)
    a = rng.exponential(2.0, 37).astype(np.float32)
    b = rng.exponential(1.0, 50).astype(np.float32)
    got = [float(v) for v in metrics.assd_statistics(_t(a), _t(b))]
    want = [float(v) for v in jmetrics.assd_statistics(jnp.asarray(a),
                                                       jnp.asarray(b))]
    np.testing.assert_allclose(got, want, **DIST_TOL)
    unbiased = (_t(a).std() + _t(b).std()) / 2
    assert abs(float(unbiased) - want[1]) > 1e-3


@pytest.mark.parametrize("route", ["dense", "host", "device"])
def test_mesh_metrics_match_jax(route):
    rng = np.random.default_rng(3)
    pv, pt = _mesh(rng, 40)
    gv, gt = _mesh(rng, 50)
    pred = rng.uniform(0, 10, (300, 3)).astype(np.float32)
    gtp = rng.uniform(0, 10, (450, 3)).astype(np.float32)
    if route == "dense":
        got = metrics.mesh_metrics_from_point_sets(_t(pred), _t(gtp),
                                                   chunk=128)
        want = jmetrics.mesh_metrics_from_point_sets(jnp.asarray(pred),
                                                     jnp.asarray(gtp))
        tol = dict(rtol=1e-5, atol=1e-4)
    else:
        got = metrics.mesh_metrics_from_point_sets(
            _t(pv), _t(gv), _t(pt), _t(gt), host=route == "host")
        want = jmetrics.mesh_metrics_from_point_sets(
            jnp.asarray(pv), jnp.asarray(gv), jnp.asarray(pt),
            jnp.asarray(gt), host=route == "host")
        tol = DIST_TOL
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], **tol)


# ---- surface sampling and fit ----------------------------------------------

def _jax_surface_draws(key, n):
    r_idx, r_uv = jax.random.split(key)
    return (_t(jax.random.uniform(r_idx, (n,))),
            _t(jax.random.uniform(r_uv, (n, 2))))


def test_sample_points_on_triangles_with_jax_draws():
    """JAX's two uniform draws injected: the same triangles are picked
    (invalid ones never) and the samples agree to float32 rounding; a
    generator's draw is reproducible and lies on the valid triangles."""
    rng = np.random.default_rng(4)
    tris = rng.uniform(0, 20, (50, 3, 3)).astype(np.float32)
    valid = rng.random(50) < 0.7
    key = jax.random.PRNGKey(7)
    want = np.asarray(jmarching.sample_points_on_triangles(
        key, jnp.asarray(tris), jnp.asarray(valid), 2000))
    got = marching.sample_points_on_triangles(
        _t(tris), _t(valid), 2000,
        draws=_jax_surface_draws(key, 2000)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    g1 = marching.sample_points_on_triangles(
        _t(tris), _t(valid), 500, torch.Generator().manual_seed(1))
    g2 = marching.sample_points_on_triangles(
        _t(tris), _t(valid), 500, torch.Generator().manual_seed(1))
    assert torch.equal(g1, g2)
    d = native.point_mesh_distance(tris[valid].reshape(-1, 3),
                                   np.arange(3 * valid.sum()).reshape(-1, 3),
                                   g1.numpy())
    assert d.max() < 1e-3
    verts, faces = marching.triangles_to_mesh(_t(tris))
    jv, jf = jmarching.triangles_to_mesh(jnp.asarray(tris))
    np.testing.assert_array_equal(verts.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(faces.numpy(), np.asarray(jf))


def _mesh_gap(a, b) -> float:
    """Symmetric max of vertex-to-mesh distances between two fitted
    (tris, valid) meshes."""
    def one(x, y):
        ty = y[0][y[1]]
        return native.point_mesh_distance(
            ty.reshape(-1, 3), np.arange(3 * len(ty)).reshape(-1, 3),
            x[0][x[1]].reshape(-1, 3)).max()
    return max(one(a, b), one(b, a))


def _fissure_cloud(case, label):
    pts = case["coords"][case["labels"] == label]
    from fissure_segmentation_tpu_torch.utils.coords import kpts_to_world
    return kpts_to_world(pts, case["shape"])


def test_pointcloud_surface_fitting_matches_jax():
    case = synthetic.make_synthetic_dataset(1, n_points=1500)[0]
    pts = _fissure_cloud(case, 2)
    kw = dict(grid_res=(32, 32, 32), right=True, center_x=case["shape"][2] / 2)
    tris_t, valid_t = tsf.pointcloud_surface_fitting(pts, case["shape"],
                                                     device="cpu", **kw)
    tris_j, valid_j = jsf.pointcloud_surface_fitting(pts, case["shape"], **kw)
    assert tris_t.dtype == np.float32 and valid_t.dtype == bool
    n_t, n_j = int(valid_t.sum()), int(np.asarray(valid_j).sum())
    assert n_j > 100 and abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
    gap = _mesh_gap((tris_t, valid_t), (np.asarray(tris_j),
                                        np.asarray(valid_j)))
    assert gap < 1e-3, gap


@pytest.mark.parametrize("n", [3, 10, 29])
def test_surface_fitting_raises_for_few_points(n):
    """Fewer than 4 points: the explicit check; 4-29 points: the normals'
    k = 30 neighbourhood does not fit (K1 raises ValueError for kk > N, as
    JAX's top_k raises), and evaluate_case turns either into a NaN row."""
    rng = np.random.default_rng(n)
    pts = rng.uniform(10, 50, (n, 3)).astype(np.float32)
    shape = (64, 64, 64)
    with pytest.raises(ValueError):
        tsf.pointcloud_surface_fitting(pts, shape, grid_res=(16, 16, 16),
                                       device="cpu")
    with pytest.raises((ValueError, TypeError)):
        jsf.pointcloud_surface_fitting(pts, shape, grid_res=(16, 16, 16))


# ---- evaluate_case and test_pipeline ------------------------------------------

def _models(k=8, n_classes=4, in_features=4):
    jm = JDGCNNSeg(k=k, in_features=in_features, num_classes=n_classes,
                   dynamic=True)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 32, in_features))))
    tm = load_jax_variables(DGCNNSeg(k=k, in_features=in_features,
                                     num_classes=n_classes), variables).eval()
    return jm, variables, tm


def _biased(cases, scale):
    """A class bias of `scale` on the GT label of the case point each input
    point equals (the inputs are case points). At 0.12 against the seeded
    model's logits (at most 0.22) the prediction follows the GT on most
    points and the model on some (Dice 0.997 and 0.983 in two classes)."""
    coords = np.concatenate([c["coords"] for c in cases])
    feats = np.concatenate([c["features"] for c in cases])
    table = np.concatenate([coords, feats], 1)
    onehot = np.eye(4, dtype=np.float32)[
        np.concatenate([c["labels"] for c in cases])] * scale

    def jbias(x):
        d = ((x[..., None, :] - jnp.asarray(table)) ** 2).sum(-1)
        return jnp.asarray(onehot)[jnp.argmin(d, -1)]

    def tbias(x):
        d = ((x[..., None, :] - _t(table)) ** 2).sum(-1)
        return _t(onehot)[d.argmin(-1)]
    return jbias, tbias


def _jax_draws(ds, sample_points, n_runs_min, n_samples=4000):
    """The draws of JAX's test_pipeline (PRNGKey(seed) split per case;
    PRNGKey(seed + c) per class), to inject into the port's."""
    rng = jax.random.PRNGKey(SEED)
    draws = []
    for i in range(len(ds)):
        rng, r = jax.random.split(rng)
        n = ds.cases[i]["coords"].shape[0]
        draws.append({
            "subsets": _t(jbuild_subsets(r, n, min(sample_points, n),
                                         n_runs_min)),
            "surface": {c: _jax_surface_draws(jax.random.PRNGKey(SEED + c),
                                              n_samples)
                        for c in range(1, ds.num_classes)}})
    return draws


def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


def _cells_close(got_rows, want_rows, rtol, what):
    assert len(got_rows) == len(want_rows), what
    for g, w in zip(got_rows, want_rows):
        assert len(g) == len(w), (what, g, w)
        for a, b in zip(g, w):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b, (what, a, b)
                continue
            assert (np.isnan(fa) and np.isnan(fb)) or \
                np.isclose(fa, fb, rtol=rtol, atol=1e-6), (what, g, w)


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    """Both packages' test_pipeline on the same two small cases, from the
    same dynamic f32 DGCNNSeg weights with the same class bias, JAX's draws
    injected into the port."""
    cases = synthetic.make_synthetic_dataset(2, n_points=400,
                                             gt_surfaces=True)
    jcases = [dict(c) for c in cases]
    ds = dataset.PointDataset(cases, sample_points=128)
    jds = jdataset.PointDataset(jcases, sample_points=128)
    jm, variables, tm = _models()
    jbias, tbias = _biased(cases, 0.12)
    kw = dict(sample_points=128, n_runs_min=4, grid_res=(32, 32, 32),
              seed=SEED)
    preds = {}

    def japply(v, x, train=False):
        return jm.apply(v, x, train=train) + jbias(x)

    def tmodel(x):
        return tm(x) + tbias(x)
    out = tmp_path_factory.mktemp("pipeline")
    seen_j, seen_t = [], []
    jeval = jevaluation.evaluate_case
    teval = evaluation.evaluate_case

    def jrecord(pred, *a, **k):
        seen_j.append(np.asarray(pred))
        return jeval(pred, *a, **k)

    def trecord(pred, *a, **k):
        seen_t.append(np.asarray(pred))
        return teval(pred, *a, **k)
    jevaluation.evaluate_case, evaluation.evaluate_case = jrecord, trecord
    try:
        with jax.default_matmul_precision("float32"):
            want = jevaluation.test_pipeline(jds, japply, variables,
                                             str(out / "jax"), **kw)
        got = evaluation.test_pipeline(ds, tmodel, str(out / "torch"),
                                       device="cpu",
                                       draws=_jax_draws(ds, 128, 4), **kw)
    finally:
        jevaluation.evaluate_case, evaluation.evaluate_case = jeval, teval
    preds = {"jax": seen_j, "torch": seen_t}
    return out, got, want, preds, ds


def test_pipeline_predictions_and_dice_equal_jax(pipeline_run):
    out, got, want, preds, ds = pipeline_run
    for pj, pt in zip(preds["jax"], preds["torch"]):
        np.testing.assert_array_equal(pt, pj)
    assert len(np.unique(np.concatenate(preds["torch"]))) >= 3
    np.testing.assert_array_equal(got["dice"], want["dice"])
    np.testing.assert_array_equal(got["missing"], want["missing"])


def test_pipeline_mesh_metrics_match_jax(pipeline_run):
    out, got, want, _, _ = pipeline_run
    for key in ("assd", "sdsd", "hd", "hd95"):
        assert np.isfinite(want[key]).sum() >= 2, (key, want[key])
        np.testing.assert_allclose(got[key], want[key], rtol=MESH_RTOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["test_results.csv", "dice_per_instance.csv",
                                  "assd_per_instance.csv",
                                  "inference_time.csv"])
def test_pipeline_csvs_match_jax(pipeline_run, name):
    """Every cell: labels and Dice equal, ASSD family within MESH_RTOL; the
    times only by layout (they are measured)."""
    out, *_ = pipeline_run
    got = _read(out / "torch" / name)
    want = _read(out / "jax" / name)
    if name == "inference_time.csv":
        assert got[0] == want[0] and len(got[1]) == len(want[1])
        assert all(np.isfinite(float(v)) and float(v) >= 0 for v in got[1])
        return
    _cells_close(got, want, 0 if name == "dice_per_instance.csv"
                 else MESH_RTOL, name)
    if name == "test_results.csv":
        dice_rows = [r for r in got if r and "Dice" in r[0]]
        assert dice_rows == [r for r in want if r and "Dice" in r[0]]


def test_pipeline_artifacts(pipeline_run):
    """OBJ, NIfTI, the viewer and (matplotlib is installed here) the PNGs,
    for every case and every fitted class, as JAX writes them."""
    out, got, _, _, ds = pipeline_run
    for pkg in ("jax", "torch"):
        pred = out / pkg / "test_predictions"
        files = sorted(p.relative_to(pred).as_posix()
                       for p in pred.rglob("*") if p.is_file())
        if pkg == "jax":
            want = files
    assert files == want
    for cid in ("_".join(map(str, i)) for i in ds.ids):
        for f in (f"labelmaps/{cid}_fissures_pred.nii.gz",
                  f"plots/{cid}_viewer.html",
                  f"plots/{cid}_point_cloud_pred.png",
                  f"plots/{cid}_point_cloud_targ.png"):
            assert f in files, f
    assert any(f.endswith("_pred.obj") for f in files)


def test_evaluate_case_matches_jax():
    """One case straight from its GT labels (every fissure fitted), JAX's
    surface draws injected."""
    case = synthetic.make_synthetic_dataset(1, n_points=900,
                                            gt_surfaces=True)[0]
    draws = {c: _jax_surface_draws(jax.random.PRNGKey(SEED + c), 4000)
             for c in range(1, 4)}
    kw = dict(grid_res=(32, 32, 32), seed=SEED)
    got = evaluation.evaluate_case(case["labels"], case["coords"], case, 4,
                                   surface_draws=draws, device="cpu", **kw)
    want = jevaluation.evaluate_case(case["labels"], case["coords"], case, 4,
                                     **kw)
    np.testing.assert_array_equal(got["missing"], want["missing"])
    assert not got["missing"].any()
    for key in ("assd", "sdsd", "hd", "hd95"):
        np.testing.assert_allclose(got[key], want[key], rtol=MESH_RTOL,
                                   err_msg=key)


def test_writers_match_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(6)
    vals = [rng.random(4), rng.random(4)] + [rng.random(3) for _ in range(8)]
    vals[2][1] = np.nan
    kw = dict(proportion_missing=np.array([0.0, 0.5, 0.25]),
              extra=np.array([1.5, 2.5]))
    dice = rng.random((2, 3)).astype(np.float32)
    assd = np.array([[1.0, np.nan, 2.0], [3.0, 4.0, 5.0]])
    for mod, d in ((evaluation, "torch"), (jevaluation, "jax")):
        os.makedirs(tmp_path / d)
        mod.write_results(str(tmp_path / d / "r.csv"), *vals, **kw)
        mod.write_raw_results_per_instance(
            str(tmp_path / d), ids=["a_x", "b_y"], copd=True, dice=dice,
            assd=assd)
        mod.write_speed_results(str(tmp_path / d), [0.5, 0.25, 0.125],
                                [1.0, 2.0, 4.0], points_per_fissure=[
                                    [10, 20], [30, 50]], suffix="_copd")
        mod.write_speed_results(str(tmp_path / d), [0.5])
    for name in ("r.csv", "dice_per_instance_copd.csv",
                 "assd_per_instance_copd.csv", "inference_time_copd.csv",
                 "inference_time.csv"):
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_binary_labels_and_label_spaces():
    rng = np.random.default_rng(7)
    lung = rng.integers(0, 3, (6, 7, 8))
    idx = rng.integers(-2, 10, (50, 3))
    pred = rng.integers(0, 2, 50)
    np.testing.assert_array_equal(
        evaluation.binary_to_fissure_labels(pred, idx, lung),
        jevaluation.binary_to_fissure_labels(pred, idx, lung))
    ds = dataset.PointDataset(synthetic.make_synthetic_dataset(
        1, n_points=100))
    with pytest.raises(ValueError, match="label_space"):
        evaluation.test_pipeline(ds, None, "unused", label_space="lobe",
                                 device="cpu")


def test_copd_split_matches_jax(tmp_path):
    """A COPD dataset is the validation set of every fold, (None, self);
    from a folder only the cases whose id says COPD are read."""
    cases = synthetic.make_synthetic_dataset(4, n_points=60)
    for i, c in enumerate(cases[:2]):
        c["case_id"] = f"COPD{i:02d}"
    for c in cases:
        dataset.save_case_npz(c, str(tmp_path))
    ours = dataset.PointDataset.from_folder(str(tmp_path), copd=True)
    theirs = jdataset.PointDataset.from_folder(str(tmp_path), copd=True)
    assert ours.ids == theirs.ids == [("COPD00", "fixed"), ("COPD01", "fixed")]
    split = dataset.create_split(ours.ids, k=2)
    tr, vl = ours.split_data_set(split[0], fold_nr=0)
    jtr, jvl = theirs.split_data_set(split[0], fold_nr=0)
    assert tr is None and jtr is None and vl is ours and jvl is theirs
    plain = dataset.PointDataset(cases)
    tr, vl = plain.split_data_set(dataset.create_split(plain.ids, k=2)[0])
    assert tr is not None and len(tr) + len(vl) == 4
    for i in range(2):
        for a, b in zip(ours.get_full_pointcloud(i),
                        theirs.get_full_pointcloud(i)):
            np.testing.assert_array_equal(a, b)
    for c in cases[2:]:
        dataset.save_case_npz(c, str(tmp_path / "other"))
    with pytest.raises(FileNotFoundError, match="COPD"):
        dataset.PointDataset.from_folder(str(tmp_path / "other"), copd=True)
