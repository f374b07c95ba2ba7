"""The default run of the port's train_point_seg entry on the CPU: no
--static and no --train_only, so DGCNN trains with the dynamic graph in
bf16 (--amp true) and then tests the fold; then --test_only, --speed and
--copd on the same output directory. And a model trained by the JAX
package's entry, carried over with load_jax_variables and save_model, tested
by both entries' --test_only from the same draws (the JAX package's,
injected into the port's test_pipeline).

Tolerances: Dice equal; the ASSD family within MESH_RTOL relative (the
surface fits differ by rounding, tests/test_torch_evaluation.py says why);
the timing cells by layout only.
"""
import csv
import os
import sys

import jax
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.models import load_model as jload_model
from fissure_segmentation_tpu.models.ensemble import \
    build_subsets as jbuild_subsets
from fissure_segmentation_tpu_torch import train_point_seg
from fissure_segmentation_tpu_torch.data import dataset, synthetic
from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                   load_jax_variables,
                                                   load_model, save_model)
from fissure_segmentation_tpu_torch.train import evaluation
from fissure_segmentation_tpu_torch.train.cross_val import cross_val_training
from fissure_segmentation_tpu.train.cross_val import \
    cross_val_training as jcross_val_training

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_RTOL = 1e-3
SMALL = ["--fold", "0", "--epochs", "1", "--pts", "64", "--k", "8",
         "--batch", "2"]
RESULT_ROWS = ["Class", "Mean Dice", "StdDev Dice", None, "Fissure",
               "Mean ASSD", "StdDev ASSD", "Mean SDSD", "StdDev SDSD",
               "Mean HD", "StdDev HD", "Mean HD95", "StdDev HD95",
               "proportion missing"]
SPEED_HEADER = ["Inference", "Inference_std", "Post-Processing",
                "Post-Processing_std", "Total", "Total_std"]


def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


def _cases_dir(tmp_path, n=5, n_copd=2):
    """n synthetic cases of 300 points with GT surfaces, the first n_copd
    with COPD ids (the COPD cohort of a --data_dir)."""
    cases = synthetic.make_synthetic_dataset(n, n_points=300,
                                             gt_surfaces=True)
    for i, c in enumerate(cases[:n_copd]):
        c["case_id"] = f"COPD{i:02d}"
    folder = tmp_path / "cases"
    for c in cases:
        dataset.save_case_npz(c, str(folder))
    return str(folder)


def _check_test_dir(test_dir, suffix=""):
    rows = _read(os.path.join(test_dir, f"test_results{suffix}.csv"))
    assert [r[0] if r else None for r in rows] == RESULT_ROWS
    dice = np.asarray(rows[1][1:], float)
    assert np.isfinite(dice).all()
    for name in ("dice", "assd"):
        per = _read(os.path.join(test_dir,
                                 f"{name}_per_instance{suffix}.csv"))
        assert per[0] == ["ID", "fissure 1", "fissure 2", "fissure 3",
                          "mean"]
        assert len(per) >= 2
    speed = _read(os.path.join(test_dir, f"inference_time{suffix}.csv"))
    assert speed[0] == SPEED_HEADER
    assert all(np.isfinite(float(v)) for v in speed[1])
    return rows


@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("entry")
    cases = _cases_dir(tmp)
    out = str(tmp / "run")
    assert train_point_seg.main(["--data_dir", cases, *SMALL, "--output",
                                 out], device="cpu") == 0
    return cases, out


def test_default_run_trains_dynamic_bf16_and_tests(default_run):
    """model.pt holds DGCNNSeg(dynamic, bf16); fold 0's test wrote the
    JAX package's CSVs and every artifact (matplotlib is installed here,
    so the PNGs too), and cv_results.csv."""
    _, out = default_run
    model = load_model(os.path.join(out, "fold0", "model.pt"), DGCNNSeg)
    assert model.dynamic and model.dtype == torch.bfloat16
    assert model.config == dict(k=8, in_features=4, num_classes=4,
                                dynamic=True, dtype="bfloat16")
    test_dir = os.path.join(out, "fold0", "test")
    _check_test_dir(test_dir)
    pred = os.path.join(test_dir, "test_predictions")
    files = [os.path.join(r, f) for r, _, fs in os.walk(pred) for f in fs]
    for ext in (".nii.gz", "_viewer.html", "_point_cloud_pred.png",
                "_point_cloud_targ.png"):
        assert any(f.endswith(ext) for f in files), ext
    cv = _read(os.path.join(out, "cv_results.csv"))
    assert [r[0] for r in cv][:2] == ["mean_assd", "std_assd"]


def test_default_run_then_test_only(default_run):
    cases, out = default_run
    first = _read(os.path.join(out, "fold0", "test", "test_results.csv"))
    assert train_point_seg.main(["--output", out, "--test_only", "--fold",
                                 "0"], device="cpu") == 0
    again = _check_test_dir(os.path.join(out, "fold0", "test"))
    assert again == first          # the same seeded draws, the same model


def test_default_run_then_speed(default_run):
    _, out = default_run
    assert train_point_seg.main(["--output", out, "--speed"],
                                device="cpu") == 0
    speed = _read(os.path.join(out, "inference_time.csv"))
    assert speed[0] == SPEED_HEADER and float(speed[1][0]) > 0
    assert float(speed[1][2]) == 0.0       # no post-processing timed


def test_default_run_then_copd(default_run):
    """--copd tests fold 0's model on the COPD cases of the data folder
    and forces test_only: the split file stays the training run's."""
    cases, out = default_run
    split = open(os.path.join(out, "cross_val_split.json")).read()
    assert train_point_seg.main(["--output", out, "--copd", "--fold", "0",
                                 "--data_dir", cases], device="cpu") == 0
    rows = _check_test_dir(os.path.join(out, "fold0", "test"), "_copd")
    per = _read(os.path.join(out, "fold0", "test",
                             "dice_per_instance_copd.csv"))
    assert [r[0] for r in per[1:]] == ["COPD00_fixed", "COPD01_fixed"]
    assert rows[0][0] == "Class"
    assert os.path.exists(os.path.join(out, "cv_results_copd.csv"))
    assert open(os.path.join(out, "cross_val_split.json")).read() == split


def test_synthetic_copd_cohort_matches_jax(monkeypatch):
    """The synthetic COPD cohort: 6 cases, seed 777, ids COPD00..05, every
    fold's validation set. Both entries' generator calls are recorded and
    run at 50 points a case (the generators are held bit-equal by
    tests/test_torch_train.py::test_synthetic_point_dataset_bit_equal)."""
    sys.path.insert(0, REPO)
    import train_point_seg as jentry
    calls = []

    def small(module):
        real = module.make_synthetic_dataset

        def make(n, n_points, **kw):
            calls.append((module.__name__, n, n_points, kw))
            return real(n, n_points=50, **kw)
        monkeypatch.setattr(module, "make_synthetic_dataset", make)
    small(jentry)
    small(train_point_seg)
    args = train_point_seg.get_point_segmentation_parser().parse_args(
        ["--ds", "synthetic", "--copd"])
    ours = train_point_seg.build_dataset(args)
    theirs = jentry.build_dataset(args)
    assert [c[1:] for c in calls] == 2 * [
        (6, 8000, dict(gt_surfaces=True, seed=777))]
    assert ours.ids == theirs.ids == [(f"COPD{i:02d}", "fixed")
                                      for i in range(6)]
    for i in range(6):
        for a, b in zip(ours.get_full_pointcloud(i),
                        theirs.get_full_pointcloud(i)):
            np.testing.assert_array_equal(a, b)
    assert ours.split_data_set({"train": [], "val": []}) == (None, ours)


def test_cross_val_matches_jax_harness(tmp_path):
    """A COPD dataset's folds reach test_fn only (never train_fn), write
    cv_results_copd.csv as the JAX harness does, byte for byte, and a
    test_only run keeps the split file it finds."""
    cases = synthetic.make_synthetic_dataset(3, n_points=40)
    ds = dataset.PointDataset(cases, copd=True)
    split = dataset.create_split(ds.ids, k=3)
    for harness, d in ((cross_val_training, "port"),
                       (jcross_val_training, "jax")):
        out = tmp_path / d
        out.mkdir()
        (out / "cross_val_split.json").write_text("the training run's")
        seen = []

        def train_fn(*a):
            raise AssertionError("train_fn reached")

        def test_fn(val_ds, fold_dir, fold):
            seen.append((len(val_ds), fold))
            return {"dice": np.array([0.5, fold / 4.0]),
                    "assd": np.array([fold + 1.5])}
        harness(ds, split, str(out), train_fn, test_fn, test_only=True,
                folds=[0, 2], results_suffix="_copd")
        assert seen == [(3, 0), (3, 2)]
        assert (out / "cross_val_split.json").read_text() == \
            "the training run's"
    assert (tmp_path / "port" / "cv_results_copd.csv").read_bytes() == \
        (tmp_path / "jax" / "cv_results_copd.csv").read_bytes()


def _jax_draws(ds, sample_points, n_runs_min=50, n_samples=4000, seed=42):
    rng = jax.random.PRNGKey(seed)
    draws = []
    for i in range(len(ds)):
        rng, r = jax.random.split(rng)
        n = ds.cases[i]["coords"].shape[0]
        surface = {}
        for c in range(1, ds.num_classes):
            r_idx, r_uv = jax.random.split(jax.random.PRNGKey(seed + c))
            surface[c] = (torch.from_numpy(np.array(jax.random.uniform(
                r_idx, (n_samples,)))), torch.from_numpy(np.array(
                    jax.random.uniform(r_uv, (n_samples, 2)))))
        draws.append({"subsets": torch.from_numpy(np.array(jbuild_subsets(
            r, n, min(sample_points, n), n_runs_min))), "surface": surface})
    return draws


def test_jax_trained_model_tested_by_both_entries(tmp_path, monkeypatch):
    """The JAX entry trains fold 0 (f32, dynamic) and tests it; its
    model.fst carried over to model.pt is tested by the port's
    --test_only with the JAX draws injected: Dice equal, the ASSD family
    within MESH_RTOL, the same layout."""
    sys.path.insert(0, REPO)
    import train_point_seg as jentry
    cases = _cases_dir(tmp_path, n_copd=0)
    out = str(tmp_path / "run")
    argv = ["--data_dir", cases, *SMALL, "--amp", "false", "--output", out]
    jparser = jentry.get_point_segmentation_parser()
    with jax.default_matmul_precision("float32"):
        jentry.run(jparser.parse_args(argv))
    want = _read(os.path.join(out, "fold0", "test", "test_results.csv"))
    _, variables = jload_model(os.path.join(out, "fold0", "model.fst"))
    model = load_jax_variables(DGCNNSeg(k=8, in_features=4, num_classes=4),
                               jax.tree_util.tree_map(np.asarray, variables))
    save_model(model, os.path.join(out, "fold0", "model.pt"))

    real = evaluation.test_pipeline

    def with_jax_draws(ds, *args, **kwargs):
        return real(ds, *args, draws=_jax_draws(ds, kwargs["sample_points"]),
                    **kwargs)
    monkeypatch.setattr(evaluation, "test_pipeline", with_jax_draws)
    assert train_point_seg.main(["--output", out, "--test_only", "--fold",
                                 "0"], device="cpu") == 0
    got = _read(os.path.join(out, "fold0", "test", "test_results.csv"))
    assert [r[:1] for r in got] == [r[:1] for r in want]
    for g, w in zip(got, want):
        if g and "Dice" in g[0]:
            assert g == w
        elif g and g[0] not in ("Class", "Fissure"):
            np.testing.assert_allclose(np.asarray(g[1:], float),
                                       np.asarray(w[1:], float),
                                       rtol=MESH_RTOL, err_msg=g[0])


def test_canonical_cv_flags_and_comparison(tmp_path):
    """train/canonical_cv.py parses the committed JAX run's flags into the
    namespace that run recorded (but for the output and the split), and
    its comparison of the reference with itself passes with every gap 0;
    one class moved past twice its fold std fails; the port's committed
    run (results/torch_h100_canonical_cv5) passes."""
    import json
    import shutil
    from fissure_segmentation_tpu_torch.cli import \
        get_point_segmentation_parser
    from fissure_segmentation_tpu_torch.train import canonical_cv
    ref = os.path.join(REPO, canonical_cv.REFERENCE)
    with open(os.path.join(ref, "commandline_args.json")) as f:
        recorded = json.load(f)
    args = vars(get_point_segmentation_parser().parse_args(
        canonical_cv.reference_argv(recorded)))
    for key, value in recorded.items():
        if key not in ("output", "split"):
            assert args[key] == value, key
    same = canonical_cv.compare(ref, ref, 5)
    assert same["pass"] and all(r["gap"] == 0 for r in same["comparisons"])
    assert json.loads(json.dumps(same)) == same
    assert same["paired_dice"]["cases"] == 20
    moved = tmp_path / "moved"
    shutil.copytree(ref, moved)
    rows = _read(moved / "cv_results.csv")
    for r in rows:
        if r[0] == "mean_assd":
            r[2] = str(float(r[2]) + 0.05)       # std 0.0176: 2.8 stds
    with open(moved / "cv_results.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    out = canonical_cv.compare(str(moved), ref, 5)
    assert not out["pass"]
    assert [(r["metric"], r["class"]) for r in out["comparisons"]
            if not r["within"]] == [("assd", 2)]
    # the port's committed H100 run passes the bound
    port = os.path.join(REPO, "results", "torch_h100_canonical_cv5")
    assert canonical_cv.compare(port, ref, 5)["pass"]


def test_canonical_cv_knn09_flags():
    """The knn09 reference's flags parse into the namespace it recorded
    (`--knn_recall 0.9` included, its split aside); the exact run's
    recorded null recall adds no flag."""
    import json
    from fissure_segmentation_tpu_torch.cli import \
        get_point_segmentation_parser
    from fissure_segmentation_tpu_torch.train import canonical_cv
    ref = os.path.join(REPO, "results", "demo_tpu_canonical_cv5_knn09")
    with open(os.path.join(ref, "commandline_args.json")) as f:
        recorded = json.load(f)
    argv = canonical_cv.reference_argv(recorded)
    assert argv[argv.index("--knn_recall") + 1] == "0.9"
    args = vars(get_point_segmentation_parser().parse_args(argv))
    for key, value in recorded.items():
        if key not in ("output", "split"):
            assert args[key] == value, key
    with open(os.path.join(REPO, canonical_cv.REFERENCE,
                           "commandline_args.json")) as f:
        assert "--knn_recall" not in canonical_cv.reference_argv(
            json.load(f))


def test_canonical_cv_knn09_committed_run():
    """The port's committed knn09 run (results/torch_h100_canonical_cv5_
    knn09, H100) re-reads to its comparison.json, which passes the bound
    on every row, and its exact-against-fast deltas.csv has the JAX
    script's columns and metrics."""
    import json
    from fissure_segmentation_tpu_torch.train import canonical_cv
    port = os.path.join(REPO, "results", "torch_h100_canonical_cv5_knn09")
    ref = os.path.join(REPO, "results", "demo_tpu_canonical_cv5_knn09")
    result = canonical_cv.compare(port, ref, 5)
    with open(os.path.join(port, "comparison.json")) as f:
        assert json.load(f) == result
    assert result["pass"] and all(r["within"] for r in result["comparisons"])
    ours = _read(os.path.join(port, "fast_variant_eval", "deltas.csv"))
    theirs = _read(os.path.join(REPO, canonical_cv.REFERENCE,
                                "fast_variant_eval", "deltas.csv"))
    assert ours[1] == theirs[1] == ["metric", "exact", "fast", "delta"]
    assert [r[0] for r in ours[2:]] == [r[0] for r in theirs[2:]]
