"""Port parity for the scripts downstream of preprocessing:
evaluate_baselines (both modes), compute_fraction_of_fissures and
qualitative_plots, against the JAX package's entries on the CPU.

Tolerances:
  * evaluate_baselines on a 32^3 case with JAX's surface-sample draws
    injected and both entries fitting with the port's surface fit (the
    test says why): the CSVs' header and row layout equal, Dice and the
    missing share equal, the ASSD family within rtol 1e-3 (reading 1.2e-4:
    both take point distances as |x|^2 - 2 x.y + |y|^2 in float32, whose
    cancellation at voxel coordinates up to 32 leaves about 1e-4 of a
    squared distance, and the sums run in other orders);
  * compute_fraction_of_fissures: the same CSV, byte for byte;
  * qualitative_plots' pure functions and the overlay/legend helpers it
    draws with: equal (the helpers' source); its entry writes the JAX
    entry's figures.
"""
import os
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

import compute_fraction_of_fissures as jfraction
import evaluate_baselines as jeb
import qualitative_plots as jqp
from fissure_segmentation_tpu_torch import compute_fraction_of_fissures
from fissure_segmentation_tpu_torch import evaluate_baselines as eb
from fissure_segmentation_tpu_torch import qualitative_plots as qp
from fissure_segmentation_tpu_torch.utils.nifti import save_nifti


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def baseline_dirs(tmp_path_factory):
    """One 32^3 case in the reference layout: fissure 1 a 16 x 16 plane
    predicted one voxel off, fissure 2 a 16 x 20 plane predicted exactly."""
    root = tmp_path_factory.mktemp("baselines")
    shape = (32, 32, 32)
    data, preds = root / "data", root / "preds"
    os.makedirs(data)
    os.makedirs(preds)
    fissures = np.zeros(shape, np.int16)
    fissures[14, 8:24, 8:24] = 1
    fissures[20, 6:26, 8:24] = 2
    mask = np.zeros(shape, np.uint8)
    mask[4:28, 4:28, 4:28] = 1
    save_nifti(str(data / "case0_img_fixed.nii.gz"),
               np.zeros(shape, np.float32))
    save_nifti(str(data / "case0_fissures_fixed.nii.gz"), fissures)
    save_nifti(str(data / "case0_mask_fixed.nii.gz"), mask)
    pred = np.zeros(shape, np.int16)
    pred[15, 8:24, 8:24] = 1
    pred[20, 6:26, 8:24] = 2
    save_nifti(str(preds / "case0_fixed.nii.gz"), pred)
    return root


def _jax_draws(seed, n_fissures=2):
    """JAX's surface-sample uniforms of label L: split(PRNGKey(seed + L))
    into the triangle and the barycentric draws."""
    out = {}
    for lbl in range(1, n_fissures + 1):
        r_idx, r_uv = jax.random.split(jax.random.PRNGKey(seed + lbl))
        out[lbl] = (torch.from_numpy(np.asarray(
                        jax.random.uniform(r_idx, (10000,)))),
                    torch.from_numpy(np.asarray(
                        jax.random.uniform(r_uv, (10000, 2)))))
    return out


def _rows(path):
    with open(path) as f:
        return [ln.rstrip("\n").split(",") for ln in f]


@pytest.mark.parametrize("mode", ["voxels", "subsample"])
def test_evaluate_baselines_matches_jax(baseline_dirs, mode, monkeypatch):
    """Both entries fit their surfaces with the port's
    pointcloud_surface_fitting (on the CPU, once a cloud; held against
    JAX's own in tests/test_torch_evaluation.py), so the comparison holds
    everything else: the subsampling, the ground-truth points, the surface
    samples, the metrics, Dice and the CSVs."""
    from fissure_segmentation_tpu_torch.postprocess import surface_fitting
    fits = {}

    def fit(points, shape, **kw):
        """The port's fit on the CPU, each cloud fitted once for both
        entries (the same arguments give the same mesh)."""
        key = (np.asarray(points).tobytes(), tuple(shape),
               kw.get("right"))
        if key not in fits:
            fits[key] = surface_fitting.pointcloud_surface_fitting(
                points, shape, **{**kw, "device": "cpu"})
        return fits[key]
    monkeypatch.setattr(jeb, "pointcloud_surface_fitting", fit)
    monkeypatch.setattr(eb, "pointcloud_surface_fitting", fit)
    args = dict(result_dir=str(baseline_dirs / "preds"),
                data_dir=str(baseline_dirs / "data"), split=None, mode=mode,
                pts_subsample=256, n_fissures=2)
    with jax.default_matmul_precision("float32"):
        jeb.main(Namespace(output=str(baseline_dirs / f"jax_{mode}"),
                           **args))
    argv = [f"--{k}={v}" for k, v in args.items() if v is not None]
    eb.main(argv + [f"--output={baseline_dirs / f'port_{mode}'}"],
            device="cpu", draws={("case0", "fixed"): _jax_draws(0)})
    for name in (os.path.join("fold0", f"test_results_{mode}.csv"),
                 f"cv_results_{mode}.csv"):
        got = _rows(baseline_dirs / f"port_{mode}" / name)
        want = _rows(baseline_dirs / f"jax_{mode}" / name)
        assert [len(r) for r in got] == [len(r) for r in want], name
        for g, w in zip(got, want):
            try:
                gv, wv = np.asarray(g[1:], float), np.asarray(w[1:], float)
            except ValueError:          # a header row
                assert g == w, name
                continue
            assert g[0] == w[0], name
            if g[0].endswith("Dice") or g[0] == "proportion missing":
                np.testing.assert_array_equal(gv, wv, err_msg=g[0])
            else:
                assert np.isfinite(gv[1:]).all(), g
                np.testing.assert_allclose(gv, wv, rtol=1e-3, err_msg=g[0])


def test_case_helpers_match_jax():
    for name in ("COPD05f_pred.nii.gz", "case3_img_fix.nii.gz",
                 "/a/b/case1_x_fixed.nii.gz", "case2_mov.nii.gz"):
        assert eb.parse_case_sequence(name) == jeb.parse_case_sequence(name)
    split = [{"val": ["caseA_fixed", ["caseB", "moving"]]},
             {"val": [["caseC", "fixed"]]}]
    for case, seq in (("caseA", "fixed"), ("caseB", "moving"),
                      ("caseC", "fixed")):
        assert eb.find_test_fold_for_id(case, seq, split) == \
            jeb.find_test_fold_for_id(case, seq, split)
    with pytest.raises(ValueError):
        eb.find_test_fold_for_id("caseZ", "fixed", split)


def test_compute_fraction_of_fissures_matches_jax(tmp_path):
    for mod, name in ((jfraction, "jax.csv"), (compute_fraction_of_fissures,
                                               "port.csv")):
        mod.main(["--n_synthetic", "2", "--output", str(tmp_path / name)])
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


def test_qualitative_plot_functions_match_jax():
    rng = np.random.default_rng(0)
    img = rng.normal(-800, 150, (6, 7, 8)).astype(np.float32)
    mask = np.zeros(img.shape, np.uint8)
    mask[1:5, 2:6, 1:7] = 1
    for dim in range(3):
        np.testing.assert_array_equal(qp.slice_3d(img, 3, dim),
                                      jqp.slice_3d(img, 3, dim))
    win = qp.fissure_window_level(img, mask)
    np.testing.assert_array_equal(win, jqp.fissure_window_level(img, mask))
    assert qp.crop_to_lung_indices(win) == jqp.crop_to_lung_indices(win)
    xs, ys = rng.uniform(0, 10, 12), rng.uniform(0, 5, 12)
    for flags in ((True, True), (False, False)):
        assert qp.pareto_frontier(xs, ys, *flags) == \
            jqp.pareto_frontier(xs, ys, *flags)
    for wr in (False, True):
        np.testing.assert_array_equal(
            qp.cosine_lr_trace(50, 1e-3, warm_restarts=wr),
            jqp.cosine_lr_trace(50, 1e-3, warm_restarts=wr))
    assert qp.REFERENCE_PARETO == jqp.REFERENCE_PARETO
    # the overlay and legend the figures use are the JAX package's code
    import inspect
    from fissure_segmentation_tpu.utils import visualization as jvis
    from fissure_segmentation_tpu_torch.utils import visualization as vis
    for name in ("visualize_with_overlay", "legend_figure"):
        assert inspect.getsource(getattr(vis, name)) == \
            inspect.getsource(getattr(jvis, name))


def test_qualitative_plots_entry(tmp_path):
    """The JAX entry's figures (tests/test_entry_scripts.py's list), at one
    slice."""
    out = str(tmp_path / "plots")
    qp.main(["--output", out, "--slices", "32"])
    for name in ("fissure_overlay.png", "keypoints.png",
                 "keypoint_qualitative_comparison_synthetic_slice32.png",
                 "keypoint_qualitative_comparison_legend.png",
                 "classes_legend.png", "cosine_annealing.png",
                 "cosine_annealing_warm_restarts.png",
                 "cosine_annealing_both.png", "performance_time.png"):
        assert os.path.exists(os.path.join(out, name)), name
    assert any(f.startswith("DGCNN_synthetic_slice")
               for f in os.listdir(out))
