"""The port's own copies of the JAX package's jax-free modules (cli,
utils/coords.py, utils/{nifti,objio,mesh_viewer,visualization,
detached_run}.py, the native C++ host runtime) and of the pieces of its
JAX modules the CNN's data path needs (utils/image_ops.py,
keypoints/features.py:normalize_img) against the originals, and the
rule that the port's entry points run on a CUDA card unless the caller asks
for the CPU, and F15's repair: train_point_seg's test modes read a fold
the JAX package wrote.

Tolerances: none for the copies, which must give equal namespaces, equal
arrays and equal grids; F15's test holds the ASSD rows within 1e-3 (its
docstring says why).
"""
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu import cli as jcli
from fissure_segmentation_tpu import native as jnative
from fissure_segmentation_tpu.keypoints import features as jfeatures
from fissure_segmentation_tpu.utils import detached_run as jdetached_run
from fissure_segmentation_tpu.utils import image_ops as jimage_ops
from fissure_segmentation_tpu.utils import coords as jcoords
from fissure_segmentation_tpu.utils import mesh_viewer as jmesh_viewer
from fissure_segmentation_tpu.utils import nifti as jnifti
from fissure_segmentation_tpu.utils import objio as jobjio
from fissure_segmentation_tpu.utils import tables as jtables
from fissure_segmentation_tpu.utils import visualization as jvisualization
from fissure_segmentation_tpu_torch import cli, native, train_point_seg
from fissure_segmentation_tpu_torch.data import synthetic
from fissure_segmentation_tpu_torch.keypoints import features
from fissure_segmentation_tpu_torch.data.dataset import PointDataset
from fissure_segmentation_tpu_torch.losses import get_loss_fn
from fissure_segmentation_tpu_torch.models import DGCNNSeg
from fissure_segmentation_tpu_torch.serving import segment_case
from fissure_segmentation_tpu_torch.train.trainer import ModelTrainer
from fissure_segmentation_tpu_torch.utils import (coords, detached_run,
                                                  image_ops, mesh_viewer,
                                                  nifti, objio, tables,
                                                  visualization)

PARSERS = ["get_dgcnn_train_parser", "get_point_segmentation_parser",
           "get_dpsr_train_parser", "get_seg_cnn_train_parser",
           "get_dgcnn_ssm_train_parser", "get_pc_ae_train_parser",
           "get_ae_reg_parser", "get_generic_parser"]
ARGV = [[], ["--epochs", "7", "--lr", "0.01", "--batch", "3", "--output",
             "somewhere", "--amp", "false", "--static", "--fold", "2",
             "--gpu", "1", "--ds", "synthetic"]]
EXTRA = {"get_ae_reg_parser": ["--seg_dir", "s", "--ae_dir", "a"],
         "get_point_segmentation_parser": ["--model", "PointTransformer"]}


@pytest.mark.parametrize("name", PARSERS)
def test_cli_copy_parses_like_the_original(name):
    args = ("point segmentation",) if name == "get_generic_parser" else ()
    for argv in ARGV:
        argv = argv + EXTRA.get(name, [])
        ours = getattr(cli, name)(*args).parse_known_args(argv)
        theirs = getattr(jcli, name)(*args).parse_known_args(argv)
        assert ours == theirs, (name, argv)


def test_cli_store_and_load_args_copy(tmp_path):
    args = cli.get_point_segmentation_parser().parse_args(ARGV[1])
    cli.store_args(args, str(tmp_path))
    assert cli.load_args(str(tmp_path)) == jcli.load_args(str(tmp_path))
    override = cli.get_point_segmentation_parser().parse_args(
        ["--test_only", "--fold", "4"])
    assert cli.load_args_for_testing(str(tmp_path), override) == \
        jcli.load_args_for_testing(str(tmp_path), override)


def test_coords_copy_equals_original():
    rng = np.random.default_rng(0)
    shape = (40, 31, 57)
    world = rng.uniform(-2, 60, (100, 3)).astype(np.float32)
    for align in (None, True, False):
        g = coords.kpts_to_grid(world, shape, align)
        np.testing.assert_array_equal(g, jcoords.kpts_to_grid(world, shape,
                                                              align))
        np.testing.assert_array_equal(
            coords.kpts_to_world(g, shape, align),
            jcoords.kpts_to_world(g, shape, align))
        # a tensor gives the same float32 numbers
        np.testing.assert_array_equal(
            coords.kpts_to_grid(torch.from_numpy(world), shape, align).numpy(),
            g)
    np.testing.assert_array_equal(coords.np_grid_coords(world, shape),
                                  jcoords.np_grid_coords(world, shape))


def test_synthetic_mesh_copy_equals_original():
    """data/synthetic.py's mesh generators (make_synthetic_meshes,
    make_synthetic_mesh_dataset): the same cases, triangle soups and world
    sizes as the JAX package's."""
    from fissure_segmentation_tpu.data import synthetic as jsynthetic
    got = synthetic.make_synthetic_mesh_dataset(n_cases=3, grid_n=12,
                                                n_points=150, seed=2,
                                                with_feature=False)
    want = jsynthetic.make_synthetic_mesh_dataset(n_cases=3, grid_n=12,
                                                  n_points=150, seed=2,
                                                  with_feature=False)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g["coords"], w["coords"])
    for gs, ws in zip(got[1], want[1]):
        assert len(gs) == len(ws) == 3
        for g, w in zip(gs, ws):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)
    case = synthetic.make_synthetic_dataset(1, n_points=100)[0]
    for g, w in zip(synthetic.make_synthetic_meshes(case, 9),
                    jsynthetic.make_synthetic_meshes(case, 9)):
        np.testing.assert_array_equal(g, w)


def test_native_copy_equals_original():
    """cc_label_3d, cc_stats, voxelize_triangles and binary_dilate_3d of
    the port's build against the JAX package's native runtime."""
    assert jnative.available()
    rng = np.random.default_rng(1)
    grid = rng.random((20, 18, 22)) < 0.3
    labels, n = native.cc_label_3d(grid)
    want_labels, want_n = jnative.cc_label_3d(grid)
    assert n == want_n > 1
    np.testing.assert_array_equal(labels, want_labels)
    for got, want in zip(native.cc_stats(labels, n),
                         jnative.cc_stats(want_labels, want_n)):
        np.testing.assert_array_equal(got, want)
    tris = rng.uniform(0, 20, (50, 3, 3)).astype(np.float32)
    valid = rng.random(50) < 0.8
    np.testing.assert_array_equal(
        native.voxelize_triangles(tris, valid, (22, 21, 23), 3),
        jnative.voxelize_triangles(tris, valid, (22, 21, 23), 3))
    for iters in (0, 1, 3):
        np.testing.assert_array_equal(native.binary_dilate_3d(grid, iters),
                                      jnative.binary_dilate_3d(grid, iters))


COPIES = {"nifti": (nifti, jnifti), "objio": (objio, jobjio),
          "mesh_viewer": (mesh_viewer, jmesh_viewer),
          "detached_run": (detached_run, jdetached_run),
          "tables": (tables, jtables)}


@pytest.mark.parametrize("name", sorted(COPIES))
def test_host_utils_copy_is_the_original(name):
    """utils/{nifti,objio,mesh_viewer,detached_run,tables}.py are the JAX package's modules
    but for the lines of the docstring that say they are copies."""
    import inspect
    mine = inspect.getsource(COPIES[name][0]).splitlines()
    theirs = inspect.getsource(COPIES[name][1]).splitlines()
    extra = [ln for ln in mine if ln not in theirs]
    assert len(extra) <= 4, extra
    assert [ln for ln in theirs if ln not in mine] in (
        [], ["    from fissure_segmentation_tpu.utils.mesh_viewer import "
             "export_mesh_viewer"])


def test_host_utils_copies_write_what_the_originals_write(tmp_path):
    """save_nifti, save_obj, export_mesh_viewer and plot_point_cloud of the
    port and of the JAX package write the same bytes (the PNGs: both
    exist and decode to the same image size)."""
    rng = np.random.default_rng(3)
    vol = rng.integers(0, 4, (6, 7, 8)).astype(np.uint8)
    tris = rng.uniform(0, 10, (20, 3, 3)).astype(np.float32)
    valid = rng.random(20) < 0.7
    pts = rng.uniform(0, 10, (50, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 50)
    for mods, d in (((nifti, objio, mesh_viewer, visualization),
                     tmp_path / "port"),
                    ((jnifti, jobjio, jmesh_viewer, jvisualization),
                     tmp_path / "jax")):
        d.mkdir()
        nii, obj, viewer, vis = mods
        nii.save_nifti(str(d / "a.nii.gz"), vol, spacing=(1.5, 1, 2))
        obj.save_obj(str(d / "a.obj"), tris.reshape(-1, 3),
                     np.arange(60).reshape(-1, 3))
        viewer.export_mesh_viewer(
            [(tris, valid), (tris[:0], valid[:0])], str(d / "a.html"),
            points=pts, point_labels=labels, title="t")
        vis.plot_point_cloud(pts, labels, path=str(d / "a.png"), title="t")
    for f in ("a.obj", "a.html"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    back = nifti.load_nifti(str(tmp_path / "port" / "a.nii.gz"))
    want = jnifti.load_nifti(str(tmp_path / "jax" / "a.nii.gz"))
    np.testing.assert_array_equal(back.array, want.array)
    assert back.spacing == want.spacing
    import matplotlib.image as mpimg
    assert mpimg.imread(tmp_path / "port" / "a.png").shape == \
        mpimg.imread(tmp_path / "jax" / "a.png").shape
    assert visualization.matplotlib_available()


def test_image_ops_and_normalize_copies_equal_originals():
    """apply_mask, get_resample_factors and normalize_img of the port and
    of the JAX package (resampling and morphology:
    tests/test_torch_image_dataset.py)."""
    rng = np.random.default_rng(5)
    img = rng.normal(-500, 400, (5, 6, 7)).astype(np.float32)
    mask = rng.random(img.shape) < 0.5
    for dtype in (np.float32, np.int32):
        got = image_ops.apply_mask(torch.from_numpy(img.astype(dtype)),
                                   torch.from_numpy(mask))
        want = np.asarray(jimage_ops.apply_mask(img.astype(dtype), mask))
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    assert image_ops.get_resample_factors((0.7, 0.8, 1.25), 1.5) == \
        jimage_ops.get_resample_factors((0.7, 0.8, 1.25), 1.5)
    assert (features.IMG_MIN, features.IMG_MAX) == \
        (jfeatures.IMG_MIN, jfeatures.IMG_MAX)
    np.testing.assert_allclose(
        features.normalize_img(torch.from_numpy(img)).numpy(),
        np.asarray(jfeatures.normalize_img(img)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(features.normalize_img(img),
                                  jfeatures.normalize_img(img))


def test_native_build_is_cached_by_content():
    path = native.build()
    assert path == native.build() and "_build" in path
    assert native.load() is native.load()


# ---- entry points need a card unless the caller asks for the CPU -------------

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_segment_case_raises_without_card(no_card):
    vol = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        segment_case(vol, np.ones(vol.shape, bool), lambda x: x)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        segment_case(torch.from_numpy(vol), np.ones(vol.shape, bool),
                     lambda x: x)


def test_train_point_seg_raises_without_card(no_card, tmp_path):
    out = tmp_path / "run"
    argv = ["--model", "PointTransformer", "--train_only", "--output",
            str(out)]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_point_seg.main(argv)
    assert not out.exists()            # raised before writing anything


def _downstream_entries(tmp_path):
    from fissure_segmentation_tpu_torch import (evaluate_baselines,
                                                register_images,
                                                shape_sanity_checks)
    from fissure_segmentation_tpu_torch.shape_model import \
        generate_corresponding_points
    pts = np.random.default_rng(0).normal(size=(2, 20, 3))
    return {
        "register_images": lambda: register_images.main(
            ["-F", "f", "-M", "m", "-f", "fm", "-m", "mm", "-d",
             str(tmp_path / "out" / "d.npz")]),
        "evaluate_baselines": lambda: evaluate_baselines.main(
            ["--result_dir", str(tmp_path), "--data_dir", str(tmp_path),
             "--output", str(tmp_path / "out")]),
        "shape_sanity_checks": lambda: shape_sanity_checks.main(
            ["--probe", "weights"]),
        "generate_corresponding_points":
            lambda: generate_corresponding_points([list(pts), list(pts)])}


@pytest.mark.parametrize("name", ["register_images", "evaluate_baselines",
                                  "shape_sanity_checks",
                                  "generate_corresponding_points"])
def test_downstream_entries_raise_without_card(no_card, tmp_path, name):
    """The entries downstream of preprocessing (and the correspondences)
    run on the card by default and, without one, raise before reading or
    writing anything."""
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _downstream_entries(tmp_path)[name]()
    assert not (tmp_path / "out").exists()


def test_model_trainer_raises_without_card(no_card, tmp_path):
    ds = PointDataset(synthetic.make_synthetic_dataset(3, n_points=100),
                      sample_points=32)
    model = DGCNNSeg(k=4, in_features=ds.n_features,
                     num_classes=ds.num_classes)
    loss_fn = get_loss_fn("nnunet", torch.ones(ds.num_classes))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ModelTrainer(model, ds, loss_fn, str(tmp_path))
    assert ModelTrainer(model, ds, loss_fn, str(tmp_path),
                        device="cpu").device == torch.device("cpu")


def _cnn_helper_args():
    import argparse
    from fissure_segmentation_tpu_torch import train_seg_cnn
    from fissure_segmentation_tpu_torch.data.image_dataset import ImageDataset
    c = synthetic.make_synthetic_image_case(0, shape=(24, 24, 24))
    ds = ImageDataset([c["image"]], [c["labels"]],
                      [(c["case_id"], c["sequence"])],
                      resample_spacing=1.0, patch_size=(16, 16, 16))
    model = train_seg_cnn.build_model(
        argparse.Namespace(model="v1", patch_size=16), ds.num_classes)
    return train_seg_cnn.test_cnn, (ds, model), "test_dice.csv"


def _pcae_helper_args():
    from fissure_segmentation_tpu_torch import train_pc_ae
    from fissure_segmentation_tpu_torch.data.mesh_dataset import \
        SampleFromMeshDS
    from fissure_segmentation_tpu_torch.models import DGCNNFoldingNet
    cases, meshes, sizes = synthetic.make_synthetic_mesh_dataset(
        n_cases=2, grid_n=8, n_points=100, with_feature=False)
    ds = SampleFromMeshDS(meshes, [(c["case_id"], c["sequence"])
                                   for c in cases], sizes, 64)
    model = DGCNNFoldingNet(k=4, n_embedding=16, shape_type="plane",
                            n_input_points=64, decode_mesh=False,
                            generator=torch.Generator().manual_seed(0))
    return (lambda *a, **kw: train_pc_ae.evaluate_reconstruction(
        *a, n_eval_samples=256, **kw)), (ds, model), \
        "reconstruction_chamfer.csv"


def _dseg_helper_args():
    from fissure_segmentation_tpu_torch import dseg_ae_regularization
    from fissure_segmentation_tpu_torch.models import DGCNNFoldingNet
    from fissure_segmentation_tpu_torch.models.dseg_ae import \
        RegularizedSegDGCNN
    ds = PointDataset(synthetic.make_synthetic_dataset(
        1, n_points=300, gt_surfaces=True), sample_points=128)
    g = torch.Generator().manual_seed(0)
    seg = DGCNNSeg(k=4, in_features=ds.n_features,
                   num_classes=ds.num_classes, generator=g).eval()
    ae = DGCNNFoldingNet(k=4, n_embedding=16, shape_type="plane",
                         n_input_points=64, generator=g).eval()
    model = RegularizedSegDGCNN(seg, ae, n_points_seg=128, n_points_ae=64)
    return dseg_ae_regularization.evaluate_fold, (ds, model), \
        "ae_reg_results.csv"


def _fit_helper_args():
    """pointcloud_surface_fitting on a fissure cloud of a synthetic case:
    its valid triangle count."""
    from fissure_segmentation_tpu_torch.postprocess.surface_fitting import \
        pointcloud_surface_fitting
    case = synthetic.make_synthetic_dataset(1, n_points=600)[0]
    pts = coords.kpts_to_world(case["coords"][case["labels"] == 2],
                               case["shape"])

    def fit(pts, out_dir, **kw):
        _, valid = pointcloud_surface_fitting(
            pts, case["shape"], grid_res=(16, 16, 16), right=True, **kw)
        return {"n_valid": float(valid.sum())}
    return fit, (pts,), None


def _evaluate_case_helper_args():
    """evaluate_case on a synthetic case's GT labels: its ASSD."""
    from fissure_segmentation_tpu_torch.train.evaluation import evaluate_case
    case = synthetic.make_synthetic_dataset(1, n_points=600,
                                            gt_surfaces=True)[0]

    def run(case, out_dir, **kw):
        out = evaluate_case(case["labels"], case["coords"], case, 4,
                            grid_res=(16, 16, 16), n_metric_samples=200,
                            **kw)
        return {"assd": float(np.nanmean(out["assd"]))}
    return run, (case,), None


@pytest.mark.parametrize("helper", ["test_cnn", "evaluate_reconstruction",
                                    "evaluate_fold",
                                    "pointcloud_surface_fitting",
                                    "evaluate_case"])
def test_test_helpers_need_a_card_or_the_cpu(helper, tmp_path, monkeypatch):
    """train_seg_cnn.test_cnn, train_pc_ae.evaluate_reconstruction,
    dseg_ae_regularization.evaluate_fold, and (F12)
    postprocess/surface_fitting.pointcloud_surface_fitting and
    train/evaluation.evaluate_case run on the card by default and raise
    without one, writing nothing; given device="cpu" they run there as
    before (the entries and test_pipeline pass their device) and return a
    finite number, the one their CSV holds where they write one."""
    fn, args, csv_name = {"test_cnn": _cnn_helper_args,
                          "evaluate_reconstruction": _pcae_helper_args,
                          "evaluate_fold": _dseg_helper_args,
                          "pointcloud_surface_fitting": _fit_helper_args,
                          "evaluate_case": _evaluate_case_helper_args}[
        helper]()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn(*args, str(tmp_path / "card"))
    assert not (tmp_path / "card").exists()
    out = fn(*args, str(tmp_path / "cpu"), device="cpu")
    value = next(iter(out.values()))
    assert np.isfinite(value)
    if csv_name is None:
        assert value > 0
        return
    with open(tmp_path / "cpu" / csv_name) as f:
        rows = [r.strip().split(",") for r in f]
    row = np.asarray(rows[1], float)
    assert value == pytest.approx(row[1:].mean() if helper == "test_cnn"
                                  else row[0])


def test_preprocessing_constants_equal_originals():
    """The HU clamp, the v1 exclusion list and the feature normalization
    of the port's preprocessing are the JAX package's."""
    from fissure_segmentation_tpu.preprocess import pipeline as jpipeline
    from fissure_segmentation_tpu_torch.preprocess import pipeline
    assert (pipeline.IMG_MIN, pipeline.IMG_MAX) == (jpipeline.IMG_MIN,
                                                    jpipeline.IMG_MAX)
    assert pipeline.EXCLUDE_LIST_V1 == jpipeline.EXCLUDE_LIST_V1
    assert (features.IMG_MIN, features.IMG_MAX) == (jfeatures.IMG_MIN,
                                                    jfeatures.IMG_MAX)
    np.testing.assert_array_equal(features._SIX_NH, jfeatures._SIX_NH)
    np.testing.assert_array_equal(features._SSC_PERM, jfeatures._SSC_PERM)


def test_shape_model_copies_equal_originals():
    """shape_model/{ssm,lssm}.py's numpy fits are copies of the JAX
    package's: the same arrays (float32) from the same data."""
    from fissure_segmentation_tpu.shape_model import lssm as jlssm
    from fissure_segmentation_tpu.shape_model import ssm as jssm
    from fissure_segmentation_tpu_torch.shape_model import fit_lssm, fit_ssm
    rng = np.random.default_rng(4)
    shapes = rng.normal(size=(9, 40, 3))
    for ours, theirs in ((fit_ssm(shapes, 2.5, 0.9),
                          jssm.fit_ssm(shapes, 2.5, 0.9)),
                         (fit_lssm(shapes, num_levels=3, target_variance=0.9),
                          jlssm.fit_lssm(shapes, num_levels=3,
                                         target_variance=0.9))):
        for a, b in zip(ours[:3], theirs[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert ours[3:] == tuple(theirs[3:])


def test_entry_synthetic_data_copies_equal_originals():
    """The two entries' synthetic datasets (train_dpsr_net.build_dataset,
    train_dgcnn_ssm's corresponding points) are the JAX entries'."""
    import argparse
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import train_dgcnn_ssm as jentry_ssm
    from fissure_segmentation_tpu_torch import train_dgcnn_ssm
    cases = synthetic.make_synthetic_dataset(3, n_points=200,
                                             with_feature=False)
    for exclude in (False, True):
        corr, labels = train_dgcnn_ssm.synthetic_correspondences(cases,
                                                                 exclude)
        assert corr.shape == (3, 256 * (2 if exclude else 3), 3)
        np.testing.assert_array_equal(np.unique(labels),
                                      [1, 2] if exclude else [1, 2, 3])
    args = argparse.Namespace(ds="synthetic", data_dir=None, pts=64,
                              exclude_rhf=False)
    monkey_cases = synthetic.make_synthetic_dataset(12, n_points=3000,
                                                    with_feature=False)
    ours = train_dgcnn_ssm.build_dataset(args)
    theirs = jentry_ssm.build_dataset(args)
    np.testing.assert_array_equal(ours.corr_points, theirs.corr_points)
    np.testing.assert_array_equal(ours.corr_labels, theirs.corr_labels)
    for a, b in zip(ours.cases, monkey_cases):
        np.testing.assert_array_equal(a["coords"], b["coords"])


# ---- F15: the test modes read a fold the JAX package wrote -------------------

@pytest.mark.parametrize("model", ["DGCNN", "PointNet"])
def test_test_only_scores_a_jax_fst_fold(tmp_path, monkeypatch, model):
    """F15: a fold that holds only the JAX package's model.fst (written by
    its save_model, BatchNorm statistics randomized with numpy) and a split
    file is scored by the port's `--test_only` as by the JAX entry's, with
    the JAX entry's draws injected (tests/test_torch_entry.py): the per-case
    Dice rows equal and the ASSD rows within MESH_RTOL (1e-3, that file's
    tolerance: the surface fits differ by rounding). `--speed` reads the
    same fold."""
    import csv
    import os
    import sys

    import jax
    import jax.numpy as jnp
    from fissure_segmentation_tpu.data.dataset import (create_split,
                                                       save_split_file)
    from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
    from fissure_segmentation_tpu.models import PointNetSeg as JPointNetSeg
    from fissure_segmentation_tpu.models import save_model as jsave_model
    from fissure_segmentation_tpu_torch.train import evaluation
    from test_torch_entry import MESH_RTOL, _cases_dir, _jax_draws
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import train_point_seg as jentry

    cases = _cases_dir(tmp_path, n_copd=0)
    out = str(tmp_path / "run")
    argv = ["--model", model, "--data_dir", cases, "--fold", "0",
            "--epochs", "1", "--pts", "64", "--k", "8", "--amp", "false",
            "--output", out]
    jcli.store_args(jentry.get_point_segmentation_parser().parse_args(argv),
                    out)
    jm = (JDGCNNSeg(k=8, in_features=4, num_classes=4) if model == "DGCNN"
          else JPointNetSeg(in_features=4, num_classes=4))
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 4)))
    rng = np.random.default_rng(0)

    def bn(path, a):
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return rng.normal(0, 0.3, a.shape).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return np.asarray(a)
    variables = jax.tree_util.tree_map_with_path(bn, variables)
    fold = os.path.join(out, "fold0")
    jsave_model(jm, variables, os.path.join(fold, "model.fst"))
    ids = sorted(f.split("_points")[0] for f in os.listdir(cases))
    save_split_file(create_split(ids, k=5), os.path.join(out,
                                                         "cross_val_split.json"))
    test_only = ["--output", out, "--test_only", "--fold", "0"]
    with jax.default_matmul_precision("float32"):
        jentry.run(jentry.get_point_segmentation_parser().parse_args(
            test_only))

    def rows(name):
        with open(os.path.join(fold, "test", f"{name}_per_instance.csv")) as f:
            return list(csv.reader(f))
    want = {name: rows(name) for name in ("dice", "assd")}
    real = evaluation.test_pipeline

    def with_jax_draws(ds, *args, **kwargs):
        return real(ds, *args, draws=_jax_draws(ds, kwargs["sample_points"]),
                    **kwargs)
    monkeypatch.setattr(evaluation, "test_pipeline", with_jax_draws)
    assert sorted(os.listdir(fold)) == ["model.fst", "test"]
    assert train_point_seg.main(test_only, device="cpu") == 0
    got = {name: rows(name) for name in ("dice", "assd")}
    assert got["dice"] == want["dice"] and len(want["dice"]) >= 2
    assert [r[0] for r in got["assd"]] == [r[0] for r in want["assd"]]
    for g, w in zip(got["assd"][1:], want["assd"][1:]):
        np.testing.assert_allclose(np.asarray(g[1:], float),
                                   np.asarray(w[1:], float), rtol=MESH_RTOL,
                                   err_msg=g[0])
    assert train_point_seg.main(["--output", out, "--speed"],
                                device="cpu") == 0
    assert os.path.exists(os.path.join(out, "inference_time.csv"))
