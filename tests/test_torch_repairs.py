"""The port's own copies of the JAX package's jax-free modules (cli,
utils/coords.py, utils/{nifti,objio,mesh_viewer,visualization}.py, the
native C++ host runtime) against the originals, and the
rule that the port's entry points run on a CUDA card unless the caller asks
for the CPU.

Tolerances: none. The copies must give equal namespaces, equal arrays and
equal grids.
"""
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu import cli as jcli
from fissure_segmentation_tpu import native as jnative
from fissure_segmentation_tpu.utils import coords as jcoords
from fissure_segmentation_tpu.utils import mesh_viewer as jmesh_viewer
from fissure_segmentation_tpu.utils import nifti as jnifti
from fissure_segmentation_tpu.utils import objio as jobjio
from fissure_segmentation_tpu.utils import visualization as jvisualization
from fissure_segmentation_tpu_torch import cli, native, train_point_seg
from fissure_segmentation_tpu_torch.data import synthetic
from fissure_segmentation_tpu_torch.data.dataset import PointDataset
from fissure_segmentation_tpu_torch.losses import get_loss_fn
from fissure_segmentation_tpu_torch.models import DGCNNSeg
from fissure_segmentation_tpu_torch.serving import segment_case
from fissure_segmentation_tpu_torch.train.trainer import ModelTrainer
from fissure_segmentation_tpu_torch.utils import (coords, mesh_viewer, nifti,
                                                  objio, visualization)

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
          "mesh_viewer": (mesh_viewer, jmesh_viewer)}


@pytest.mark.parametrize("name", sorted(COPIES))
def test_host_utils_copy_is_the_original(name):
    """utils/{nifti,objio,mesh_viewer}.py are the JAX package's modules
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
