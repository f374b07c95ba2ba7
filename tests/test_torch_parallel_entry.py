"""The entries' parallel and visualization flags on the CPU:

  * `train_point_seg --dp` over 2 gloo ranks (`run(args, device="cpu",
    world_size=2)`) writes the fold files of the run without `--dp`
    (model.pt, history, the visualizations, then the test half, which runs
    once in the calling process), with the histories within JAX's
    data-parallel bound (rtol = atol = 3e-2, __graft_entry__.py);
  * every `--model` the entry takes trains under `--dp`;
  * `--visualize N` writes visualizations/epoch{E}.png on the epochs the
    JAX trainer calls its hook on;
  * `train_pc_ae` takes `--dp` and `--visualize` and, as the JAX entry,
    does nothing with them.
"""
import csv
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.data import dataset as jdataset
from fissure_segmentation_tpu.data import synthetic as jsynthetic
from fissure_segmentation_tpu.losses import get_loss_fn as jget_loss_fn
from fissure_segmentation_tpu.train.trainer import \
    ModelTrainer as JModelTrainer
from fissure_segmentation_tpu.train.trainer import TrainConfig as JConfig
from fissure_segmentation_tpu_torch import train_pc_ae, train_point_seg
from fissure_segmentation_tpu_torch.cli import get_point_segmentation_parser
from fissure_segmentation_tpu_torch.data import dataset, synthetic
from fissure_segmentation_tpu_torch.utils.visualization import \
    matplotlib_available

EPOCHS, EVERY = 4, 2
BASE = ["--static", "--amp", "false", "--fold", "0", "--pts", "48", "--k",
        "4", "--batch", "2"]


def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads (the --dp ranks share them): with a thread a
    core, the suite's workers and the ranks spin against each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    folder = tmp_path_factory.mktemp("cases")
    for c in synthetic.make_synthetic_dataset(10, n_points=300,
                                              gt_surfaces=True):
        dataset.save_case_npz(c, str(folder))
    return str(folder)


def _run(argv, world_size=None):
    args = get_point_segmentation_parser().parse_args(argv)
    return train_point_seg.run(args, device="cpu", world_size=world_size)


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    out = {}
    for name, extra, world in (("single", [], None), ("dp", ["--dp"], 2)):
        d = str(tmp_path_factory.mktemp(name))
        _run(BASE + extra + ["--epochs", str(EPOCHS), "--visualize",
                             str(EVERY), "--data_dir", cases, "--output", d],
             world)
        out[name] = d
    return out


def test_dp_entry_writes_the_fold_files_of_a_single_run(runs):
    """The same files (the fold's model, history, figures and test
    results, the CV results); the loss histories within 3e-2."""
    single, dp = runs["single"], runs["dp"]
    assert _files(dp) == _files(single)
    assert "fold0/model.pt" in _files(dp)
    assert "fold0/test/test_results.csv" in _files(dp)
    h1 = _read(os.path.join(single, "fold0", "history.csv"))
    hn = _read(os.path.join(dp, "fold0", "history.csv"))
    assert h1[0] == hn[0]
    np.testing.assert_allclose(np.asarray(hn[1:], float),
                               np.asarray(h1[1:], float), rtol=3e-2,
                               atol=3e-2)


def _jax_visualized_epochs(tmp_path):
    """The epochs JAX's ModelTrainer calls its visualization hook on (a
    one-layer model: the schedule does not depend on the model)."""
    class Tiny(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            return fnn.Dense(4)(x)

    ds = jdataset.PointDataset(
        jsynthetic.make_synthetic_dataset(10, n_points=64), sample_points=16)
    seen = []
    tr = JModelTrainer(Tiny(), ds, jget_loss_fn("ce"), str(tmp_path),
                       JConfig(epochs=EPOCHS, batch_size=2, show_every=100),
                       visualization_fn=lambda x, y, o, e, d: seen.append(e),
                       visualize_every=EVERY)
    tr.run()
    return seen


def test_visualize_writes_the_epochs_jax_visualizes(runs, tmp_path):
    """visualizations/epoch{E}.png on the epochs of JAX's hook (rank 0
    alone under --dp), where matplotlib imports."""
    epochs = _jax_visualized_epochs(tmp_path)
    assert epochs == [1, 3]
    want = ([f"fold0/visualizations/epoch{e}.png" for e in epochs]
            if matplotlib_available() else [])
    for d in runs.values():
        assert [f for f in _files(d) if "visualizations" in f] == want


@pytest.mark.parametrize("model,extra", [
    ("PointNet", ["--pts", "48"]),
    ("PointTransformer", ["--pts", "256"]),
])
def test_dp_entry_trains_every_model(cases, tmp_path, model, extra):
    """PointNet and PointTransformer (DGCNN above) train one epoch of fold
    0 over 2 ranks: model.pt of the right class and a finite loss."""
    from fissure_segmentation_tpu_torch.models import load_model
    out = str(tmp_path)
    _run(["--model", model, "--dp", "--train_only", "--amp", "false",
          "--fold", "0", "--batch", "2", "--epochs", "1", "--data_dir",
          cases, "--output", out] + extra, world_size=2)
    m = load_model(os.path.join(out, "fold0", "model.pt"))
    assert type(m).__name__ == {"PointNet": "PointNetSeg",
                                "PointTransformer": "PointTransformerSeg"}[
                                    model]
    hist = np.asarray(_read(os.path.join(out, "fold0", "history.csv"))[1:],
                      float)
    assert np.isfinite(hist).all()


def test_pc_ae_takes_dp_and_visualize(tmp_path):
    """`train_pc_ae --dp --visualize 1` runs as without them and writes the
    same files with the same numbers (the JAX entry parses both and reads
    neither)."""
    small = ["--ds", "synthetic", "--epochs", "1", "--batch", "4", "--pts",
             "64", "--k", "8", "--latent", "32", "--fold", "0", "--static",
             "--scheduler", "none"]
    outs = []
    for extra in ([], ["--dp", "--visualize", "1"]):
        out = str(tmp_path / ("flags" if extra else "plain"))
        assert train_pc_ae.main(small + extra + ["--output", out],
                                device="cpu") == 0
        outs.append(out)
    assert _files(outs[0]) == _files(outs[1])
    for name in ("fold0/history.csv",
                 "fold0/test/reconstruction_chamfer.csv"):
        assert _read(os.path.join(outs[0], name)) == \
            _read(os.path.join(outs[1], name)), name
