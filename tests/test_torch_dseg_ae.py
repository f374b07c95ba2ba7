"""Port parity for DSEG-AE (models/dseg_ae.py, dseg_ae_regularization.py):
`random_extend_points`, the segmentation ensemble, `reconstruct` in the
"farthest" and "accumulate" modes, and the entry, against the JAX package
on the CPU with JAX's draws injected (matmuls at float32 precision).

Tolerances: masks, labels and FPS selections equal; padded points within
TOL (the nearest-neighbour mean and std sum in other orders); decoded
vertices within AE_TOL (tests/test_torch_pc_ae.py's); the entry's Chamfer
means within ENTRY_RTOL relative.
"""
import csv
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu.models import io as jio
from fissure_segmentation_tpu.models.dseg_ae import \
    RegularizedSegDGCNN as JRegularized
from fissure_segmentation_tpu.models.dseg_ae import \
    random_extend_points as jrandom_extend
from fissure_segmentation_tpu.models.ensemble import \
    build_subsets as jbuild_subsets
from fissure_segmentation_tpu.models.folding_net import \
    DGCNNFoldingNet as JFoldingNet
from fissure_segmentation_tpu_torch import dseg_ae_regularization
from fissure_segmentation_tpu_torch.data import synthetic
from fissure_segmentation_tpu_torch.models import (DGCNNFoldingNet, DGCNNSeg,
                                                   load_jax_variables)
from fissure_segmentation_tpu_torch.models.dseg_ae import (
    RegularizedSegDGCNN, random_extend_points)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
AE_TOL = dict(rtol=2e-4, atol=2e-4)
ENTRY_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _extend_draws(key, b, n):
    r_src, r_dir, r_mag = jax.random.split(key, 3)
    return (_t(jax.random.uniform(r_src, (b, n))),
            _t(jax.random.normal(r_dir, (b, n, 3))),
            _t(jax.random.normal(r_mag, (b, n, 1))))


def _dyadic(rng, shape):
    return (rng.integers(-64, 65, shape) / 32.0).astype(np.float32)


@pytest.mark.parametrize("case", ["few_valid", "scattered", "duplicates",
                                  "one_valid", "all_valid"])
def test_random_extend_points_matches_jax(case):
    """K1's padding graph (kk = 2 on a cloud whose invalid points sit at
    1e6, ties to the lower index), the neighbour-distance mean and std and
    the jittered copies, from JAX's draws: the mask equal, the points
    within TOL."""
    rng = np.random.default_rng(3)
    b, n = 2, 200
    pts = _dyadic(rng, (b, n, 3))
    valid = {"few_valid": np.arange(n)[None] < np.asarray([[30], [7]]),
             "scattered": rng.random((b, n)) < 0.3,
             "duplicates": rng.random((b, n)) < 0.5,
             "one_valid": np.arange(n)[None] == np.asarray([[5], [150]]),
             "all_valid": np.ones((b, n), bool)}[case]
    if case == "duplicates":
        pts[:, 1::2] = pts[:, ::2]        # every valid point has a twin
    key = jax.random.PRNGKey(4)
    want_p, want_v = jrandom_extend(key, jnp.asarray(pts),
                                    jnp.asarray(valid), 120)
    got_p, got_v = random_extend_points(_t(pts), _t(valid), 120,
                                        draws=_extend_draws(key, b, n))
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_allclose(got_p.numpy(), want_p, **TOL)
    g = torch.Generator().manual_seed(0)
    p1, _ = random_extend_points(_t(pts), _t(valid), 120, g)
    assert torch.isfinite(p1).all()


def _models(seed=0, n_seg=128, n_ae=64, k=8, num_classes=4, **ae_kw):
    seg = JDGCNNSeg(k=k, in_features=4, num_classes=num_classes,
                    dynamic=False)
    seg_vars = jax.tree_util.tree_map(np.asarray, seg.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, n_seg, 4))))
    # seeded weights put nearly every point in one class: centre the
    # logits of a case's points so that the classes share them
    pc, _ = _case_cloud()
    dense = seg_vars["params"]["SharedMLP_4"]["Dense_0"]
    with jax.default_matmul_precision("float32"):
        logits = np.asarray(seg.apply(seg_vars, pc[None, :n_seg],
                                      train=False))[0]
    dense["bias"] = (dense["bias"] - logits.mean(0)).astype(np.float32)
    ae = JFoldingNet(k=k, n_embedding=32, shape_type="plane",
                     n_input_points=n_ae, **ae_kw)
    ae_vars = jax.tree_util.tree_map(np.asarray, ae.init(
        jax.random.PRNGKey(seed + 1), jnp.zeros((1, n_ae, 3))))
    tseg = load_jax_variables(DGCNNSeg(k=k, in_features=4,
                                       num_classes=num_classes,
                                       dynamic=False), seg_vars).eval()
    tae = load_jax_variables(DGCNNFoldingNet(
        k=k, n_embedding=32, shape_type="plane", n_input_points=n_ae,
        **ae_kw), ae_vars).eval()
    return (seg, seg_vars, ae, ae_vars), (tseg, tae)


def _case_cloud(n=600, seed=0):
    case = synthetic.make_synthetic_dataset(1, n_points=n, seed=seed)[0]
    return np.concatenate([case["coords"], case["features"]], 1), case


def _class_draws(jmodel, seg, key, n, accumulate_n=10):
    """JAX's per-class draws of reconstruct(pc, seg, key): a class with
    fewer than k points splits no key."""
    draws, rng = [], key
    for obj in range(1, jmodel.seg_model.num_classes):
        if int((np.asarray(seg) == obj).sum()) < jmodel.ae.k:
            draws.append({})
            continue
        rng, r_ext, r_acc = jax.random.split(rng, 3)
        draws.append({"extend": _extend_draws(r_ext, 1, n),
                      "accumulate": [_t(jax.random.uniform(r, (1, n)))
                                     for r in jax.random.split(r_acc,
                                                               accumulate_n)]})
    return draws


@pytest.mark.parametrize("mode,extend", [("farthest", False),
                                         ("farthest", True),
                                         ("accumulate", True)])
def test_reconstruct_matches_jax(mode, extend):
    """segment with JAX's subsets gives JAX's labels; reconstruct with
    JAX's per-class draws gives JAX's decoded meshes (the same masked FPS
    selections, K5) within AE_TOL."""
    (seg, seg_vars, ae, ae_vars), (tseg, tae) = _models()
    pc, _ = _case_cloud()
    jm = JRegularized(seg, seg_vars, ae, ae_vars, n_points_seg=128,
                      n_points_ae=64, sample_mode=mode, random_extend=extend)
    tm = RegularizedSegDGCNN(tseg, tae, n_points_seg=128, n_points_ae=64,
                             sample_mode=mode, random_extend=extend)
    key = jax.random.PRNGKey(2)
    with jax.default_matmul_precision("float32"):
        labels_j = np.asarray(jm.segment(jnp.asarray(pc), key))
        out_j = jm.reconstruct(jnp.asarray(pc), jnp.asarray(labels_j), key)
    subsets = _t(jbuild_subsets(key, pc.shape[0], 128, 50))
    labels = tm.segment(_t(pc), subsets=subsets)
    np.testing.assert_array_equal(labels.numpy(), labels_j)
    counts = np.bincount(labels_j, minlength=4)[1:]
    assert (counts >= 8).sum() >= 2, counts       # classes reconstructed
    if extend:
        assert (counts < 64).any(), counts        # and some padded
    out = tm.reconstruct(_t(pc), labels, draws=_class_draws(
        jm, labels_j, key, pc.shape[0]))
    assert len(out) == len(out_j) == 3
    for o, w in zip(out, out_j):
        assert (o is None) == (w is None)
        if w is None:
            continue
        np.testing.assert_array_equal(o[1].numpy(), np.asarray(w[1]))
        np.testing.assert_allclose(o[0].numpy(), np.asarray(w[0]), **AE_TOL)


def test_reconstruct_skips_small_classes_and_draws_itself():
    (_, _, _, _), (tseg, tae) = _models()
    pc, _ = _case_cloud()
    tm = RegularizedSegDGCNN(tseg, tae, n_points_seg=128, n_points_ae=64)
    labels = torch.zeros(pc.shape[0], dtype=torch.long)
    labels[:5] = 1                      # fewer than k = 8 points
    labels[100:300] = 2
    labels[300:] = 3
    out, h = tm.reconstruct(_t(pc), labels, torch.Generator().manual_seed(0),
                            return_hidden=True)[1]
    assert tm.reconstruct(_t(pc), labels)[0] is None
    assert out[0].shape == (1, 64, 3) and h.shape == (1, 32)
    res, seg = tm(_t(pc), torch.Generator().manual_seed(1))
    assert seg.shape == (pc.shape[0],) and len(res) == 3
    with pytest.raises(NotImplementedError):
        RegularizedSegDGCNN(tseg, tae, sample_mode="nearest")


# ---- the entry ---------------------------------------------------------------

def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture
def fold_dirs(tmp_path, monkeypatch):
    """A seg and an AE cross-validation directory as the JAX entries write
    them (commandline_args.json, cross_val_split.json, fold0/model.fst;
    weights from a seed), and both packages' synthetic cases cut to 600
    points (the generators are bit-equal)."""
    sys.path.insert(0, REPO)
    import dseg_ae_regularization as jentry
    for module in (jentry, dseg_ae_regularization):
        real = module.make_synthetic_dataset

        def small(n, n_points, real=real, **kw):
            return real(n, n_points=600, **kw)
        monkeypatch.setattr(module, "make_synthetic_dataset", small)
    (seg, seg_vars, ae, ae_vars), _ = _models(seed=5)
    seg_dir, ae_dir = tmp_path / "seg", tmp_path / "ae"
    for d, model, variables, args in (
            (seg_dir, seg, seg_vars, {"pts": 128, "exclude_rhf": False,
                                      "binary": False}),
            (ae_dir, ae, ae_vars, {"pts": 64})):
        jio.save_model(model, {"params": variables["params"],
                               "batch_stats": variables["batch_stats"]},
                       str(d / "fold0" / "model.fst"))
        (d / "commandline_args.json").write_text(json.dumps(args))
    ids = [[f"synth{i:04d}", "fixed"] for i in range(20)]
    split = [{"train": ids[2:], "val": ids[:2]}]
    (seg_dir / "cross_val_split.json").write_text(json.dumps(split))
    return jentry, str(seg_dir), str(ae_dir), (seg, seg_vars, ae, ae_vars)


def _entry_draws(models, ds, mode, extend):
    """Per case i of `ds`: the JAX entry's draws from PRNGKey(i)."""
    seg, seg_vars, ae, ae_vars = models
    jm = JRegularized(seg, seg_vars, ae, ae_vars, n_points_seg=128,
                      n_points_ae=64, sample_mode=mode, random_extend=extend)
    draws = []
    for i in range(len(ds)):
        pc = jnp.asarray(ds.get_full_pointcloud(i)[0])
        key = jax.random.PRNGKey(i)
        with jax.default_matmul_precision("float32"):
            labels = np.asarray(jm.segment(pc, key))
        draws.append({"subsets": _t(jbuild_subsets(key, pc.shape[0], 128,
                                                   50)),
                      "classes": _class_draws(jm, labels, key,
                                              pc.shape[0])})
    return draws


@pytest.mark.parametrize("extra", [[], ["--sampling", "accumulate",
                                        "--pad_with_random_offsets"]])
def test_entry_matches_jax(fold_dirs, monkeypatch, tmp_path, extra):
    """Both entries on the same fold directories (model.fst only): the
    port's, with the JAX entry's draws injected, writes its
    ae_reg_results.csv Chamfer mean and std within ENTRY_RTOL, the same
    cv_results.csv layout and an inference_time.csv."""
    jentry, seg_dir, ae_dir, models = fold_dirs
    argv = ["--ds", "synthetic", "--seg_dir", seg_dir, "--ae_dir",
            ae_dir] + extra
    with jax.default_matmul_precision("float32"):
        jentry.run(jentry.get_ae_reg_parser().parse_args(
            argv + ["--output", str(tmp_path / "jax")]))
    mode = "accumulate" if extra else "farthest"
    real = dseg_ae_regularization.evaluate_fold

    def with_jax_draws(ds, model, out_dir, device="cpu"):
        return real(ds, model, out_dir, device,
                    draws=_entry_draws(models, ds, mode, bool(extra)))
    monkeypatch.setattr(dseg_ae_regularization, "evaluate_fold",
                        with_jax_draws)
    out = str(tmp_path / "port")
    assert dseg_ae_regularization.main(argv + ["--output", out],
                                       device="cpu") == 0
    want = _read(str(tmp_path / "jax" / "fold0" / "ae_reg_results.csv"))
    got = _read(os.path.join(out, "fold0", "ae_reg_results.csv"))
    assert got[0] == want[0] == ["mean_chamfer", "std_chamfer",
                                 "mean_time_s"]
    np.testing.assert_allclose(np.asarray(got[1][:2], float),
                               np.asarray(want[1][:2], float),
                               rtol=ENTRY_RTOL)
    assert np.isfinite(float(got[1][0]))
    cv, jcv = (_read(os.path.join(d, "cv_results.csv"))
               for d in (out, str(tmp_path / "jax")))
    assert [r[0] for r in cv] == [r[0] for r in jcv] == ["fold", "0",
                                                          "mean"]
    speed = _read(os.path.join(out, "fold0", "inference_time.csv"))
    assert speed[0][0] == "Inference" and float(speed[1][0]) > 0
