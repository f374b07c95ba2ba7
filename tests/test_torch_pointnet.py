"""Port parity for PointNet (models/pointnet.py: TNet, PointNetSeg), its
`.fst` header both ways, and `train_point_seg --model PointNet`.

The same numpy-seeded inputs and the JAX package's initial variables
(carried over by `load_jax_variables`, BatchNorm statistics and offsets
randomized with numpy, and each T-Net's zero head kernel given small random
values so that the transforms are not the identity) go through the JAX
module (matmuls at float32 precision) and the port on the CPU.

Tolerances (readings on this file's inputs beside each):
  * eval logits in float32, for each of the four combinations of the input
    T-Net (`spatial_transform`) and the feature T-Net
    (`feature_transform`): rtol = atol = TOL, 2e-4 (the precedent of
    tests/test_torch_models.py; 4.8e-7 to 7.7e-7). PointNet builds no
    graph, so nothing but summation order differs.
  * train mode normalises by the batch's own statistics, and the T-Nets'
    second stacks see one 1024-d vector a cloud: on 8 clouds their
    BatchNorm amplifies float32 rounding, and JAX's own float32 gradient
    is up to 1.4 % (relative L2) off its float64 one (the precedent of
    tests/test_torch_point_transformer.py, which compares in float64). So
    the train-mode forward is held in float64 against JAX under
    `jax.enable_x64`: logits and running statistics within TOL64 (1e-5;
    1.2e-7 to 4.6e-6, JAX rounding to float32 where its module casts) and
    each gradient leaf within LEAF64 (1e-5) of its largest entry (5.6e-8
    to 1.7e-6); and in float32 against that float64 reference: logits
    within TOL_TRAIN32 (1e-3; 2.3e-5 to 2.4e-4), running statistics within
    TOL (9.5e-7 to 8.5e-6), the whole gradient within GRAD_REL (0.05) in
    relative L2 (5.3e-6 to 0.014, where JAX's float32 reads 1.5e-5 to
    0.014).
  * bfloat16 (`dtype`, the shared-MLP stacks only): both packages round at
    the same places but their products sum in other orders, so a bf16
    output can land on the neighbouring bf16 value. The port's eval logits
    are held within BF16_TOL * max|logit| of JAX's bf16 logits (0.05;
    0.0053 and 0.011) and no further from JAX's float32 logits than JAX's
    own bf16 logits are, times BF16_SLACK (1.5; 0.89 and 1.22).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.models import PointNetSeg as JPointNetSeg
from fissure_segmentation_tpu.models import load_model as jload_model
from fissure_segmentation_tpu.models import save_model as jsave_model
from fissure_segmentation_tpu_torch import train_point_seg
from fissure_segmentation_tpu_torch.data import dataset, synthetic
from fissure_segmentation_tpu_torch.models import (PointNetSeg,
                                                   export_jax_variables,
                                                   load_jax_variables,
                                                   load_fold_model,
                                                   load_model)
from fissure_segmentation_tpu_torch.models.io import load_fst, save_fst

TOL = dict(rtol=2e-4, atol=2e-4)
TOL64 = dict(rtol=1e-5, atol=1e-5)
TOL_TRAIN32 = dict(rtol=1e-3, atol=1e-3)
GRAD_REL = 0.05
LEAF64 = 1e-5
BF16_TOL = 0.05
BF16_SLACK = 1.5
COMBOS = [(False, False), (True, False), (False, True), (True, True)]
IDS = ["plain", "input_tnet", "feature_tnet", "both_tnets"]


def randomize(variables, rng, head_scale=0.02):
    """BatchNorm statistics and offsets drawn from `rng`; every T-Net's
    zero head kernel given entries of `head_scale`."""
    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "TNet" in name and "Dense" in name and "kernel" in name:
            return (rng.normal(0, head_scale, a.shape)).astype(np.float32)
        if "BatchNorm" not in name:
            return a
        if "var" in name:
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return (rng.normal(0, 0.3, a.shape)
                + (1.0 if "scale" in name else 0.0)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def jax_model(st, ft, seed=0, in_features=4, num_classes=4, dtype=None):
    jm = JPointNetSeg(in_features, num_classes, st, ft, dtype=dtype)
    variables = jm.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 32, in_features)))
    return jm, randomize(variables, np.random.default_rng(seed))


def port_model(variables, st, ft, in_features=4, num_classes=4, dtype=None):
    tm = PointNetSeg(in_features, num_classes, st, ft, dtype=dtype)
    return load_jax_variables(tm, variables)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_train(jm, variables, x, w):
    """JAX's train-mode logits, running statistics and the gradient of
    sum(logits * w), at the variables' and x's precision."""
    def loss(p):
        out, upd = jm.apply({"params": p,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return (out * w).sum(), (out, upd["batch_stats"])
    (_, (out, stats)), g = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    return np.asarray(out), _leaves(stats), _leaves(g)


def _port_train(tm, x, w):
    tm.train()
    out = tm(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    return (out.detach().double().numpy(),
            _leaves(export_jax_variables(tm)["batch_stats"]),
            _leaves(export_jax_variables(tm, grad=True)["params"]))


def _rel_l2(got, want):
    gap = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    return np.sqrt(gap / sum(float(np.sum(want[k] ** 2)) for k in want))


@pytest.mark.parametrize("st,ft", COMBOS, ids=IDS)
def test_pointnet_seg_matches_jax(st, ft):
    """Eval logits in float32; the train-mode forward, running statistics
    and gradient in float64 leaf by leaf, and in float32 as a whole
    against JAX's float64 (the module docstring says why)."""
    rng = np.random.default_rng(1)
    jm, variables = jax_model(st, ft)
    x = rng.normal(size=(8, 64, 4)).astype(np.float32)
    w = rng.normal(size=(8, 64, 4)).astype(np.float32)
    names = sorted(variables["params"])
    want = ["Dense_0", "MLPStack_0", "MLPStack_1", "MLPStack_2"] + \
        [f"TNet_{i}" for i in range(st + ft)]
    assert names == sorted(want)
    tm = port_model(variables, st, ft)
    assert sorted(n for n, _ in tm.named_children()) == sorted(want)

    with jax.default_matmul_precision("float32"):
        ev_j = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
        _, _, g32_j = _jax_train(jm, variables, x, w)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)
        out_j, stats_j, g_j = _jax_train(jm, v64, x.astype(np.float64),
                                         w.astype(np.float64))
    with torch.no_grad():
        ev_t = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ev_t, ev_j, **TOL)

    out64, stats64, g64 = _port_train(port_model(variables, st, ft).double(),
                                      x.astype(np.float64),
                                      w.astype(np.float64))
    np.testing.assert_allclose(out64, out_j, **TOL64)
    for name, a in stats_j.items():
        np.testing.assert_allclose(stats64[name], a, err_msg=name, **TOL64)
    assert set(g64) == set(g_j)
    worst = max(np.abs(g64[n] - a).max() / np.abs(a).max()
                for n, a in g_j.items())
    print(f"float64 gradient: worst leaf error / leaf max {worst:.3g}")
    assert worst <= LEAF64

    out32, stats32, g32 = _port_train(tm, x, w)
    np.testing.assert_allclose(out32, out_j, **TOL_TRAIN32)
    for name, a in stats_j.items():
        np.testing.assert_allclose(stats32[name], a, err_msg=name, **TOL)
    err, jax_err = _rel_l2(g32, g_j), _rel_l2(g32_j, g_j)
    print(f"float32 gradient vs float64: port {err:.3g}, JAX {jax_err:.3g}")
    assert err <= GRAD_REL


@pytest.mark.parametrize("st,ft", [(False, False), (True, True)],
                         ids=["plain", "both_tnets"])
def test_pointnet_seg_bf16_matches_jax(st, ft):
    """The bf16 forward: the shared MLPs compute in bf16, the T-Nets and
    the head in float32, the logits float32."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 128, 4)).astype(np.float32)
    jm, variables = jax_model(st, ft, seed=3, dtype=jnp.bfloat16)
    jm32 = JPointNetSeg(4, 4, st, ft)
    with jax.default_matmul_precision("float32"):
        j16 = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
        j32 = np.asarray(jm32.apply(variables, jnp.asarray(x), train=False))
    tm = port_model(variables, st, ft, dtype=torch.bfloat16).eval()
    assert tm.MLPStack_0.SharedMLP_0.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    seen = []
    for name in [n for n in ("TNet_0", "TNet_1") if hasattr(tm, n)]:
        getattr(tm, name).register_forward_hook(
            lambda m, i, o: seen.append(o.dtype))
    with torch.no_grad():
        t16 = tm(torch.from_numpy(x))
    assert t16.dtype == torch.float32
    assert set(seen) <= {torch.float32} and len(seen) == st + ft
    t16 = t16.numpy()
    scale = np.abs(j32).max()
    assert np.abs(t16 - j16).max() <= BF16_TOL * scale
    assert np.abs(t16 - j32).max() <= BF16_SLACK * np.abs(j16 - j32).max()


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_pointnet_fst_both_ways(tmp_path, dtype):
    """A JAX `.fst` PointNetSeg (both T-Nets) loads in the port with its
    config, and the port's writer gives a file JAX's load_model reads back
    to the same tree and the same eval logits."""
    jdt = None if dtype is None else jnp.bfloat16
    jm, variables = jax_model(True, True, seed=4, dtype=jdt)
    jsave_model(jm, variables, str(tmp_path / "j.fst"))
    tm = load_fst(str(tmp_path / "j.fst"))
    assert isinstance(tm, PointNetSeg)
    assert tm.spatial_transform and tm.feature_transform
    assert tm.dtype == (None if dtype is None else torch.bfloat16)
    x = np.random.default_rng(5).normal(size=(2, 64, 4)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    tol = TOL if dtype is None else dict(rtol=0, atol=BF16_TOL *
                                         np.abs(want).max())
    np.testing.assert_allclose(got, want, **tol)

    save_fst(tm, str(tmp_path / "t.fst"))
    jm2, back = jload_model(str(tmp_path / "t.fst"))
    assert (jm2.spatial_transform, jm2.feature_transform, jm2.dtype) == \
        (True, True, jdt)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(variables),
                            jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=jax.tree_util.keystr(path))


def _cases_dir(tmp_path, n=5):
    folder = tmp_path / "cases"
    for c in synthetic.make_synthetic_dataset(n, n_points=300,
                                              gt_surfaces=True):
        dataset.save_case_npz(c, str(folder))
    return str(folder)


@pytest.mark.parametrize("transformer", [False, True],
                         ids=["pointnet", "pointnet_transformer"])
def test_train_point_seg_pointnet_fold_then_test_only(tmp_path, transformer):
    """`--model PointNet` (`--amp true`, the default: bf16 shared MLPs)
    trains fold 0 for 2 epochs and tests it on the CPU, then
    `--test_only` tests it again from model.pt: the JAX package's CSVs,
    finite Dice; model.pt holds PointNetSeg with the flags' options."""
    out = str(tmp_path / "run")
    argv = ["--model", "PointNet", "--data_dir", _cases_dir(tmp_path),
            "--fold", "0", "--epochs", "2", "--pts", "64", "--batch", "2",
            "--output", out] + (["--transformer"] if transformer else [])
    assert train_point_seg.main(argv, device="cpu") == 0
    model = load_model(os.path.join(out, "fold0", "model.pt"))
    assert isinstance(model, PointNetSeg)
    assert model.config == dict(in_features=4, num_classes=4,
                                spatial_transform=transformer,
                                feature_transform=False, dtype="bfloat16")
    assert load_fold_model(os.path.join(out, "fold0")).config == \
        model.config
    with open(os.path.join(out, "fold0", "test", "test_results.csv")) as f:
        first = f.read()
    assert train_point_seg.main(["--output", out, "--test_only", "--fold",
                                 "0"], device="cpu") == 0
    with open(os.path.join(out, "fold0", "test", "test_results.csv")) as f:
        again = f.read()
    dice = [r for r in again.splitlines() if r.startswith("Mean Dice")]
    assert dice and all(np.isfinite(float(v))
                        for v in dice[0].split(",")[1:])
    assert again.splitlines()[:3] == first.splitlines()[:3]
    with open(os.path.join(out, "commandline_args.json")) as f:
        assert json.load(f)["model"] == "PointNet"


def test_segment_case_with_pointnet_matches_jax():
    """The Förstner serving path with a PointNetSeg ensemble (both T-Nets,
    the JAX model's weights, tests/test_torch_serving.py's case, class
    bias, configuration and injected subsets): keypoints and labels equal,
    meshes and labelmap held as that file holds DGCNN's."""
    from fissure_segmentation_tpu.models.ensemble import build_subsets
    from fissure_segmentation_tpu.serving import \
        segment_case as jsegment_case
    from fissure_segmentation_tpu_torch.serving import segment_case
    from test_torch_serving import CFG, SHAPE, _band_class, _case
    img, mask = _case()
    jm, variables = jax_model(True, True, seed=6, in_features=3)

    def japply(v, x, train=False):
        return jm.apply(v, x, train=train) + 50.0 * jax.nn.one_hot(
            _band_class(x, jnp), 4)
    tm = port_model(variables, True, True, in_features=3).eval()

    def tapply(x):
        return tm(x) + 50.0 * torch.nn.functional.one_hot(
            _band_class(x, torch), 4)
    key = jax.random.PRNGKey(7)
    with jax.default_matmul_precision("float32"):
        rj = jsegment_case(img, mask, japply, variables, key,
                           center_x=SHAPE[2] / 2, **CFG)
    subsets = np.array(build_subsets(key, CFG["max_kpts"],
                                     CFG["sample_points"], CFG["n_runs_min"]))
    rt = segment_case(img, mask, tapply, subsets=torch.from_numpy(subsets),
                      center_x=SHAPE[2] / 2, device="cpu", **CFG)
    np.testing.assert_array_equal(rt.kpts, rj.kpts)
    np.testing.assert_array_equal(rt.labels, rj.labels)
    assert set(np.unique(rj.labels)) == {0, 1, 2, 3}
    for c, ((t1, v1), (t2, v2)) in enumerate(zip(rj.meshes, rt.meshes), 1):
        n1, n2 = int(v1.sum()), int(v2.sum())
        assert n1 > 0 and abs(n1 - n2) <= max(8, 0.05 * max(n1, n2))
        a, b = rj.labelmap == c, rt.labelmap == c
        assert 2 * (a & b).sum() / (a.sum() + b.sum()) >= 0.9, c
