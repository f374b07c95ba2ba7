"""Port parity for DGCNN's two stems (`DGCNNSeg(spatial_transformer=True,
image_feat_module=True)`, static and dynamic), DGCNNReg, the affine models
(models/affine.py: AffineDGCNN, AffineOpenDGCNN, AffinePointNet on
PointNetCls), `random_transformation` / `rotate_around_center` and one
step of `affine_experiments` against the JAX package on the CPU, plus the
entry's grid on the CPU.

Inputs are numpy-seeded generic floats (no two kNN distances within
rounding of each other on these inputs, so both packages build the same
graphs: K1's plain version, sum of squared differences, and JAX's matmul
formula); the JAX modules' initial variables are carried over by
`load_jax_variables`, BatchNorm statistics and offsets randomized with
numpy, and the spatial transformer's zero head kernel given small random
values so that its transform is not the identity. JAX's matmuls run at
float32 precision.

Tolerances (readings on this file's inputs beside each):
  * eval outputs within rtol = atol = TOL, 2e-4 (the precedent of
    tests/test_torch_models.py; 8.9e-7 to 1.3e-6);
  * train-mode outputs within TOL (2.8e-5 to 4.4e-5), running statistics
    within TOL;
  * the gradient of a fixed random projection of the train-mode outputs
    as a whole, within GRAD_REL (0.05, the precedent of
    tests/test_torch_point_transformer.py) in relative L2 (4.6e-6 to
    0.014, the static DGCNNSeg with both stems the largest).
    Leaf by leaf it is not held: several leaves (the bias of a Dense or the
    offset of a BatchNorm whose output a later train-mode BatchNorm over
    the batch normalises, such as the spatial transformer's Dense_0 bias)
    have a gradient that is 0 up to rounding, 1e-10 to 1e-8 of the
    model's largest entry on both sides, and a LeakyReLU or maximum that
    rounding sends the other way moves a leaf by a few percent;
  * random_transformation / rotate_around_center with JAX's draws
    injected: within 1e-6 (float32 Rodrigues and centroids);
  * one experiment step from the same weights and draws: loss and
    metrics within rtol 1e-4 (the loss sums the same float32 terms in
    another order; 5.6e-7 and 7.9e-7), and the second step's, after one
    Adam update each, within rtol 1e-3 (1.1e-4 and 1.2e-4: Adam's first
    step is about lr * sign(g), so a gradient entry near 0 may step the
    other way).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fissure_segmentation_tpu.models import DGCNNReg as JDGCNNReg
from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu.models.affine import AFFINE_MODELS as JAFFINE
from fissure_segmentation_tpu.models.affine import \
    random_transformation as jrandom_transformation
from fissure_segmentation_tpu.models.affine import \
    rotate_around_center as jrotate_around_center
from fissure_segmentation_tpu_torch import affine_experiments
from fissure_segmentation_tpu_torch.models import (AFFINE_MODELS, DGCNNReg,
                                                   DGCNNSeg,
                                                   export_jax_variables,
                                                   load_jax_variables,
                                                   load_model, save_model)
from fissure_segmentation_tpu_torch.models.affine import (
    random_transformation, rotate_around_center)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_REL = 0.05
STEP_RTOL = 1e-4
STEP2_RTOL = 1e-3


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _rel_l2(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    gap = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    return np.sqrt(gap / sum(float(np.sum(want[k] ** 2)) for k in want))


def randomize(variables, rng):
    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        if "SpatialTransformer" in name and "Dense_2" in name and \
                "kernel" in name:
            return rng.normal(0, 0.01, a.shape).astype(np.float32)
        if "BatchNorm" not in name:
            return a
        if "var" in name:
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return (rng.normal(0, 0.3, a.shape)
                + (1.0 if "scale" in name else 0.0)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _check_model(jm, tm, variables, x, seed=1, flat=lambda o: o):
    """Eval outputs, train outputs, running statistics and the gradient of
    sum(flat(outputs) * w), port against JAX."""
    rng = np.random.default_rng(seed)
    with jax.default_matmul_precision("float32"):
        ev_j = flat(jm.apply(variables, jnp.asarray(x), train=False))
        w = rng.normal(size=np.shape(ev_j)).astype(np.float32)

        def loss(p):
            out, upd = jm.apply({"params": p,
                                 "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
            out = flat(out)
            return (out * w).sum(), (out, upd["batch_stats"])
        (_, (tr_j, stats_j)), g_j = jax.value_and_grad(
            loss, has_aux=True)(variables["params"])
    tm = load_jax_variables(tm, variables)
    with torch.no_grad():
        ev_t = flat(tm.eval()(torch.from_numpy(x)))
    np.testing.assert_allclose(ev_t.numpy(), np.asarray(ev_j), **TOL)
    tm.train()
    tr_t = flat(tm(torch.from_numpy(x)))
    (tr_t * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tr_t.detach().numpy(), np.asarray(tr_j),
                               **TOL)
    got = _leaves(export_jax_variables(tm)["batch_stats"])
    for name, a in _leaves(stats_j).items():
        np.testing.assert_allclose(got[name], a, err_msg=name, **TOL)
    err = _rel_l2(_leaves(export_jax_variables(tm, grad=True)["params"]),
                  _leaves(g_j))
    print(f"gradient relative L2 {err:.3g}")
    assert err <= GRAD_REL
    return tm


@pytest.mark.parametrize("model", ["seg", "reg"])
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_dgcnn_stems_match_jax(model, dynamic):
    """DGCNNSeg and DGCNNReg with the spatial transformer and the image
    features: the flax tree maps one to one (EdgeConv_0 reads 3 + 12
    channels), outputs and one step's gradient agree."""
    jcls, tcls, nc = ((JDGCNNSeg, DGCNNSeg, 4) if model == "seg"
                      else (JDGCNNReg, DGCNNReg, 6))
    kw = dict(k=6, in_features=5, num_classes=nc, spatial_transformer=True,
              image_feat_module=True, dynamic=dynamic)
    jm = jcls(**kw)
    variables = randomize(jm.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 32, 5))),
                          np.random.default_rng(0))
    x = np.random.default_rng(1).normal(size=(8, 64, 5)).astype(np.float32)
    tm = _check_model(jm, tcls(**kw), variables, x)
    assert tm.EdgeConv_0.EdgeMLP_0.kernel.shape[0] == 2 * 15
    assert tm.config["spatial_transformer"] and \
        tm.config["image_feat_module"]


def test_dgcnn_reg_plain_matches_jax():
    """DGCNNReg without the stems, the dynamic graph: four EdgeConvs (64,
    64, 128, 256), SharedMLP(1024), a global max and the (B, C) head."""
    jm = JDGCNNReg(k=6, in_features=3, num_classes=9)
    variables = randomize(jm.init(jax.random.PRNGKey(2),
                                  jnp.zeros((1, 32, 3))),
                          np.random.default_rng(2))
    x = np.random.default_rng(3).normal(size=(8, 64, 3)).astype(np.float32)
    tm = _check_model(jm, DGCNNReg(k=6, in_features=3, num_classes=9),
                      variables, x)
    assert [tm.EdgeConv_3.EdgeMLP_0.kernel.shape[1],
            tm.SharedMLP_3.Dense_0.out_features] == [256, 9]


@pytest.mark.parametrize("name", sorted(AFFINE_MODELS))
def test_affine_models_match_jax(name):
    """Each affine model (k = 6; AffinePointNet keeps its unused k):
    rotation and translation, eval and train, and the gradient."""
    jm = JAFFINE[name](k=6)
    variables = randomize(jm.init(jax.random.PRNGKey(4),
                                  jnp.zeros((1, 32, 3))),
                          np.random.default_rng(4))
    x = np.random.default_rng(5).normal(size=(8, 64, 3)).astype(np.float32)
    cat = (lambda o: jnp.concatenate(o, -1) if isinstance(o[0], jax.Array)
           else torch.cat(o, -1))
    _check_model(jm, AFFINE_MODELS[name](k=6), variables, x, flat=cat)


@pytest.mark.parametrize("rot,trans", [(True, False), (False, True)])
def test_affine_disabled_component_is_zero(rot, trans, tmp_path):
    """A disabled component is zeros; model.pt records the options."""
    model = AFFINE_MODELS["PointNet"](do_rotation=rot, do_translation=trans,
                                      generator=torch.Generator()
                                      .manual_seed(0)).eval()
    with torch.no_grad():
        r, t = model(torch.randn(2, 32, 3,
                                 generator=torch.Generator().manual_seed(1)))
    assert r.shape == t.shape == (2, 3)
    assert (not rot and not r.any()) or (not trans and not t.any())
    save_model(model, str(tmp_path / "model.pt"))
    again = load_model(str(tmp_path / "model.pt"))
    assert again.config == dict(k=40, do_rotation=rot, do_translation=trans)


@pytest.mark.parametrize("rot,trans", [(True, True), (True, False),
                                       (False, True)])
def test_random_transformation_matches_jax(rot, trans):
    """JAX's draws (the split key's two uniform (n, 3) arrays) injected:
    log rotations, translations, the transforms and the moved shapes."""
    key = jax.random.PRNGKey(7)
    t_j, lr_j, tr_j = jrandom_transformation(key, 5, rotation=rot,
                                             translation=trans)
    r_rot, r_tr = jax.random.split(key)
    draws = (torch.from_numpy(np.array(jax.random.uniform(r_rot, (5, 3)))),
             torch.from_numpy(np.array(jax.random.uniform(r_tr, (5, 3)))))
    t, lr, tr = random_transformation(None, 5, rotation=rot,
                                      translation=trans, draws=draws)
    for got, want in ((lr, lr_j), (tr, tr_j), (t.rotation, t_j.rotation),
                      (t.scaling, t_j.scaling)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    shapes = np.random.default_rng(8).normal(
        size=(1, 50, 3)).astype(np.float32) + 5
    want = jrotate_around_center(jnp.asarray(shapes), t_j)
    got = rotate_around_center(torch.from_numpy(shapes), t)
    assert got.shape == (5, 50, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    gen = torch.Generator().manual_seed(3)
    a = random_transformation(gen, 4)[1]
    b = random_transformation(torch.Generator().manual_seed(3), 4)[1]
    assert torch.equal(a, b) and a.abs().max() <= 2.0


def _jax_entry():
    sys.path.insert(0, REPO)
    import affine_experiments as jentry
    return jentry


@pytest.mark.parametrize("name", ["DGCNN", "PointNet"])
def test_experiment_step_matches_jax(name):
    """Two steps of the experiment (rotation and translation, point and
    parameter loss) from the same weights on the same draws: the JAX
    entry's jitted step against the port's `make_train_step`, at k = 6 on
    a 128-point target."""
    jentry = _jax_entry()
    target, _ = affine_experiments.normalized_target_shape(
        np.random.default_rng(42), n_points=128)
    jtarget, _ = jentry.normalized_target_shape(np.random.default_rng(42),
                                                n_points=128)
    np.testing.assert_array_equal(target, jtarget)
    jm = JAFFINE[name](k=6)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(target)[None], train=False))
    tx = optax.adam(1e-3)
    with jax.default_matmul_precision("float32"):
        jstep = jentry.make_train_step(jm, tx, jnp.asarray(target), True,
                                       True, True, True)
        params, opt_state = variables["params"], tx.init(variables["params"])
        stats, rng = variables["batch_stats"], jax.random.PRNGKey(1)
        want, draws = [], []
        for _ in range(2):
            _, r_t = jax.random.split(rng)
            r_rot, r_tr = jax.random.split(r_t)
            draws.append(tuple(torch.from_numpy(np.array(
                jax.random.uniform(r, (8, 3)))) for r in (r_rot, r_tr)))
            params, opt_state, stats, rng, m = jstep(params, opt_state,
                                                     stats, rng)
            want.append({k: float(v) for k, v in m.items()})

    model = load_jax_variables(AFFINE_MODELS[name](k=6), variables)
    step = affine_experiments.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3),
        torch.from_numpy(target), True, True, True, True)
    for i, (d, w) in enumerate(zip(draws, want)):
        got = {k: float(v) for k, v in step(None, draws=d).items()}
        assert set(got) == set(w)
        for k in w:
            np.testing.assert_allclose(got[k], w[k], err_msg=f"{i} {k}",
                                       rtol=STEP_RTOL if i == 0
                                       else STEP2_RTOL)


def test_entry_runs_the_grid_on_the_cpu(tmp_path, monkeypatch):
    """`main(argv, device="cpu")` runs the JAX entry's grid (nine runs:
    rotation, translation or both, times the point loss, the parameter
    loss or both) and writes each run's training_progression.csv with the
    JAX entry's rows; without a card and without a device it raises."""
    out = tmp_path / "out"
    assert affine_experiments.main(["--model", "PointNet", "--epochs", "1",
                                    "--steps", "1", "--output", str(out)],
                                   device="cpu") == 0
    runs = sorted(os.listdir(out / "PointNet_sanity_check"))
    assert len(runs) == 9 and len(affine_experiments.GRID) == 9
    assert "PointNet_rot_translation_pointloss_paramloss" in runs
    for run in runs:
        with open(out / "PointNet_sanity_check" / run /
                  "training_progression.csv") as f:
            rows = [r.split(",") for r in f.read().splitlines()]
        assert [r[0] for r in rows] == ["loss", "angle_rmse",
                                        "trans_rmse_mm", "corr_err_mm"]
        assert all(len(r) == 2 and np.isfinite(np.asarray(r[1:], float)).all()
                   for r in rows)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        affine_experiments.main(["--output", str(tmp_path / "none")])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        affine_experiments.run_example("PointNet", 1, 1, str(tmp_path))
