"""Port parity for PointTransformerSeg: the neighborhood ops, every module
in eval and train mode, one Adam step of the whole model, the model
registry and the training entry point.

The same numpy-seeded inputs and the same weights (carried across by
load_jax_variables) go through the JAX package (matmuls at float32
precision; FPS through its XLA path, which tests/test_torch_fps.py holds
equal to fps_pallas) and through fissure_segmentation_tpu_torch on the CPU.
Coordinates are multiples of 1/16 unless a test says otherwise: every
distance of the expanded formula |q|^2 - 2 q.s + |s|^2 is then exact in
float32, so both sides pick the same neighbours, ties included, and the
same FPS points, and the differences left are summation orders in the
matmuls and reductions (the tolerances below).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fissure_segmentation_tpu.losses import segmentation as jlosses
from fissure_segmentation_tpu.models import point_transformer as jpt
from fissure_segmentation_tpu.ops import pointops as jpointops
from fissure_segmentation_tpu_torch import train_point_seg
from fissure_segmentation_tpu_torch.data import dataset, synthetic
from fissure_segmentation_tpu_torch.losses import get_loss_fn
from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                   PointTransformerSeg,
                                                   export_jax_variables,
                                                   get_point_seg_model_class,
                                                   load_jax_variables,
                                                   load_model)
from fissure_segmentation_tpu_torch.models import point_transformer as tpt
from fissure_segmentation_tpu_torch.ops import pointops
from fissure_segmentation_tpu_torch.train.trainer import (ModelTrainer,
                                                          TrainConfig)

TOL = dict(rtol=2e-4, atol=2e-4)
LR, WD = 1e-3, 1e-5
ADAM_PINNED = 1e-6  # |g| from which Adam's first step is lr * sign(g)


def _t(a):
    return torch.tensor(np.asarray(a))


def _dyadic(rng, shape):
    return (rng.integers(-16, 17, shape) / 16.0).astype(np.float32)


def _assert_trees_close(got, want, path="", **tol):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], f"{path}{k}/", **tol)
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       err_msg=f"{path}{k}", **tol)


def _leaves(tree, path=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", tree[k]


# ---- neighborhood ops ------------------------------------------------------

@pytest.mark.parametrize("k", [5, 12], ids=["k<n", "k>n"])
def test_knn_query_matches_jax(k):
    """Generic float coordinates, query != support: indices equal except
    where the two sides' distances tie within float32 rounding; distances
    within rtol = atol = 1e-5 (the expanded formula's matmul runs in another
    order). k > n pads with the nearest neighbour on both sides."""
    rng = np.random.default_rng(k)
    support = rng.uniform(-1, 1, (2, 10, 3)).astype(np.float32)
    query = rng.uniform(-1, 1, (2, 30, 3)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        i_j, d_j = (np.asarray(a) for a in jpointops.knn_query(
            jnp.asarray(support), jnp.asarray(query), k))
    i_t, d_t = pointops.knn_query(_t(support), _t(query), k)
    assert i_t.dtype == torch.int32 and i_t.shape == (2, 30, k)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-5, atol=1e-5)
    diff = i_t.numpy() != i_j
    np.testing.assert_allclose(d_t.numpy()[diff], d_j[diff], rtol=1e-5,
                               atol=1e-5)
    assert diff.mean() < 0.05


def test_knn_query_and_group_exact_on_dyadic_points():
    """Dyadic coordinates, the self case with many exact ties: indices
    equal (ties to the lower index on both sides, the query itself first
    among its duplicates), distances and grouped features within 1e-6."""
    rng = np.random.default_rng(1)
    p = (rng.integers(0, 4, (2, 64, 3)) / 4.0).astype(np.float32)
    feat = rng.normal(size=(2, 64, 5)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        i_j, d_j = jpointops.knn_query(jnp.asarray(p), jnp.asarray(p), 9)
        g_j, gi_j = jpointops.query_and_group(jnp.asarray(p), jnp.asarray(p),
                                              jnp.asarray(feat), 9)
        f_j, _ = jpointops.query_and_group(jnp.asarray(p), jnp.asarray(p),
                                           jnp.asarray(feat), 9, idx=i_j,
                                           use_xyz=False)
    i_t, d_t = pointops.knn_query(_t(p), _t(p), 9)
    g_t, gi_t = pointops.query_and_group(_t(p), _t(p), _t(feat), 9)
    f_t, _ = pointops.query_and_group(_t(p), _t(p), _t(feat), 9, idx=i_t,
                                      use_xyz=False)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(gi_t.numpy(), np.asarray(gi_j))
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-6, atol=1e-6)
    assert g_t.shape == (2, 64, 9, 8)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=1e-6, atol=1e-6)


def test_interpolate_matches_jax():
    """The fine points include the coarse ones, as after FPS. On dyadic
    points a coincident point's distance is exactly 0 on both sides, and
    the result agrees to 1e-6. On generic floats the expanded formula
    leaves a coincident point a "distance" of rounding noise (up to about
    sqrt(1e-7 |x|^2) ~ 5e-4), which the two sides round differently; its
    weight 1 / (dist + 1e-8) then dominates by a different factor, and the
    other two neighbours' share of the result moves by up to about
    dist / neighbour distance ~ 1e-2: there the tolerance is rtol = atol =
    5e-2 on the coincident rows, 2e-4 on the others."""
    rng = np.random.default_rng(2)
    for make, exact in ((_dyadic, True), (lambda r, s: r.uniform(
            -1, 1, s).astype(np.float32), False)):
        fine = make(rng, (2, 48, 3))
        coarse = fine[:, ::4].copy()
        feat = rng.normal(size=(2, 12, 6)).astype(np.float32)
        with jax.default_matmul_precision("float32"):
            want = np.asarray(jpointops.interpolate(
                jnp.asarray(coarse), jnp.asarray(fine), jnp.asarray(feat)))
        got = pointops.interpolate(_t(coarse), _t(fine), _t(feat)).numpy()
        if exact:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            continue
        coincident = np.zeros(48, bool)
        coincident[::4] = True
        np.testing.assert_allclose(got[:, coincident], want[:, coincident],
                                   rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(got[:, ~coincident], want[:, ~coincident],
                                   **TOL)


# ---- modules ---------------------------------------------------------------

def _randomize_bn(rng, variables):
    """Nonzero BatchNorm offsets and non-trivial running statistics, so
    eval mode and the running update are exercised."""
    def leaf(path, a):
        name = jax.tree_util.keystr(path)
        if "BatchNorm" not in name:
            return a
        if "var" in name:
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return (rng.normal(0, 0.3, a.shape) +
                (1.0 if "scale" in name else 0.0)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _module_case(name, rng):
    """(flax module, port module factory, inputs) at B=2, N=64."""
    p = _dyadic(rng, (2, 64, 3))
    x16 = rng.normal(size=(2, 64, 16)).astype(np.float32)
    if name == "layer":
        return (jpt.PointTransformerLayer(16, 4, 8),
                lambda: tpt.PointTransformerLayer(16, 4, 8), (p, x16))
    if name == "block":
        return (jpt.PointTransformerBlock(16, 4, 8),
                lambda: tpt.PointTransformerBlock(16, 4, 8), (p, x16))
    if name == "down_stride4":
        x = rng.normal(size=(2, 64, 8)).astype(np.float32)
        return (jpt.TransitionDown(16, 4, 8),
                lambda: tpt.TransitionDown(8, 16, 4, 8), (p, x))
    if name == "down_stride1":
        x = rng.normal(size=(2, 64, 5)).astype(np.float32)
        return (jpt.TransitionDown(16, 1),
                lambda: tpt.TransitionDown(5, 16, 1), (p, x))
    if name == "up_summit":
        return (jpt.TransitionUp(None), lambda: tpt.TransitionUp(16),
                (p, x16))
    x1 = rng.normal(size=(2, 64, 8)).astype(np.float32)
    x2 = rng.normal(size=(2, 16, 24)).astype(np.float32)
    return (jpt.TransitionUp(16), lambda: tpt.TransitionUp(8, 16, 24),
            (p, x1, p[:, 3::4].copy(), x2))


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


MODULES = ["layer", "block", "down_stride4", "down_stride1", "up_summit",
           "up_skip"]


@pytest.mark.parametrize("name", MODULES)
def test_module_eval_matches_flax(name):
    """Eval mode (running statistics): outputs within 2e-4."""
    rng = np.random.default_rng(MODULES.index(name))
    jm, make, ins = _module_case(name, rng)
    variables = _randomize_bn(rng, jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), *ins)))
    with jax.default_matmul_precision("float32"):
        want = _outputs(jm.apply(variables, *ins))
    tm = load_jax_variables(make(), variables).eval()
    with torch.no_grad():
        got = _outputs(tm(*(_t(a) for a in ins)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("name", MODULES)
def test_module_train_matches_flax(name):
    """Train mode (batch statistics): outputs, the running-statistics
    update and the gradient of sum(out * w) with respect to every
    parameter, within 2e-4."""
    rng = np.random.default_rng(10 + MODULES.index(name))
    jm, make, ins = _module_case(name, rng)
    variables = _randomize_bn(rng, jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(1), *ins)))
    with jax.default_matmul_precision("float32"):
        shapes = [o.shape for o in _outputs(jax.eval_shape(
            lambda: jm.apply(variables, *ins)))]
    ws = [rng.normal(size=s).astype(np.float32) for s in shapes]

    def jloss(params):
        out, mut = jm.apply({**variables, "params": params}, *ins,
                            train=True, mutable=["batch_stats"])
        out = _outputs(out)
        return sum(jnp.sum(o * w) for o, w in zip(out, ws)), \
            (out, mut["batch_stats"])

    with jax.default_matmul_precision("float32"):
        (_, (out_j, stats_j)), grads_j = jax.value_and_grad(
            jloss, has_aux=True)(variables["params"])
    tm = load_jax_variables(make(), variables).train()
    out_t = _outputs(tm(*(_t(a) for a in ins)))
    sum((o * _t(w)).sum() for o, w in zip(out_t, ws)).backward()
    for g, w in zip(out_t, out_j):
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL)
    _assert_trees_close(export_jax_variables(tm)["batch_stats"], stats_j,
                        **TOL)
    _assert_trees_close(export_jax_variables(tm, grad=True)["params"],
                        grads_j, **TOL)


# ---- the whole model -------------------------------------------------------

SMALL = dict(blocks=(1, 1, 1, 1, 1), planes=(8, 16, 16, 32, 32))


def _small_dataset(n_cases=4, n_points=600, sample_points=512):
    cases = synthetic.make_synthetic_dataset(n_cases, n_points=n_points)
    return dataset.PointDataset(cases, sample_points=sample_points)


def test_point_transformer_seg_names_and_eval_logits_match_flax():
    """The port's module tree is flax's, name for name (a strict load,
    exported back bit for bit; the default widths build the same tree as
    the JAX model). In eval mode
    (running statistics) the full-depth model at B=2, N=256 gives the
    logits and the gradient of sum(logits * w) with respect to every
    parameter within 2e-4."""
    rng = np.random.default_rng(30)
    x = _dyadic(rng, (2, 256, 4))
    w = rng.normal(size=(2, 256, 4)).astype(np.float32)
    jm = jpt.PointTransformerSeg(in_features=4, num_classes=4, **SMALL)
    variables = _randomize_bn(rng, jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(2), x)))

    def jloss(params):
        out = jm.apply({**variables, "params": params}, x)
        return jnp.sum(out * w), out

    with jax.default_matmul_precision("float32"):
        (_, want), grads_j = jax.value_and_grad(jloss, has_aux=True)(
            variables["params"])
    tm = load_jax_variables(PointTransformerSeg(4, 4, **SMALL),
                            variables).eval()
    got = tm(_t(x))
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    _assert_trees_close(export_jax_variables(tm, grad=True)["params"],
                        grads_j, **TOL)
    _assert_trees_close(export_jax_variables(tm), variables, rtol=0, atol=0)
    full = jax.eval_shape(lambda: jpt.PointTransformerSeg(
        in_features=3, num_classes=4).init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 256, 3))))
    port = export_jax_variables(PointTransformerSeg(3, 4))
    for coll in ("params", "batch_stats"):
        want_leaves = [(k, tuple(v.shape)) for k, v in _leaves(full[coll])]
        assert [(k, v.shape) for k, v in _leaves(port[coll])] == \
            want_leaves, coll


def test_point_transformer_adam_step_matches_jax(tmp_path):
    """One NNU-loss Adam + weight-decay step of the full-depth model
    (blocks 1 x 5, planes narrowed) at B=2, N=512 from the same weights on
    the same batch, in train mode (batch statistics), against the JAX
    package run in float64 (`jax.enable_x64`).

    Why float64: train-mode BatchNorm normalises by the batch's own
    statistics (fast variance E[x^2] - E[x]^2), and at B=2 the coarse
    stages hold few samples, so float32 rounding of the statistics grows
    through the depth. On this step the JAX package's own float32 gradient
    is 9.3 % (relative L2) off its float64 one, the port's float32 gradient
    0.8 % (scripts/prof/pt_float32_conditioning.py --jax): against JAX's
    float32 the comparison would measure JAX's rounding. At N=256 the last
    stage holds one point per cloud and its BatchNorm normalises pure
    rounding noise, hence N=512.

    Tolerances: loss and CE/GDL within rtol 1e-5; running statistics within
    rtol = atol = 2e-4; the gradient within 0.05 in relative L2 over all
    parameters (leaf by leaf it is held to 2e-4 in eval mode by the test
    above, and per module in train mode by test_module_train_matches_flax).
    Updated parameters: Adam's first step is about lr * sign(g') with
    g' = g + wd * p; they are held to 2e-4 of the JAX ones where the two
    sides' g' agree in sign and exceed 1e-6 in magnitude (below that eps =
    1e-8 sizes the step; a Dense followed by BatchNorm has a bias gradient
    of zero up to rounding), and everywhere to optax's update of the
    port's own gradients (1e-6)."""
    rng = np.random.default_rng(31)
    jm = jpt.PointTransformerSeg(in_features=4, num_classes=4, **SMALL)
    x = _dyadic(rng, (2, 512, 4))
    y = rng.integers(0, 4, (2, 512)).astype(np.int32)
    variables = _randomize_bn(rng, jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(3), x)))
    cw = np.asarray([0.4, 1.2, 1.1, 1.3], np.float32)
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))

    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)

        def jloss(params):
            out, mut = jm.apply({**v64, "params": params},
                                x.astype(np.float64), train=True,
                                mutable=["batch_stats"])
            loss, comps = jlosses.nnu_loss(out, y,
                                           jnp.asarray(cw, jnp.float64))
            return loss, (comps, mut["batch_stats"])

        (loss_j, (comps_j, stats_j)), grads_j = jax.value_and_grad(
            jloss, has_aux=True)(v64["params"])
        updates, _ = tx.update(grads_j, tx.init(v64["params"]),
                               v64["params"])
        params_j = optax.apply_updates(v64["params"], updates)
        loss_j = float(loss_j)
        comps_j = {k: float(v) for k, v in comps_j.items()}
        stats_j, grads_j, params_j = (jax.tree_util.tree_map(
            np.asarray, t) for t in (stats_j, grads_j, params_j))

    model = load_jax_variables(PointTransformerSeg(4, 4, **SMALL), variables)
    trainer = ModelTrainer(model, _small_dataset(), get_loss_fn(
        "nnunet", _t(cw)), str(tmp_path), TrainConfig(lr=LR, weight_decay=WD),
        device="cpu")
    loss, comps = trainer.train_step(_t(x), _t(y).long())
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    for name in ("CE", "GDL"):
        np.testing.assert_allclose(float(comps[name]), comps_j[name],
                                   rtol=1e-5, err_msg=name)
    grads_t = export_jax_variables(model, grad=True)["params"]
    gap = np.sqrt(sum(np.sum((g - gj) ** 2) for (_, g), (_, gj)
                      in zip(_leaves(grads_t), _leaves(grads_j))))
    norm = np.sqrt(sum(np.sum(gj ** 2) for _, gj in _leaves(grads_j)))
    assert gap <= 0.05 * norm, (gap, norm)           # measured 0.008
    got = export_jax_variables(model)
    _assert_trees_close(got["batch_stats"], stats_j, **TOL)
    with jax.default_matmul_precision("float32"):
        upd_t, _ = tx.update(grads_t, tx.init(variables["params"]),
                             variables["params"])
        from_port_grads = optax.apply_updates(variables["params"], upd_t)
    _assert_trees_close(got["params"], from_port_grads, rtol=1e-6,
                        atol=1e-6)
    n_held = n_all = 0
    for (path, p), (_, pj), (_, g), (_, gj), (_, p0) in zip(
            _leaves(got["params"]), _leaves(params_j), _leaves(grads_t),
            _leaves(grads_j), _leaves(variables["params"])):
        a, b = g + WD * p0, gj + WD * p0                 # Adam's inputs
        held = (np.sign(a) == np.sign(b)) & \
            (np.minimum(np.abs(a), np.abs(b)) > ADAM_PINNED)
        np.testing.assert_allclose(p[held], pj[held], err_msg=path, **TOL)
        n_held, n_all = n_held + held.sum(), n_all + held.size
    assert n_held > 0.8 * n_all, (n_held, n_all)


def test_model_registry_and_unported_dtype():
    assert get_point_seg_model_class("DGCNN") is DGCNNSeg
    assert get_point_seg_model_class("PointTransformer") is \
        PointTransformerSeg
    from fissure_segmentation_tpu_torch.models import PointNetSeg
    assert get_point_seg_model_class("PointNet") is PointNetSeg
    with pytest.raises(ValueError, match="unknown"):
        get_point_seg_model_class("nope")
    # bf16 is ported (tests/test_torch_helpers.py holds it); float16 is no
    # compute dtype of the port
    assert PointTransformerSeg(3, 4, dtype=torch.bfloat16).config[
        "dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="dtype"):
        PointTransformerSeg(3, 4, dtype=torch.float16)


# ---- the training entry point ----------------------------------------------

def test_entry_point_trains_point_transformer(tmp_path):
    """`--model PointTransformer` at 256 points, batch 2, 2 epochs through
    `run(args, device="cpu")` writes model.pt; load_model rebuilds the
    model, which gives the trained model's logits exactly. `--amp true`
    (the CLI default) without `--static` is accepted: PT trains in
    float32."""
    for c in synthetic.make_synthetic_dataset(5, n_points=300):
        dataset.save_case_npz(c, str(tmp_path / "cases"))
    out = tmp_path / "run"
    argv = ["--model", "PointTransformer", "--data_dir",
            str(tmp_path / "cases"), "--pts", "256", "--batch", "2",
            "--epochs", "2", "--train_only", "--fold", "0", "--amp", "true",
            "--output", str(out)]
    args = train_point_seg.get_point_segmentation_parser().parse_args(argv)
    trained = train_point_seg.run(args, device="cpu")[0].eval()
    for f in ("commandline_args.json", "fold0/model.pt", "fold0/history.csv"):
        assert os.path.exists(out / f), f
    model = load_model(str(out / "fold0" / "model.pt"),
                       get_point_seg_model_class("PointTransformer"))
    assert isinstance(trained, PointTransformerSeg)
    assert model.config == dict(in_features=4, num_classes=4,
                                blocks=[2, 3, 4, 6, 3],
                                planes=[32, 64, 128, 256, 512],
                                strides=[1, 4, 4, 4, 4],
                                nsamples=[8, 16, 16, 16, 16], share_planes=8)
    x = torch.from_numpy(_dyadic(np.random.default_rng(4), (1, 256, 4)))
    with torch.no_grad():
        assert torch.equal(model(x), trained(x))
