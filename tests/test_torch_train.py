"""Port parity for the DGCNNSeg training slice: BatchNorm in train mode,
the fused EdgeConv core, one Adam step of the whole model (unfused and
fused), the losses, batch sampling and augmentation, the synthetic point
dataset, splits and class weights, the schedulers and Adam, the trainer,
and the entry point.

The same numpy-seeded inputs go through the JAX package (matmuls at float32
precision; Pallas kernels in interpret mode) and through
fissure_segmentation_tpu_torch on the CPU (plain kernel versions). Random
draws are injected: jax.random cannot be replayed in torch. Each test
states its tolerance; the model-level ones (2e-4) follow
tests/test_torch_models.py, whose dyadic coordinates make both sides build
the same kNN graph.
"""
import csv
import os
import subprocess
import sys
import textwrap

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fissure_segmentation_tpu.data import dataset as jdataset
from fissure_segmentation_tpu.data import synthetic as jsynthetic
from fissure_segmentation_tpu.data.augmentation import \
    random_transform as jrandom_transform
from fissure_segmentation_tpu.data.augmentation import \
    so3_exp_map as jso3_exp_map
from fissure_segmentation_tpu.data.store import build_store as jbuild_store
from fissure_segmentation_tpu.data.store import sample_batch as jsample_batch
from fissure_segmentation_tpu.losses import segmentation as jlosses
from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu.models.dgcnn import EdgeConv as JEdgeConv
from fissure_segmentation_tpu.ops.fused_edge import \
    fused_edge_train as jfused_edge_train
from fissure_segmentation_tpu.train.trainer import \
    _PlateauScheduler as JPlateau
from fissure_segmentation_tpu_torch import train_point_seg
from fissure_segmentation_tpu_torch.data import dataset, synthetic
from fissure_segmentation_tpu_torch.data.augmentation import (
    SimilarityTransform, point_augmentation, so3_exp_map)
from fissure_segmentation_tpu_torch.data.store import (build_store,
                                                       sample_batch)
from fissure_segmentation_tpu_torch.losses import get_loss_fn
from fissure_segmentation_tpu_torch.losses import segmentation as losses
from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                   export_jax_variables,
                                                   load_jax_variables,
                                                   load_model)
from fissure_segmentation_tpu_torch.models.blocks import BatchNorm
from fissure_segmentation_tpu_torch.models.dgcnn import EdgeConv
from fissure_segmentation_tpu_torch.ops.fused_edge import (fused_edge_enabled,
                                                           fused_edge_train)
from fissure_segmentation_tpu_torch.train.trainer import (ModelTrainer,
                                                          PlateauScheduler,
                                                          TrainConfig)

TOL = dict(rtol=2e-4, atol=2e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD = 1e-3, 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_trees_close(got, want, path="", **tol):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], f"{path}{k}/", **tol)
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       err_msg=f"{path}{k}", **tol)


def _leaves(tree, path=""):
    """(path, leaf) pairs of a nested dict, in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", tree[k]


def _dyadic_cloud(rng, shape):
    return (rng.integers(-16, 17, shape) / 16.0).astype(np.float32)


@pytest.fixture
def routing(monkeypatch):
    """Set FSEG_FUSED_EDGE for both packages; the JAX fused tail stays off
    (it is not ported)."""
    monkeypatch.delenv("FSEG_FUSED_EDGE_TAIL", raising=False)

    def set_fused(on: bool):
        monkeypatch.setenv("FSEG_FUSED_EDGE", "1" if on else "0")
    return set_fused


# ---- BatchNorm ------------------------------------------------------------

def test_batchnorm_train_matches_flax():
    """Output, batch-statistics gradient path and running update against
    flax nn.BatchNorm (momentum 0.9, eps 1e-5) over (B, N, k): float32 sums
    in another order, so rtol = atol = 1e-5."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 16, 5, 8)) * 2 + 0.5).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.normal(1, 0.3, 8).astype(np.float32)
    bias = rng.normal(0, 0.3, 8).astype(np.float32)
    ra_mean = rng.normal(0, 0.3, 8).astype(np.float32)
    ra_var = rng.uniform(0.5, 2, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}

    def jloss(params, x):
        y, mut = bn.apply({**variables, "params": params}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (y_j, stats_j)), (g_params, g_x) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"],
                                             jnp.asarray(x))
    tbn = load_jax_variables(BatchNorm(8), variables).train()
    xt = _t(x).requires_grad_(True)
    y_t = tbn(xt)
    (y_t * _t(w)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, **tol)
    np.testing.assert_allclose(xt.grad.numpy(), g_x, **tol)
    np.testing.assert_allclose(tbn.scale.grad.numpy(), g_params["scale"],
                               **tol)
    np.testing.assert_allclose(tbn.bias.grad.numpy(), g_params["bias"], **tol)
    _assert_trees_close(export_jax_variables(tbn)["batch_stats"],
                        stats_j, **tol)


# ---- fused EdgeConv -------------------------------------------------------

def _fused_case(rng, b=2, n=64, kk=7, c=24, ties=False):
    a = rng.normal(size=(b, n, c)).astype(np.float32)
    cen = rng.normal(size=(b, n, c)).astype(np.float32)
    gamma = (rng.normal(size=c) + 0.3).astype(np.float32)   # some < 0
    beta = (rng.normal(size=c) * 0.2).astype(np.float32)
    idx = rng.integers(0, n, size=(b, n, kk)).astype(np.int32)
    if ties:
        # duplicate points: rows 1..3 repeat row 0, and every node sees two
        # of the copies, so max and min tie between slots
        a[:, 1:4] = a[:, :1]
        idx[:, :, 2] = rng.integers(0, 4, size=(b, n))
        idx[:, :, 5] = rng.integers(0, 4, size=(b, n))
    return a, cen, gamma, beta, idx


@pytest.mark.parametrize("ties", [False, True], ids=["generic", "ties"])
def test_fused_edge_train_matches_jax(routing, ties):
    """fused_edge_train forward (out, batch mean, var) and backward (da,
    dcen, dgamma, dbeta) against the JAX function. With ties the gradient
    must go to the FIRST extremal slot on both sides. The JAX backward
    splits f32 payloads into hi + lo bf16 halves (~16 bits): rtol = atol =
    2e-4 for the gradients, 1e-5 for the forward."""
    routing(True)
    rng = np.random.default_rng(5 + ties)
    a, cen, gamma, beta, idx = _fused_case(rng, ties=ties)
    w = rng.normal(size=a.shape).astype(np.float32)

    def jloss(a, cen, gamma, beta):
        out, mean, var = jfused_edge_train(a, cen, gamma, beta,
                                           jnp.asarray(idx), 1e-5, 0.2)
        return jnp.sum(out * w), (out, mean, var)

    (_, (out_j, mean_j, var_j)), grads_j = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(a, cen, gamma, beta)
    ins = [_t(v).requires_grad_(True) for v in (a, cen, gamma, beta)]
    out, mean, var = fused_edge_train(*ins, _t(idx), 1e-5, 0.2)
    (out * _t(w)).sum().backward()
    fwd = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), out_j, **fwd)
    np.testing.assert_allclose(mean.numpy(), mean_j, **fwd)
    np.testing.assert_allclose(var.numpy(), var_j, **fwd)
    assert not mean.requires_grad and not var.requires_grad
    for t, g, name in zip(ins, grads_j, ("a", "cen", "gamma", "beta")):
        np.testing.assert_allclose(t.grad.numpy(), g, err_msg=name, **TOL)


def test_edgeconv_routes_by_env(routing):
    """FSEG_FUSED_EDGE is read at every call, both ways; without it the CPU
    takes the unfused route (CUDA's default is measured, PERF.md)."""
    routing(True)
    assert fused_edge_enabled("cpu") and fused_edge_enabled("cuda")
    routing(False)
    assert not fused_edge_enabled("cpu") and not fused_edge_enabled("cuda")
    os.environ.pop("FSEG_FUSED_EDGE")
    assert not fused_edge_enabled("cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_edgeconv_module_train_matches_jax(routing, fused):
    """A single-layer EdgeConv module in train mode: output, parameter
    gradients and running statistics, on both routes."""
    routing(fused)
    rng = np.random.default_rng(12)
    b, n, k = 2, 48, 6
    x = rng.normal(size=(b, n, 8)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, n, k)).astype(np.int32)
    w = rng.normal(size=(b, n, 16)).astype(np.float32)
    jm = JEdgeConv([16], k=k)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), x, idx, True))

    def jloss(params):
        out, mut = jm.apply({**variables, "params": params}, x, idx, True,
                            mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"])

    with jax.default_matmul_precision("float32"):
        (_, (out_j, stats_j)), grads_j = jax.value_and_grad(
            jloss, has_aux=True)(variables["params"])
    tm = load_jax_variables(EdgeConv(8, [16]), variables).train()
    out = tm(_t(x), _t(idx))
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_j, **TOL)
    _assert_trees_close(export_jax_variables(tm, grad=True)["params"],
                        grads_j, **TOL)
    _assert_trees_close(export_jax_variables(tm)["batch_stats"], stats_j,
                        **TOL)


# ---- the eval model with grad enabled ---------------------------------------

def _eval_variables(jm, rng, in_features):
    """JAX DGCNNSeg variables with numpy-randomized BatchNorm scale, bias
    and running statistics (as tests/test_torch_models.py draws them), so
    both signs of the scale take the max and the min route."""
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, in_features), jnp.float32)))

    def randomize(path, leaf):
        name = jax.tree_util.keystr(path)
        if "BatchNorm" not in name:
            return leaf
        if "var" in name:
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.3, leaf.shape).astype(np.float32) + \
            (1.0 if "scale" in name else 0.0)
    return jax.tree_util.tree_map_with_path(randomize, variables)


def test_dgcnn_eval_with_grad_matches_jax(routing):
    """DGCNNSeg.eval() with grad enabled on the fused EdgeConv route: the
    logits and the input and parameter gradients against jax.grad of the
    JAX eval model (fused route too) and against the port's unfused route,
    within the eval-parity tolerance (2e-4, tests/test_torch_models.py)."""
    rng = np.random.default_rng(21)
    k, b, n, f = 6, 2, 64, 3
    jm = JDGCNNSeg(k=k, in_features=f, num_classes=4, dynamic=False)
    variables = _eval_variables(jm, rng, f)
    x = _dyadic_cloud(rng, (b, n, f))
    w = rng.normal(size=(b, n, 4)).astype(np.float32)

    def jloss(params, xx):
        out = jm.apply({**variables, "params": params}, xx, train=False)
        return jnp.sum(out * w), out

    routing(True)
    with jax.default_matmul_precision("float32"):
        (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(variables["params"],
                                                 jnp.asarray(x))

    def port(fused: bool):
        routing(fused)
        tm = load_jax_variables(DGCNNSeg(k=k, in_features=f, num_classes=4,
                                         dynamic=False),
                                variables).eval()
        xt = _t(x).requires_grad_(True)
        out = tm(xt)
        (out * _t(w)).sum().backward()
        return (out.detach().numpy(), xt.grad.numpy(),
                export_jax_variables(tm, grad=True)["params"])

    out_f, gx_f, gp_f = port(True)
    np.testing.assert_allclose(out_f, out_j, **TOL)
    np.testing.assert_allclose(gx_f, gx_j, **TOL)
    _assert_trees_close(gp_f, gp_j, **TOL)
    out_u, gx_u, gp_u = port(False)
    np.testing.assert_allclose(out_f, out_u, **TOL)
    np.testing.assert_allclose(gx_f, gx_u, **TOL)
    _assert_trees_close(gp_f, gp_u, **TOL)


# ---- one Adam step of the whole model --------------------------------------

def _small_dataset(n_cases=4, n_points=300, sample_points=64):
    cases = synthetic.make_synthetic_dataset(n_cases, n_points=n_points)
    return dataset.PointDataset(cases, sample_points=sample_points)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_dgcnn_adam_step_matches_jax(routing, tmp_path, fused):
    """One NNU-loss Adam + weight-decay step of DGCNNSeg(k=6, static) from
    the same weights on the same batch: loss and CE/GDL within rtol 1e-5;
    every gradient, updated parameter and running statistic within
    rtol = atol = 2e-4."""
    routing(fused)
    rng = np.random.default_rng(20)
    jm = JDGCNNSeg(k=6, in_features=4, num_classes=4, dynamic=False)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 4), jnp.float32)))
    x = _dyadic_cloud(rng, (2, 64, 4))
    y = rng.integers(0, 4, (2, 64)).astype(np.int32)
    cw = np.asarray([0.4, 1.2, 1.1, 1.3], np.float32)
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))

    def jloss(params):
        out, mut = jm.apply({**variables, "params": params}, x, train=True,
                            mutable=["batch_stats"])
        loss, comps = jlosses.nnu_loss(out, y, jnp.asarray(cw))
        return loss, (comps, mut["batch_stats"])

    with jax.default_matmul_precision("float32"):
        (loss_j, (comps_j, stats_j)), grads_j = jax.value_and_grad(
            jloss, has_aux=True)(variables["params"])
        updates, _ = tx.update(grads_j, tx.init(variables["params"]),
                               variables["params"])
        params_j = optax.apply_updates(variables["params"], updates)

    model = load_jax_variables(DGCNNSeg(k=6, in_features=4, num_classes=4,
                                        dynamic=False),
                               variables)
    trainer = ModelTrainer(model, _small_dataset(), get_loss_fn(
        "nnunet", _t(cw)), str(tmp_path), TrainConfig(lr=LR, weight_decay=WD),
        device="cpu")
    loss, comps = trainer.train_step(_t(x), _t(y).long())
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for name in ("CE", "GDL"):
        np.testing.assert_allclose(float(comps[name]), float(comps_j[name]),
                                   rtol=1e-5, err_msg=name)
    grads_t = export_jax_variables(model, grad=True)["params"]
    _assert_trees_close(grads_t, grads_j, **TOL)
    got = export_jax_variables(model)
    _assert_trees_close(got["batch_stats"], stats_j, **TOL)
    # Adam's first step is lr * g / (|g| + eps), about lr * sign(g): where a
    # gradient is float32 noise around zero (the SharedMLP_0 BatchNorm bias
    # gets an exactly-zero gradient — the next BatchNorm removes any shift),
    # the two updates differ by up to 2 lr whatever the port does. The sign
    # of g is only pinned where |g| exceeds the gradients' own tolerance, so
    # the updated parameters are held to the JAX ones where |g| > 2e-4, and
    # everywhere to optax's update of the port's own gradients.
    with jax.default_matmul_precision("float32"):
        upd_t, _ = tx.update(grads_t, tx.init(variables["params"]),
                             variables["params"])
        from_port_grads = optax.apply_updates(variables["params"], upd_t)
    _assert_trees_close(got["params"], from_port_grads, rtol=1e-6,
                        atol=1e-6)
    n_held = n_all = 0
    for (path, p), (_, pj), (_, gj) in zip(_leaves(got["params"]),
                                           _leaves(params_j),
                                           _leaves(grads_j)):
        held = np.abs(np.asarray(gj)) > TOL["atol"]
        np.testing.assert_allclose(p[held], np.asarray(pj)[held],
                                   err_msg=path, **TOL)
        n_held, n_all = n_held + held.sum(), n_all + held.size
    assert n_held > 0.9 * n_all, (n_held, n_all)


def test_adam_weight_decay_matches_optax():
    """Three steps of torch Adam(weight_decay) against optax
    add_decayed_weights + adam on a fixed quadratic: rtol = atol = 1e-6."""
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    target = rng.normal(size=(5, 3)).astype(np.float32)
    wd = 1e-2
    tx = optax.chain(optax.add_decayed_weights(wd), optax.adam(LR))
    p_j, state = jnp.asarray(p0), None
    state = tx.init(p_j)
    p_t = torch.nn.Parameter(_t(p0))
    opt = torch.optim.Adam([p_t], lr=LR, weight_decay=wd)
    for _ in range(3):
        g = jax.grad(lambda p: jnp.sum((p - target) ** 3))(p_j)
        upd, state = tx.update(g, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        opt.zero_grad()
        ((p_t - _t(target)) ** 3).sum().backward()
        opt.step()
        np.testing.assert_allclose(p_t.detach().numpy(), p_j, rtol=1e-6,
                                   atol=1e-6)


def test_plateau_scheduler_matches_jax():
    metrics = [1.0, 0.9, 0.9, 0.95, 0.9, 0.8999, 0.91, 0.92, 0.93, 0.5,
               0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 0.4, 0.4, 0.4]
    kw = dict(lr=1e-3, factor=0.8, patience=2, threshold=1e-4, cooldown=1,
              min_lr=6e-4)
    a, b = PlateauScheduler(**kw), JPlateau(**kw)
    assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]
    assert a.lr == kw["min_lr"]


# ---- losses ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["ce", "ce_weighted", "gdl", "nnu",
                                  "nnu_weighted", "recall"])
def test_losses_match_jax(name):
    """Value and logit gradient of each loss: rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 50, 4)) * 3).astype(np.float32)
    y = rng.integers(0, 4, (2, 50)).astype(np.int32)
    cw = rng.uniform(0.2, 2.0, 4).astype(np.float32)
    fns = {
        "ce": (jlosses.cross_entropy, losses.cross_entropy, {}),
        "ce_weighted": (jlosses.cross_entropy, losses.cross_entropy,
                        {"class_weights": cw}),
        "gdl": (jlosses.generalized_dice_loss,
                losses.generalized_dice_loss, {}),
        "nnu": (jlosses.nnu_loss, losses.nnu_loss, {}),
        "nnu_weighted": (jlosses.nnu_loss, losses.nnu_loss,
                         {"class_weights": cw}),
        "recall": (jlosses.batch_recall_loss, losses.batch_recall_loss, {}),
    }
    jfn, tfn, kw = fns[name]
    (lj, cj), gj = jax.value_and_grad(
        lambda lg: jfn(lg, jnp.asarray(y),
                       **{k: jnp.asarray(v) for k, v in kw.items()}),
        has_aux=True)(jnp.asarray(logits))
    lt_in = _t(logits).requires_grad_(True)
    lt, ct = tfn(lt_in, _t(y), **{k: _t(v) for k, v in kw.items()})
    lt.backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(lt.detach()), float(lj), **tol)
    assert set(ct) == set(cj)
    for k in cj:
        np.testing.assert_allclose(float(ct[k].detach()), float(cj[k]), **tol)
    np.testing.assert_allclose(lt_in.grad.numpy(), gj, **tol)


def test_loss_registry():
    cw = torch.ones(4)
    logits, y = torch.zeros((1, 5, 4)), torch.zeros((1, 5), dtype=torch.long)
    assert set(get_loss_fn("nnunet", cw)(logits, y)[1]) == {"CE", "GDL"}
    assert set(get_loss_fn("ce", cw)(logits, y)[1]) == {"CE"}
    assert set(get_loss_fn("recall")(logits, y)[1]) == {"Recall-CE"}
    pts = torch.zeros((1, 5, 3))
    dpsr = get_loss_fn("dpsr", cw)((logits, pts, torch.ones(1, 5, dtype=bool)),
                                   (y, pts))
    assert set(dpsr[1]) == {"Segmentation", "Chamfer"}
    affine = torch.zeros((1, 9))
    ssm = get_loss_fn("ssm")((pts, torch.zeros((1, 2)), affine),
                             (pts, torch.zeros((1, 2)), affine))
    assert set(ssm[1]) == {"Point-Loss", "Coefficients", "Affine-Params"}
    assert set(get_loss_fn("chamfer")(pts, pts)[1]) == {"Chamfer"}
    assert callable(get_loss_fn("mesh", term_weights=[1.0, 1.0, 0.1, 0.1]))
    with pytest.raises(ValueError, match="No loss"):
        get_loss_fn("nope")


# ---- data ------------------------------------------------------------------

def test_synthetic_point_dataset_bit_equal():
    a = jsynthetic.make_synthetic_dataset(2, n_points=400, seed=3,
                                          gt_surfaces=True)
    b = synthetic.make_synthetic_dataset(2, n_points=400, seed=3,
                                         gt_surfaces=True)
    for ca, cb in zip(a, b):
        assert set(ca) == set(cb)
        for k in ("coords", "labels", "features"):
            np.testing.assert_array_equal(cb[k], ca[k])
            assert cb[k].dtype == ca[k].dtype
        for lbl in ca["gt_surfaces"]:
            np.testing.assert_array_equal(cb["gt_surfaces"][lbl],
                                          ca["gt_surfaces"][lbl])
        assert cb["surface_params"] == ca["surface_params"]
        np.testing.assert_array_equal(
            synthetic.gt_surface_points(cb, 2, n=300),
            jsynthetic.gt_surface_points(ca, 2, n=300))


def test_dataset_weights_splits_and_files(tmp_path):
    cases = synthetic.make_synthetic_dataset(6, n_points=200)
    for kw in ({}, {"binary": True}, {"exclude_rhf": True}):
        ds = dataset.PointDataset([dict(c) for c in cases], **kw)
        jds = jdataset.PointDataset([dict(c) for c in cases], **kw)
        np.testing.assert_array_equal(ds.get_class_weights(),
                                      jds.get_class_weights())
        assert (ds.num_classes, ds.n_features) == (jds.num_classes,
                                                   jds.n_features)
    ds = dataset.PointDataset(cases)
    split = dataset.create_split(ds.ids, k=3)
    assert split == jdataset.create_split(ds.ids, k=3)
    tr, vl = ds.split_data_set(split[1])
    jtr, jvl = jdataset.PointDataset(cases).split_data_set(split[1])
    assert tr.ids == jtr.ids and vl.ids == jvl.ids and not vl.do_augmentation
    path = str(tmp_path / "split.json")
    dataset.save_split_file(split, path)
    assert [{k: [tuple(i) for i in v] for k, v in s.items()}
            for s in jdataset.load_split_file(path)] == split
    f = dataset.save_case_npz(cases[0], str(tmp_path / "cases"))
    back = jdataset.load_case_npz(f)
    np.testing.assert_array_equal(back["coords"], cases[0]["coords"])
    again = dataset.load_case_npz(f)
    assert again["surface_params"] == cases[0]["surface_params"]


def test_sample_batch_with_injected_draws_matches_jax():
    """The JAX draws (subset noise, augmentation transform) injected into
    the port: the same points in the same order, coordinates within 1e-6."""
    cases = synthetic.make_synthetic_dataset(3, n_points=300)
    jstore = jbuild_store(cases)
    store = build_store(cases)
    assert store.coords.shape == jstore.coords.shape     # 128-lane padding
    case_idx = np.asarray([2, 0, 2, 1])
    key = jax.random.PRNGKey(5)
    xj, yj = jsample_batch(key, jstore, jnp.asarray(case_idx), 100)
    r_sample, r_aug = jax.random.split(key)
    noise = jax.random.uniform(r_sample, (4, jstore.coords.shape[1]))
    tj = jrandom_transform(r_aug, (4,))
    t = SimilarityTransform(*(_t(v) for v in tj))
    xt, yt = sample_batch(store, _t(case_idx), 100, noise=_t(noise),
                          transform=t)
    np.testing.assert_array_equal(yt.numpy(), yj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-6, atol=1e-6)
    xb, yb = sample_batch(store, _t(case_idx), 100, noise=_t(noise),
                          augment=False, binary=True)
    np.testing.assert_array_equal(yb.numpy(), np.asarray(yj) != 0)
    np.testing.assert_array_equal(
        xb.numpy()[..., 3:], xj[..., 3:])        # features pass unchanged


def test_augmentation_matches_jax():
    """so3_exp_map and point_augmentation with the JAX transform injected:
    rtol = atol = 1e-6; a drawn transform is a similarity."""
    rng = np.random.default_rng(9)
    log_rot = rng.normal(size=(6, 3)).astype(np.float32)
    log_rot[0] = 0.0
    np.testing.assert_allclose(so3_exp_map(_t(log_rot)).numpy(),
                               jso3_exp_map(jnp.asarray(log_rot)),
                               rtol=1e-6, atol=1e-6)
    pts = rng.uniform(-1, 1, (3, 40, 3)).astype(np.float32)
    tj = jrandom_transform(jax.random.PRNGKey(2), (3,))
    from fissure_segmentation_tpu.data.augmentation import transform_points
    want = transform_points(jnp.asarray(pts), tj)
    got, _ = point_augmentation(_t(pts), transform=SimilarityTransform(
        *(_t(v) for v in tj)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    drawn, t = point_augmentation(_t(pts), torch.Generator().manual_seed(0))
    d0 = torch.cdist(_t(pts), _t(pts))
    d1 = torch.cdist(drawn, drawn)
    for i in range(3):
        far = d0[i] > 0.1
        ratio = d1[i][far] / d0[i][far]
        assert torch.allclose(ratio, t.scaling[i].expand_as(ratio),
                              atol=1e-4)
    assert ((t.scaling >= 0.9) & (t.scaling <= 1.0)).all()


# ---- trainer and entry point -----------------------------------------------

def _train(out_dir, epochs, checkpoint_every=None, resume=False):
    ds = _small_dataset(n_cases=5, n_points=200, sample_points=48)
    model = DGCNNSeg(k=4, in_features=4, num_classes=ds.num_classes,
                     dynamic=False,
                     generator=torch.Generator().manual_seed(0))
    trainer = ModelTrainer(
        model, ds, get_loss_fn("nnunet", _t(ds.get_class_weights())),
        str(out_dir), TrainConfig(epochs=epochs, batch_size=2,
                                  scheduler="cosine", seed=3,
                                  checkpoint_every=checkpoint_every),
        device="cpu")
    trainer.run(resume=resume)
    return trainer


def test_trainer_writes_artifacts_and_resumes(tmp_path):
    """Two epochs on the CPU write model.pt, history.csv and
    train_time.csv; a run stopped after epoch 0 and resumed from its
    checkpoint ends in the same state as the uninterrupted run (the same
    code on the same device: equal)."""
    full = _train(tmp_path / "full", 2)
    for f in ("model.pt", "history.csv", "train_time.csv"):
        assert os.path.exists(tmp_path / "full" / f), f
    with open(tmp_path / "full" / "history.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["train_CE", "train_GDL", "train_total_loss",
                       "val_CE", "val_GDL", "val_total_loss"]
    assert len(rows) == 3 and all(np.isfinite(float(v)) for v in rows[2])
    assert full.steps_per_epoch == 2 and len(full.val_indices) == 1

    _train(tmp_path / "resumed", 1, checkpoint_every=1)
    resumed = _train(tmp_path / "resumed", 2, resume=True)
    assert resumed.training_history == full.training_history
    assert resumed.validation_history == full.validation_history
    for (k, a), (_, b) in zip(full.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), k
    loaded = load_model(str(tmp_path / "full" / "model.pt"), DGCNNSeg)
    _assert_trees_close(export_jax_variables(loaded),
                        export_jax_variables(full.model), rtol=0, atol=0)


ENTRY = ["--static", "--amp", "false", "--train_only", "--fold", "0"]


@pytest.mark.parametrize("extra,match", [
    (["--transformer"], None),
    (["--img_feat_extractor"], None),
    (["--knn_recall", "0.9"], None),
    (["--dp"], None),
    (["--visualize", "1"], None),
    (["--model", "PointNet"], None),
], ids=["transformer", "img_feat_extractor", "knn_recall", "dp",
        "visualize", "pointnet"])
def test_entry_point_raises_for_unported_options(tmp_path, extra, match):
    """Options still unported raise before anything is written (none of
    these is left). The ported ones (`--transformer`,
    `--img_feat_extractor`, `--knn_recall`, `--model PointNet`, `--dp`,
    `--visualize`) train fold 0 for one epoch on the CPU and write model.pt
    with the option in the model's config; `--dp` on one device trains as
    without it, and `--visualize 1` draws epoch 0's figure where
    matplotlib imports."""
    argv = list(ENTRY) + extra + ["--output", str(tmp_path)]
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            train_point_seg.main(argv)
        assert not os.listdir(tmp_path)     # raised before writing anything
        return
    # 10 cases leave fold 0's trainer a validation case to draw
    n_cases = 10 if extra[0] == "--visualize" else 5
    for c in synthetic.make_synthetic_dataset(n_cases, n_points=150):
        dataset.save_case_npz(c, str(tmp_path / "cases"))
    argv += ["--data_dir", str(tmp_path / "cases"), "--pts", "48", "--k",
             "4", "--batch", "2", "--epochs", "1"]
    assert train_point_seg.main(argv, device="cpu") == 0
    config = load_model(str(tmp_path / "fold0" / "model.pt")).config
    if extra[0] == "--visualize":
        from fissure_segmentation_tpu_torch.utils.visualization import \
            matplotlib_available
        assert (tmp_path / "fold0" / "visualizations" / "epoch0.png"
                ).exists() == matplotlib_available()
        return
    if extra[0] == "--dp":
        assert config["k"] == 4 and not config["dynamic"]
        return
    want = {"--transformer": ("spatial_transformer", True),
            "--img_feat_extractor": ("image_feat_module", True),
            "--knn_recall": ("knn_recall", 0.9),
            "--model": ("spatial_transform", False)}[extra[0]]
    assert config[want[0]] == want[1]
    assert type(config[want[0]]) is type(want[1])


def test_entry_point_trains_a_fold_with_amp(tmp_path, monkeypatch):
    """`--amp true` (the CLI default) trains DGCNN with the bf16 compute
    dtype, as the JAX entry does: `main(argv, device="cpu")` trains one
    epoch of fold 0; the model it built is DGCNNSeg(dtype=bf16) with float32
    parameters, its EdgeConvs returned bf16 in every training forward, and
    model.pt keeps the dtype."""
    built, seen = [], []
    build = train_point_seg.build_model

    def build_and_watch(*args, **kwargs):
        model = build(*args, **kwargs)
        model.EdgeConv_1.register_forward_hook(
            lambda m, i, o: seen.append((m.training, o.dtype)))
        built.append(model)
        return model
    monkeypatch.setattr(train_point_seg, "build_model", build_and_watch)
    argv = ["--static", "--amp", "true", "--train_only", "--fold", "0",
            "--ds", "synthetic", "--pts", "48", "--k", "4", "--batch", "2",
            "--epochs", "1", "--output", str(tmp_path)]
    assert train_point_seg.main(argv, device="cpu") == 0
    (model,) = built
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert (True, torch.bfloat16) in seen
    assert {dtype for _, dtype in seen} == {torch.bfloat16}
    loaded = load_model(str(tmp_path / "fold0" / "model.pt"), DGCNNSeg)
    assert loaded.dtype == torch.bfloat16
    assert loaded.config["dtype"] == "bfloat16"


def test_entry_point_trains_a_fold_without_jax(tmp_path):
    """The training entry point (`main(argv, device="cpu")`, what `python
    -m fissure_segmentation_tpu_torch.train_point_seg` runs, on the CPU as
    a caller must ask for) on a --data_dir of five small cases, in a fresh
    interpreter: fold 0 trains one epoch, writes its artifacts, and jax,
    flax and the JAX package stay unloaded."""
    for c in synthetic.make_synthetic_dataset(5, n_points=150):
        dataset.save_case_npz(c, str(tmp_path / "cases"))
    out = tmp_path / "run"
    argv = ENTRY + ["--data_dir", str(tmp_path / "cases"), "--pts", "48",
                    "--k", "4", "--batch", "2", "--epochs", "1",
                    "--output", str(out)]
    code = textwrap.dedent(f"""
        import sys
        from fissure_segmentation_tpu_torch import train_point_seg
        assert train_point_seg.main({argv!r}, device="cpu") == 0
        bad = [m for m in ("jax", "flax", "fissure_segmentation_tpu")
               if m in sys.modules]
        assert not bad, bad
        print("OK")
        """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), \
        res.stderr[-3000:]
    for f in ("commandline_args.json", "cross_val_split.json",
              "fold0/model.pt", "fold0/history.csv"):
        assert os.path.exists(out / f), f
    model = load_model(str(out / "fold0" / "model.pt"), DGCNNSeg)
    assert model.config == dict(k=4, in_features=4, num_classes=4,
                                dynamic=False)
