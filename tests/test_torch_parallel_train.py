"""Data-parallel training in the port (train/trainer.py `group=`, the
global-batch BatchNorm, fused EdgeConv and losses) against the JAX
package's data-parallel step, on the CPU: the port on 4 gloo ranks (one
spawn for the file, tests/torch_parallel_ranks.py:dp_step_rank), JAX's
jitted step with the batch sharded over a virtual 4-device mesh.

  * one NNU-loss Adam + weight-decay step of DGCNNSeg(k=6, static) from
    the same weights on the same injected batch (dyadic coordinates, as
    tests/test_torch_train.py's single-device step, so both packages take
    the same branches), unfused and fused: the loss and CE/GDL within
    rtol 1e-5; every gradient and running statistic within rtol = atol =
    2e-4 (the single-device step's tolerance);
  * a batch whose shards differ in class balance and in position: the
    port's global loss and gradient are JAX's, and those of a plain-DDP
    port (per-rank loss and BatchNorm, the ranks' mean) miss them by far
    more than the tolerance;
  * the same step with the fused EdgeConv tail on in both packages
    (FSEG_FUSED_EDGE_TAIL=1: its statistics are summed over the group),
    within the same tolerances;
  * the per-sample generalized Dice loss (batch_dice=False) under the
    group: the mean over the global batch of each sample's Dice, against
    JAX's on the whole batch: the loss within rtol 1e-6, each rank's rows
    of the logits' gradient within rtol = atol = 1e-7;
  * 3 epochs of the data-parallel trainer against the single-device one at
    the same seed: the histories within JAX's data-parallel bound (rtol =
    atol = 3e-2, __graft_entry__.py:dryrun_multichip), rank 0 alone writing
    the run's files.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from fissure_segmentation_tpu.losses import segmentation as jlosses
from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu.parallel import make_mesh as jmake_mesh
from fissure_segmentation_tpu_torch.parallel import spawn

import torch_parallel_ranks

N_DEV, SHARE = 4, 2
LR, WD = 1e-3, 1e-5
TOL = dict(rtol=2e-4, atol=2e-4)
CW = np.asarray([0.4, 1.2, 1.1, 1.3], np.float32)
TRAIN_CFG = dict(epochs=3, lr=1e-3, batch_size=4, scheduler="cosine",
                 show_every=100, seed=0)


def _dyadic_cloud(rng, shape):
    return (rng.integers(-16, 17, shape) / 16.0).astype(np.float32)


def _assert_trees_close(got, want, path="", **tol):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], f"{path}{k}/", **tol)
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       err_msg=f"{path}{k}", **tol)


def _flat(tree):
    if isinstance(tree, dict):
        return np.concatenate([_flat(tree[k]) for k in sorted(tree)])
    return np.asarray(tree, np.float64).ravel()


def _rel_l2(got, want):
    """|got - want| / |want| over every leaf of two trees."""
    g, w = _flat(got), _flat(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(20)
    jm = JDGCNNSeg(k=6, in_features=4, num_classes=4, dynamic=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 4), jnp.float32))))
    b = N_DEV * SHARE
    x = _dyadic_cloud(rng, (b, 64, 4))
    y = rng.integers(0, 4, (b, 64)).astype(np.int32)
    # shards of other class balance and position: rank r's rows hold
    # classes r and 0 only, shifted by r / 2
    xu = _dyadic_cloud(rng, (b, 64, 4))
    yu = np.zeros((b, 64), np.int32)
    for r in range(N_DEV):
        xu[r * SHARE:(r + 1) * SHARE, :, :3] += r / 2
        yu[r * SHARE:(r + 1) * SHARE, ::2] = r
    gdl_logits = rng.normal(size=(b, 64, 4)).astype(np.float32)
    gdl_y = rng.integers(0, 4, (b, 64)).astype(np.int32)
    gdl_y[0] = 0                    # a sample without the other classes
    inp = dict(vars=variables, x=x, y=y, xu=xu, yu=yu, cw=CW, lr=LR, wd=WD,
               share=SHARE, train_cfg=TRAIN_CFG, gdl_logits=gdl_logits,
               gdl_y=gdl_y)

    mesh = jmake_mesh(("data",), devices=jax.devices()[:N_DEV])
    rep, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))

    def jloss(params, xb, yb):
        out, mut = jm.apply({**variables, "params": params}, xb, train=True,
                            mutable=["batch_stats"])
        loss, comps = jlosses.nnu_loss(out, yb, jnp.asarray(CW))
        return loss, (comps, mut["batch_stats"])

    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))
    want = {}
    routes = {False: {"FSEG_FUSED_EDGE": "0"}, True: {"FSEG_FUSED_EDGE": "1"},
              "tail": {"FSEG_FUSED_EDGE_TAIL": "1"}}
    for fused, env in routes.items():
        os.environ.update(env)       # read while the step is traced
        with jax.default_matmul_precision("float32"):
            step = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                           in_shardings=(rep, shard, shard),
                           out_shardings=rep)
            (loss, (comps, stats)), grads = step(variables["params"], x, y)
            updates, _ = tx.update(grads, tx.init(variables["params"]),
                                   variables["params"])
            want[f"step_{fused}"] = jax.tree_util.tree_map(np.asarray, dict(
                loss=loss, comps=comps, stats=stats, grads=grads,
                params=optax.apply_updates(variables["params"], updates)))
        for name in env:
            os.environ.pop(name)
    gdl, gdl_grad = jax.value_and_grad(
        lambda lg: jlosses.generalized_dice_loss(
            lg, jnp.asarray(gdl_y), batch_dice=False)[0])(
                jnp.asarray(gdl_logits))
    want["gdl"] = (float(gdl), np.asarray(gdl_grad))
    with jax.default_matmul_precision("float32"):
        (loss_u, _), grads_u = jax.value_and_grad(jloss, has_aux=True)(
            variables["params"], xu, yu)
    want["unbalanced"] = (float(loss_u),
                          jax.tree_util.tree_map(np.asarray, grads_u))
    got = spawn(torch_parallel_ranks.dp_step_rank, N_DEV, args=(inp,),
                threads=1)
    return inp, want, got


@pytest.mark.parametrize("fused", [False, True, "tail"],
                         ids=["unfused", "fused", "tail"])
def test_dp_step_matches_jax_dp_step(run, fused):
    _, want, got = run
    w, g = want[f"step_{fused}"], got[0][f"step_{fused}"]
    np.testing.assert_allclose(g["loss"], float(w["loss"]), rtol=1e-5)
    for name in ("CE", "GDL"):
        np.testing.assert_allclose(g["comps"][name], float(w["comps"][name]),
                                   rtol=1e-5, err_msg=name)
    _assert_trees_close(g["grads"], w["grads"], **TOL)
    _assert_trees_close(g["variables"]["batch_stats"], w["stats"], **TOL)
    # every rank ends the step with the same parameters and statistics
    for other in got[1:]:
        _assert_trees_close(other[f"step_{fused}"]["variables"],
                            g["variables"], rtol=0, atol=0)


def test_per_sample_dice_over_the_group_matches_jax(run):
    inp, want, got = run
    loss_j, grad_j = want["gdl"]
    for r, g in enumerate(got):
        loss, grad = g["gdl"]
        np.testing.assert_allclose(loss, loss_j, rtol=1e-6)
        rows = slice(r * inp["share"], (r + 1) * inp["share"])
        np.testing.assert_allclose(grad, grad_j[rows], rtol=1e-7, atol=1e-7)


def test_plain_ddp_would_fail_this_batch(run):
    """The shards differ in class balance and position, so the per-rank
    Dice, CE normalization and BatchNorm statistics are not the global
    batch's: the port's loss is JAX's global one within rtol 1e-5 and its
    whole gradient within 1e-2 in relative L2, while a plain-DDP port
    misses the loss by more than 100x rtol and the gradient by more than
    10x that bound. The bound is this batch's own float32 spread: the
    shifted shards put edges at the LeakyReLU's kink and at ties of the
    max over k, so JAX's gradient moves by 4.2e-3 when the shards are
    swapped, and the port's (single-device or over the ranks) is 1.6e-3
    from JAX's; plain DDP's is 1.0 away."""
    _, want, got = run
    loss_j, grads_j = want["unbalanced"]
    np.testing.assert_allclose(got[0]["global"]["loss"], loss_j, rtol=1e-5)
    assert _rel_l2(got[0]["global"]["grads"], grads_j) < 1e-2
    assert abs(got[0]["ddp"]["loss"] - loss_j) > 100 * 1e-5 * abs(loss_j)
    assert _rel_l2(got[0]["ddp"]["grads"], grads_j) > 1e-1


def test_dp_trainer_matches_single_device_trainer(run):
    """3 epochs over 4 ranks (one row each) against one device at the
    same seed; every rank holds the same history; only rank 0 writes."""
    inp, _, got = run
    (h1, v1), files1 = torch_parallel_ranks.single_trainer_history(inp)
    hn, vn = got[0]["history"]
    for k in h1:
        np.testing.assert_allclose(hn[k], h1[k], rtol=3e-2, atol=3e-2,
                                   err_msg=k)
        np.testing.assert_allclose(vn[k], v1[k], rtol=3e-2, atol=3e-2,
                                   err_msg=k)
    assert all(g["history"] == got[0]["history"] for g in got[1:])
    assert got[0]["files"] == files1 and "model.pt" in files1
    assert all(g["files"] == [] for g in got[1:])
