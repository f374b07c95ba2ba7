"""Port parity of the fused EdgeConv tail (models/blocks.py:FusedEdgeTail,
ops/fused_edge.py:fused_tail_enabled) against the JAX package's
FusedEdgeTail, on the CPU, with FSEG_FUSED_EDGE_TAIL set on both sides.
JAX's products run at float32 precision (`jax.default_matmul_precision`);
JAX reads the flag while it traces, and nothing here is jitted, so every
JAX call traces afresh after the flag is set.

Tolerances:
  * the module in float32: output and running statistics within 1e-5
    relative (atol 1e-5 for entries near 0), the gradients of the input,
    the Dense kernel, the BatchNorm scale and bias within 1e-4 in relative
    L2 each;
  * the module in bf16: each of those within 2 x JAX's own bf16-vs-f32
    error (relative L2), the rule the bf16 CNN and DGCNN are held to;
  * k-ties in bf16: both packages split the gradient of a tied maximum
    evenly among the tied edges (`amax` against `jnp.max`), and the input
    gradients agree to the same 1e-4;
  * DGCNNSeg (static, with and without the spatial transformer, whose
    EdgeConv is the tail's second call site) with the tail on against JAX
    with the tail on: eval logits within rtol = atol = 2e-4, one NNU-loss
    Adam step's loss within rtol 1e-5, gradients and running statistics
    within rtol = atol = 2e-4 (the unfused model's tolerances,
    tests/test_torch_train.py);
  * tail on against tail off in the port: float32 within 8 ulps relative
    to the output's scale (the two routes sum the statistics in another
    order), bf16 within 2 bf16 ulps (2^-7) of it;
  * in eval mode the tail equals the unfused route bit for bit;
  * one JAX variable tree loads into both routes and exports back
    unchanged.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fissure_segmentation_tpu.losses import segmentation as jlosses
from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu.models.blocks import \
    FusedEdgeTail as JFusedEdgeTail
from fissure_segmentation_tpu.models.blocks import SharedMLP as JSharedMLP
from fissure_segmentation_tpu_torch.data import dataset, synthetic
from fissure_segmentation_tpu_torch.losses import get_loss_fn
from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                   export_jax_variables,
                                                   load_jax_variables)
from fissure_segmentation_tpu_torch.models.blocks import FusedEdgeTail
from fissure_segmentation_tpu_torch.ops.fused_edge import (
    CUDA_TAIL_DEFAULT, fused_tail_enabled)
from fissure_segmentation_tpu_torch.train.trainer import (ModelTrainer,
                                                          TrainConfig)

TOL = dict(rtol=2e-4, atol=2e-4)
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD_REL_L2 = 1e-4
LR, WD = 1e-3, 1e-5
FIN, FOUT = 16, 8


@pytest.fixture
def tail(monkeypatch):
    """Set FSEG_FUSED_EDGE_TAIL for both packages; the single-layer fused
    route stays at its default (off on the CPU in both)."""
    monkeypatch.delenv("FSEG_FUSED_EDGE", raising=False)

    def set_tail(on: bool):
        monkeypatch.setenv("FSEG_FUSED_EDGE_TAIL", "1" if on else "0")
    return set_tail


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def _leaves(tree, path=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", np.asarray(tree[k], np.float32)


def _assert_trees_close(got, want, **tol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# ---- the module -------------------------------------------------------------

def _tail_variables(rng):
    """A JAX FusedEdgeTail tree with numpy-drawn BatchNorm leaves: about a
    third of the scales negative (the min route), running statistics off
    their initial values."""
    v = jax.tree_util.tree_map(np.asarray, JFusedEdgeTail(FOUT).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 3, FIN), jnp.float32)))
    bn = {"scale": rng.normal(0.4, 1.0, FOUT).astype(np.float32),
          "bias": rng.normal(0, 0.3, FOUT).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.3, FOUT).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, FOUT).astype(np.float32)}
    return {"params": {"Dense_0": v["params"]["Dense_0"],
                           "BatchNorm_0": bn},
                "batch_stats": {"BatchNorm_0": stats}}


def _edges(rng, ties=False, shape=(2, 24, 6, FIN)):
    e = rng.normal(0.2, 1.0, shape).astype(np.float32)
    if ties:
        # slots 1 and 3 repeat slot 0: q ties among three of k edges
        e[:, :, 1] = e[:, :, 0]
        e[:, :, 3] = e[:, :, 0]
    return e


def _jax_tail(variables, e, w, train, dtype, fused=True):
    """JAX output, new batch_stats and the gradients of e and params, by
    FusedEdgeTail or (`fused` False) by SharedMLP and the max over k."""
    jm = (JFusedEdgeTail if fused else JSharedMLP)(FOUT, dtype=dtype)

    def loss(params, e):
        out, mut = jm.apply({**variables, "params": params}, e, train,
                            mutable=["batch_stats"])
        if not fused:
            out = jnp.max(out, axis=-2)
        return jnp.sum(out.astype(jnp.float32) * w), (out, mut)

    with jax.default_matmul_precision("float32"):
        (_, (out, mut)), (gp, ge) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                                jnp.asarray(e))
    stats = mut.get("batch_stats", variables["batch_stats"])
    return dict(out=np.asarray(out.astype(jnp.float32)),
                stats=jax.tree_util.tree_map(np.asarray, dict(stats)),
                e=np.asarray(ge, np.float32),
                params=jax.tree_util.tree_map(np.asarray, dict(gp)))


def _port_tail(variables, e, w, train, dtype, fused=True):
    tm = load_jax_variables(FusedEdgeTail(FIN, FOUT, dtype=dtype),
                            variables).train(train)
    et = _t(e).requires_grad_(True)
    out = tm(et) if fused else tm.unfused(et)
    (out.to(torch.float32) * _t(w)).sum().backward()
    v = export_jax_variables(tm)
    return dict(out=out.detach().to(torch.float32).numpy(),
                stats=v["batch_stats"], e=et.grad.to(torch.float32).numpy(),
                params=export_jax_variables(tm, grad=True)["params"])


def _errors(got, want) -> dict:
    """Relative L2 of every compared quantity of `got` against `want`."""
    errs = {"out": _rel_l2(got["out"], want["out"]),
            "e": _rel_l2(got["e"], want["e"])}
    for tree in ("stats", "params"):
        w = dict(_leaves(want[tree]))
        for k, g in _leaves(got[tree]):
            errs[f"{tree}/{k}"] = _rel_l2(g, w[k])
    return errs


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_tail_module_f32_matches_jax(tail, train):
    tail(True)
    rng = np.random.default_rng(3 + train)
    variables = _tail_variables(rng)
    e = _edges(rng)
    w = rng.normal(size=e.shape[:-2] + (FOUT,)).astype(np.float32)
    want = _jax_tail(variables, e, w, train, None)
    got = _port_tail(variables, e, w, train, None)
    np.testing.assert_allclose(got["out"], want["out"], **FWD)
    _assert_trees_close(got["stats"], want["stats"], **FWD)
    errs = _errors(got, want)
    grads = {k: v for k, v in errs.items() if k == "e" or
             k.startswith("params/")}
    assert max(grads.values()) < GRAD_REL_L2, grads


@pytest.mark.parametrize("ties", [False, True], ids=["generic", "ties"])
def test_tail_module_bf16_matches_jax(tail, ties):
    """bf16 against JAX's bf16 within 2 x JAX's bf16-vs-f32 error, leaf by
    leaf; the train-mode forward and backward."""
    tail(True)
    rng = np.random.default_rng(11 + ties)
    variables = _tail_variables(rng)
    e = _edges(rng, ties=ties)
    w = rng.normal(size=e.shape[:-2] + (FOUT,)).astype(np.float32)
    want = _jax_tail(variables, e, w, True, jnp.bfloat16)
    ref = _jax_tail(variables, e, w, True, None)
    got = _port_tail(variables, e, w, True, torch.bfloat16)
    port_err, jax_err = _errors(got, want), _errors(want, ref)
    over = {k: (port_err[k], jax_err[k]) for k in jax_err
            if port_err[k] > 2 * jax_err[k] and port_err[k] > 1e-6}
    assert not over, over


def test_tail_splits_tied_gradients_like_jax(tail):
    """Three of k edges carry the same q (bf16): the cotangent of each tied
    maximum is split evenly among them on both sides (torch's max(dim)
    would send it to one slot), and the port's input gradient is JAX's."""
    tail(True)
    rng = np.random.default_rng(17)
    variables = _tail_variables(rng)
    e = _edges(rng, ties=True)
    w = rng.normal(size=e.shape[:-2] + (FOUT,)).astype(np.float32)
    for dt_j, dt_t in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = _jax_tail(variables, e, w, False, dt_j)
        got = _port_tail(variables, e, w, False, dt_t)
        for g in (want["e"], got["e"]):
            np.testing.assert_array_equal(g[:, :, 1], g[:, :, 0])
            np.testing.assert_array_equal(g[:, :, 3], g[:, :, 0])
            assert np.abs(g[:, :, 0]).max() > 0
        assert _rel_l2(got["e"], want["e"]) < (
            GRAD_REL_L2 if dt_j is None else 2 ** -7)


@pytest.mark.parametrize("dtype,ulps", [(None, 8 * 2.0 ** -23),
                                        (torch.bfloat16, 2 * 2.0 ** -7)],
                         ids=["f32", "bf16"])
def test_tail_on_equals_tail_off(tail, dtype, ulps):
    """The tail against SharedMLP + amax on the same weights and edges, in
    train mode: the output within `ulps` of its largest entry; in float32
    the running statistics and the gradients within 1e-4 relative L2; in
    bf16 within 2 x JAX's own tail-on-vs-off distance, leaf by leaf (the
    unfused route rounds every edge's BatchNorm output and activation to
    bf16 and back-propagates through them in bf16, the tail does not)."""
    rng = np.random.default_rng(23)
    variables = _tail_variables(rng)
    e = _edges(rng, shape=(2, 32, 8, FIN))
    w = rng.normal(size=(2, 32, FOUT)).astype(np.float32)
    on = _port_tail(variables, e, w, True, dtype, fused=True)
    off = _port_tail(variables, e, w, True, dtype, fused=False)
    scale = np.abs(off["out"]).max()
    assert np.abs(on["out"] - off["out"]).max() <= ulps * scale
    errs = _errors(on, off)
    if dtype is None:
        assert max(errs.values()) < GRAD_REL_L2, errs
        return
    jdt = jnp.bfloat16
    jax_errs = _errors(_jax_tail(variables, e, w, True, jdt),
                       _jax_tail(variables, e, w, True, jdt, fused=False))
    over = {k: (errs[k], jax_errs[k]) for k in errs
            if errs[k] > 2 * jax_errs[k] and errs[k] > 1e-6}
    assert not over, over


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tail_eval_equals_unfused_bit_for_bit(dtype):
    """In eval mode (running statistics) the tail selects max or min of q
    and applies BatchNorm's own formula and the LeakyReLU to the selection:
    float rounding is monotone, so the output is the unfused route's bit
    for bit, with and without autograd recording."""
    variables = _tail_variables(np.random.default_rng(31))
    tm = load_jax_variables(FusedEdgeTail(FIN, FOUT, dtype=dtype),
                            variables).eval()
    e = _t(_edges(np.random.default_rng(32), ties=True,
                  shape=(2, 40, 9, FIN)))
    with torch.no_grad():
        assert torch.equal(tm(e), tm.unfused(e))
    assert torch.equal(tm(e), tm.unfused(e))


def test_tail_flag_is_read_at_every_call(tail, monkeypatch):
    """FSEG_FUSED_EDGE_TAIL=1/0 overrides both ways at every call; without
    it the CPU takes the unfused route and CUDA `CUDA_TAIL_DEFAULT`."""
    tail(True)
    assert fused_tail_enabled("cpu") and fused_tail_enabled("cuda")
    tail(False)
    assert not fused_tail_enabled("cpu") and not fused_tail_enabled("cuda")
    monkeypatch.delenv("FSEG_FUSED_EDGE_TAIL")
    assert not fused_tail_enabled("cpu")
    assert fused_tail_enabled("cuda") == CUDA_TAIL_DEFAULT
    calls = []
    orig = FusedEdgeTail.forward
    monkeypatch.setattr(FusedEdgeTail, "forward",
                        lambda self, e: calls.append(1) or orig(self, e))
    model = DGCNNSeg(k=4, in_features=3, num_classes=4, dynamic=False,
                     spatial_transformer=True,
                     generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(1, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model(x)
        assert not calls
        tail(True)
        model(x)
    assert len(calls) == 2       # EdgeConv_0 and the transformer's


# ---- DGCNNSeg ---------------------------------------------------------------

def _dyadic_cloud(rng, shape):
    return (rng.integers(-16, 17, shape) / 16.0).astype(np.float32)


def _variables(st, seed=1):
    """A JAX DGCNNSeg tree: the port's initial weights from a seeded
    generator, exported (no JAX init to compile); with the spatial
    transformer its zero head kernel drawn small, so that its transform is
    not the identity and gradients reach its EdgeConv."""
    v = export_jax_variables(DGCNNSeg(
        k=6, in_features=4, num_classes=4, dynamic=False,
        spatial_transformer=st, generator=torch.Generator().manual_seed(seed)))
    if st:
        head = v["params"]["SpatialTransformer_0"]["Dense_2"]
        head["kernel"] = np.random.default_rng(seed).normal(
            0, 0.01, head["kernel"].shape).astype(np.float32)
    return v


def _port_dgcnn(variables, st):
    return load_jax_variables(DGCNNSeg(k=6, in_features=4, num_classes=4,
                                       dynamic=False, spatial_transformer=st),
                              variables)


@pytest.mark.parametrize("st", [False, True], ids=["plain", "transformer"])
def test_dgcnn_with_tail_matches_jax_with_tail(tail, tmp_path, st):
    """Eval logits, then one NNU-loss Adam + weight-decay step from the same
    weights on the same batch: loss, CE/GDL, running statistics and the
    updated parameters (where JAX's gradient pins the sign of Adam's first
    step) against JAX with the tail on (jitted after the flag is set). The
    gradients: leaf by leaf within TOL without the transformer; with it (8
    clouds) as a whole within 1e-2 relative L2, as its head's BatchNorm
    over the batch amplifies float32 rounding whichever route runs (8
    clouds, inputs of seeds 41 / 42: 5.0e-3 / 1.5e-5 with the tail on both
    sides, 2.5e-3 / 2.0e-5 unfused on both; 4 clouds: up to 2.1e-2 and
    1.8e-2)."""
    tail(True)
    rng = np.random.default_rng(40 + 2 * st)
    jm = JDGCNNSeg(k=6, in_features=4, num_classes=4, dynamic=False,
                   spatial_transformer=st)
    variables = _variables(st)
    x = _dyadic_cloud(rng, (8 if st else 2, 64, 4))
    y = rng.integers(0, 4, x.shape[:2]).astype(np.int32)
    cw = np.asarray([0.4, 1.2, 1.1, 1.3], np.float32)
    tx = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))

    def jloss(params):
        out, mut = jm.apply({**variables, "params": params}, x, train=True,
                            mutable=["batch_stats"])
        loss, comps = jlosses.nnu_loss(out, y, jnp.asarray(cw))
        return loss, (comps, mut["batch_stats"])

    with jax.default_matmul_precision("float32"):
        logits_j = np.asarray(jax.jit(
            lambda v: jm.apply(v, x, train=False))(variables))
        (loss_j, (comps_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(variables["params"])
        updates, _ = tx.update(grads_j, tx.init(variables["params"]),
                               variables["params"])
        params_j = optax.apply_updates(variables["params"], updates)

    model = _port_dgcnn(variables, st).eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(_t(x)).numpy(), logits_j, **TOL)
    trainer = ModelTrainer(
        model, dataset.PointDataset(synthetic.make_synthetic_dataset(
            4, n_points=300), sample_points=64),
        get_loss_fn("nnunet", _t(cw)), str(tmp_path),
        TrainConfig(lr=LR, weight_decay=WD), device="cpu")
    loss, comps = trainer.train_step(_t(x), _t(y).long())
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for name in ("CE", "GDL"):
        np.testing.assert_allclose(float(comps[name]), float(comps_j[name]),
                                   rtol=1e-5, err_msg=name)
    grads = dict(_leaves(export_jax_variables(model, grad=True)["params"]))
    grads_j = dict(_leaves(grads_j))
    assert set(grads) == set(grads_j)
    if st:
        flat = [np.concatenate([g[k].ravel() for k in sorted(grads_j)])
                for g in (grads, grads_j)]
        assert _rel_l2(*flat) < 1e-2
    else:
        for k in grads_j:
            np.testing.assert_allclose(grads[k], grads_j[k], err_msg=k,
                                       **TOL)
    got = export_jax_variables(model)
    _assert_trees_close(got["batch_stats"], stats_j, **TOL)
    params_j = dict(_leaves(params_j))
    n_held = n_all = 0
    for name, p in _leaves(got["params"]):
        held = np.abs(grads_j[name]) > TOL["atol"]
        if st:     # where the gradients agree leaf by leaf
            held &= np.isclose(grads[name], grads_j[name], **TOL)
        np.testing.assert_allclose(p[held], params_j[name][held],
                                   err_msg=name, **TOL)
        n_held, n_all = n_held + held.sum(), n_all + held.size
    assert n_held > 0.9 * n_all, (n_held, n_all)


def test_one_jax_tree_loads_into_both_routes(tail):
    """The same JAX tree fills the port's model for either route (the tail
    is a SharedMLP with the same leaves) and exports back bit for bit; the
    two routes' eval logits agree within the eval tolerance."""
    variables = _variables(True, seed=2)
    x = torch.from_numpy(_dyadic_cloud(np.random.default_rng(5),
                                       (2, 64, 4)))
    logits = {}
    for on in (False, True):
        tail(on)
        model = _port_dgcnn(variables, True).eval()
        exported = export_jax_variables(model)
        for (k, a), (_, b) in zip(_leaves(exported), _leaves(variables)):
            np.testing.assert_array_equal(a, b, err_msg=k)
        with torch.no_grad():
            logits[on] = model(x).numpy()
    np.testing.assert_allclose(logits[True], logits[False], **TOL)
    assert os.environ["FSEG_FUSED_EDGE_TAIL"] == "1"
