"""Port parity of the bf16 DGCNNSeg (`dtype=torch.bfloat16`, what `--amp
true` trains) against the JAX model with `dtype=jnp.bfloat16`, weights
carried across by `load_jax_variables`, in both EdgeConv routings
(FSEG_FUSED_EDGE=1/0 on both sides).

bf16 keeps 8 bits of mantissa. Both sides round every product, BatchNorm
output and activation to bf16 at the same places, but each sums a
product's terms in float32 in its own order (and XLA's CPU, unlike torch,
rounds a Dense's product before adding its bias), so an element now and
then lands on the neighbouring bf16 value (2^-8 relative) on one side.
Tolerances:
  * eval logits within 3e-2 * max|logit|; the NNU loss and its components
    within 1e-2 relative; the running statistics within 2e-2 relative L2
    per leaf;
  * each gradient leaf within GRAD_TOL of JAX's bf16 gradient in relative
    L2, and the whole gradient within GRAD_WHOLE_TOL: 5e-2 at SharedMLP_4,
    next to the loss; wider towards the input, where JAX's own bf16
    gradient is as far from its float32 gradient (the readings stand
    beside each limit). The reason: the backward rounds every cotangent to
    bf16 and each train-mode BatchNorm backward subtracts two batch means
    from it, so an element's step to a neighbouring bf16 value grows layer
    by layer from the loss down (to 20-30 % at any batch size tried, 2 x 64
    to 8 x 512), and no bf16 computation that rounds in another order can
    be held closer to JAX's than that;
  * the same step with a wrong neighbour planted in the port's backward
    (chip_smoke.planted_fault: the fused core's routed slot, or the unfused
    K2's target, moved one slot on) must miss those limits: it reads 0.62-0.67 for the whole
    gradient and 0.73-1.20 at the EdgeConv leaves it reaches.
  * SharedMLP_0's BatchNorm offset is held absolutely: its gradient is zero
    analytically (the global max passes the shift on to SharedMLP_1, whose
    BatchNorm removes it), so both sides hold rounding noise only; the
    port's is held below 5e-2 of the whole gradient's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import planted_fault
from fissure_segmentation_tpu.losses import segmentation as jlosses
from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu_torch.data import dataset, synthetic
from fissure_segmentation_tpu_torch.losses import get_loss_fn
from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                   export_jax_variables,
                                                   load_jax_variables,
                                                   load_model, save_model)
from fissure_segmentation_tpu_torch.train.trainer import (ModelTrainer,
                                                          TrainConfig)

LOGIT_TOL = 3e-2
LOSS_RTOL = 1e-2
GRAD_REL_L2 = 5e-2
# per leaf by layer, nearest the loss first; beside each limit this file's
# readings over both routings: the port against JAX's bf16 gradient | JAX's
# bf16 gradient against its float32 gradient
GRAD_TOL = (
    ("SharedMLP_4", GRAD_REL_L2),  # 0.010-0.041 | 0.009-0.040
    ("SharedMLP_3", 0.16),         # 0.042-0.122 | 0.037-0.131
    ("SharedMLP_2", 0.32),         # 0.111-0.246 | 0.107-0.244
    ("SharedMLP_1", 0.33),         # 0.171-0.253 | 0.180-0.276
    ("SharedMLP_0", 0.34),         # 0.204-0.260 | 0.193-0.303
    ("EdgeConv", 0.42),            # 0.217-0.323 | 0.260-0.439
)
GRAD_WHOLE_TOL = 0.32              # 0.226-0.245 | 0.269-0.276
STATS_REL_L2 = 2e-2
ZERO_GRAD = "SharedMLP_0/BatchNorm_0/bias"


@pytest.fixture
def routing(monkeypatch):
    """Set FSEG_FUSED_EDGE for both packages; the JAX fused tail stays off
    (it is not ported)."""
    monkeypatch.delenv("FSEG_FUSED_EDGE_TAIL", raising=False)

    def set_fused(on: bool):
        monkeypatch.setenv("FSEG_FUSED_EDGE", "1" if on else "0")
    return set_fused


def _leaves(tree, path=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", np.asarray(tree[k], np.float32)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def _whole_rel_l2(got: dict, want: dict) -> float:
    return _rel_l2(np.concatenate([got[k].ravel() for k in sorted(want)]),
                   np.concatenate([want[k].ravel() for k in sorted(want)]))


def _grad_misses(got: dict, want: dict) -> list:
    """The leaves of `got` beyond their GRAD_TOL of JAX's `want`, and
    "whole" if the whole gradient is beyond GRAD_WHOLE_TOL; SharedMLP_0's
    BatchNorm offset is held below GRAD_REL_L2 of the largest entry."""
    scale = max(np.abs(w).max() for w in want.values())
    misses = []
    for name in want:
        if name == ZERO_GRAD:
            if np.abs(got[name]).max() > GRAD_REL_L2 * scale:
                misses.append(name)
            continue
        tol = next(t for prefix, t in GRAD_TOL if name.startswith(prefix))
        if _rel_l2(got[name], want[name]) > tol:
            misses.append((name, _rel_l2(got[name], want[name]), tol))
    rest = [k for k in want if k != ZERO_GRAD]
    if _whole_rel_l2({k: got[k] for k in rest},
                     {k: want[k] for k in rest}) > GRAD_WHOLE_TOL:
        misses.append("whole")
    return misses


def _models(seed=1, k=6, in_features=4, num_classes=4):
    jm = JDGCNNSeg(k=k, in_features=in_features, num_classes=num_classes,
                   dynamic=False, dtype=jnp.bfloat16)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, in_features),
                                            jnp.float32)))
    tm = load_jax_variables(DGCNNSeg(k=k, in_features=in_features,
                                     num_classes=num_classes, dynamic=False,
                                     dtype=torch.bfloat16), variables)
    return jm, variables, tm


def _cloud(rng, shape):
    return (rng.integers(-16, 17, shape) / 16.0).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_dgcnn_bf16_eval_logits_match_jax(routing, fused):
    routing(fused)
    rng = np.random.default_rng(30)
    jm, variables, tm = _models()
    x = _cloud(rng, (2, 128, 4))
    want = np.asarray(jm.apply(variables, x, train=False))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    gap = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert gap <= LOGIT_TOL, gap


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_dgcnn_bf16_adam_step_matches_jax(routing, tmp_path, fused):
    """One NNU-loss step of DGCNNSeg(k=6, static, bf16) from the same
    weights on the same batch, at the size of test_torch_train.py::
    test_dgcnn_adam_step_matches_jax: loss, gradients and running
    statistics within the module's tolerances; the step with a planted
    wrong neighbour misses the gradient's."""
    routing(fused)
    rng = np.random.default_rng(20)
    jm, variables, tm = _models()
    x = _cloud(rng, (2, 64, 4))
    y = rng.integers(0, 4, (2, 64)).astype(np.int32)
    cw = np.asarray([0.4, 1.2, 1.1, 1.3], np.float32)

    def jloss(params, model=jm):
        out, mut = model.apply({**variables, "params": params}, x,
                               train=True, mutable=["batch_stats"])
        loss, comps = jlosses.nnu_loss(out, y, jnp.asarray(cw))
        return loss, (comps, mut["batch_stats"])

    (loss_j, (comps_j, stats_j)), grads_j = jax.value_and_grad(
        jloss, has_aux=True)(variables["params"])
    cases = synthetic.make_synthetic_dataset(4, n_points=300)

    def port_step(model):
        trainer = ModelTrainer(model, dataset.PointDataset(
            cases, sample_points=64), get_loss_fn(
            "nnunet", torch.from_numpy(cw)), str(tmp_path), TrainConfig(),
            device="cpu")
        return trainer.train_step(torch.from_numpy(x),
                                  torch.from_numpy(y).long())
    loss, comps = port_step(tm)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=LOSS_RTOL)
    for name in ("CE", "GDL"):
        np.testing.assert_allclose(float(comps[name]), float(comps_j[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    got = dict(_leaves(export_jax_variables(tm, grad=True)["params"]))
    want = dict(_leaves(grads_j))
    assert set(got) == set(want)
    assert all(g.dtype == np.float32 for g in got.values())
    assert _grad_misses(got, want) == []
    stats = dict(_leaves(export_jax_variables(tm)["batch_stats"]))
    for name, w in _leaves(stats_j):
        assert _rel_l2(stats[name], w) <= STATS_REL_L2, \
            (name, _rel_l2(stats[name], w))
    faulty = _models()[2]
    with planted_fault("fused" if fused else "unfused"):
        port_step(faulty)
    misses = _grad_misses(dict(_leaves(export_jax_variables(
        faulty, grad=True)["params"])), want)
    assert "whole" in misses and any(
        isinstance(m, tuple) and m[0].startswith("EdgeConv") for m in misses)


def test_dgcnn_bf16_computes_in_bf16_with_f32_parameters(tmp_path):
    """Parameters and buffers stay float32, the EdgeConvs and blocks run in
    bf16, the logits come back float32; the JAX tree loads and exports
    unchanged, and model.pt keeps the dtype."""
    _, variables, tm = _models()
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(b.dtype == torch.float32 for b in tm.buffers())
    for (path, a), (_, b) in zip(_leaves(variables),
                                 _leaves(export_jax_variables(tm))):
        np.testing.assert_array_equal(a, b, err_msg=path)
    seen = {}
    hooks = [getattr(tm, n).register_forward_hook(
        lambda m, i, o, n=n: seen.__setitem__(n, o.dtype))
        for n in ("EdgeConv_0", "EdgeConv_1", "SharedMLP_0", "SharedMLP_4")]
    with torch.no_grad():
        out = tm.eval()(torch.zeros((1, 32, 4)))
    for h in hooks:
        h.remove()
    assert out.dtype == torch.float32
    assert set(seen.values()) == {torch.bfloat16}, seen
    save_model(tm, str(tmp_path / "model.pt"))
    back = load_model(str(tmp_path / "model.pt"), DGCNNSeg)
    assert back.dtype == torch.bfloat16 and back.config["dtype"] == "bfloat16"
    assert DGCNNSeg(k=4, in_features=3, num_classes=4,
                    dtype="bfloat16").dtype == torch.bfloat16
    assert DGCNNSeg(k=4, in_features=3, num_classes=4,
                    dtype=torch.float32).dtype is None
    with pytest.raises(ValueError, match="dtype"):
        DGCNNSeg(k=4, in_features=3, num_classes=4, dtype=torch.float16)
