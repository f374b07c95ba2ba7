"""The CNN's training half against the JAX package on the CPU: K6's
backward (the plain dgrad and wgrad), MobileNetASPP and LR-ASPP in train
mode (forward, BatchNorm's running update, gradient) and the ImageTrainer
(one step of each CNN, a whole epoch of MobileNetASPP with validation),
the `.fst` files of both trainers read by the other package, and the
entry point.

JAX runs under `jax.default_matmul_precision("float32")`. The JAX
package's LR-ASPP cannot be applied as it stands: its `nn.remat` has no
`static_argnums`, so `train` is traced and BatchNorm's
`use_running_average=not train` raises (ROADMAP Queue 3, F8). The tests
apply it with `train` static (`jax_lraspp`), which changes no number.
Dropout: JAX's keep mask is read from flax's `capture_intermediates` as
(output != 0) and injected into the port; where the ReLU output is 0 the
mask does not matter.

Tolerances, each with its reading on a CPU:
  * K6 backward: dx is K6 with flipped taps, a sum of 27 products: within
    54 * 2^-24 * sum |dy w| of XLA's (the forward's bound,
    tests/test_torch_depthwise.py); dw sums B D H W products per tap: the
    port's and XLA's each lie within gamma_N * sum |x dy| of the exact sum
    (N the number of terms), so they differ by at most twice that. A dw
    with one tap shifted by one voxel must miss it.
  * each step replayed from JAX's parameters: logits within 1e-3 (read
    3.1e-4 for v1 at 16^3, 4.4e-4 for v3 at 32^3: batch statistics over
    few voxels amplify the frameworks' different summation orders), the
    loss within 1e-5 relative (read 6.3e-6, 4.0e-6), running statistics
    within 1e-3 (read 2.5e-5, 4.3e-5), the whole gradient within 3e-2
    relative L2 of JAX's float32 gradient for v1 (read 9.1e-3; JAX's
    float32 lies 6.1e-4 from its float64 there, the port's 9.1e-3) and of
    JAX's float64 gradient for v3 (read 2.1e-5; JAX's own float32 one
    lies 2.2e-2 from it, too far to hold the port to). The port's float64
    gradient equals JAX's float64 one to 2.5e-8.
  * the epoch: the two trajectories part after the first Adam step (its
    move is lr g'/(|g'| + eps), g' = g + wd p, so a rounding-sized
    gradient moves a parameter by +-lr either way): losses within 1e-2
    relative (read 3.9e-3), the running statistics within 5e-2 + 10 %
    (read 8.2e-2 on entries of about 1), the parameters within 2.5 lr a
    step; after one step (v3) each parameter within 2e-4 of the
    difference of the two sides' first Adam moves.
"""
import contextlib
import copy
import os
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from fissure_segmentation_tpu.data import image_dataset as jds
from fissure_segmentation_tpu.data.synthetic import \
    make_synthetic_image_case as jcase
from fissure_segmentation_tpu.losses import get_loss_fn as jloss
from fissure_segmentation_tpu.models import io as jio
from fissure_segmentation_tpu.models import lraspp_3d as jlr
from fissure_segmentation_tpu.models import seg_cnn as jseg
from fissure_segmentation_tpu.train import TrainConfig as JConfig
from fissure_segmentation_tpu.train.image_trainer import \
    ImageTrainer as JImageTrainer
from fissure_segmentation_tpu_torch import train_seg_cnn
from fissure_segmentation_tpu_torch.data.image_dataset import ImageDataset
from fissure_segmentation_tpu_torch.kernels.depthwise import (
    depthwise_conv3_cuda, depthwise_conv3_dgrad, depthwise_conv3_plain,
    depthwise_conv3_wgrad_plain, stuff)
from fissure_segmentation_tpu_torch.losses import get_loss_fn
from fissure_segmentation_tpu_torch.models import (LRASPPMobileNetV33D,
                                                   MobileNetASPP,
                                                   export_jax_variables,
                                                   load_fst,
                                                   load_jax_variables)
from fissure_segmentation_tpu_torch.models.seg_cnn import (
    Conv, DepthwiseConv3Stride2)
from fissure_segmentation_tpu_torch.utils.profiling import op_count
from fissure_segmentation_tpu_torch.train.image_trainer import ImageTrainer
from fissure_segmentation_tpu_torch.train.trainer import TrainConfig

EPS32 = 2.0 ** -24
LOGIT_ATOL, STATS_ATOL, GRAD_REL, LOSS_RTOL = 1e-3, 1e-3, 3e-2, 1e-5
PARAM_ATOL, ADAM_EPS, ADAM_DRIFT = 2e-4, 1e-8, 2.5
EPOCH_RTOL, EPOCH_STATS_RTOL, EPOCH_STATS_ATOL = 1e-2, 0.1, 5e-2
LR, WD = 1e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's tests: the suite runs six
    workers on the machine's cores, where torch's default of a thread a
    core makes them spin against each other (this file's fixtures took
    minutes there instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- K6's backward ----------------------------------------------------------

def _gamma(n):
    return n * EPS32 / (1 - n * EPS32)


def _xla_vjp(x, w, gy):
    c = x.shape[-1]

    def conv(x, w):
        return lax.conv_general_dilated(
            x, w.reshape(3, 3, 3, 1, c), (1, 1, 1), "SAME",
            feature_group_count=c,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            precision=lax.Precision.HIGHEST)
    _, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(gy))
    return np.asarray(dx, np.float64), np.asarray(dw, np.float64)


def _bounds(x, w, gy):
    ax, aw, ag = (torch.from_numpy(np.abs(a)) for a in (x, w, gy))
    n = int(np.prod(x.shape[:4]))
    return (54 * EPS32 * depthwise_conv3_plain(
        ag, aw.flip((0, 1, 2)).contiguous()).numpy(),
        2 * _gamma(n) * depthwise_conv3_wgrad_plain(ax, ag).numpy())


def _miss(got, want, bound) -> float:
    """Largest excess of |got - want| over its bound (<= 0: within)."""
    return float((np.abs(got.astype(np.float64) - want) - bound).max())


@pytest.mark.parametrize("shape", [(2, 6, 8, 10, 8), (1, 5, 7, 9, 33),
                                   (2, 3, 4, 20, 96), (1, 1, 6, 5, 5)])
def test_k6_backward_matches_xla_gradient(shape):
    rng = np.random.default_rng(sum(shape))
    x, gy = (rng.standard_normal(shape).astype(np.float32) for _ in "ab")
    w = rng.standard_normal((3, 3, 3, shape[-1])).astype(np.float32)
    want_dx, want_dw = _xla_vjp(x, w, gy)
    b_dx, b_dw = _bounds(x, w, gy)
    # the port: autograd through the wrapper (its Function) ...
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    depthwise_conv3_cuda(xt, wt).backward(torch.from_numpy(gy))
    assert _miss(xt.grad.numpy(), want_dx, b_dx) <= 0
    assert _miss(wt.grad.numpy(), want_dw, b_dw) <= 0
    # ... and torch's own autograd of the plain forward
    xp = torch.from_numpy(x).requires_grad_()
    wp = torch.from_numpy(w).requires_grad_()
    depthwise_conv3_plain(xp, wp).backward(torch.from_numpy(gy))
    assert _miss(xp.grad.numpy(), want_dx, b_dx) <= 0
    assert _miss(wp.grad.numpy(), want_dw, b_dw) <= 0
    # a planted fault: one tap of dw taken one voxel off along W
    bad = wt.grad.numpy().copy()
    bad[1, 1, 1] = wt.grad.numpy()[1, 1, 2]
    assert _miss(bad, want_dw, b_dw) > 0


def _xla_vjp_stride2(x, w, gy):
    c = x.shape[-1]

    def conv(x, w):
        return lax.conv_general_dilated(
            x, w.reshape(3, 3, 3, 1, c), (2, 2, 2), ((1, 1),) * 3,
            feature_group_count=c,
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            precision=lax.Precision.HIGHEST)
    _, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(gy))
    return np.asarray(dx, np.float64), np.asarray(dw, np.float64)


@pytest.mark.parametrize("shape", [(2, 6, 8, 10, 8), (1, 5, 7, 9, 33),
                                   (2, 3, 4, 1, 96), (1, 1, 6, 5, 5)])
def test_k6_stride2_backward_matches_xla_gradient(shape):
    """The stride-2 backward: dx is K6 at stride 1 with flipped taps on dy
    stuffed to x's shape, within 54 * 2^-24 * sum |dy w| of XLA's (a sum
    of at most 27 products); dw is the plain wgrad at stride 2, within
    twice gamma_N * sum |x dy| (N the terms, B x ceil(D/2) x ceil(H/2) x
    ceil(W/2)); a dw with one tap shifted by one voxel must miss it."""
    rng = np.random.default_rng(3 + sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, shape[-1])).astype(np.float32)
    oshape = (shape[0], *(-(-n // 2) for n in shape[1:4]), shape[-1])
    gy = rng.standard_normal(oshape).astype(np.float32)
    want_dx, want_dw = _xla_vjp_stride2(x, w, gy)
    ax, aw, ag = (torch.from_numpy(np.abs(a)) for a in (x, w, gy))
    b_dx = 54 * EPS32 * depthwise_conv3_plain(
        stuff(ag, shape), aw.flip((0, 1, 2)).contiguous()).numpy()
    b_dw = 2 * _gamma(int(np.prod(oshape[:4]))) * \
        depthwise_conv3_wgrad_plain(ax, ag, 2).numpy()
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = depthwise_conv3_cuda(xt, wt, stride=2)
    assert tuple(out.shape) == oshape
    out.backward(torch.from_numpy(gy))
    assert _miss(xt.grad.numpy(), want_dx, b_dx) <= 0
    assert _miss(wt.grad.numpy(), want_dw, b_dw) <= 0
    # the dgrad is K6 on the stuffed gradient, bit for bit
    assert torch.equal(xt.grad, depthwise_conv3_dgrad(
        torch.from_numpy(gy), torch.from_numpy(w), 2, shape))
    bad = wt.grad.numpy().copy()
    bad[1, 1, 1] = wt.grad.numpy()[1, 1, 2]
    assert _miss(bad, want_dw, b_dw) > 0


@pytest.mark.parametrize("version", ["v1", "v3"])
def test_op_count_counts_the_stride2_layers_as_before(version):
    """op_count.csv's flops and bytes_accessed with the stride-2 depthwise
    layers on K6 equal those of the same model whose stride-2 layers are
    the grouped `Conv` (`F.conv3d`) they replaced: 2 x 27 an output, x,
    the taps and y once each."""
    cls, size = ((MobileNetASPP, 16) if version == "v1"
                 else (LRASPPMobileNetV33D, 32))
    model = cls(num_classes=4, patch_size=(size,) * 3,
                generator=torch.Generator().manual_seed(0))
    assert any(isinstance(m, DepthwiseConv3Stride2) for m in model.modules())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, size, size, size, 1)).astype(np.float32))
    got = op_count(model, x)
    for m in model.modules():
        if isinstance(m, DepthwiseConv3Stride2):
            m.__class__ = Conv
    assert op_count(model, x) == got


def test_k6_backward_float32_only():
    x = torch.zeros((1, 2, 3, 4, 8), dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.zeros((3, 3, 3, 8), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 only"):
        depthwise_conv3_cuda(x, w)
    with torch.no_grad():
        assert depthwise_conv3_cuda(x, w).dtype == torch.bfloat16


# ---- the CNNs in train mode and the ImageTrainer -----------------------------

@contextlib.contextmanager
def jax_lraspp():
    """The JAX package's LR-ASPP with `train` static in its remat."""
    proxy = types.SimpleNamespace(**{k: getattr(fnn, k) for k in dir(fnn)
                                     if not k.startswith("__")})
    proxy.remat = lambda cls: fnn.remat(cls, static_argnums=(2,))
    jlr.nn = proxy
    try:
        yield
    finally:
        jlr.nn = fnn


def _leaves(tree, path=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", np.asarray(tree[k], np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), dict(tree))


def _data(n, shape, seed):
    """Synthetic fissure labels; images the synthetic CT scaled to unit
    variance plus noise (preprocessed)."""
    rng = np.random.default_rng(seed)
    cases = [jcase(seed + i, shape=shape) for i in range(n)]
    imgs = [(c["image"] * 3 + rng.normal(0, 0.5, shape)).astype(np.float32)
            for c in cases]
    return imgs, [c["labels"] for c in cases], \
        [(f"c{i}", "fixed") for i in range(n)]


CASES = {
    # v1 at 16^3: 6 cases -> 1 validation case, 2 steps of 2 patches
    "v1": dict(jcls=jseg.MobileNetASPP, tcls=MobileNetASPP, n=6,
               shape=(20, 20, 20), patch=16, ref64=False),
    # v3 at 32^3 (its high-level feature 2^3): 2 cases -> one step; JAX's
    # float32 gradient lies 2.2e-2 from its float64 one here
    "v3": dict(jcls=jlr.LRASPPMobileNetV33D, tcls=LRASPPMobileNetV33D, n=2,
               shape=(34, 34, 34), patch=32, ref64=True),
}


def _dataset(cls, case, imgs, lbls, ids):
    return cls(imgs, lbls, ids, patch_size=(case["patch"],) * 3,
               do_augmentation=False, preprocessed=True)


def _jax_run(case, init, data, out_dir):
    """JAX's ImageTrainer for one epoch (augmentation off, cosine) from the
    variables `init`, with each step's parameters and statistics, batch,
    dropout keep mask, train-mode logits, running update and gradient
    recorded before the step runs. The step is composed from the
    trainer's loss and optax chain, as its `_train_step` is, so that one
    compiled gradient serves both the step and the record."""
    ds = _dataset(jds.ImageDataset, case, *data)
    model = case["jcls"](num_classes=ds.num_classes,
                         patch_size=(case["patch"],) * 3)
    # start from the port's initial tree (JAX's eager init is slow)
    object.__setattr__(model, "init", lambda *a, **k: copy.deepcopy(init))
    loss_fn = jloss("nnunet", jnp.asarray(ds.get_class_weights()))
    cfg = JConfig(epochs=1, lr=LR, batch_size=2, weight_decay=WD,
                  scheduler="cosine", seed=0)
    trainer = JImageTrainer(model, ds, loss_fn, out_dir, cfg)

    def probe(params, bs, x, lbl, r_drop):
        def f(p):
            y, mut = model.apply(
                {"params": p, "batch_stats": bs}, x[..., None], train=True,
                mutable=["batch_stats", "intermediates"],
                rngs={"dropout": r_drop},
                capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout))
            b = y.shape[0]
            loss, comps = loss_fn(y.reshape(b, -1, y.shape[-1]),
                                  lbl.reshape(b, -1))
            return loss, (comps, y, mut)
        return jax.value_and_grad(f, has_aux=True)(params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = trainer.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state
    probe, steps = jax.jit(probe), []

    def spy(params, bs, opt_state, key, x, lbl):
        """The trainer's `_train_step` without augmentation, from its own
        parts (its loss, its optax chain), recording as it goes."""
        _, r_drop = jax.random.split(key)
        (loss, (comps, y, mut)), grad = probe(params, bs, x, lbl, r_drop)
        drop = jax.tree_util.tree_leaves(mut.get("intermediates", {}))
        steps.append({"vars": _np_tree({"params": params,
                                        "batch_stats": bs}),
                      "x": np.array(x), "lbl": np.array(lbl),
                      "keep": np.array(drop[0]) != 0 if drop else None,
                      "loss": float(loss), "logits": np.array(y),
                      "stats": _np_tree({"batch_stats": mut["batch_stats"]}),
                      "grad": _np_tree({"params": grad})})
        params, opt_state = update(grad, opt_state, params)
        return params, mut["batch_stats"], opt_state, loss, comps
    trainer._step = spy
    with jax.default_matmul_precision("float32"):
        trainer.run()
    final = _np_tree({"params": trainer.params,
                      "batch_stats": trainer.batch_stats})
    return {"steps": steps, "final": final, "trainer": trainer,
            "fst": os.path.join(out_dir, "model.fst")}


def _jax_grad64(case, steps, weights):
    """JAX's float64 gradient of each recorded step, the reference the
    port's float32 gradient is held to (JAX's own float32 gradient reads
    up to 2.2e-2 from it here). x64 is on for the call only; float64
    draws another dropout mask, so JAX's recorded keep mask is applied to
    its Dropout through flax's method interception."""
    with jax.enable_x64(True), jax_lraspp():
        model = case["jcls"](num_classes=steps[0]["logits"].shape[-1],
                             patch_size=(case["patch"],) * 3)
        loss_fn = jloss("nnunet", jnp.asarray(weights, jnp.float64))

        @jax.jit
        def grad(params, bs, x, lbl, keep):
            def drop(f, args, kwargs, ctx):
                if isinstance(ctx.module, fnn.Dropout) and \
                        ctx.method_name == "__call__":
                    return jnp.where(keep, args[0] / 0.5, 0.0)
                return f(*args, **kwargs)

            def loss(p):
                with fnn.intercept_methods(drop):
                    y, _ = model.apply({"params": p, "batch_stats": bs}, x,
                                       train=True, mutable=["batch_stats"])
                b = y.shape[0]
                return loss_fn(y.reshape(b, -1, y.shape[-1]),
                               lbl.reshape(b, -1))[0]
            return jax.grad(loss)(params)

        out = []
        for rec in steps:
            f64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), rec["vars"])
            keep = np.ones(1, bool) if rec["keep"] is None else rec["keep"]
            out.append(_np_tree({"params": grad(
                f64["params"], f64["batch_stats"],
                jnp.asarray(rec["x"], jnp.float64)[..., None],
                jnp.asarray(rec["lbl"]), keep)}))
    return out


def _port_model(case, tree, num_classes):
    return load_jax_variables(
        case["tcls"](num_classes=num_classes,
                     patch_size=(case["patch"],) * 3), tree)


def _port_run(case, init, data, keep, out_dir):
    ds = _dataset(ImageDataset, case, *data)
    loss_fn = get_loss_fn("nnunet", torch.as_tensor(
        ds.get_class_weights(), dtype=torch.float32))
    cfg = TrainConfig(epochs=1, lr=LR, batch_size=2, weight_decay=WD,
                      scheduler="cosine", seed=0)
    trainer = ImageTrainer(_port_model(case, init, ds.num_classes), ds,
                           loss_fn, out_dir, cfg, device="cpu")
    step, seen = trainer.train_step, []

    def spy(x, lbl, **kw):
        seen.append((x.numpy().copy(), lbl.numpy().copy()))
        out = step(x, lbl, **kw)
        seen[-1] += (export_jax_variables(trainer.model, grad=True),)
        return out
    trainer.train_step = spy
    trainer.run(inject=lambda i: {} if keep[i] is None else
                {"keep": torch.from_numpy(keep[i])})
    return trainer, seen


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, tmp_path_factory):
    case = CASES[request.param]
    out = tmp_path_factory.mktemp(request.param)
    data = _data(case["n"], case["shape"], 7)
    n_cls = int(max(lbl.max() for lbl in data[1])) + 1
    init = export_jax_variables(case["tcls"](
        num_classes=n_cls, patch_size=(case["patch"],) * 3,
        generator=torch.Generator().manual_seed(1)))
    with jax_lraspp():
        jrun = _jax_run(case, init, data, str(out / "jax"))
    keep = [s["keep"] for s in jrun["steps"]]
    trainer, seen = _port_run(case, init, data, keep, str(out / "port"))
    # the gradient reference: JAX's float32 one, or where that is too far
    # from the exact gradient to hold the port to, its float64 one
    jrun["grad_ref"] = _jax_grad64(
        case, jrun["steps"], trainer.loss_fn.keywords["class_weights"]) \
        if case["ref64"] else [s["grad"] for s in jrun["steps"]]
    yield request.param, case, jrun, trainer, seen


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(((got[k] - want[k]).astype(np.float64) ** 2).sum()
              for k in want)
    return float(np.sqrt(num / sum((want[k].astype(np.float64) ** 2).sum()
                                   for k in want)))


def _step_on_port(case, rec, loss_fn):
    """The port's train-mode forward and backward of one recorded JAX step
    at JAX's parameters and statistics: (logits, model)."""
    model = _port_model(case, rec["vars"], rec["logits"].shape[-1]).train()
    keep = None if rec["keep"] is None else torch.from_numpy(rec["keep"])
    logits = model(torch.from_numpy(rec["x"])[..., None], keep=keep)
    b = logits.shape[0]
    loss, _ = loss_fn(logits.reshape(b, -1, logits.shape[-1]),
                      torch.from_numpy(rec["lbl"]).reshape(b, -1))
    loss.backward()                 # the checkpoints' recomputation runs here
    return logits, loss, model


def test_train_step_matches_jax_at_each_step(runs):
    """Each step of JAX's epoch replayed on the port from JAX's parameters
    and statistics, with JAX's batch and keep mask: the train-mode logits,
    the loss, the running statistics folded in (once, though every block
    is checkpointed) and the gradient."""
    name, case, jrun, trainer, _ = runs
    for i, rec in enumerate(jrun["steps"]):
        logits, loss, model = _step_on_port(case, rec, trainer.loss_fn)
        np.testing.assert_allclose(logits.detach().numpy(), rec["logits"],
                                   rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_allclose(loss.item(), rec["loss"], rtol=LOSS_RTOL)
        got = dict(_leaves({"batch_stats":
                            export_jax_variables(model)["batch_stats"]}))
        for k, v in _leaves(rec["stats"]):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=STATS_ATOL,
                                       err_msg=f"step {i} {k}")
        grad = dict(_leaves(export_jax_variables(model, grad=True)))
        assert _rel_l2(grad, dict(_leaves(jrun["grad_ref"][i]))) <= GRAD_REL, i
    if name == "v1":
        keep = jrun["steps"][0]["keep"]
        assert keep is not None and 0 < keep.mean() < 1


def test_trainer_epoch_matches_jax(runs):
    """The port's ImageTrainer over the epoch: the same crops, step 0's
    gradient; then the epoch's losses, the validation loss, the best
    epoch and the parameters and statistics after Adam (each step of
    the two trajectories moves a parameter by at most about lr, so where
    JAX's gradient is rounding, Adam's sign may differ)."""
    name, _, jrun, trainer, seen = runs
    assert len(seen) == len(jrun["steps"]) == trainer.steps_per_epoch
    for (x, lbl, _), s in zip(seen, jrun["steps"]):
        np.testing.assert_array_equal(x, s["x"])
        np.testing.assert_array_equal(lbl, s["lbl"])
    assert _rel_l2(dict(_leaves(seen[0][2])),
                   dict(_leaves(jrun["grad_ref"][0]))) <= GRAD_REL
    jt = jrun["trainer"]
    for hist in ("training_history", "validation_history"):
        want, got = getattr(jt, hist), getattr(trainer, hist)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=EPOCH_RTOL,
                                       err_msg=f"{hist}/{k}")
    assert (trainer.val_indices, trainer.best_epoch) == \
        (jt.val_indices, jt.best_epoch)
    if name == "v1":
        assert trainer.val_indices     # the validation crops ran
    got = dict(_leaves(export_jax_variables(trainer.model)))
    grad0 = dict(_leaves(jrun["steps"][0]["grad"]))
    init = dict(_leaves(jrun["steps"][0]["vars"]))
    n = len(jrun["steps"])
    for k, want in _leaves(jrun["final"]):
        if k.startswith("batch_stats"):
            np.testing.assert_allclose(got[k], want, rtol=EPOCH_STATS_RTOL,
                                       atol=EPOCH_STATS_ATOL, err_msg=k)
            continue
        if n == 1:
            # Adam's first step moves p by lr g' / (|g'| + eps), g' = g +
            # wd p: where the two gradients give other moves (signs of
            # rounding-sized gradients), the parameters differ by that
            p0 = init[k]
            moves = [LR * g / (np.abs(g) + ADAM_EPS) for g in (
                dict(_leaves(seen[0][2]))[k] + WD * p0, grad0[k] + WD * p0)]
            atol = np.abs(moves[0] - moves[1]) + PARAM_ATOL
        else:
            atol = ADAM_DRIFT * LR * n + PARAM_ATOL
        excess = np.abs(got[k] - want) - atol
        assert (excess <= 0).all(), (k, float(excess.max()))


def test_fst_files_cross_packages(runs):
    """JAX's model.fst loads into the port equal to JAX's final tree; the
    port's loads in the JAX package equal to the port's."""
    name, case, jrun, trainer, _ = runs
    port_fst = os.path.join(trainer.out_dir, "model.fst")
    mine = load_fst(jrun["fst"])
    assert type(mine) is case["tcls"]
    assert mine.config == {"num_classes": trainer.model.num_classes,
                           "patch_size": [case["patch"]] * 3}
    back = dict(_leaves(export_jax_variables(mine)))
    for k, v in _leaves(jrun["final"]):
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    jmodel, jvars = jio.load_model(port_fst)
    assert type(jmodel) is case["jcls"]
    assert tuple(jmodel.patch_size) == (case["patch"],) * 3
    assert dict(_leaves(_np_tree(jvars))).keys() == \
        dict(_leaves(export_jax_variables(trainer.model))).keys()
    for k, v in _leaves(export_jax_variables(trainer.model)):
        np.testing.assert_array_equal(dict(_leaves(_np_tree(jvars)))[k], v,
                                      err_msg=k)


def test_entry_trains_tests_and_writes_the_jax_files(tmp_path, monkeypatch):
    """train_seg_cnn.main on the CPU at a small patch: the JAX entry's
    files and CSV layouts; --test_only reads the fold's model.fst."""
    small = train_seg_cnn.make_synthetic_image_case
    monkeypatch.setattr(train_seg_cnn, "make_synthetic_image_case",
                        lambda i, shape: small(i, shape=(24, 24, 24)))
    out = tmp_path / "run"
    argv = ["--ds", "synthetic", "--fold", "0", "--epochs", "2",
            "--patch_size", "16", "--batch", "2", "--spacing", "1.0",
            "--output", str(out)]
    train_seg_cnn.main(argv, device="cpu")
    for f in ("op_count.csv", "cross_val_split.json", "commandline_args.json",
              "cv_results.csv", "fold0/train_time.csv", "fold0/model.fst",
              "fold0/test/test_dice.csv"):
        assert (out / f).exists(), f
    header, values = (out / "op_count.csv").read_text().splitlines()
    assert header == "flops,bytes_accessed,params"
    assert int(values.split(",")[2]) == sum(
        int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(
            jio.load_model(str(out / "fold0/model.fst"))[1]["params"]))
    dice = (out / "fold0/test/test_dice.csv").read_text().splitlines()
    assert dice[0] == "class0,class1,class2,class3"
    assert all(0 <= float(v) <= 1 for v in dice[1].split(","))
    cv = (out / "cv_results.csv").read_text().splitlines()
    assert cv[0] == "fold,dice" and cv[1].startswith("0,")
    first = dice[1]
    train_seg_cnn.main(["--output", str(out), "--test_only", "--fold", "0"],
                       device="cpu")
    assert (out / "fold0/test/test_dice.csv").read_text().splitlines()[1] \
        == first
