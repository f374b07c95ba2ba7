"""How well float32 computes a PointTransformerSeg train step: the port's
model in float32 against the same model in float64, on the CPU.

    python scripts/prof/pt_float32_conditioning.py [--small] [B N ...]
    python scripts/prof/pt_float32_conditioning.py --jax

For each (B, N) (default: 2 512, 8 1024, 16 1024) it builds the model of
chip_smoke.py's phase 12 (seed 0, nonzero BatchNorm offsets; `--small`:
the narrow model of tests/test_torch_point_transformer.py, blocks 1 x 5,
planes (8, 16, 16, 32, 32)), takes dyadic coordinates (every kNN distance
exact, so both precisions select the same neighbours and FPS points), and
prints, float32 against float64:
  * train mode: the NNU loss (relative gap), the largest logit gap, the
    largest gap of each TransitionDown's output, the running statistics
    after the step's forward, and the gradient (relative L2 over all
    parameters, and the worst leaf);
  * eval mode: the largest logit gap and the largest gradient gap of
    sum(logits * w).
With --jax it runs instead the configuration of
tests/test_torch_point_transformer.py::test_point_transformer_adam_step_
matches_jax (the JAX model's init, BatchNorm randomized, B=2 x 512) through
the JAX package in float32 and in float64 (jax.enable_x64) and through the
port in float32, and prints the gradients' relative L2 gaps.

In float64 BatchNorm's statistics and the attention softmax run in
float64 (the port fixes both to float32, so they are patched here); FPS
runs on float32 copies of the dyadic points, which are exact. These are
CPU numbers about float32 arithmetic, not device measurements. They set
the tolerances of phase 12 of chip_smoke.py and of the whole-model train
test in tests/test_torch_point_transformer.py.
"""
from __future__ import annotations

import argparse
import copy
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from chip_smoke import _pt_reference_model  # noqa: E402
from fissure_segmentation_tpu_torch.losses import get_loss_fn  # noqa: E402
from fissure_segmentation_tpu_torch.models import (  # noqa: E402
    PointTransformerSeg, export_jax_variables)
from fissure_segmentation_tpu_torch.models import blocks  # noqa: E402
from fissure_segmentation_tpu_torch.ops import fps as ops_fps  # noqa: E402

SMALL = dict(blocks=(1, 1, 1, 1, 1), planes=(8, 16, 16, 32, 32))


def _bn_any_dtype(self, x):
    """models/blocks.py:BatchNorm.forward with statistics in x's dtype."""
    if self.training:
        axes = tuple(range(x.ndim - 1))
        mean = x.mean(axes)
        var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
        self.update_running(mean.float(), var.float())
    else:
        mean, var = self.mean.to(x.dtype), self.var.to(x.dtype)
    mul = torch.rsqrt(var + self.epsilon) * self.scale.to(x.dtype)
    return (x - mean) * mul + self.bias.to(x.dtype)


def _leaves(tree, path=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", tree[k]


def _model(small: bool):
    if not small:
        return _pt_reference_model(0)
    return PointTransformerSeg(4, 4, generator=torch.Generator().manual_seed(0),
                               **SMALL)


def measure(b: int, n: int, small: bool) -> None:
    rng = np.random.default_rng(200)
    x = torch.from_numpy((rng.integers(-16, 17, (b, n, 4)) / 16.0)
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (b, n)))
    w = torch.from_numpy(rng.normal(size=(b, n, 4)))
    cw = torch.tensor([0.4, 1.2, 1.1, 1.3], dtype=torch.float64)
    m0 = _model(small)
    res = {}
    for dt in (torch.float32, torch.float64):
        m = copy.deepcopy(m0).to(dt).train()
        downs = {}
        for i in range(5):
            getattr(m, f"TransitionDown_{i}").register_forward_hook(
                lambda mod, inp, out, i=i: downs.__setitem__(
                    i, out[1].detach().double()))
        logits = m(x.to(dt))
        loss, _ = get_loss_fn("nnunet", cw.to(dt))(logits, y)
        loss.backward()
        grads = dict(_leaves(export_jax_variables(m, grad=True)))
        stats = dict(_leaves(export_jax_variables(m)["batch_stats"]))
        e = copy.deepcopy(m0).to(dt).eval()
        e_logits = e(x.to(dt))
        (e_logits * w.to(dt)).sum().backward()
        e_grads = dict(_leaves(export_jax_variables(e, grad=True)))
        res[dt] = (float(loss.detach()), logits.detach().double(), downs,
                   grads, stats, e_logits.detach().double(), e_grads)
    a, r = res[torch.float32], res[torch.float64]
    gap = np.sqrt(sum(np.sum((a[3][k] - r[3][k]) ** 2) for k in r[3]))
    norm = np.sqrt(sum(np.sum(r[3][k] ** 2) for k in r[3]))
    worst = max((float(np.linalg.norm(a[3][k] - r[3][k])
                       / (np.linalg.norm(r[3][k]) + 1e-30)), k)
                for k in r[3] if np.abs(r[3][k]).max() > 1e-4)
    print(f"B={b} N={n} {'narrow' if small else 'full width'}: train loss "
          f"{a[0]:.7f} vs {r[0]:.7f} (relative {abs(a[0] - r[0]) / r[0]:.3g}"
          f"), logits {float((a[1] - r[1]).abs().max()):.3g}; "
          "TransitionDown outputs "
          f"{[float(f'{float((a[2][i] - r[2][i]).abs().max()):.3g}') for i in range(5)]}; "
          f"running statistics "
          f"{max(float(np.abs(a[4][k] - r[4][k]).max()) for k in r[4]):.3g}; "
          f"gradient {gap / norm:.3g} (relative L2), worst leaf "
          f"{worst[0]:.3g} ({worst[1]}); eval logits "
          f"{float((a[5] - r[5]).abs().max()):.3g}, eval gradient "
          f"{max(float(np.abs(a[6][k] - r[6][k]).max()) for k in r[6]):.3g}",
          flush=True)


def jax_comparison() -> None:
    """The JAX package in float32 and float64 and the port in float32, on
    the whole-model train test's configuration."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from fissure_segmentation_tpu.losses import segmentation as jlosses
    from fissure_segmentation_tpu.models import point_transformer as jpt
    from fissure_segmentation_tpu_torch.models import load_jax_variables
    jax.config.update("jax_platforms", "cpu")
    rng = np.random.default_rng(31)
    jm = jpt.PointTransformerSeg(in_features=4, num_classes=4, **SMALL)
    x = (rng.integers(-16, 17, (2, 512, 4)) / 16.0).astype(np.float32)
    y = rng.integers(0, 4, (2, 512)).astype(np.int32)

    def randomize(path, a):       # as the test's _randomize_bn
        name = jax.tree_util.keystr(path)
        if "BatchNorm" not in name:
            return a
        if "var" in name:
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return (rng.normal(0, 0.3, a.shape) +
                (1.0 if "scale" in name else 0.0)).astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(
        randomize, jax.tree_util.tree_map(np.asarray, jm.init(
            jax.random.PRNGKey(3), x)))
    cw = np.asarray([0.4, 1.2, 1.1, 1.3], np.float32)

    def jax_grads(dt):
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, dt), variables)

        def loss(params):
            out = jm.apply({**v, "params": params}, x.astype(dt), train=True,
                           mutable=["batch_stats"])[0]
            return jlosses.nnu_loss(out, y, jnp.asarray(cw, dt))[0]
        return dict(_leaves(jax.tree_util.tree_map(
            np.asarray, jax.grad(loss)(v["params"]))))

    with jax.default_matmul_precision("float32"):
        g32 = jax_grads(np.float32)
    with jax.enable_x64():
        g64 = jax_grads(np.float64)
    model = load_jax_variables(PointTransformerSeg(4, 4, **SMALL),
                               variables).train()
    loss, _ = get_loss_fn("nnunet", torch.from_numpy(cw))(
        model(torch.from_numpy(x)), torch.from_numpy(y).long())
    loss.backward()
    gt = dict(_leaves(export_jax_variables(model, grad=True)["params"]))

    def rel(a, b):
        return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in b)
                             / sum(np.sum(b[k] ** 2) for k in b)))
    print(f"train-mode gradient, relative L2: JAX float32 vs JAX float64 "
          f"{rel(g32, g64):.3g}; port float32 vs JAX float64 "
          f"{rel(gt, g64):.3g}; port float32 vs JAX float32 "
          f"{rel(gt, g32):.3g}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("shapes", nargs="*", type=int,
                    default=[2, 512, 8, 1024, 16, 1024])
    args = ap.parse_args(argv)
    if args.jax:
        jax_comparison()
        return 0
    blocks.BatchNorm.forward = _bn_any_dtype
    fps0 = ops_fps.fps_cuda
    ops_fps.fps_cuda = lambda p, m, v=None: fps0(p.float().contiguous(), m, v)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for b, n in zip(args.shapes[::2], args.shapes[1::2]):
        measure(b, n, args.small)
    return 0


if __name__ == "__main__":
    sys.exit(main())
