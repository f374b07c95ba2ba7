#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fissure_segmentation_tpu_torch) on
one NVIDIA card. Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero, nothing falls back to the CPU:
  1. card and settings: CUDA present, card name and power limit, TF32 off,
     the native C++ host runtime available;
  2. build every kernel from kernels/csrc with nvcc (timed);
  3. K1 (kNN) against its plain PyTorch version on the card, at the two
     shapes the serving path gives it, a ragged N and a lattice full of
     ties: indices and distances must be equal; median times of both;
  4. the serving slice at full size: a synthetic 256^3 CT, DGCNNSeg(k=40)
     with seeded random weights and a coordinate-keyed class bias added
     after the full forward (untrained weights put every keypoint in one
     class), segment_case with its defaults — one warm-up, then timed
     cases; checks keypoints, per-class meshes, labelmap, finiteness, and
     that every case launched K1 at least 11 times (10 ensemble groups +
     the normals);
  5. reference check on a small input: the same slice at 128^3 on the card
     (kernels) and on the CPU (plain versions) must agree;
  6. K2-K4 (the EdgeConv scatter kernels) against their plain versions on
     the card, at the train step's shapes (B=32, N=2048, k=40, C=64, the
     graph from K1) and a ragged shape with dropped targets, K2 with f32 and
     bf16 payloads: K4 equal, K2/K3 within twice the worst-case float32
     rounding of a sequential sum (both sides sum the same values in
     different orders), two launches bit-equal; median times of both;
  7. the training slice at full width: the port's entry point
     (train_point_seg.main, synthetic data, DGCNNSeg(k=40, static), batch
     32 x 2048, f32, NNU loss + Adam) trains fold 0 for 3 epochs; checks a
     finite loss history, model.pt and moved running statistics; then 10
     timed warm steps unfused and fused (FSEG_FUSED_EDGE=0/1, the harness
     of train/profile_step.py): ms/step, clouds/s, peak device memory,
     kernel launches. K2 must launch in both routings, K3 and K4 in the
     fused one;
  8. train-step reference on a small input (B=2, N=256, k=8): one step on
     the card (kernels) and on the CPU (plain versions) from the same
     weights and batch, in both routings: loss within rtol 1e-5, running
     statistics within 2e-4; the forward's branches (LeakyReLU sides,
     maxima, routed slots) recorded on both sides, and on the first input
     where they all agree every gradient within 2e-4 and every updated
     parameter within 2e-4, card vs CPU where Adam's step has a sure sign
     and against the CPU's Adam on the card's gradients everywhere
     (phase_train_reference says why).

Kernel launch counts are set to 0 before each main path (phase 4 serving,
phase 7 training) and read after it; the comparison launches of phases 3, 5,
6 and 8 are not counted. The line before the last is a JSON object
describing the kernels; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import csv
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from fissure_segmentation_tpu_torch.train.profile_step import card_line

KNN_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/knn.cu"
KNN_REPLACES = "fissure_segmentation_tpu/ops/pallas/knn.py:158"
SCATTER_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/scatter.cu"
PALLAS_SCATTER = "fissure_segmentation_tpu/ops/pallas/scatter.py"
SCATTER_REPLACES = {"scatter_rows": f"{PALLAS_SCATTER}:369",
                    "scatter_routed": f"{PALLAS_SCATTER}:260",
                    "scatter_count": f"{PALLAS_SCATTER}:332"}
SHAPE = (256, 256, 256)
TRAIN_ARGV = ["--ds", "synthetic", "--pts", "2048", "--k", "40", "--static",
              "--batch", "32", "--amp", "false", "--epochs", "3", "--fold",
              "0", "--train_only"]
TRAIN_TOL = dict(rtol=2e-4, atol=2e-4)
REF_SEEDS = 10      # inputs the train-step reference may try
REF_MAX_FLIPS = 8   # more forward branches than this differing: a fault
ADAM_PINNED = 1e-6  # |g'| from which Adam's first step has a sure sign
ADAM_UNPINNED_SHARE = 0.01  # of the parameters, at most, below it
EPS32 = 2.0 ** -24


def median_ms(fn, reps: int = 7, inner: int = 10, warm: int = 3) -> float:
    """Per-call ms: median over `reps` runs of `inner` back-to-back warm
    calls, each run timed with CUDA events (back to back, the host's launch
    overhead overlaps the device work instead of adding to it)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def phase_kernels(knn_cuda, knn_plain):
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    lattice = torch.randint(0, 6, (3, 4096, 3), generator=g).float()
    lattice[:, :800] = -1.0
    cases = {
        # name: (x, k, self_loop, timed)
        "dgcnn_graph_5x2048x3_k40": (
            torch.rand((5, 2048, 3), generator=g) * 2 - 1, 40, False, True),
        "psr_normals_3x8192x3_k30": (
            torch.rand((3, 8192, 3), generator=g) * 2 - 1, 30, True, True),
        "ragged_2x1000x3_k16": (
            torch.rand((2, 1000, 3), generator=g) * 2 - 1, 16, False, False),
        "lattice_ties_3x4096x3_k30": (lattice, 30, True, False),
    }
    max_err, timings = 0.0, {}
    for name, (x, k, self_loop, timed) in cases.items():
        x = x.to(dev)
        i_k, d_k = knn_cuda(x, k, self_loop)
        torch.cuda.synchronize()
        i_p, d_p = knn_plain(x, k, self_loop)
        torch.cuda.synchronize()
        if not (torch.equal(i_k, i_p) and torch.equal(d_k, d_p)):
            raise AssertionError(f"K1 {name}: kernel differs from plain "
                                 f"({(i_k != i_p).sum().item()} indices)")
        err = (d_k - d_p).abs().max().item()
        max_err = max(max_err, err)
        line = f"K1 {name}: kernel == plain (indices, distances)"
        if timed:
            t_k = median_ms(lambda: knn_cuda(x, k, self_loop))
            t_p = median_ms(lambda: knn_plain(x, k, self_loop))
            timings[name] = {"ms": t_k, "plain_ms": t_p}
            line += f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median)"
        print(line, flush=True)
    return max_err, timings


def biased_model(model, case, shape):
    """bench.py's class bias: keypoints in a z-band around each synthetic
    fissure sheet, on its lung's side, get +50 on that class's logit."""
    from fissure_segmentation_tpu_torch.data.synthetic import \
        sample_fissure_surface
    from fissure_segmentation_tpu_torch.serving import kpts_to_grid
    rng = np.random.default_rng(11)
    scale = np.array(shape[::-1], np.float32) - 1
    bands = []
    for c in (1, 2, 3):
        s = sample_fissure_surface(case["surface_params"], c, 2000, rng)
        gc = kpts_to_grid(torch.from_numpy((s * scale).astype(np.float32)),
                          shape).numpy()
        bands.append((float(gc[:, 2].mean()), float(2 * gc[:, 2].std() + 0.02),
                      float(np.sign(gc[:, 0].mean()))))

    def apply(x):
        logits = model(x)
        z, xg = x[..., 2], x[..., 0]
        bias = torch.zeros_like(logits)
        for c, (mu, w, side) in enumerate(bands, start=1):
            bias[..., c] = 50.0 * ((z - mu).abs() < w) * (xg * side > 0)
        return logits + bias
    return apply


def check_result(res, shape, what: str):
    if len(res.kpts) == 0:
        raise AssertionError(f"{what}: no valid keypoints")
    for c, (tris, valid) in enumerate(res.meshes, start=1):
        if int(valid.sum()) == 0:
            raise AssertionError(f"{what}: class {c} has no valid triangles")
        if tris.ndim != 3 or tris.shape[1:] != (3, 3) or \
                not np.isfinite(tris[valid]).all():
            raise AssertionError(f"{what}: class {c} triangles malformed")
    if res.labelmap.shape != shape or not (res.labelmap > 0).any():
        raise AssertionError(f"{what}: empty or misshapen labelmap")


def phase_slice(knn_cuda, card: str):
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    from fissure_segmentation_tpu_torch.serving import segment_case
    t0 = time.perf_counter()
    case = make_synthetic_image_case(0, shape=SHAPE)
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    model = DGCNNSeg(k=40, in_features=3, num_classes=4,
                     generator=torch.Generator().manual_seed(0)).cuda().eval()
    apply = biased_model(model, case, SHAPE)
    print(f"slice: synthetic {SHAPE} case made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def run(seed):
        return segment_case(vol, mask, apply, torch.Generator().manual_seed(seed),
                            center_x=SHAPE[2] / 2)

    t0 = time.perf_counter()
    check_result(run(1), SHAPE, "warm-up case")
    print(f"slice: warm-up case {time.perf_counter() - t0:.3f} s", flush=True)

    n_cases = 10
    knn_cuda.launches = 0
    times = []
    for i in range(n_cases):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(2 + i)
        times.append(time.perf_counter() - t0)
        check_result(res, SHAPE, f"case {i}")
    launches = knn_cuda.launches
    if launches < 11 * n_cases:
        raise AssertionError(f"K1 launched {launches} times in {n_cases} "
                             f"cases; the path needs >= {11 * n_cases}")
    tri = [int(v.sum()) for _, v in res.meshes]
    print(f"slice: {len(res.kpts)} valid keypoints, labels "
          f"{np.bincount(res.labels, minlength=4).tolist()}, valid triangles "
          f"per class {tri}, labelmap voxels per class "
          f"{np.bincount(res.labelmap.ravel(), minlength=4)[1:].tolist()}",
          flush=True)
    print(f"slice: K1 launches in {n_cases} timed cases: {launches}",
          flush=True)
    print(f"slice: {statistics.median(times):.4f} s/case median of "
          f"{[round(t, 4) for t in times]} on {card}", flush=True)
    return launches


def phase_reference(card: str):
    """Small input: the slice on the card (kernels) vs on the CPU (plain
    versions), same weights, same subsets."""
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    from fissure_segmentation_tpu_torch.serving import segment_case
    shape = (128, 128, 128)
    case = make_synthetic_image_case(1, shape=shape)
    model = DGCNNSeg(k=40, in_features=3, num_classes=4,
                     generator=torch.Generator().manual_seed(3)).eval()
    cfg = dict(max_kpts=4000, sample_points=512, n_runs_min=8,
               subset_batch=2, grid_res=(32, 32, 32), center_x=shape[2] / 2)
    out = {}
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        out[dev] = segment_case(case["image"], case["lung_mask"],
                                biased_model(m, case, shape),
                                torch.Generator().manual_seed(4), device=dev,
                                **cfg)
    a, b = out["cuda"], out["cpu"]
    if not np.array_equal(a.kpts, b.kpts):
        raise AssertionError("reference: keypoints differ card vs CPU")
    agree = float((a.labels == b.labels).mean())
    if agree < 0.99:
        raise AssertionError(f"reference: labels agree on {agree:.4f} only")
    for c, ((t1, v1), (t2, v2)) in enumerate(zip(a.meshes, b.meshes), 1):
        n1, n2 = int(v1.sum()), int(v2.sum())
        if abs(n1 - n2) > max(8, 0.05 * max(n1, n2)):
            raise AssertionError(f"reference: class {c} triangles {n1} vs {n2}")
        x, y = a.labelmap == c, b.labelmap == c
        if x.any() or y.any():
            dice = 2 * (x & y).sum() / (x.sum() + y.sum())
            if dice < 0.9:
                raise AssertionError(f"reference: class {c} Dice {dice:.3f}")
    print(f"reference: {shape} card vs CPU: keypoints equal "
          f"({len(a.kpts)}), labels agree {agree:.4f}, triangles per class "
          f"{[int(v.sum()) for _, v in a.meshes]} vs "
          f"{[int(v.sum()) for _, v in b.meshes]}", flush=True)


def _bound(ks, idx, absg, n_rows):
    """Twice the worst-case rounding of a sequential float32 sum, per
    output element: (deg - 1) * 2^-24 * sum|x| for each of the two sums."""
    deg = ks.scatter_count_plain(idx, n_rows)[..., None]
    return 2 * deg * EPS32 * ks.scatter_rows_plain(idx, absg, n_rows)


def _check_scatter(name, got, again, want, bound=None):
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    err = (got - want).abs()
    if bound is None:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain")
    elif not bool((err <= bound).all()):
        raise AssertionError(f"{name}: kernel off the plain version by "
                             f"{err.max().item()} (bound exceeded)")
    return err.max().item()


def phase_scatter(ks, knn_cuda):
    """K2-K4 against their plain versions at the train step's shapes and a
    ragged shape; returns {kernel: (max_abs_err, {shape: timings})}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, n, k, c = 32, 2048, 40, 64
    graph, _ = knn_cuda(torch.rand((b, n, 3), generator=g, device=dev) * 2
                        - 1, k)                       # the step's K1 graph
    graph = graph.contiguous()
    ragged = torch.randint(0, 1000, (3, 1000, 13), generator=g, device=dev,
                           dtype=torch.int32)
    ragged[:, ::17, 0] = 1007                         # dropped targets
    ragged[:, 3::19, 1] = -2
    ragged[:, :, 2] = 0                               # a hub row
    out = {"scatter_rows": [0.0, {}], "scatter_routed": [0.0, {}],
           "scatter_count": [0.0, {}]}

    def record(kernel, shape, err, fn_k, fn_p):
        out[kernel][0] = max(out[kernel][0], err)
        line = f"{kernel} {shape}: max |kernel - plain| {err:.3g}"
        if fn_k is not None:
            t_k, t_p = median_ms(fn_k), median_ms(fn_p)
            out[kernel][1][shape] = {"ms": t_k, "plain_ms": t_p}
            line += f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median)"
        print(line, flush=True)

    for tag, idx3, timed in (("path", graph, True), ("ragged", ragged, False)):
        bb, nn_, kk = idx3.shape
        idx2 = idx3.reshape(bb, nn_ * kk)
        for dtype in (torch.float32, torch.bfloat16):
            pay = torch.randn((bb, nn_ * kk, c), generator=g,
                              device=dev).to(dtype)
            got = ks.scatter_rows(idx2, pay, nn_)
            again = ks.scatter_rows(idx2, pay, nn_)
            want = ks.scatter_rows_plain(idx2, pay, nn_)
            err = _check_scatter("K2", got, again, want,
                                 _bound(ks, idx2, pay.float().abs(), nn_))
            shape = f"{tag}_{bb}x{nn_ * kk}x{c}_{str(dtype)[6:]}"
            record("scatter_rows", shape, err,
                   (lambda: ks.scatter_rows(idx2, pay, nn_)) if timed else None,
                   lambda: ks.scatter_rows_plain(idx2, pay, nn_))
        kstar = torch.randint(0, kk, (bb, nn_, c), generator=g, device=dev,
                              dtype=torch.int32)
        s = torch.randn((bb, nn_, c), generator=g, device=dev)
        p = torch.randn((bb, nn_, c), generator=g, device=dev)
        got = ks.scatter_routed(idx3, kstar, s, p, nn_)
        again = ks.scatter_routed(idx3, kstar, s, p, nn_)
        want = ks.scatter_routed_plain(idx3, kstar, s, p, nn_)
        deg = ks.scatter_count_plain(idx2, nn_)[..., None]
        bound = 2 * deg * EPS32 * ks.scatter_routed_plain(
            idx3, kstar, s.abs(), p.abs(), nn_)
        err = _check_scatter("K3", got, again, want, bound)
        record("scatter_routed", f"{tag}_{bb}x{nn_}x{kk}x{c}", err,
               (lambda: ks.scatter_routed(idx3, kstar, s, p, nn_))
               if timed else None,
               lambda: ks.scatter_routed_plain(idx3, kstar, s, p, nn_))
        got = ks.scatter_count(idx2, nn_)
        again = ks.scatter_count(idx2, nn_)
        err = _check_scatter("K4", got, again,
                             ks.scatter_count_plain(idx2, nn_))
        record("scatter_count", f"{tag}_{bb}x{nn_ * kk}", err,
               (lambda: ks.scatter_count(idx2, nn_)) if timed else None,
               lambda: ks.scatter_count_plain(idx2, nn_))
    torch.cuda.synchronize()
    return out


def _counts(ks, knn_cuda):
    return {"knn": knn_cuda.launches,
            "scatter_rows": ks.scatter_rows.launches,
            "scatter_routed": ks.scatter_routed.launches,
            "scatter_count": ks.scatter_count.launches}


def _reset(ks, knn_cuda):
    knn_cuda.launches = 0
    for fn in (ks.scatter_rows, ks.scatter_routed, ks.scatter_count):
        fn.launches = 0


def _read_history(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [float(r["train_total_loss"]) for r in rows]


def phase_train(ks, knn_cuda, card: str):
    """The training slice at full width through the port's entry point,
    then timed warm steps in both routings. Counts are reset before and
    read after; returns them with the timings."""
    from fissure_segmentation_tpu_torch import train_point_seg
    from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                       export_jax_variables,
                                                       load_model)
    from fissure_segmentation_tpu_torch.ops.fused_edge import (
        CUDA_DEFAULT, fused_edge_enabled)
    from fissure_segmentation_tpu_torch.train.profile_step import (
        WARM, canonical_data, make_step, time_steps)
    os.environ.pop("FSEG_FUSED_EDGE", None)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        _reset(ks, knn_cuda)
        t0 = time.perf_counter()
        if train_point_seg.main(TRAIN_ARGV + ["--output", tmp]) != 0:
            raise AssertionError("train: the entry point failed")
        counts["entry"] = _counts(ks, knn_cuda)
        fold = os.path.join(tmp, "fold0")
        hist = _read_history(os.path.join(fold, "history.csv"))
        if len(hist) != 3 or not np.isfinite(hist).all():
            raise AssertionError(f"train: loss history {hist}")
        model = load_model(os.path.join(fold, "model.pt"), DGCNNSeg)
        stats = export_jax_variables(model)["batch_stats"]
        still = [name for name, leaf in _leaves(stats)
                 if np.array_equal(leaf, np.zeros_like(leaf))
                 or np.array_equal(leaf, np.ones_like(leaf))]
        if still:
            raise AssertionError(f"train: running statistics never moved: "
                                 f"{still}")
        print(f"train: entry point (3 epochs, fold 0, default routing "
              f"{'fused' if fused_edge_enabled('cuda') else 'unfused'}) in "
              f"{time.perf_counter() - t0:.1f} s; loss history {hist}; "
              f"launches {counts['entry']}", flush=True)

        ds, loss_fn = canonical_data()
        timing = {}
        for fused in ("0", "1"):
            os.environ["FSEG_FUSED_EDGE"] = fused
            step = make_step(ds, loss_fn, tmp)
            for _ in range(WARM):
                step()
            before = _counts(ks, knn_cuda)
            ms, peak, losses = time_steps(step)
            after = _counts(ks, knn_cuda)
            if not torch.isfinite(torch.stack(losses)).all():
                raise AssertionError(f"train: non-finite loss ({fused})")
            name = "fused" if fused == "1" else "unfused"
            launched = {k: after[k] - before[k] for k in after}
            timing[name] = {
                "ms_per_step": ms, "clouds_per_s": 32e3 / ms,
                "peak_bytes": peak, "launches_10_steps": launched}
            print(f"train: {name} step {ms:.2f} ms ({32e3 / ms:.1f} "
                  f"clouds/s), peak {peak / 2 ** 30:.2f} GiB, launches in "
                  f"10 steps {launched} on {card}", flush=True)
        os.environ.pop("FSEG_FUSED_EDGE")
    counts["total"] = _counts(ks, knn_cuda)
    if timing["unfused"]["launches_10_steps"]["scatter_rows"] < 10 or \
            timing["fused"]["launches_10_steps"]["scatter_rows"] < 10:
        raise AssertionError("train: K2 did not launch in every step")
    for name in ("scatter_routed", "scatter_count"):
        if timing["fused"]["launches_10_steps"][name] < 10:
            raise AssertionError(f"train: {name} did not launch in every "
                                 "fused step")
    faster = min(timing, key=lambda r: timing[r]["ms_per_step"])
    print(f"train: faster routing on this card: {faster} (CUDA default in "
          f"ops/fused_edge.py: {'fused' if CUDA_DEFAULT else 'unfused'})",
          flush=True)
    return counts, timing


def _leaves(tree, path=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", tree[k]


def _close(name, got, want, **tol):
    if not np.allclose(got, want, **tol):
        raise AssertionError(f"train reference: {name} differs card vs CPU "
                             f"by {np.abs(got - want).max():.3g}")


class BranchRecorder(TorchFunctionMode):
    """Records the branch each decision of a forward takes: the condition
    of every three-argument torch.where (LeakyReLU, the fused core's slot
    choice and tail), the extremal mask of every amax (max over k, global
    max-pool) and every argmax/argmin (the fused core's routed slot)."""

    def __init__(self):
        super().__init__()
        self.branches = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        if name == "where" and len(args) == 3:
            self.branches.append(args[0].detach().cpu())
        elif name == "amax":
            dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
            x = args[0].detach()
            self.branches.append((x == x.amax(dim=dim, keepdim=True)).cpu())
        elif name in ("argmax", "argmin"):
            self.branches.append(out.detach().cpu())
        return out


def _reference_step(dev, model0, ds, cw, cfg, x, y):
    """One trainer step on `dev`; returns (model, loss, components, the
    forward's branches)."""
    from fissure_segmentation_tpu_torch.losses import get_loss_fn
    from fissure_segmentation_tpu_torch.train.trainer import ModelTrainer
    trainer = ModelTrainer(copy.deepcopy(model0), ds,
                           get_loss_fn("nnunet", cw.to(dev)),
                           tempfile.gettempdir(), cfg, device=dev)
    rec = BranchRecorder()

    def enter(*_):
        rec.__enter__()

    def leave(*_):
        rec.__exit__(None, None, None)
    hooks = [trainer.model.register_forward_pre_hook(enter),
             trainer.model.register_forward_hook(leave)]
    loss, comps = trainer.train_step(x.to(dev), y.to(dev))
    for h in hooks:
        h.remove()
    return (trainer.model, float(loss),
            {k: float(v) for k, v in comps.items()}, rec.branches)


def _reference_model(seed, ds):
    """DGCNNSeg(k=8) with seeded weights and every BatchNorm offset drawn
    from ±[0.05, 0.1]. The offsets matter to the updated parameters: the
    loss gradient of SharedMLP_0's BatchNorm offset vanishes analytically
    (the global max passes its shift on to SharedMLP_1, whose BatchNorm
    removes it), and with a zero offset Adam's first step,
    lr * g' / (|g'| + eps) with g' = g + wd * p, would move it by up to lr
    in the direction of its rounding noise. A nonzero offset gives g' the
    sign of wd * p on both sides."""
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    from fissure_segmentation_tpu_torch.models.blocks import BatchNorm
    model = DGCNNSeg(k=8, in_features=ds.n_features,
                     num_classes=ds.num_classes,
                     generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(1000 + seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                size = torch.rand(m.bias.shape, generator=g)
                sign = torch.randint(0, 2, m.bias.shape, generator=g) * 2 - 1
                m.bias.copy_(sign * (0.05 + 0.05 * size))
    return model


def phase_train_reference():
    """One step at B=2, N=256, k=8 on the card (kernels) and on the CPU
    (plain versions), same weights (`_reference_model`), same batch, both
    routings.

    The loss and its components (rtol 1e-5) and the running statistics
    (2e-4) are continuous in the rounding and are held on every input
    tried. The gradient is not: where a float32 rounding puts one
    LeakyReLU input or one max on the other side of its decision, the
    gradient of that element changes by a finite amount. So the forward's
    branches are recorded on both sides (BranchRecorder) and compared: more
    than REF_MAX_FLIPS differing branches fail the phase (that is no
    rounding); an input with 1..REF_MAX_FLIPS is set aside, and the next
    seed's weights and batch are tried, up to REF_SEEDS. On the first input
    whose branches all agree:
      * every gradient leaf within 2e-4 card vs CPU;
      * every updated parameter within 2e-4 card vs CPU, but for those
        whose Adam input g' = g + wd * p has opposite signs on the two
        sides or a magnitude below ADAM_PINNED on either: Adam's first step
        is lr * g' / (|g'| + eps), about lr * sign(g'), so there float32
        rounding decides the step. They are counted and may be at most
        ADAM_UNPINNED_SHARE of the parameters;
      * every updated parameter, those included, within 2e-4 of the CPU's
        Adam applied to the card's gradients from the same start."""
    from fissure_segmentation_tpu_torch.data.dataset import PointDataset
    from fissure_segmentation_tpu_torch.data.store import sample_batch
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_dataset
    from fissure_segmentation_tpu_torch.models import export_jax_variables
    from fissure_segmentation_tpu_torch.train.trainer import TrainConfig
    ds = PointDataset(make_synthetic_dataset(3, n_points=600),
                      sample_points=256)
    store = ds.to_store(device="cuda")
    cw = torch.as_tensor(ds.get_class_weights())
    cfg = TrainConfig()
    for fused in ("0", "1"):
        os.environ["FSEG_FUSED_EDGE"] = fused
        route = "fused" if fused == "1" else "unfused"
        set_aside = []
        for seed in range(REF_SEEDS):
            model0 = _reference_model(seed, ds)
            x, y = sample_batch(
                store, torch.tensor([0, 2], device="cuda"), ds.sample_points,
                torch.Generator(device="cuda").manual_seed(100 + seed))
            m_g, l_g, c_g, br_g = _reference_step("cuda", model0, ds, cw,
                                                  cfg, x, y)
            m_c, l_c, c_c, br_c = _reference_step("cpu", model0, ds, cw,
                                                  cfg, x, y)
            _close("loss", l_g, l_c, rtol=1e-5, atol=0)
            for k in c_c:
                _close(k, c_g[k], c_c[k], rtol=1e-5, atol=0)
            v_g = dict(_leaves(export_jax_variables(m_g)))
            v_c = dict(_leaves(export_jax_variables(m_c)))
            for name in v_c:
                if name.startswith("batch_stats/"):
                    _close(name, v_g[name], v_c[name], **TRAIN_TOL)
            if [b.shape for b in br_g] != [b.shape for b in br_c]:
                raise AssertionError("train reference: the card's forward "
                                     "took other decisions than the CPU's")
            n_br = sum(b.numel() for b in br_c)
            flips = sum(int((a != b).sum()) for a, b in zip(br_g, br_c))
            if flips > REF_MAX_FLIPS:
                raise AssertionError(f"train reference: {flips} of {n_br} "
                                     "forward branches differ card vs CPU")
            g_g = dict(_leaves(export_jax_variables(m_g, grad=True)))
            g_c = dict(_leaves(export_jax_variables(m_c, grad=True)))
            worst = max(float(np.abs(g_g[k] - g_c[k]).max()) for k in g_c)
            if flips:
                set_aside.append((seed, flips, float(f"{worst:.3g}")))
                continue
            for name in g_c:
                _close(f"grad {name}", g_g[name], g_c[name], **TRAIN_TOL)
            adam = copy.deepcopy(model0)
            for p, q in zip(adam.parameters(), m_g.parameters()):
                p.grad = q.grad.detach().cpu()
            torch.optim.Adam(adam.parameters(), lr=cfg.lr,
                             weight_decay=cfg.weight_decay).step()
            want = dict(_leaves(export_jax_variables(adam)))
            start = dict(_leaves(export_jax_variables(model0)))
            n_params, unpinned, upd_gap = 0, 0, 0.0
            for name in g_c:
                _close(f"updated {name}", v_g[name], want[name], **TRAIN_TOL)
                wd_p = cfg.weight_decay * start[name]
                a, b = g_g[name] + wd_p, g_c[name] + wd_p
                free = (np.sign(a) != np.sign(b)) | \
                    (np.minimum(np.abs(a), np.abs(b)) < ADAM_PINNED)
                _close(f"updated {name}", v_g[name][~free],
                       v_c[name][~free], **TRAIN_TOL)
                if (~free).any():
                    upd_gap = max(upd_gap, float(np.abs(
                        v_g[name][~free] - v_c[name][~free]).max()))
                n_params += free.size
                unpinned += int(free.sum())
            if unpinned > ADAM_UNPINNED_SHARE * n_params:
                raise AssertionError(f"train reference: {unpinned} of "
                                     f"{n_params} Adam steps not pinned")
            print(f"train reference: {route} step, seed {seed} (set aside, "
                  "(seed, differing branches, max gradient gap): "
                  f"{set_aside}); {n_br} "
                  f"forward branches equal card vs CPU; loss {l_g:.7f} vs "
                  f"{l_c:.7f}; all {len(g_c)} gradient leaves within 2e-4 "
                  f"(max |diff| {worst:.3g}); updated parameters within "
                  f"2e-4 card vs CPU (max |diff| {upd_gap:.3g}) but "
                  f"{unpinned} of {n_params} whose Adam input is unpinned "
                  f"(opposite signs or below {ADAM_PINNED:g}); all within "
                  f"2e-4 of the CPU's Adam on the card's gradients; "
                  f"running statistics within 2e-4", flush=True)
            break
        else:
            raise AssertionError(f"train reference: no {route} input of "
                                 f"{REF_SEEDS} with equal branches: "
                                 f"{set_aside}")
    os.environ.pop("FSEG_FUSED_EDGE")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA card", file=sys.stderr)
        return 2
    from fissure_segmentation_tpu_torch.kernels import _build
    from fissure_segmentation_tpu_torch.kernels import scatter as ks
    from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda, knn_plain
    from fissure_segmentation_tpu_torch.postprocess.surface_fitting import \
        native_runtime

    # 1. card and settings
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    native_runtime()  # raises if the native C++ host runtime is unavailable

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"build: {_build.sources()} -> {lib} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 3. K1 against its plain version
    max_err, timings = phase_kernels(knn_cuda, knn_plain)

    # 4. the serving slice at full size (counts from 0, read after)
    _reset(ks, knn_cuda)
    serving_launches = phase_slice(knn_cuda, card)

    # 5. serving reference check on a small input
    phase_reference(card)

    # 6. K2-K4 against their plain versions
    scatter = phase_scatter(ks, knn_cuda)

    # 7. the training slice at full width (counts from 0, read after)
    counts, train_timing = phase_train(ks, knn_cuda, card)
    print(json.dumps({"train": train_timing, "card": card}), flush=True)

    # 8. train-step reference on a small input
    phase_train_reference()

    graph = timings["dgcnn_graph_5x2048x3_k40"]
    kernels = [{
        "name": "knn", "route": "cuda", "source": KNN_SOURCE,
        "replaces": KNN_REPLACES,
        "launches": serving_launches + counts["total"]["knn"],
        "max_abs_err": max_err, "ms": graph["ms"],
        "plain_ms": graph["plain_ms"], "shapes": timings}]
    for name, (err, shapes) in scatter.items():
        path = next(iter(shapes.values()))       # the first timed shape
        row = {"name": name, "route": "cuda", "source": SCATTER_SOURCE,
               "replaces": SCATTER_REPLACES[name],
               "launches": counts["total"][name], "max_abs_err": err,
               "ms": path["ms"], "plain_ms": path["plain_ms"],
               "shapes": shapes}
        if name == "scatter_rows":
            row["also_replaces"] = f"{PALLAS_SCATTER}:133"
        kernels.append(row)
    for row in kernels:
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} never launched on the main "
                                 "paths")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
