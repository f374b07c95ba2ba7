#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fissure_segmentation_tpu_torch) on
one NVIDIA card. Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero, nothing falls back to the CPU:
  1. card and settings: CUDA present, card name and power limit, TF32 off,
     the native C++ host runtime built from native/src with g++;
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
     the normals) and the gather-reduce at least 20 (10 groups x the two
     fused EdgeConvs);
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

  9. K5 (farthest-point sampling) against its plain PyTorch version on the
     card at the PointTransformer path's shapes (the train step's first two
     TransitionDowns, a served ensemble group), DSEG-AE's masked shape, a
     ragged N, a lattice full of ties and C = 4: indices equal; median
     times of both;
 10. the serving slice with PointTransformerSeg at full width (seeded
     weights, the same class bias): one warm-up and 3 timed full-size
     cases with phase 4's checks; K5 must launch at least 40 times a case
     (10 ensemble groups x 4 TransitionDowns);
 11. the training slice with PointTransformerSeg at full width through the
     entry point (--model PointTransformer, 32 x 2048, 3 epochs of fold 0;
     phase 7's checks), then 10 timed warm steps (ms/step, clouds/s, peak
     memory); K5 must launch at least 4 times a step;
 12. PointTransformer train-step reference, card vs CPU, at full depth and
     width on a small batch (phase_pt_reference says which and why): every
     FPS and kNN selection recorded on both sides; FPS equal; an input
     whose kNN selections differ is set aside; on the first agreeing input
     the loss, running statistics, gradients and updated parameters are
     held as phase_pt_reference states;
 13. K6 (the 3x3x3 depthwise convolution) against its plain version on
     the card at the seven stride-1 depthwise layers of MobileNetASPP on a
     256^3 CT (six shapes), bfloat16 at the widest, a ragged shape and
     D = 1: outputs equal; median times of the kernel, the plain version
     and cuDNN's grouped conv3d (the library yardstick), with the bound;
 14. the serving slice in kp_mode="cnn" at full size: segment_case runs
     MobileNetASPP(num_classes=4) (seeded weights) on the 256^3 CT, then
     phase 4's keypoint-to-mesh path; one warm-up and 3 timed cases with
     phase 4's checks, K6 at least 7 launches a case; the CNN forward's
     time and the peak device memory; then one kp_mode="enhancement" case
     with phase 4's checks;
 15. CNN reference on a small input (40 x 48 x 56, full width): softmax
     card vs CPU within CNN_SOFT_TOL, argmax and the staged keypoints
     equal but at near-ties (phase_cnn_reference);
 16. the fused EdgeConv gather-reduce (P5's function) against its plain
     version, equal in every output, want "max", "extrema" and "all", f32
     and bf16: at the train step's shape (32, 2048, 40, 64) on K1's graph,
     the serving ensemble's (5, 2048, 40, 64), an integer lattice full of
     k-ties and indices out of range; median times of the kernel, the
     plain version, the flat gather + reductions the port ran before, the
     library call (embedding_bag, "max" only) and the bound;
 17. the bf16 DGCNN training slice at full width (--amp true): 10 timed
     warm steps of DGCNNSeg(k=40, static, bf16) fused and unfused (ms/step,
     clouds/s, peak memory, launches: K2 every step in both routings, the
     gather-reduce, K3 and K4 every fused step), then the entry point with
     --amp true trains fold 0 for 3 epochs (phase 7's checks, and the model
     written as bf16);
 18. bf16 train-step reference on a small input (B=2, N=256, k=8): one
     step on the card and on the CPU from the same weights and batch, both
     routings, held within BF16_TOL (phase_bf16_reference says why); the
     same step on the card with a planted fault (a wrong neighbour in the
     backward) must miss the gradient tolerance;
 19. the probes of P1-P4 (prof/probes.py) at 3 repetitions, each variant
     checked against its plain version first (stream_sum and
     stream_sum_async within their rounding bound on the payload, equal on
     a payload of integers, where every sum is exact, and unequal there
     once a tile is zeroed); the stream kernels' times beside their plain
     version, torch.sum and the bound. P5's comparison is phase 16's.

Kernel launch counts are set to 0 before each main path (phases 4, 10 and
14 serving, phases 7, 11 and 17 training, phase 19 the probes) and read
after it; the comparison launches of phases 3, 5, 6, 8, 9, 12, 13, 15, 16
and 18 and of the probes' own checks are not counted. The line before the last but one is a JSON object
describing the kernels (with each one's bound: the larger of its bytes over
3.35 TB/s and its operations over the 67 TFLOP/s float32 rate, and the time
of one PyTorch library call that computes the same function, where there
is one; the stream kernels' rows say "path": "probes"); then the card's
name and power limit as nvidia-smi gives them; the last line is {"ok":
true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import copy
import csv
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from fissure_segmentation_tpu_torch.prof.probes import median_ms
from fissure_segmentation_tpu_torch.train.profile_step import card_line

KNN_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/knn.cu"
FPS_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/fps.cu"
FPS_REPLACES = "fissure_segmentation_tpu/ops/pallas/fps.py:83"
KNN_REPLACES = "fissure_segmentation_tpu/ops/pallas/knn.py:158"
SCATTER_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/scatter.cu"
DW_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/depthwise.cu"
PALLAS_DW = "fissure_segmentation_tpu/ops/pallas/depthwise.py"
PALLAS_SCATTER = "fissure_segmentation_tpu/ops/pallas/scatter.py"
SCATTER_REPLACES = {"scatter_rows": f"{PALLAS_SCATTER}:369",
                    "scatter_routed": f"{PALLAS_SCATTER}:260",
                    "scatter_count": f"{PALLAS_SCATTER}:332"}
GR_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/gather_reduce.cu"
GR_REPLACES = "scripts/prof/prof_fused_gather.py:64"
STREAM_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/stream.cu"
STREAM_REPLACES = {
    "stream_sum": "scripts/prof/prof_stream_bw.py:35",
    "stream_sum_async": "scripts/prof/prof_scatter_alt.py:147"}
STREAM_ALSO = {
    "stream_sum": ["scripts/prof/prof_scatter_floor.py:28",
                   "scripts/prof/prof_scatter_clean.py:65",
                   "scripts/prof/prof_scatter_alt.py:130"],
    "stream_sum_async": []}
SHAPE = (256, 256, 256)
TRAIN_ARGV = ["--ds", "synthetic", "--pts", "2048", "--k", "40", "--static",
              "--batch", "32", "--amp", "false", "--epochs", "3", "--fold",
              "0", "--train_only"]
AMP_TRAIN_ARGV = [a if a != "false" else "true" for a in TRAIN_ARGV]
PT_TRAIN_ARGV = ["--model", "PointTransformer", "--ds", "synthetic", "--pts",
                 "2048", "--batch", "32", "--train_only", "--fold", "0",
                 "--epochs", "3"]
TRAIN_TOL = dict(rtol=2e-4, atol=2e-4)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12           # float32 outside the tensor cores
# least cycles of one dependent FPS step: a block-wide argmax needs two
# 5-level shuffle trees (~25 cycles a level), a shared-memory store and
# load (~30 each) and a barrier (~20): an estimate, not a measurement
FPS_STEP_CYCLES = 330
REF_SEEDS = 10      # inputs the train-step reference may try
REF_MAX_FLIPS = 8   # more forward branches than this differing: a fault
ADAM_PINNED = 1e-6  # |g'| from which Adam's first step has a sure sign
ADAM_UNPINNED_SHARE = 0.01  # of the parameters, at most, below it
PT_UNPINNED_SHARE = 0.1     # PointTransformer (phase_pt_reference)
PT_EVAL_GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
EPS32 = 2.0 ** -24
CNN_SOFT_TOL = 5e-5  # phase_cnn_reference says why
# phase_bf16_reference says why
BF16_TOL = {"logits": 3e-2, "loss": 1e-2, "grad_rel_l2": 0.12,
            "stats_rel_l2": 2e-2}


def bound_ms(n_bytes: float, n_ops: float):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over the peak rate;
    returns (ms, "bytes" or "operations")."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


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
            b, n, c = x.shape
            kk = k if self_loop else k + 1
            # read x once, write idx and dist; c subs, c muls, c adds a pair
            bound, by = bound_ms(x.numel() * 4 + b * n * kk * 8,
                                 3 * c * b * n * n)
            timings[name] = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound,
                             "bound_by": by}
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), "
                     f"bound {bound:.4f} ms ({by})")
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
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import \
        gather_reduce
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
    knn_cuda.launches = gather_reduce.launches = 0
    times = []
    for i in range(n_cases):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(2 + i)
        times.append(time.perf_counter() - t0)
        check_result(res, SHAPE, f"case {i}")
    launches = {"knn": knn_cuda.launches,
                "gather_reduce": gather_reduce.launches}
    if launches["knn"] < 11 * n_cases:
        raise AssertionError(f"K1 launched {launches['knn']} times in "
                             f"{n_cases} cases; the path needs >= "
                             f"{11 * n_cases}")
    if launches["gather_reduce"] < 20 * n_cases:
        raise AssertionError(f"gather_reduce launched "
                             f"{launches['gather_reduce']} times in "
                             f"{n_cases} cases; the path needs >= "
                             f"{20 * n_cases}")
    tri = [int(v.sum()) for _, v in res.meshes]
    print(f"slice: {len(res.kpts)} valid keypoints, labels "
          f"{np.bincount(res.labels, minlength=4).tolist()}, valid triangles "
          f"per class {tri}, labelmap voxels per class "
          f"{np.bincount(res.labelmap.ravel(), minlength=4)[1:].tolist()}",
          flush=True)
    print(f"slice: launches in {n_cases} timed cases: {launches}",
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

    def record(kernel, shape, err, fn_k, fn_p, work=None, fn_lib=None):
        """`work`: (bytes, operations) of the function, for its bound;
        `fn_lib`: one PyTorch library call computing it, or None."""
        out[kernel][0] = max(out[kernel][0], err)
        line = f"{kernel} {shape}: max |kernel - plain| {err:.3g}"
        if fn_k is not None:
            t_k, t_p = median_ms(fn_k), median_ms(fn_p)
            t_l = None if fn_lib is None else median_ms(fn_lib)
            bound, by = bound_ms(*work)
            out[kernel][1][shape] = {"ms": t_k, "plain_ms": t_p,
                                     "bound_ms": bound, "bound_by": by,
                                     "library_ms": t_l}
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library "
                     f"{'none' if t_l is None else f'{t_l:.4f} ms'} "
                     f"(median), bound {bound:.4f} ms ({by})")
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
            flat = ks._flat_targets(idx2, nn_)
            acc = torch.zeros((bb * nn_ + 1, c), device=dev)
            pay2 = pay.reshape(-1, c).float()
            record("scatter_rows", shape, err,
                   (lambda: ks.scatter_rows(idx2, pay, nn_)) if timed else None,
                   lambda: ks.scatter_rows_plain(idx2, pay, nn_),
                   # read idx and the payload, write (B, rows, C) f32; one
                   # add per payload element
                   (idx2.numel() * 4 + pay.numel() * pay.element_size()
                    + bb * nn_ * c * 4, pay.numel()),
                   lambda: acc.index_add_(0, flat, pay2))
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
               lambda: ks.scatter_routed_plain(idx3, kstar, s, p, nn_),
               # read idx, kstar, s, p; write (B, rows, 2C) f32; per edge
               # and channel two adds
               (idx3.numel() * 4 + 3 * bb * nn_ * c * 4 + bb * nn_ * 2 * c
                * 4, 2 * idx3.numel() * c))
        got = ks.scatter_count(idx2, nn_)
        again = ks.scatter_count(idx2, nn_)
        err = _check_scatter("K4", got, again,
                             ks.scatter_count_plain(idx2, nn_))
        flat = ks._flat_targets(idx2, nn_)
        record("scatter_count", f"{tag}_{bb}x{nn_ * kk}", err,
               (lambda: ks.scatter_count(idx2, nn_)) if timed else None,
               lambda: ks.scatter_count_plain(idx2, nn_),
               # read idx, write (B, rows) f32; one add per edge
               (idx2.numel() * 4 + bb * nn_ * 4, idx2.numel()),
               lambda: torch.bincount(flat, minlength=bb * nn_ + 1))
    torch.cuda.synchronize()
    return out


def _wrappers(ks, knn_cuda) -> dict:
    """Every kernel wrapper of the port, by the name its counts go under."""
    from fissure_segmentation_tpu_torch.kernels.depthwise import \
        depthwise_conv3_cuda
    from fissure_segmentation_tpu_torch.kernels.fps import fps_cuda
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import \
        gather_reduce
    from fissure_segmentation_tpu_torch.kernels.stream import (
        stream_sum, stream_sum_async)
    return {"knn": knn_cuda, "scatter_rows": ks.scatter_rows,
            "scatter_routed": ks.scatter_routed,
            "scatter_count": ks.scatter_count, "fps": fps_cuda,
            "depthwise_conv3": depthwise_conv3_cuda,
            "gather_reduce": gather_reduce, "stream_sum": stream_sum,
            "stream_sum_async": stream_sum_async}


def _counts(ks, knn_cuda):
    return {k: fn.launches for k, fn in _wrappers(ks, knn_cuda).items()}


def _reset(ks, knn_cuda):
    for fn in _wrappers(ks, knn_cuda).values():
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
    for name in ("scatter_routed", "scatter_count", "gather_reduce"):
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
    max-pool), every argmax/argmin, and the first extremal slots the fused
    core's gather-reduce returns (its routed slots; ops/fused_edge.py's
    `gather_reduce` is wrapped while active, and the plain version's own
    torch calls inside it are not recorded, so the card's kernel and the
    CPU's plain version record the same)."""

    def __init__(self):
        super().__init__()
        self.branches = []
        self._inside = False

    def __enter__(self):
        from fissure_segmentation_tpu_torch.ops import fused_edge as fe
        self._fe, self._saved = fe, fe.gather_reduce

        def gather_reduce(a, idx, want):
            self._inside = True
            try:
                out = self._saved(a, idx, want)
            finally:
                self._inside = False
            if want == "all":
                self.branches += [out[2].cpu(), out[3].cpu()]
            return out
        fe.gather_reduce = gather_reduce
        return super().__enter__()

    def __exit__(self, *exc):
        self._fe.gather_reduce = self._saved
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
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


def _reference_model(seed, ds, dtype=None):
    """DGCNNSeg(k=8) with seeded weights and every BatchNorm offset drawn
    from ±[0.05, 0.1]. The offsets matter to the updated parameters: the
    loss gradient of SharedMLP_0's BatchNorm offset vanishes analytically
    (the global max passes its shift on to SharedMLP_1, whose BatchNorm
    removes it), and with a zero offset Adam's first step,
    lr * g' / (|g'| + eps) with g' = g + wd * p, would move it by up to lr
    in the direction of its rounding noise. A nonzero offset gives g' the
    sign of wd * p on both sides."""
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    model = DGCNNSeg(k=8, in_features=ds.n_features,
                     num_classes=ds.num_classes,
                     generator=torch.Generator().manual_seed(seed),
                     dtype=dtype)
    return _draw_bn_offsets(model, seed)


def _draw_bn_offsets(model, seed):
    """Every BatchNorm offset of `model` drawn from ±[0.05, 0.1]."""
    from fissure_segmentation_tpu_torch.models.blocks import BatchNorm
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

# ---- PointTransformer (K5) ---------------------------------------------------

def _max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def phase_fps(fps_cuda, fps_plain):
    """K5 against its plain version; returns (max index gap, {shape:
    timings with bound}). Beside the byte/operation bound each timed shape
    gets a latency estimate: m - 1 dependent steps, each at least
    FPS_STEP_CYCLES cycles at the card's highest SM clock."""
    dev = torch.device("cuda")
    step_s = FPS_STEP_CYCLES / _max_sm_clock_hz()
    g = torch.Generator().manual_seed(5)

    def uniform(*shape):
        return torch.rand(shape, generator=g) * 2 - 1
    lattice = torch.randint(0, 6, (2, 4096, 3), generator=g).float()
    cases = {
        # name: (points, m, valid share, timed)
        "pt_step_32x2048x3_m512": (uniform(32, 2048, 3), 512, 1.0, True),
        "pt_step_32x512x3_m128": (uniform(32, 512, 3), 128, 1.0, True),
        "pt_serve_5x2048x3_m512": (uniform(5, 2048, 3), 512, 1.0, True),
        "dseg_masked_1x20000x3_m1024": (uniform(1, 20000, 3), 1024, 0.35,
                                        True),
        "ragged_3x1000x3_m250": (uniform(3, 1000, 3), 250, 0.8, False),
        "lattice_ties_2x4096x3_m300": (lattice, 300, 1.0, False),
        "c4_2x700x4_m100": (uniform(2, 700, 4), 100, 0.6, False),
    }
    timings = {}
    for name, (x, m, share, timed) in cases.items():
        x = x.to(dev)
        valid = None
        if share < 1.0:
            valid = (torch.rand(x.shape[:2], generator=g) < share).to(dev)
        got = fps_cuda(x, m, valid)
        torch.cuda.synchronize()
        want = fps_plain(x, m, valid)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K5 {name}: kernel differs from plain "
                                 f"({(got != want).sum().item()} indices)")
        line = f"K5 {name}: kernel == plain (indices)"
        if timed:
            t_k = median_ms(lambda: fps_cuda(x, m, valid))
            t_p = median_ms(lambda: fps_plain(x, m, valid), reps=3, inner=1,
                            warm=1)
            b, n, c = x.shape
            # read points and validity, write (B, m) int32; per step and
            # point c subs, c muls, c adds and the min
            bound, by = bound_ms(x.numel() * 4 + b * n + b * m * 4,
                                 (m - 1) * b * n * (3 * c + 1))
            latency = (m - 1) * step_s * 1e3
            timings[name] = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound,
                             "bound_by": by, "latency_estimate_ms": latency}
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), "
                     f"bound {bound:.4f} ms ({by}), latency estimate "
                     f"{latency:.4f} ms; {m - 1} dependent steps: "
                     f"{t_k / (m - 1) * 1e3:.3f} us a step")
        print(line, flush=True)
    return 0.0, timings


def phase_pt_slice(card: str):
    """The serving slice with PointTransformerSeg at full width; returns
    the kernel launches of the timed cases."""
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.kernels.fps import fps_cuda
    from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda
    from fissure_segmentation_tpu_torch.models import PointTransformerSeg
    from fissure_segmentation_tpu_torch.serving import segment_case
    case = make_synthetic_image_case(0, shape=SHAPE)
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    model = PointTransformerSeg(
        in_features=3, num_classes=4,
        generator=torch.Generator().manual_seed(0)).cuda().eval()
    apply = biased_model(model, case, SHAPE)

    def run(seed):
        return segment_case(vol, mask, apply,
                            torch.Generator().manual_seed(seed),
                            center_x=SHAPE[2] / 2)

    t0 = time.perf_counter()
    check_result(run(1), SHAPE, "PT warm-up case")
    print(f"pt slice: warm-up case {time.perf_counter() - t0:.3f} s",
          flush=True)
    n_cases = 3
    fps_cuda.launches = knn_cuda.launches = 0
    times = []
    for i in range(n_cases):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(2 + i)
        times.append(time.perf_counter() - t0)
        check_result(res, SHAPE, f"PT case {i}")
    launches = {"fps": fps_cuda.launches, "knn": knn_cuda.launches}
    if launches["fps"] < 40 * n_cases:
        raise AssertionError(f"K5 launched {launches['fps']} times in "
                             f"{n_cases} PT cases; the path needs >= "
                             f"{40 * n_cases}")
    tri = [int(v.sum()) for _, v in res.meshes]
    print(f"pt slice: {len(res.kpts)} valid keypoints, labels "
          f"{np.bincount(res.labels, minlength=4).tolist()}, valid triangles "
          f"per class {tri}; launches in {n_cases} timed cases {launches}",
          flush=True)
    print(f"pt slice: {statistics.median(times):.4f} s/case median of "
          f"{[round(t, 4) for t in times]} on {card}", flush=True)
    return launches, times


def phase_pt_train(ks, knn_cuda, card: str):
    """The PointTransformer training slice through the entry point, then 10
    timed warm steps. Counts are reset before and read after."""
    from fissure_segmentation_tpu_torch import train_point_seg
    from fissure_segmentation_tpu_torch.models import (PointTransformerSeg,
                                                       export_jax_variables,
                                                       load_model)
    from fissure_segmentation_tpu_torch.train.profile_step import (
        STEPS, WARM, canonical_data, make_step, time_steps)
    with tempfile.TemporaryDirectory() as tmp:
        _reset(ks, knn_cuda)
        t0 = time.perf_counter()
        if train_point_seg.main(PT_TRAIN_ARGV + ["--output", tmp]) != 0:
            raise AssertionError("pt train: the entry point failed")
        entry = _counts(ks, knn_cuda)
        fold = os.path.join(tmp, "fold0")
        hist = _read_history(os.path.join(fold, "history.csv"))
        if len(hist) != 3 or not np.isfinite(hist).all():
            raise AssertionError(f"pt train: loss history {hist}")
        model = load_model(os.path.join(fold, "model.pt"),
                           PointTransformerSeg)
        stats = export_jax_variables(model)["batch_stats"]
        still = [name for name, leaf in _leaves(stats)
                 if np.array_equal(leaf, np.zeros_like(leaf))
                 or np.array_equal(leaf, np.ones_like(leaf))]
        if still:
            raise AssertionError(f"pt train: running statistics never "
                                 f"moved: {still}")
        print(f"pt train: entry point (3 epochs, fold 0) in "
              f"{time.perf_counter() - t0:.1f} s; loss history {hist}; "
              f"launches {entry}", flush=True)

        ds, loss_fn = canonical_data()
        step = make_step(ds, loss_fn, tmp, model="PointTransformer")
        for _ in range(WARM):
            step()
        before = _counts(ks, knn_cuda)
        ms, peak, losses = time_steps(step)
        after = _counts(ks, knn_cuda)
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError("pt train: non-finite loss")
    launched = {k: after[k] - before[k] for k in after}
    if launched["fps"] < 4 * STEPS:
        raise AssertionError(f"pt train: K5 launched {launched['fps']} times "
                             f"in {STEPS} steps; each step needs >= 4")
    timing = {"ms_per_step": ms, "clouds_per_s": 32e3 / ms,
              "peak_bytes": peak, "launches_10_steps": launched}
    print(f"pt train: step {ms:.2f} ms ({32e3 / ms:.1f} clouds/s), peak "
          f"{peak / 2 ** 30:.2f} GiB, launches in {STEPS} steps {launched} "
          f"on {card}", flush=True)
    return _counts(ks, knn_cuda), timing


class SelectionRecorder:
    """Records every FPS and kNN selection of PointTransformerSeg's forward
    (the module-level names its code calls are wrapped while active)."""

    def __init__(self):
        self.fps, self.knn = [], []

    def __enter__(self):
        from fissure_segmentation_tpu_torch.models import \
            point_transformer as pt
        from fissure_segmentation_tpu_torch.ops import pointops as po
        self._mods = (pt, po)
        self._saved = (pt.farthest_point_sampling, pt.knn_query,
                       po.knn_query)
        fps0, knn0 = pt.farthest_point_sampling, po.knn_query

        def fps(*args, **kwargs):
            out = fps0(*args, **kwargs)
            self.fps.append(out.detach().cpu())
            return out

        def knn(*args, **kwargs):
            idx, dist = knn0(*args, **kwargs)
            self.knn.append(idx.detach().cpu())
            return idx, dist
        pt.farthest_point_sampling, pt.knn_query, po.knn_query = fps, knn, knn
        return self

    def __exit__(self, *exc):
        pt, po = self._mods
        pt.farthest_point_sampling, pt.knn_query, po.knn_query = self._saved


def _pt_reference_model(seed):
    """Full-width PointTransformerSeg with nonzero BatchNorm offsets (see
    _reference_model)."""
    from fissure_segmentation_tpu_torch.models import PointTransformerSeg
    return _draw_bn_offsets(PointTransformerSeg(
        in_features=4, num_classes=4,
        generator=torch.Generator().manual_seed(seed)), seed)


def phase_pt_reference():
    """PointTransformerSeg at full depth and width, B=8 x N=1024 points
    with dyadic coordinates (multiples of 1/16: every distance exact, so
    both sides select the same neighbours unless a kernel is wrong): one
    step as ModelTrainer.train_step takes it (NNU loss, Adam with L2) on the
    card (K5) and on the CPU (plain versions) from the same weights and
    batch, recording every FPS and kNN selection.

    FPS selections must be equal. An input whose kNN selections differ is
    set aside (up to REF_SEEDS). The tolerances follow how well float32
    itself computes this step, measured on the CPU against the same model
    in float64 (BatchNorm statistics and softmax in float64;
    scripts/prof/pt_float32_conditioning.py): train-mode
    BatchNorm normalises by the batch's own statistics, and over the coarse
    stages' few samples it amplifies rounding. At B=2 x 512 (stage 4: 2 x 2
    points) float32 missed float64 by 0.7 % in the loss, 1.1 in a logit and
    41 % in the gradient (relative L2): no two float32 runs agree there. At
    B=8 x 1024: loss 6e-6 relative, logits 1.8e-3, running statistics
    3.9e-5, gradient 2.2 % (relative L2), eval-mode gradients 1.1e-4. So,
    on the first agreeing input:
      * loss and components within rtol 5e-5, running statistics within
        2e-4;
      * the train-mode gradient as a whole within 0.1 in relative L2, not
        leaf by leaf;
      * every updated parameter within 2e-4 of the CPU's Adam on the
        card's gradients, and card vs CPU where Adam's input g' = g + wd p
        has one sign and |g'| >= ADAM_PINNED on both sides (the rest
        counted, at most PT_UNPINNED_SHARE);
      * in eval mode (running statistics: no such amplification) the
        logits within 2e-4 and every gradient leaf of sum(logits * w) within
        rtol = atol = 5e-4: that gradient sums 8 x 1024 x 4 terms, float32
        alone misses float64 by up to 1.1e-4 there, and the card's float32
        (its gather backward adds with atomics, in no fixed order) was
        seen 1.98e-4 and 2.29e-4 from the CPU's on an H100."""
    from fissure_segmentation_tpu_torch.losses import get_loss_fn
    from fissure_segmentation_tpu_torch.models import export_jax_variables
    from fissure_segmentation_tpu_torch.train.trainer import TrainConfig
    cfg = TrainConfig()
    cw = torch.tensor([0.4, 1.2, 1.1, 1.3])
    set_aside = []
    for seed in range(REF_SEEDS):
        rng = np.random.default_rng(200 + seed)
        x = torch.from_numpy((rng.integers(-16, 17, (8, 1024, 4)) / 16.0)
                             .astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 4, (8, 1024)))
        w = torch.from_numpy(rng.normal(size=(8, 1024, 4)).astype(
            np.float32))
        model0 = _pt_reference_model(seed)
        side = {}
        for dev in ("cuda", "cpu"):
            m = copy.deepcopy(model0).to(dev)
            opt = torch.optim.Adam(m.parameters(), lr=cfg.lr,
                                   weight_decay=cfg.weight_decay)
            loss_fn = get_loss_fn("nnunet", cw.to(dev))
            m.train()
            with SelectionRecorder() as rec:
                loss, comps = loss_fn(m(x.to(dev)), y.to(dev))
            loss.backward()
            grads = dict(_leaves(export_jax_variables(m, grad=True)))
            opt.step()
            side[dev] = (m, float(loss.detach()), {k: float(v) for k, v in
                                          comps.items()}, rec, grads)
        (m_g, l_g, c_g, r_g, g_g), (m_c, l_c, c_c, r_c, g_c) = \
            side["cuda"], side["cpu"]
        if len(r_g.fps) != len(r_c.fps) or not all(
                torch.equal(a, b) for a, b in zip(r_g.fps, r_c.fps)):
            raise AssertionError("pt reference: FPS selections differ card "
                                 "vs CPU")
        knn_diff = sum(int((a != b).sum()) for a, b in zip(r_g.knn, r_c.knn))
        if knn_diff:
            set_aside.append((seed, knn_diff))
            continue
        _close("pt loss", l_g, l_c, rtol=5e-5, atol=0)
        for k in c_c:
            _close(f"pt {k}", c_g[k], c_c[k], rtol=5e-5, atol=0)
        v_g = dict(_leaves(export_jax_variables(m_g)))
        v_c = dict(_leaves(export_jax_variables(m_c)))
        for name in v_c:
            if name.startswith("batch_stats/"):
                _close(f"pt {name}", v_g[name], v_c[name], **TRAIN_TOL)
        gap = np.sqrt(sum(np.sum((g_g[k] - g_c[k]) ** 2) for k in g_c))
        norm = np.sqrt(sum(np.sum(g_c[k] ** 2) for k in g_c))
        if gap > 0.1 * norm:
            raise AssertionError(f"pt reference: train-mode gradient "
                                 f"{gap / norm:.3g} apart in relative L2")
        adam = copy.deepcopy(model0)
        for p, q in zip(adam.parameters(), m_g.parameters()):
            p.grad = q.grad.detach().cpu()
        torch.optim.Adam(adam.parameters(), lr=cfg.lr,
                         weight_decay=cfg.weight_decay).step()
        want = dict(_leaves(export_jax_variables(adam)))
        start = dict(_leaves(export_jax_variables(model0)))
        n_params, unpinned, upd_gap = 0, 0, 0.0
        for name in g_c:
            _close(f"pt updated {name}", v_g[name], want[name], **TRAIN_TOL)
            wd_p = cfg.weight_decay * start[name]
            a, b = g_g[name] + wd_p, g_c[name] + wd_p
            free = (np.sign(a) != np.sign(b)) | \
                (np.minimum(np.abs(a), np.abs(b)) < ADAM_PINNED)
            _close(f"pt updated {name}", v_g[name][~free], v_c[name][~free],
                   **TRAIN_TOL)
            if (~free).any():
                upd_gap = max(upd_gap, float(np.abs(
                    v_g[name][~free] - v_c[name][~free]).max()))
            n_params += free.size
            unpinned += int(free.sum())
        if unpinned > PT_UNPINNED_SHARE * n_params:
            raise AssertionError(f"pt reference: {unpinned} of {n_params} "
                                 "Adam steps not pinned")
        eval_grads, logits = {}, {}
        for dev in ("cuda", "cpu"):
            m = copy.deepcopy(model0).to(dev).eval()
            out = m(x.to(dev))
            (out * w.to(dev)).sum().backward()
            logits[dev] = out.detach().cpu().numpy()
            eval_grads[dev] = dict(_leaves(export_jax_variables(m,
                                                                grad=True)))
        _close("pt eval logits", logits["cuda"], logits["cpu"], **TRAIN_TOL)
        e_gap = 0.0
        for name in eval_grads["cpu"]:
            _close(f"pt eval grad {name}", eval_grads["cuda"][name],
                   eval_grads["cpu"][name], **PT_EVAL_GRAD_TOL)
            e_gap = max(e_gap, float(np.abs(eval_grads["cuda"][name]
                                            - eval_grads["cpu"][name]).max()))
        print(f"pt reference: seed {seed} (set aside, (seed, differing kNN "
              f"selections): {set_aside}); {len(r_c.fps)} FPS and "
              f"{len(r_c.knn)} kNN selections equal card vs CPU; loss "
              f"{l_g:.7f} vs {l_c:.7f}; running statistics within 2e-4; "
              f"train-mode gradient {gap / norm:.3g} apart (relative L2); "
              f"updated parameters within 2e-4 of the CPU's Adam on the "
              f"card's gradients, and card vs CPU (max |diff| {upd_gap:.3g}) "
              f"but {unpinned} of {n_params} unpinned; eval-mode logits "
              f"within 2e-4, gradient leaves within 5e-4 (max |diff| "
              f"{e_gap:.3g})", flush=True)
        return
    raise AssertionError(f"pt reference: no input of {REF_SEEDS} with equal "
                         f"kNN selections: {set_aside}")


# ---- the CNN keypoint path (K6) ---------------------------------------------

def _dw_library(x, w):
    """cuDNN's grouped conv3d on the channels_last_3d view of NDHWC x: the
    library yardstick for K6 (timed here, never called by the port)."""
    c = x.shape[-1]
    return torch.nn.functional.conv3d(
        x.permute(0, 4, 1, 2, 3), w.permute(3, 0, 1, 2).unsqueeze(1),
        padding=1, groups=c)


def phase_depthwise(dw_cuda, dw_plain):
    """K6 against its plain version at the CNN path's shapes (the seven
    stride-1 depthwise layers of MobileNetASPP on a 256^3 CT; (128^3, 144)
    occurs twice), bfloat16 at the widest, a ragged shape and D = 1:
    outputs equal; median times of the kernel, the plain version and the
    library call, and the bound. Returns (0.0, {shape: timings}, the sums
    over one forward's seven launches)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = {
        # name: (shape, dtype, launches per CNN forward, timed)
        "b0_1x128x128x128x32": ((1, 128, 128, 128, 32), f32, 1, True),
        "b1_1x128x128x128x96": ((1, 128, 128, 128, 96), f32, 1, True),
        "b2b3_1x128x128x128x144": ((1, 128, 128, 128, 144), f32, 2, True),
        "b4_1x128x128x128x192": ((1, 128, 128, 128, 192), f32, 1, True),
        "b6_1x64x64x64x192": ((1, 64, 64, 64, 192), f32, 1, True),
        "b7_1x64x64x64x384": ((1, 64, 64, 64, 384), f32, 1, True),
        "bf16_1x128x128x128x192": ((1, 128, 128, 128, 192), bf16, 0, True),
        "ragged_2x7x9x11x5": ((2, 7, 9, 11, 5), f32, 0, False),
        "d1_1x1x6x10x5": ((1, 1, 6, 10, 5), f32, 0, False),
    }
    timings = {}
    forward = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "launches": 0}
    for name, (shape, dtype, per_fwd, timed) in cases.items():
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        w = torch.randn((3, 3, 3, shape[-1]), generator=g, device=dev).to(dtype)
        got = dw_cuda(x, w)
        torch.cuda.synchronize()
        want = dw_plain(x, w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"K6 {name}: kernel differs from plain "
                f"({(got != want).sum().item()} outputs, max "
                f"{(got.float() - want.float()).abs().max().item():.3g})")
        line = f"K6 {name}: kernel == plain (outputs)"
        if timed:
            t_k = median_ms(lambda: dw_cuda(x, w))
            t_p = median_ms(lambda: dw_plain(x, w), reps=3, inner=1, warm=1)
            t_l = median_ms(lambda: _dw_library(x, w), reps=3, inner=1,
                            warm=1)
            lib_err = (_dw_library(x, w).permute(0, 2, 3, 4, 1).float()
                       - got.float()).abs().max().item()
            # read x and w once, write y; 27 multiplies and 27 adds an output
            bound, by = bound_ms((2 * x.numel() + w.numel()) * x.element_size(),
                                 54 * x.numel())
            timings[name] = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound,
                             "bound_by": by, "library_ms": t_l,
                             "library_max_abs_diff": lib_err}
            for key, val in (("ms", t_k), ("plain_ms", t_p),
                             ("bound_ms", bound), ("library_ms", t_l)):
                forward[key] += per_fwd * val
            forward["launches"] += per_fwd
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library "
                     f"conv3d {t_l:.4f} ms (median; library differs by "
                     f"{lib_err:.3g}), bound {bound:.4f} ms ({by})")
        print(line, flush=True)
        del x, w, got, want
    torch.cuda.empty_cache()
    print(f"K6 one CNN forward ({forward['launches']} launches): kernel "
          f"{forward['ms']:.4f} ms, plain {forward['plain_ms']:.4f} ms, "
          f"library {forward['library_ms']:.4f} ms, bound "
          f"{forward['bound_ms']:.4f} ms", flush=True)
    return 0.0, timings, forward


def _cnn_model(seed):
    """MobileNetASPP(num_classes=4) at full width from seeded weights, with
    every BatchNorm offset drawn nonzero (eval-mode BatchNorm is then no
    identity)."""
    from fissure_segmentation_tpu_torch.models import MobileNetASPP
    return _draw_bn_offsets(MobileNetASPP(
        num_classes=4, generator=torch.Generator().manual_seed(seed)), seed)


def _cnn_flops(cnn, vol) -> dict:
    """Multiply-add operations (2 per product) of one whole-volume forward
    of `cnn` on `vol`, by kind of convolution, counted from every conv's
    output shape with forward hooks (one extra forward)."""
    from fissure_segmentation_tpu_torch.models import predict_full_volume
    from fissure_segmentation_tpu_torch.models.seg_cnn import (Conv,
                                                               DepthwiseConv3)
    flops = {"dense_3x3x3": 0, "1x1x1": 0, "depthwise_k6": 0,
             "depthwise_stride2": 0}

    def hook(mod, _, out):
        if isinstance(mod, DepthwiseConv3):
            flops["depthwise_k6"] += 2 * 27 * out.numel()
            return
        taps = mod.weight[0].numel()              # in / groups * kd kh kw
        kind = ("1x1x1" if mod.kernel_size == (1, 1, 1) else
                "depthwise_stride2" if mod.groups > 1 else "dense_3x3x3")
        flops[kind] += 2 * taps * out.numel()
    handles = [m.register_forward_hook(hook) for m in cnn.modules()
               if isinstance(m, (Conv, DepthwiseConv3))]
    try:
        predict_full_volume(cnn, vol)
    finally:
        for h in handles:
            h.remove()
    return flops


def phase_cnn_slice(dw_cuda, card: str):
    """The serving slice in kp_mode="cnn" at full size: the CNN's
    whole-volume forward on the 256^3 CT inside segment_case, then the
    keypoints, the DGCNNSeg(k=40) ensemble with phase 4's class bias and
    the surface fit; one warm-up and 3 timed cases with phase 4's checks.
    K6 must launch at least 7 times a case. Then the CNN forward alone
    (CUDA events) and one kp_mode="enhancement" case. Returns (K6
    launches of the timed cases, timings)."""
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import \
        gather_reduce
    from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda
    from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                       predict_full_volume)
    from fissure_segmentation_tpu_torch.serving import segment_case
    case = make_synthetic_image_case(0, shape=SHAPE)
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    model = DGCNNSeg(k=40, in_features=3, num_classes=4,
                     generator=torch.Generator().manual_seed(0)).cuda().eval()
    apply = biased_model(model, case, SHAPE)
    cnn = _cnn_model(0).cuda()

    def run(seed):
        return segment_case(vol, mask, apply,
                            torch.Generator().manual_seed(seed),
                            kp_mode="cnn", cnn_model=cnn,
                            center_x=SHAPE[2] / 2)

    t0 = time.perf_counter()
    check_result(run(1), SHAPE, "cnn warm-up case")
    print(f"cnn slice: warm-up case {time.perf_counter() - t0:.3f} s",
          flush=True)
    n_cases = 3
    dw_cuda.launches = knn_cuda.launches = gather_reduce.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n_cases):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(2 + i)
        times.append(time.perf_counter() - t0)
        check_result(res, SHAPE, f"cnn case {i}")
    peak = torch.cuda.max_memory_allocated()
    launches = {"depthwise_conv3": dw_cuda.launches, "knn": knn_cuda.launches,
                "gather_reduce": gather_reduce.launches}
    if launches["depthwise_conv3"] < 7 * n_cases:
        raise AssertionError(f"K6 launched {launches['depthwise_conv3']} "
                             f"times in {n_cases} cnn cases; the path needs "
                             f">= {7 * n_cases}")
    tri = [int(v.sum()) for _, v in res.meshes]
    print(f"cnn slice: {len(res.kpts)} valid keypoints, labels "
          f"{np.bincount(res.labels, minlength=4).tolist()}, valid triangles "
          f"per class {tri}; launches in {n_cases} timed cases {launches}",
          flush=True)
    fwd_ms = median_ms(lambda: predict_full_volume(cnn, vol), reps=3,
                       inner=1, warm=1)
    flops = _cnn_flops(cnn, vol)
    total = sum(flops.values())
    timing = {"s_per_case": statistics.median(times),
              "cases_s": times, "cnn_forward_ms": fwd_ms,
              "cnn_forward_flops": flops, "peak_bytes": peak}
    print(f"cnn slice: {timing['s_per_case']:.4f} s/case median of "
          f"{[round(t, 4) for t in times]}; CNN forward {fwd_ms:.3f} ms "
          f"(CUDA events, median of 3); peak device memory "
          f"{peak / 2 ** 30:.2f} GiB on {card}", flush=True)
    print(f"cnn slice: the CNN forward's convolutions do {total / 1e12:.4f} "
          f"TFLOP ({', '.join(f'{k} {v / 1e9:.1f}' for k, v in flops.items())}"
          f" GFLOP): at least {total / F32_FLOPS * 1e3:.2f} ms at the f32 "
          f"peak; {total / fwd_ms / 1e9:.2f} TFLOP/s achieved", flush=True)

    # the enhancement mode: the synthetic CT is not in Hounsfield units
    # (parenchyma -0.6, fissures -0.25, noise 0.05), so the intensity
    # weighting is centred on its fissures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = segment_case(vol, mask, apply, torch.Generator().manual_seed(9),
                       kp_mode="enhancement", fissure_mu=-0.25,
                       fissure_sigma=0.1, center_x=SHAPE[2] / 2)
    timing["enhancement_case_s"] = time.perf_counter() - t0
    check_result(res, SHAPE, "enhancement case")
    print(f"enhancement slice: {len(res.kpts)} valid keypoints, labels "
          f"{np.bincount(res.labels, minlength=4).tolist()}, valid triangles "
          f"per class {[int(v.sum()) for _, v in res.meshes]}; one case "
          f"{timing['enhancement_case_s']:.4f} s (first in this mode) on "
          f"{card}", flush=True)
    return launches, timing


def phase_cnn_reference():
    """The CNN on a small input at full width, card (K6) against CPU (plain
    versions), TF32 off: softmax volumes within CNN_SOFT_TOL (both sides
    sum each convolution in float32 in another order: about 1e-6 relative
    a layer over some twenty layers; 5e-5 on probabilities leaves a margin
    of ten); argmax equal except where the CPU's top-two margin is below
    twice that; the staged keypoints with the same injected scores equal,
    but for the voxels whose argmax flipped (each moves at most two
    keypoints)."""
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.keypoints.extraction import \
        get_cnn_keypoints
    from fissure_segmentation_tpu_torch.models import predict_full_volume
    shape = (40, 48, 56)
    case = make_synthetic_image_case(2, shape=shape)
    cnn = _cnn_model(6)   # its argmax splits the lung into bg and fg
    img = torch.from_numpy(case["image"])
    mask = torch.from_numpy(case["lung_mask"])
    soft = {"cpu": predict_full_volume(cnn, img)}
    soft["cuda"] = predict_full_volume(copy.deepcopy(cnn).cuda(),
                                       img.cuda()).cpu()
    err = (soft["cuda"] - soft["cpu"]).abs().max().item()
    if not err <= CNN_SOFT_TOL:
        raise AssertionError(f"cnn reference: softmax differs by {err:.3g} "
                             f"> {CNN_SOFT_TOL}")
    top2 = soft["cpu"].topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    flipped = soft["cuda"].argmax(-1) != soft["cpu"].argmax(-1)
    if (flipped & (margin >= 2 * CNN_SOFT_TOL)).any():
        raise AssertionError("cnn reference: argmax differs at a voxel with "
                             "a clear margin")
    scores = torch.rand(img.numel(), generator=torch.Generator().manual_seed(3))
    kp = {}
    for dev in ("cuda", "cpu"):
        k, v, _ = get_cnn_keypoints(soft[dev].to(dev), mask.to(dev),
                                    max_kpts=2000, scores=scores.to(dev))
        kp[dev] = {tuple(r) for r in k[v].cpu().tolist()}
    n_flip = int(flipped.sum())
    diff = len(kp["cuda"] ^ kp["cpu"])
    if diff > 2 * n_flip or (n_flip == 0 and diff):
        raise AssertionError(f"cnn reference: keypoints differ in {diff} "
                             f"with {n_flip} flipped voxels")
    classes = np.bincount(soft["cpu"].argmax(-1)[mask].numpy(), minlength=4)
    print(f"cnn reference: {shape} card vs CPU: softmax max abs diff "
          f"{err:.3g} (tol {CNN_SOFT_TOL}), argmax flips {n_flip} (all at "
          f"margins < {2 * CNN_SOFT_TOL}), keypoints {len(kp['cpu'])} with "
          f"{diff} differing; argmax per class in the lung "
          f"{classes.tolist()}", flush=True)
    return err


# ---- the fused gather-reduce, the bf16 step and the probes ------------------

def _old_gather_reduce(a, idx, want):
    """What the port ran before the gather-reduce kernel: the flat gather of
    the whole (B, N, K, C) neighbour tensor, then one reduction per output
    (timed as the 'old' column only)."""
    from fissure_segmentation_tpu_torch.ops.edge import _flat_gather
    ga = _flat_gather(a, idx)
    if want == "max":
        return (ga.amax(dim=2),)
    if want == "extrema":
        return ga.amax(dim=2), ga.amin(dim=2)
    gaf = ga.to(torch.float32)
    return (ga.amax(dim=2), ga.amin(dim=2), ga.argmax(dim=2),
            ga.argmin(dim=2), gaf.sum(dim=2), (gaf * gaf).sum(dim=2))


def _gr_bytes(a, idx, want) -> int:
    """Bytes the gather-reduce must move: a and idx read once, the outputs
    written once."""
    b, n, c = a.shape
    out = {"max": a.element_size(), "extrema": 2 * a.element_size(),
           "all": 2 * a.element_size() + 4 * 4}[want]
    return (a.numel() * a.element_size() + idx.numel() * 4
            + b * n * c * out)


def phase_gather_reduce(knn_cuda):
    """The gather-reduce against its plain version: every output equal
    (torch.equal), for every want and dtype, at the path's shapes (the train
    step's on K1's graph, the serving ensemble's), a lattice full of k-ties
    and indices out of range; timings at the path's shapes. Returns (max
    |kernel - plain| over every output and case, {shape: timings})."""
    import torch.nn.functional as F
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import (
        flat_rows, gather_reduce, gather_reduce_plain)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    graphs = {}
    for b in (32, 5):
        pts = torch.rand((b, 2048, 3), generator=g, device=dev) * 2 - 1
        graphs[b] = knn_cuda(pts, 40)[0].contiguous()
    lattice_idx = torch.randint(0, 512, (4, 512, 40), generator=g,
                                device=dev, dtype=torch.int32)
    bad = torch.randint(0, 300, (3, 300, 24), generator=g, device=dev,
                        dtype=torch.int32)
    bad[:, ::7, 0] = -1                   # wraps to the last row
    bad[:, 3::11, 5] = 300 + 17           # clamps
    bad[1, :, 9] = -5000                  # clamps to row 0
    cases = {
        # name: (idx, table maker, timed)
        "train_32x2048x40x64": (graphs[32], "normal", True),
        "serve_5x2048x40x64": (graphs[5], "normal", True),
        "lattice_ties_4x512x40x64": (lattice_idx, "lattice", False),
        "out_of_range_3x300x24x40": (bad, "normal", False),
    }
    timings, max_err = {}, 0.0
    for name, (idx, kind, timed) in cases.items():
        b, n, _ = idx.shape
        c = 40 if name.startswith("out_of_range") else 64
        if kind == "lattice":
            base = torch.randint(0, 3, (b, n, c), generator=g,
                                 device=dev).float()
        else:
            base = torch.randn((b, n, c), generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            a = base.to(dtype)
            for want in ("max", "extrema", "all"):
                got = gather_reduce(a, idx, want)
                torch.cuda.synchronize()
                ref = gather_reduce_plain(a, idx, want)
                max_err = max([max_err] + [
                    (x.double() - y.double()).abs().max().item()
                    for x, y in zip(got, ref)])
                if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                    raise AssertionError(
                        f"gather_reduce {name} {dtype} {want}: kernel "
                        f"differs from plain in "
                        f"{[int((x != y).sum()) for x, y in zip(got, ref)]}")
                if not timed:
                    continue
                key = f"{name}_{str(dtype)[6:]}_{want}"
                t_k = median_ms(lambda: gather_reduce(a, idx, want))
                t_p = median_ms(lambda: gather_reduce_plain(a, idx, want),
                                reps=3, inner=1, warm=1)
                t_o = median_ms(lambda: _old_gather_reduce(a, idx, want),
                                reps=3, inner=3, warm=1)
                t_l = None
                if want == "max":
                    table = a.view(b * n, c)
                    bags = flat_rows(idx, n).view(b * n, -1)
                    t_l = median_ms(lambda: F.embedding_bag(
                        bags, table, mode="max"), reps=3, inner=3, warm=1)
                # per (point, slot, channel): two compares, and for "all"
                # a multiply and two adds
                ops = idx.numel() * c * (5 if want == "all" else
                                         2 if want == "extrema" else 1)
                bound, by = bound_ms(_gr_bytes(a, idx, want), ops)
                timings[key] = {"ms": t_k, "plain_ms": t_p, "old_ms": t_o,
                                "library_ms": t_l, "bound_ms": bound,
                                "bound_by": by}
                print(f"gather_reduce {key}: kernel == plain (every "
                      f"output); kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                      f"old gather + reductions {t_o:.4f} ms, library "
                      f"{'none' if t_l is None else f'{t_l:.4f} ms'} "
                      f"(median), bound {bound:.4f} ms ({by})", flush=True)
        if not timed:
            print(f"gather_reduce {name}: kernel == plain (every output, "
                  f"every want, f32 and bf16)", flush=True)
    return max_err, timings


def phase_bf16_train(ks, knn_cuda, card: str):
    """The bf16 training slice at full width: 10 timed warm steps in each
    routing (the harness of train/profile_step.py with dtype=bf16), then
    the entry point with --amp true (3 epochs of fold 0). Counts are reset
    before and read after; returns them with the timings."""
    from fissure_segmentation_tpu_torch import train_point_seg
    from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                       export_jax_variables,
                                                       load_model)
    from fissure_segmentation_tpu_torch.train.profile_step import (
        STEPS, WARM, canonical_data, make_step, time_steps)
    timing = {}
    with tempfile.TemporaryDirectory() as tmp:
        _reset(ks, knn_cuda)
        ds, loss_fn = canonical_data()
        for fused in ("0", "1"):
            os.environ["FSEG_FUSED_EDGE"] = fused
            step = make_step(ds, loss_fn, tmp, dtype=torch.bfloat16)
            for _ in range(WARM):
                step()
            before = _counts(ks, knn_cuda)
            ms, peak, losses = time_steps(step)
            after = _counts(ks, knn_cuda)
            if not torch.isfinite(torch.stack(losses)).all():
                raise AssertionError(f"bf16 train: non-finite loss ({fused})")
            name = "fused" if fused == "1" else "unfused"
            launched = {k: after[k] - before[k] for k in after}
            timing[name] = {"ms_per_step": ms, "clouds_per_s": 32e3 / ms,
                            "peak_bytes": peak,
                            "launches_10_steps": launched}
            print(f"bf16 train: {name} step {ms:.2f} ms ({32e3 / ms:.1f} "
                  f"clouds/s), peak {peak / 2 ** 30:.2f} GiB, launches in "
                  f"{STEPS} steps {launched} on {card}", flush=True)
        os.environ.pop("FSEG_FUSED_EDGE")
        for name, kernels in (("unfused", ("scatter_rows",)),
                              ("fused", ("scatter_rows", "scatter_routed",
                                         "scatter_count", "gather_reduce"))):
            for k in kernels:
                if timing[name]["launches_10_steps"][k] < STEPS:
                    raise AssertionError(f"bf16 train: {k} did not launch "
                                         f"in every {name} step")
        t0 = time.perf_counter()
        if train_point_seg.main(AMP_TRAIN_ARGV + ["--output", tmp]) != 0:
            raise AssertionError("bf16 train: the entry point failed")
        fold = os.path.join(tmp, "fold0")
        hist = _read_history(os.path.join(fold, "history.csv"))
        if len(hist) != 3 or not np.isfinite(hist).all():
            raise AssertionError(f"bf16 train: loss history {hist}")
        model = load_model(os.path.join(fold, "model.pt"), DGCNNSeg)
        if model.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 train: model.pt holds a "
                                 f"{model.dtype} model")
        stats = export_jax_variables(model)["batch_stats"]
        still = [name for name, leaf in _leaves(stats)
                 if np.array_equal(leaf, np.zeros_like(leaf))
                 or np.array_equal(leaf, np.ones_like(leaf))]
        if still:
            raise AssertionError(f"bf16 train: running statistics never "
                                 f"moved: {still}")
        print(f"bf16 train: entry point --amp true (3 epochs, fold 0) in "
              f"{time.perf_counter() - t0:.1f} s; loss history {hist}",
              flush=True)
    return _counts(ks, knn_cuda), timing


def _rel_l2(got: dict, want: dict) -> float:
    gap = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want))
    return float(gap / max(np.sqrt(sum(np.sum(want[k] ** 2) for k in want)),
                           1e-30))


@contextlib.contextmanager
def planted_fault(route: str):
    """A wrong neighbour in the backward, for as long as the context lasts:
    the fused core routes each (n, c) to the slot after its extremal one,
    the unfused route's K2 scatters each edge's cotangent to the next
    slot's neighbour. The forward is unchanged."""
    from fissure_segmentation_tpu_torch.ops import edge, fused_edge
    if route == "fused":
        mod, name = fused_edge, "gather_reduce"
        real = fused_edge.gather_reduce

        def fault(a, idx, want="max"):
            out = real(a, idx, want)
            if want != "all":
                return out
            k = idx.shape[-1]
            return out[:2] + ((out[2] + 1) % k, (out[3] + 1) % k) + out[4:]
    else:
        mod, name = edge, "scatter_rows"
        real = edge.scatter_rows

        def fault(idx, g, n):
            b, e = idx.shape
            rolled = idx.view(b, n, e // n).roll(1, -1).reshape(b, e)
            return real(rolled.contiguous(), g, n)
    setattr(mod, name, fault)
    try:
        yield
    finally:
        setattr(mod, name, real)


def phase_bf16_reference():
    """One bf16 train step at B=2, N=256, k=8 on the card (kernels) and on
    the CPU (plain versions), same weights (`_reference_model` in bf16),
    same batch, both routings; then the eval logits of the same model.

    bf16 keeps 8 bits of mantissa: each product's result is rounded to
    2^-9 relative, and the card (cuBLAS) and the CPU sum a product's terms
    in float32 in other orders before that rounding, so now and then an
    element rounds to the neighbouring bf16 value on one side, and later
    layers carry that step on. The forward is held as the CPU tests hold
    the port's bf16 model against JAX's (tests/test_torch_bf16.py): eval
    logits within BF16_TOL["logits"] * max|logit|, the loss and its
    components within rtol BF16_TOL["loss"], the running statistics within
    BF16_TOL["stats_rel_l2"] in relative L2. The backward rounds every
    cotangent to bf16 and each train-mode BatchNorm backward subtracts two
    batch means from it, so those steps grow layer by layer towards the
    input: the whole gradient is held within BF16_TOL["grad_rel_l2"] in
    relative L2, a limit between the sound step's readings and those of
    the same step with a wrong neighbour planted in its backward
    (`planted_fault`; PERF.md has both). That control runs on the card in
    each routing and must miss the limit. No updated parameter is held:
    Adam's first step turns any sign flip of a near-zero gradient into a
    step of lr."""
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
    model0 = _reference_model(0, ds, dtype=torch.bfloat16)
    x, y = sample_batch(store, torch.tensor([0, 2], device="cuda"),
                        ds.sample_points,
                        torch.Generator(device="cuda").manual_seed(100))
    for fused in ("0", "1"):
        os.environ["FSEG_FUSED_EDGE"] = fused
        route = "fused" if fused == "1" else "unfused"
        m_g, l_g, c_g, _ = _reference_step("cuda", model0, ds, cw,
                                           TrainConfig(), x, y)
        m_c, l_c, c_c, _ = _reference_step("cpu", model0, ds, cw,
                                           TrainConfig(), x, y)
        _close("bf16 loss", l_g, l_c, rtol=BF16_TOL["loss"], atol=0)
        for k in c_c:
            _close(f"bf16 {k}", c_g[k], c_c[k], rtol=BF16_TOL["loss"], atol=0)
        g_c = dict(_leaves(export_jax_variables(m_c, grad=True)))
        grad = _rel_l2(dict(_leaves(export_jax_variables(m_g, grad=True))),
                       g_c)
        grad_tol = BF16_TOL["grad_rel_l2"]
        with planted_fault(route):
            m_f = _reference_step("cuda", model0, ds, cw, TrainConfig(), x,
                                  y)[0]
        fault = _rel_l2(dict(_leaves(export_jax_variables(m_f, grad=True))),
                        g_c)
        if fault <= grad_tol:
            raise AssertionError(f"bf16 reference ({route}): a planted wrong "
                                 f"neighbour moved the gradient only "
                                 f"{fault:.3g} (tolerance {grad_tol:.3g})")
        v_g = dict(_leaves(export_jax_variables(m_g)["batch_stats"]))
        v_c = dict(_leaves(export_jax_variables(m_c)["batch_stats"]))
        stats = _rel_l2(v_g, v_c)
        if grad > grad_tol or stats > BF16_TOL["stats_rel_l2"]:
            raise AssertionError(f"bf16 reference ({route}): gradient "
                                 f"{grad:.3g} (tolerance {grad_tol:.3g}), "
                                 f"running statistics {stats:.3g} apart in "
                                 "relative L2")
        with torch.no_grad():
            lg = copy.deepcopy(model0).cuda().eval()(x).float().cpu()
            lc = copy.deepcopy(model0).eval()(x.cpu()).float()
        gap = float((lg - lc).abs().max() / lc.abs().max())
        if gap > BF16_TOL["logits"]:
            raise AssertionError(f"bf16 reference ({route}): eval logits "
                                 f"{gap:.3g} * max|logit| apart")
        print(f"bf16 reference: {route} step card vs CPU: loss {l_g:.6f} vs "
              f"{l_c:.6f}; gradient {grad:.4g} apart (relative L2, "
              f"tolerance {grad_tol:.3g}; with the planted fault "
              f"{fault:.4g}), running statistics {stats:.3g} apart; eval "
              f"logits {gap:.3g} * max|logit| apart (tolerances {BF16_TOL})",
              flush=True)
    os.environ.pop("FSEG_FUSED_EDGE")


def phase_probes(card: str):
    """The probes of P1-P4 (prof/probes.py) at 3 repetitions, then the
    stream kernels' headline times beside their plain version, torch.sum
    and the bound. The path's launches are those of the probes' timed calls
    (each row counts its own; the probes' checks are not counted). Returns
    ({kernel: launches}, rows, {kernel: timings})."""
    from fissure_segmentation_tpu_torch.kernels.stream import (
        stream_sum, stream_sum_async, stream_sum_plain)
    from fissure_segmentation_tpu_torch.prof import probes
    idx, g = probes.payload()
    rows = (probes.p1(idx, g, reps=3) + probes.p2_p4(g, reps=3)
            + probes.p3(g, reps=3))
    counts = {}
    for row in rows:
        for name, n in row["launches"].items():
            counts[name] = counts.get(name, 0) + n
    g64, g128 = g.view(-1, 64), g.view(-1, 128)
    ring = min((r for r in rows if "stream_sum_async" in r["variant"]),
               key=lambda r: r["ms"])
    chunk, nbuf = (int(t[2:]) for t in ring["variant"].split()[-2:])
    heads = {}
    for name, view, fn, row in (
            ("stream_sum", g64, lambda: stream_sum(g64),
             next(r for r in rows if r["variant"].startswith("k_stream"))),
            ("stream_sum_async", g128,
             lambda: stream_sum_async(g128, chunk, nbuf), ring)):
        t_p = median_ms(lambda: stream_sum_plain(view), reps=3)
        t_l = median_ms(lambda: torch.sum(view, 0, dtype=torch.float32),
                        reps=3)
        # read the view once, write L f32; one add per element
        bound, by = bound_ms(view.numel() * 2 + view.shape[1] * 4,
                             view.numel())
        heads[name] = {"ms": row["ms"], "plain_ms": t_p, "library_ms": t_l,
                       "bound_ms": bound, "bound_by": by,
                       "max_abs_err": row["max_abs_err"],
                       "shape": list(view.shape), "variant": row["variant"],
                       "gb_per_s": row["gb_per_s"]}
        print(f"{name} {row['variant']}: kernel {row['ms']:.4f} ms "
              f"({row['gb_per_s']:.1f} GB/s), plain {t_p:.4f} ms, library "
              f"torch.sum {t_l:.4f} ms, bound {bound:.4f} ms ({by}) on "
              f"{card}", flush=True)
    return counts, rows, heads


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA card", file=sys.stderr)
        return 2
    from fissure_segmentation_tpu_torch import native
    from fissure_segmentation_tpu_torch.kernels import _build
    from fissure_segmentation_tpu_torch.kernels import scatter as ks
    from fissure_segmentation_tpu_torch.kernels.depthwise import (
        depthwise_conv3_cuda, depthwise_conv3_plain)
    from fissure_segmentation_tpu_torch.kernels.fps import fps_cuda, fps_plain
    from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda, knn_plain

    # 1. card and settings
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    native.load()  # builds the C++ host runtime with g++; raises on failure
    print(f"native: {native.build()} in {time.perf_counter() - t0:.1f} s",
          flush=True)

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
    serving = phase_slice(knn_cuda, card)

    # 5. serving reference check on a small input
    phase_reference(card)

    # 6. K2-K4 against their plain versions
    scatter = phase_scatter(ks, knn_cuda)

    # 7. the training slice at full width (counts from 0, read after)
    counts, train_timing = phase_train(ks, knn_cuda, card)
    print(json.dumps({"train": train_timing, "card": card}), flush=True)

    # 8. train-step reference on a small input
    phase_train_reference()

    # 9. K5 against its plain version
    fps_err, fps_timings = phase_fps(fps_cuda, fps_plain)

    # 10. the serving slice with PointTransformer (counts from 0, read after)
    _reset(ks, knn_cuda)
    pt_serving, pt_case_s = phase_pt_slice(card)

    # 11. the PointTransformer training slice (counts from 0, read after)
    pt_counts, pt_timing = phase_pt_train(ks, knn_cuda, card)
    print(json.dumps({"pt_train": pt_timing, "pt_case_s": pt_case_s,
                      "card": card}), flush=True)

    # 12. PointTransformer train-step reference on a small input
    phase_pt_reference()

    # 13. K6 against its plain version
    dw_err, dw_timings, dw_forward = phase_depthwise(depthwise_conv3_cuda,
                                                     depthwise_conv3_plain)

    # 14. the serving slice in the cnn and enhancement keypoint modes
    # (counts from 0, read after)
    _reset(ks, knn_cuda)
    cnn_serving, cnn_timing = phase_cnn_slice(depthwise_conv3_cuda, card)
    print(json.dumps({"cnn_serving": cnn_timing, "k6_per_forward": dw_forward,
                      "card": card}), flush=True)

    # 15. CNN reference, card against CPU, on a small input
    phase_cnn_reference()

    # 16. the fused gather-reduce against its plain version
    gr_err, gr_timings = phase_gather_reduce(knn_cuda)

    # 17. the bf16 training slice (counts from 0, read after)
    bf16_counts, bf16_timing = phase_bf16_train(ks, knn_cuda, card)
    print(json.dumps({"bf16_train": bf16_timing, "card": card}), flush=True)

    # 18. bf16 train-step reference on a small input
    phase_bf16_reference()

    # 19. the probes of P1-P4 (the stream kernels' path: the launches of
    # their timed calls)
    probe_counts, probe_rows, stream_heads = phase_probes(card)
    print(json.dumps({"probes": probe_rows, "card": card}), flush=True)

    train_total = {k: counts["total"][k] + bf16_counts[k]
                   for k in bf16_counts}
    graph = timings["dgcnn_graph_5x2048x3_k40"]
    kernels = [{
        "name": "knn", "route": "cuda", "source": KNN_SOURCE,
        "replaces": KNN_REPLACES,
        "launches": serving["knn"] + train_total["knn"]
        + pt_serving["knn"] + pt_counts["knn"] + cnn_serving["knn"],
        "max_abs_err": max_err, "ms": graph["ms"],
        "plain_ms": graph["plain_ms"], "bound_ms": graph["bound_ms"],
        "bound_by": graph["bound_by"], "library_ms": None,
        "shapes": timings}]
    for name, (err, shapes) in scatter.items():
        path = next(iter(shapes.values()))       # the first timed shape
        row = {"name": name, "route": "cuda", "source": SCATTER_SOURCE,
               "replaces": SCATTER_REPLACES[name],
               "launches": train_total[name], "max_abs_err": err,
               "ms": path["ms"], "plain_ms": path["plain_ms"],
               "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
               "library_ms": path["library_ms"], "shapes": shapes}
        if name == "scatter_rows":
            row["also_replaces"] = f"{PALLAS_SCATTER}:133"
        kernels.append(row)
    step = fps_timings["pt_step_32x2048x3_m512"]
    kernels.append({
        "name": "fps", "route": "cuda", "source": FPS_SOURCE,
        "replaces": FPS_REPLACES,
        "launches": pt_serving["fps"] + pt_counts["fps"],
        "max_abs_err": fps_err, "ms": step["ms"],
        "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"], "library_ms": None,
        "shapes": fps_timings})
    widest = dw_timings["b4_1x128x128x128x192"]
    kernels.append({
        "name": "depthwise_conv3", "route": "cuda", "source": DW_SOURCE,
        "replaces": f"{PALLAS_DW}:200", "also_replaces": f"{PALLAS_DW}:171",
        "launches": cnn_serving["depthwise_conv3"], "max_abs_err": dw_err,
        "ms": widest["ms"], "plain_ms": widest["plain_ms"],
        "bound_ms": widest["bound_ms"], "bound_by": widest["bound_by"],
        "library_ms": widest["library_ms"], "per_forward": dw_forward,
        "shapes": dw_timings})
    p5 = gr_timings["train_32x2048x40x64_bfloat16_max"]
    kernels.append({
        "name": "gather_reduce", "route": "cuda", "source": GR_SOURCE,
        "replaces": GR_REPLACES,
        "launches": serving["gather_reduce"] + train_total["gather_reduce"]
        + cnn_serving["gather_reduce"], "max_abs_err": gr_err,
        "ms": p5["ms"], "plain_ms": p5["plain_ms"],
        "bound_ms": p5["bound_ms"], "bound_by": p5["bound_by"],
        "library_ms": p5["library_ms"], "old_ms": p5["old_ms"],
        "shapes": gr_timings})
    for name, head in stream_heads.items():
        kernels.append({
            "name": name, "route": "cuda", "source": STREAM_SOURCE,
            "replaces": STREAM_REPLACES[name],
            "also_replaces": STREAM_ALSO[name], "path": "probes",
            "launches": probe_counts.get(name, 0), **head})
    for row in kernels:
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} never launched on the main "
                                 "paths")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
