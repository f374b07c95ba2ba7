"""K1 (kNN), K5 (farthest-point sampling), K6 (the depthwise convolution),
K2-K4 (the EdgeConv scatters, with the graph transpose they build), the
fused EdgeConv gather-reduce, P1's k_onehot, the streaming column sums and
the approximate top-k of
one checkout of this repository, timed on the card at their path shapes,
so that two commits can be compared in one call on one card. Run it with
the checkout's root:

    python fissure_segmentation_tpu_torch/prof/kernel_ab.py ROOT [--tag NAME]
        [--stream_only | --gr_only]

The script imports the kernels from ROOT, not from its own location, and
times both roots with its own copy's prof/timing.py, so one copy times any
checkout whose kernels/knn.py, fps.py, depthwise.py, scatter.py and
gather_reduce.py have
`knn_cuda`/`knn_plain`, `fps_cuda`/`fps_plain`,
`depthwise_conv3_cuda`/`depthwise_conv3_plain`,
`scatter_rows`/`scatter_routed` (with `transpose`, or the older sorting
`_transpose`) and `gather_reduce`/`gather_reduce_plain`; run it on the two
roots in turns (A, B, B, A). Every input is drawn from one seeded
generator in a fixed order, so both sides time the same inputs; K1, K5,
K6 and the gather-reduce are checked bit-equal to their plain versions
first, K2 and K3 within their rounding bound of plain. K2 and K3 are timed
as the wrapper runs them, building their own transpose, and K3 also given
the train step's shared transpose (f32 and bf16 payloads), and the
transpose alone. The gather-reduce is timed at its path calls, each on
K1's graph: the train step's "all" in f32 and bf16 and P5's bf16 "max" at
(32, 2048, 40, 64); the few-cloud "extrema" calls: the served ensemble
group's f32 and the default run's test ensemble's bf16 at (5, 2048, 40,
64), the sharded ensemble's 3 clouds, DPSR-Net's test ensemble at (5,
1024, 20, 64) and (1, 1024, 20, 64) f32; each by `graph_ms` (the card
alone), by `median_ms` ("_host_included"), by the host's ms a call
back to back ("_host_ms") and by the same with the library's entry
launching nothing ("_host_ms_no_launch": the wrapper's own host time);
`--gr_only` times these alone. K4 is timed as its histogram at the
train step's (32, 81 920) to 2048 rows and at P1's 512 rows (idx mod
512), and as the fused
backward calls it: given the step's transpose where the checkout's
`scatter_count` takes one (`transposed`), else the histogram; each result
equal to plain, each timed by `graph_ms` (its work on the card: K4's
launches are shorter than the wrapper's host time) and by `median_ms`
("_host_included"). P1's k_onehot (K4 at 512 rows + `stream_sum`) is the
checkout's `prof.probes.p1` row. The dynamic graph's feature-space kNN
(`ops/knn.py:feature_knn`, no kernel of its own: a matmul and a stable
sort, or the approximate top-k's fused row selection where the checkout
has it) is timed at the default run's (32, 2048, 64) bf16, k = 40. The
approximate selection (`ops/approx_topk.py:approx_top_k`, as the
checkout runs it: the bin pass and two sorts, or the fused row selection
for k <= 128), equal to the checkout's `approx_top_k_plain` first, is
timed at the kNN rows of the --knn_recall step ((32 * 2048, 2048) -> 40
at recall 0.9, coordinate distances f32 and bf16 feature distances) and
at the 256^3 detector's (1, 256^3) -> 20 000 at 0.95 in bf16. K6's
backward and stride-2 layer at the CNN paths' shapes: the wgrad kernel
at (32, 48^3, 192) (within gamma_depth * sum |x dy| of float64 first; the
checkout's `wgrad_plan` gives the depth), and block 5's stride-2 layer
forward at (1, 128^3, 192) f32 and weight gradient at (32, 48^3, 192):
K6's stride-2 mode and the wgrad kernel at stride 2 where the checkout's
`depthwise_conv3_cuda` takes `stride` (equal to plain, within the bound),
else what the checkout runs for that layer, cuDNN's grouped conv3d and
conv3d_weight (the route is recorded beside each time). The streaming
column sums (`stream_sum`, `stream_sum_async`; "stream" in its JSON) at
P1's (2 621 440, 64) bf16 view and its float32 copy, at P3's (1 310 720,
128) view over ASYNC_GRID and P3's total as the checkout's probe takes
it, each within the checkout's own rounding_bound first, beside
torch.sum(g) and torch.sum(., 0), each also split by the profiler into
its kernels' device ms a call. Prints one JSON line (per shape the median
ms of CUDA-event runs), then the card's name and power limit. Raises
without a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

import torch

# The path shapes of chip_smoke.py phases 3 and 9, listed here because an
# older checkout's chip_smoke.py may not time all of them.
# (name, shape, k, self_loop): the DGCNN serving graph, the training
# step's graph, the PSR normals
KNN_SHAPES = (("graph_5x2048x3_k40", (5, 2048, 3), 40, False),
              ("train_32x2048x3_k40", (32, 2048, 3), 40, False),
              ("normals_3x8192x3_k30", (3, 8192, 3), 30, True))
# (name, shape, m, valid share): the PointTransformer step's first two
# TransitionDowns, a served ensemble group, DSEG-AE's masked cloud
FPS_SHAPES = (("pt_step_32x2048x3_m512", (32, 2048, 3), 512, 1.0),
              ("pt_step_32x512x3_m128", (32, 512, 3), 128, 1.0),
              ("pt_serve_5x2048x3_m512", (5, 2048, 3), 512, 1.0),
              ("dseg_masked_1x20000x3_m1024", (1, 20000, 3), 1024, 0.35))
# (name, shape, dtype): chip_smoke.py phase 13's, MobileNetASPP's stride-1
# depthwise layers on a 256^3 CT (b2 and b3 share a shape) and bf16
DW_SHAPES = (("b0_1x128x128x128x32", (1, 128, 128, 128, 32), "float32"),
             ("b1_1x128x128x128x96", (1, 128, 128, 128, 96), "float32"),
             ("b2b3_1x128x128x128x144", (1, 128, 128, 128, 144), "float32"),
             ("b4_1x128x128x128x192", (1, 128, 128, 128, 192), "float32"),
             ("b6_1x64x64x64x192", (1, 64, 64, 64, 192), "float32"),
             ("b7_1x64x64x64x384", (1, 64, 64, 64, 384), "float32"),
             ("bf16_1x128x128x128x192", (1, 128, 128, 128, 192), "bfloat16"))
# the DGCNN train step's scatters: B, N, k, C
STEP = (32, 2048, 40, 64)
# the gather-reduce's path calls: (name, (B, N, k, C), dtype, want)
GR_CALLS = (("all_32x2048x40x64_float32", STEP, "float32", "all"),
            ("all_32x2048x40x64_bfloat16", STEP, "bfloat16", "all"),
            ("max_32x2048x40x64_bfloat16", STEP, "bfloat16", "max"),
            ("extrema_5x2048x40x64_float32", (5, 2048, 40, 64), "float32",
             "extrema"),
            ("extrema_5x2048x40x64_bfloat16", (5, 2048, 40, 64), "bfloat16",
             "extrema"),
            ("extrema_3x2048x40x64_float32", (3, 2048, 40, 64), "float32",
             "extrema"),
            ("extrema_5x1024x20x64_float32", (5, 1024, 20, 64), "float32",
             "extrema"),
            ("extrema_1x1024x20x64_float32", (1, 1024, 20, 64), "float32",
             "extrema"))


def _timing():
    """This copy's prof/timing.py (torch only), loaded by its path: both
    roots are timed by the same helpers."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "timing.py")
    spec = importlib.util.spec_from_file_location("kernel_ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _depthwise_backward(depthwise, gen, median_ms) -> dict:
    """The wgrad kernel at (32, 48^3, 192), and block 5's stride-2 layer
    (forward at (1, 128^3, 192), weight gradient at (32, 48^3, 192)) as
    the checkout runs it: K6's stride-2 mode and the wgrad kernel at
    stride 2, or cuDNN."""
    strided = "stride" in inspect.signature(
        depthwise.depthwise_conv3_cuda).parameters
    out = {"stride2_route": "k6" if strided else "cudnn"}
    x = torch.randn((32, 48, 48, 48, 192), generator=gen).cuda()
    for s in (1, 2):
        od = -(-48 // s)
        gy = torch.randn((32, od, od, od, 192), generator=gen).cuda()
        if s == 2 and not strided:
            out["wgrad_s2_32x48x48x48x192"] = median_ms(
                lambda: torch.nn.grad.conv3d_weight(
                    x.permute(0, 4, 1, 2, 3), (192, 1, 3, 3, 3),
                    gy.permute(0, 4, 1, 2, 3), stride=2, padding=1,
                    groups=192), reps=3, inner=1, warm=1)
            continue
        args = (x, gy, s) if s == 2 else (x, gy)
        plan = depthwise.wgrad_plan(tuple(x.shape), *args[2:])
        depth = plan.depth if hasattr(plan, "depth") else plan[2]
        got = depthwise.depthwise_conv3_wgrad_cuda(*args).double()
        want = depthwise.depthwise_conv3_wgrad_plain(
            x.double(), gy.double(), *args[2:])
        bound = depthwise.gamma(depth) * depthwise.depthwise_conv3_wgrad_plain(
            x.double().abs(), gy.double().abs(), *args[2:])
        if not bool(((got - want).abs() <= bound).all()):
            raise AssertionError(f"wgrad stride {s}: off its bound")
        out[f"wgrad_s{s}_32x48x48x48x192"] = median_ms(
            lambda: depthwise.depthwise_conv3_wgrad_cuda(*args), reps=5,
            inner=3)
        del got, want, bound
    del x, gy
    torch.cuda.empty_cache()
    x = torch.randn((1, 128, 128, 128, 192), generator=gen).cuda()
    w = torch.randn((3, 3, 3, 192), generator=gen).cuda()
    if strided:
        if not torch.equal(depthwise.depthwise_conv3_cuda(x, w, 2),
                           depthwise.depthwise_conv3_plain(x, w, 2)):
            raise AssertionError("K6 stride 2: kernel differs from plain")
        out["forward_s2_1x128x128x128x192"] = median_ms(
            lambda: depthwise.depthwise_conv3_cuda(x, w, 2))
    else:
        wc = w.permute(3, 0, 1, 2).unsqueeze(1)
        out["forward_s2_1x128x128x128x192"] = median_ms(
            lambda: torch.nn.functional.conv3d(
                x.permute(0, 4, 1, 2, 3), wc, stride=2, padding=1,
                groups=192), reps=3, inner=3, warm=1)
    del x, w
    torch.cuda.empty_cache()
    return out


def _approx_selection(ops_knn, feats, gen, median_ms) -> dict:
    """The checkout's approx_top_k at the kNN rows of the --knn_recall
    step (f32 coordinate distances with the diagonal at +inf, the bf16
    feature distances of `feats` with it at -1; k = 40 at 0.9) and at the
    256^3 detector in bf16 (k = 20 000 at 0.95), each equal to the
    checkout's approx_top_k_plain first."""
    from fissure_segmentation_tpu_torch.ops import approx_topk
    pts = torch.rand((32, 2048, 3), generator=gen).cuda()
    d = ops_knn.pairwise_sqdist(pts, pts)
    d.diagonal(dim1=-2, dim2=-1).fill_(torch.inf)
    fd = ops_knn.pairwise_sqdist(feats, feats)
    fd.diagonal(dim1=-2, dim2=-1).fill_(-1.0)
    det = torch.rand((256 ** 3,), generator=gen).to("cuda", torch.bfloat16)
    out = {}
    for name, x, k, target, largest in (
            ("knn_rows_65536x2048_float32_k40", d, 40, 0.9, False),
            ("knn_rows_65536x2048_bfloat16_k40", fd, 40, 0.9, False),
            ("detector_1x16777216_bfloat16_k20000", det, 20_000, 0.95,
             True)):
        got = approx_topk.approx_top_k(x, k, target, largest)
        want = approx_topk.approx_top_k_plain(x, k, target, largest)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"approx_top_k {name}: differs from plain")
        out[name] = median_ms(
            lambda: approx_topk.approx_top_k(x, k, target, largest), reps=5,
            inner=3)
    del d, fd, det
    torch.cuda.empty_cache()
    return out


def _device_split(fn, calls: int = 10) -> dict:
    """{kernel name: [device ms a call, launches a call]} of `fn` from the
    profiler's trace of `calls` warm calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: [e.self_device_time_total / calls / 1e3,
                         e.count / calls]
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def _host_ms(fn, calls: int = 50) -> float:
    """The host's ms a call of `fn` back to back (what it takes to enqueue
    one; the card's queue is far deeper than `calls`)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def _gather_reduce(gather_reduce, knn, gen, graph_ms, median_ms) -> dict:
    """The checkout's gather-reduce at GR_CALLS on K1's graphs, each equal
    to its plain version first; the card alone (`graph_ms`), the wrapper
    back to back ("_host_included"), the host's ms a call ("_host_ms") and
    the same with no launch ("_host_ms_no_launch", `_no_launch`)."""
    out, graphs = {}, {}
    for name, (bb, n, k, c), dt, want in GR_CALLS:
        if (bb, n, k) not in graphs:
            graphs[bb, n, k] = knn.knn_cuda(
                (torch.rand((bb, n, 3), generator=gen) * 2 - 1).cuda(),
                k)[0].contiguous()
        a = torch.randn((bb, n, c), generator=gen).to("cuda",
                                                      getattr(torch, dt))
        gi = graphs[bb, n, k]
        got = gather_reduce.gather_reduce(a, gi, want)
        ref = gather_reduce.gather_reduce_plain(a, gi, want)
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise AssertionError(f"gather_reduce {name}: kernel differs "
                                 "from plain")

        def fn(a=a, gi=gi, want=want):
            return gather_reduce.gather_reduce(a, gi, want)
        out[name] = graph_ms(fn)
        out[f"{name}_host_included"] = median_ms(fn)
        out[f"{name}_host_ms"] = _host_ms(fn)
        with _no_launch(gather_reduce):
            out[f"{name}_host_ms_no_launch"] = _host_ms(fn)
    return out


class _Stub:
    """A kernel library whose gather-reduce entry launches nothing."""

    @staticmethod
    def fseg_gather_reduce(*args):
        return 0


class _no_launch:
    """Within: the checkout's gather-reduce wrapper calls `_Stub` instead of
    its library (its checks, allocations and bookkeeping alone: the host's
    share of a call without the card's work)."""

    def __init__(self, mod):
        import importlib
        self.mod = mod
        self.build = importlib.import_module(
            mod.__name__.rsplit(".", 1)[0] + "._build")

    def __enter__(self):
        self.load, self.lib = self.build.load, getattr(self.mod, "_lib", None)
        self.build.load = lambda: _Stub
        if hasattr(self.mod, "_lib"):
            self.mod._lib = _Stub

    def __exit__(self, *exc):
        self.build.load = self.load
        if hasattr(self.mod, "_lib"):
            self.mod._lib = self.lib


def _stream_sums(stream, probes, g, median_ms, graph_ms) -> dict:
    """The checkout's stream_sum at P1's (2 621 440, 64) bf16 view and on
    its float32 copy, stream_sum_async at P3's (1 310 720, 128) view over
    the probes' ASYNC_GRID (each within the checkout's rounding_bound of
    plain first), P3's total as the checkout's probe takes it (from the
    launch where `stream_sum` takes `total`, else `.sum()` of the column
    sums), torch.sum(g) to a scalar and torch.sum(., 0) beside them; each
    also split by the profiler into its kernels' device ms a call; P3's
    totals through stream_sum and the (128, 4) ring and torch.sum(g) also
    by CUDA-graph replays (the card alone) and by the host's ms to enqueue
    one."""
    with_total = "total" in inspect.signature(stream.stream_sum).parameters
    g64, g128 = g.view(-1, 64), g.view(-1, 128)
    gf = g64.float()
    calls = [("stream_sum_2621440x64_bfloat16", g64, None, None),
             ("stream_sum_2621440x64_float32", gf, None, None)] + [
        (f"stream_sum_async_1310720x128_bfloat16_c{c}_b{b}", g128, c, b)
        for c, b in probes.ASYNC_GRID]
    out, split = {}, {}
    for name, view, c, b in calls:
        def fn(view=view, c=c, b=b):
            return (stream.stream_sum(view) if c is None else
                    stream.stream_sum_async(view, c, b))
        err = (fn().double() - stream.stream_sum_plain(view).double()).abs()
        if not bool((err <= stream.rounding_bound(view, c, b)).all()):
            raise AssertionError(f"{name}: off its rounding bound of plain")
        out[name] = median_ms(fn)
        split[name] = _device_split(fn)
    for name, view, c, b in (("P3_total_stream_sum", g64, None, None),
                             ("P3_total_async_c32_b2", g128, 32, 2),
                             ("P3_total_async_c128_b4", g128, 128, 4)):
        def fn(view=view, c=c, b=b):
            if with_total:
                return (stream.stream_sum(view, total=True) if c is None else
                        stream.stream_sum_async(view, c, b, total=True))[1]
            return (stream.stream_sum(view) if c is None else
                    stream.stream_sum_async(view, c, b)).sum()
        out[name] = median_ms(fn)
        split[name] = _device_split(fn)
        if c in (None, 128):
            out[f"{name}_card_alone"] = graph_ms(fn)
            out[f"{name}_host"] = _host_ms(fn)
    for name, fn in (
            ("torch_sum_total", lambda: torch.sum(g, dtype=torch.float32)),
            ("torch_sum_cols_2621440x64_bfloat16",
             lambda: torch.sum(g64, 0, dtype=torch.float32)),
            ("torch_sum_cols_1310720x128_bfloat16",
             lambda: torch.sum(g128, 0, dtype=torch.float32)),
            ("torch_sum_cols_2621440x64_float32",
             lambda: torch.sum(gf, 0))):
        out[name] = median_ms(fn)
    out["torch_sum_total_card_alone"] = graph_ms(
        lambda: torch.sum(g, dtype=torch.float32))
    out["torch_sum_total_host"] = _host_ms(
        lambda: torch.sum(g, dtype=torch.float32))
    out["total_from_launch"] = with_total
    out["split"] = split
    del gf
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--tag", default="")
    ap.add_argument("--stream_only", action="store_true",
                    help="time the streaming column sums alone")
    ap.add_argument("--gr_only", action="store_true",
                    help="time the gather-reduce's path calls alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab runs only on an NVIDIA card")
    timing = _timing()
    graph_ms, median_ms = timing.graph_ms, timing.median_ms
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from fissure_segmentation_tpu_torch.kernels import (
        depthwise, fps, gather_reduce, knn, scatter)
    for mod in (fps, knn, depthwise, scatter, gather_reduce):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} imported from "
                               f"{mod.__file__}, not from {root}")
    if args.stream_only:
        from fissure_segmentation_tpu_torch.kernels import stream
        from fissure_segmentation_tpu_torch.prof import probes
        out = {"root": root, "tag": args.tag, "stream": _stream_sums(
            stream, probes, probes.payload()[1], median_ms, graph_ms)}
        print(json.dumps(out), flush=True)
        print(_card(), flush=True)
        return
    gen = torch.Generator().manual_seed(0)
    if args.gr_only:
        out = {"root": root, "tag": args.tag,
               "gather_reduce": _gather_reduce(gather_reduce, knn, gen,
                                               graph_ms, median_ms)}
        print(json.dumps(out), flush=True)
        print(_card(), flush=True)
        return
    out = {"root": root, "tag": args.tag, "knn": {}, "fps": {},
           "depthwise": {}, "scatter": {}}
    for name, shape, k, self_loop in KNN_SHAPES:
        x = (torch.rand(shape, generator=gen) * 2 - 1).cuda()
        i_k, d_k = knn.knn_cuda(x, k, self_loop)
        i_p, d_p = knn.knn_plain(x, k, self_loop)
        if not (torch.equal(i_k, i_p) and torch.equal(d_k, d_p)):
            raise AssertionError(f"K1 {name}: kernel differs from plain")
        out["knn"][name] = median_ms(lambda: knn.knn_cuda(x, k, self_loop))
    for name, shape, m, share in FPS_SHAPES:
        x = (torch.rand(shape, generator=gen) * 2 - 1).cuda()
        valid = None
        if share < 1.0:
            valid = (torch.rand(shape[:2], generator=gen) < share).cuda()
        if not torch.equal(fps.fps_cuda(x, m, valid),
                           fps.fps_plain(x, m, valid)):
            raise AssertionError(f"K5 {name}: kernel differs from plain")
        out["fps"][name] = median_ms(lambda: fps.fps_cuda(x, m, valid))
    for name, shape, dt in DW_SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn(shape, generator=gen).to("cuda", dtype)
        w = torch.randn((3, 3, 3, shape[-1]), generator=gen).to("cuda", dtype)
        if not torch.equal(depthwise.depthwise_conv3_cuda(x, w),
                           depthwise.depthwise_conv3_plain(x, w)):
            raise AssertionError(f"K6 {name}: kernel differs from plain")
        out["depthwise"][name] = median_ms(
            lambda: depthwise.depthwise_conv3_cuda(x, w))
        del x, w
    torch.cuda.empty_cache()
    b, n, k, c = STEP
    idx = knn.knn_cuda((torch.rand((b, n, 3), generator=gen) * 2 - 1)
                       .cuda(), k)[0].contiguous()
    idx2 = idx.reshape(b, n * k)
    build = getattr(scatter, "transpose", None) or scatter._transpose
    out["scatter"]["transpose_32x81920_rows2048"] = median_ms(
        lambda: build(idx2, n))
    for dt in ("float32", "bfloat16"):
        g = torch.randn((b, n * k, c), generator=gen).to("cuda",
                                                         getattr(torch, dt))
        got = scatter.scatter_rows(idx2, g, n)
        want = scatter.scatter_rows_plain(idx2, g, n)
        deg = scatter.scatter_count_plain(idx2, n)[..., None]
        bound = 2 * deg * 2.0 ** -24 * scatter.scatter_rows_plain(
            idx2, g.float().abs(), n)
        if not bool(((got - want).abs() <= bound).all()):
            raise AssertionError(f"K2 {dt}: kernel off its bound of plain")
        out["scatter"][f"K2_32x81920x64_{dt}"] = median_ms(
            lambda: scatter.scatter_rows(idx2, g, n))
        del g
    kstar = torch.randint(0, k, (b, n, c), generator=gen,
                          dtype=torch.int32).cuda()
    sp = torch.randn((b, n, c), generator=gen).cuda()
    pp = torch.randn((b, n, c), generator=gen).cuda()
    out["scatter"]["K3_32x2048x40x64_float32"] = median_ms(
        lambda: scatter.scatter_routed(idx, kstar, sp, pp, n))
    tr = build(idx2, n)
    deg = scatter.scatter_count_plain(idx2, n)[..., None]
    for dt in ("float32", "bfloat16"):
        s_, p_ = sp.to(getattr(torch, dt)), pp.to(getattr(torch, dt))
        got = scatter.scatter_routed(idx, kstar, s_, p_, n, tr)
        want = scatter.scatter_routed_plain(idx, kstar, s_, p_, n)
        bound = 2 * deg * 2.0 ** -24 * scatter.scatter_routed_plain(
            idx, kstar, s_.float().abs(), p_.float().abs(), n)
        if not bool(((got - want).abs() <= bound).all()):
            raise AssertionError(f"K3 {dt}: kernel off its bound of plain")
        out["scatter"][f"K3_32x2048x40x64_{dt}_shared"] = median_ms(
            lambda: scatter.scatter_routed(idx, kstar, s_, p_, n, tr))
    del sp, pp, kstar
    # K4: its device work (graph_ms) and, host included, back to back
    from_ptr = "transposed" in inspect.signature(
        scatter.scatter_count).parameters
    for tag, args, want in (
            ("hist_32x81920_rows2048", (idx2, n), n),
            ("hist_32x81920_rows512", (idx2 % 512, 512), 512),
            # as the fused backward calls it
            ("fused_backward_32x2048", (idx2, n, tr) if from_ptr
             else (idx2, n), n)):
        if not torch.equal(scatter.scatter_count(*args),
                           scatter.scatter_count_plain(args[0], want)):
            raise AssertionError(f"K4 {tag}: kernel differs from plain")
        out["scatter"][f"K4_{tag}"] = graph_ms(
            lambda: scatter.scatter_count(*args))
        out["scatter"][f"K4_{tag}_host_included"] = median_ms(
            lambda: scatter.scatter_count(*args))
    out["scatter"]["K4_fused_backward_from"] = ("transpose" if from_ptr
                                                else "histogram")
    del tr
    out["gather_reduce"] = _gather_reduce(gather_reduce, knn, gen, graph_ms,
                                          median_ms)
    torch.cuda.empty_cache()
    out["depthwise_backward"] = _depthwise_backward(depthwise, gen,
                                                    median_ms)
    from fissure_segmentation_tpu_torch.ops import knn as ops_knn
    feats = torch.randn((32, 2048, 64), generator=gen).to("cuda",
                                                         torch.bfloat16)
    out["feature_graph"] = {"32x2048x64_bfloat16_k40": median_ms(
        lambda: ops_knn.feature_knn(feats, 40), reps=5, inner=3)}
    out["approx_topk"] = _approx_selection(ops_knn, feats, gen, median_ms)
    del feats
    from fissure_segmentation_tpu_torch.prof import probes
    pidx, pg = probes.payload()
    row = next(r for r in probes.p1(pidx, pg)
               if r["variant"].startswith("k_onehot"))
    out["probes"] = {"P1_k_onehot": row["ms"]}
    from fissure_segmentation_tpu_torch.kernels import stream
    out["stream"] = _stream_sums(stream, probes, pg, median_ms, graph_ms)
    del pidx, pg
    print(json.dumps(out), flush=True)
    print(_card(), flush=True)


def _card() -> str:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    return card.stdout.strip().splitlines()[0]


if __name__ == "__main__":
    main()
