"""The span recorder (utils/profiling.py: span, recording, spanned) on the
CPU: off it is the shared no-op, on it nests, keeps parents and the
threads' native ids and stamps on torch.profiler's clock; serving's stages,
the train step's parts and the former profiler ranges as spans; the
benchmark's attribution of device operations to spans (portbench/
spans.py) on synthetic traces, and its readers. One test, marked cuda,
lays a span over the card's trace.

This file imports no jax; the card's test runs there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py
"""
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fissure_segmentation_tpu_torch.models import DGCNNSeg, MobileNetASPP
from fissure_segmentation_tpu_torch.models.dpsr_net import DPSRNet2
from fissure_segmentation_tpu_torch.ops.knn import approx_knn, feature_knn
from fissure_segmentation_tpu_torch.serving import (TIMING_KEYS,
                                                    case_generator,
                                                    segment_case,
                                                    segment_cases)
from fissure_segmentation_tpu_torch.utils import profiling
from fissure_segmentation_tpu_torch.utils.profiling import (Record,
                                                            recording, span,
                                                            spanned, stage)
from portbench import common
from portbench import spans as pspans

SHAPE = (48, 48, 48)
CFG = dict(max_kpts=1500, sample_points=128, n_runs_min=4, subset_batch=2,
           grid_res=(16, 16, 16), center_x=SHAPE[2] / 2, device="cpu")
DISPATCH = ["serving.dispatch", "serving.upload", "serving.keypoints",
            "serving.ensemble", "serving.surface", "serving.copy_out"]
HOST = ["serving.fetch", "serving.host_half", "serving.components",
        "serving.labelmap"]
NEW_METRICS = ["upload_ms.stream", "keypoints_ms.stream",
               "ensemble_ms.stream", "surface_ms.stream"] + [
    n for cell in pspans.PENDING.values() for n, _ in cell]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- the recorder ----

def test_span_off_is_the_shared_no_op(monkeypatch):
    """Off, a span takes no stamp, opens no profiler range and records
    nothing: every span is one object."""
    def fail(*a, **k):
        raise AssertionError("called while off")
    monkeypatch.setattr(profiling.time, "time_ns", fail)
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        fail)
    a, b = span("a"), span("b")
    assert a is b is profiling._NO_SPAN
    with span("c") as s:
        assert s is profiling._NO_SPAN


def test_recording_nests_and_keeps_parents():
    with span("before"):
        with recording() as recs:
            with span("outer"):
                with span("inner"):
                    pass
                with span("second"):
                    with recording() as inner:
                        with span("deep"):
                            pass
    assert all(isinstance(r, Record) for r in recs + inner)
    got = {r.name: r for r in recs}
    assert set(got) == {"outer", "inner", "second"}
    assert [r.name for r in inner] == ["deep"]
    assert got["outer"].parent == -1
    assert got["inner"].parent == got["second"].parent == got["outer"].id
    assert inner[0].parent == got["second"].id
    assert got["outer"].start_ns <= got["inner"].start_ns <= \
        got["inner"].end_ns <= got["second"].start_ns <= \
        got["second"].end_ns <= got["outer"].end_ns
    assert {r.tid for r in recs} == {threading.get_native_id()}
    with span("after"):
        pass
    assert len(recs) == 3


def test_recording_takes_worker_threads_native_ids():
    def job(i):
        with span(f"worker.{i}"):
            with span("worker.inner"):
                time.sleep(0.001)
        return threading.get_native_id(), threading.get_ident()

    with recording() as recs:
        with span("main"):
            with ThreadPoolExecutor(3) as pool:
                tids = list(pool.map(job, range(6)))
    main = threading.get_native_id()
    workers = [r for r in recs if r.name.startswith("worker.")
               and r.name != "worker.inner"]
    assert sorted((r.tid, r.ident) for r in workers) == sorted(tids)
    assert main not in {t for t, _ in tids}
    ids = {r.id: r for r in recs}
    for r in recs:
        if r.name == "worker.inner":
            assert ids[r.parent].tid == r.tid
            assert ids[r.parent].name.startswith("worker.")
        elif r.name != "main":
            assert r.parent == -1      # nothing open on its thread


def test_span_stamps_on_the_profiler_clock():
    """A span and a record_function opened inside it start within 1 ms of
    each other on the profiler's clock; the span is a range of its own
    name in the profiler's table."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]):
        with span("warm"), record_function("warm"):
            pass
    with recording() as recs:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("clocked"):
                with record_function("inside"):
                    torch.ones(8).add_(1)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    rec = recs[0]
    assert abs(events["inside"].start_ns() - rec.start_ns) < 1_000_000
    assert abs(events["clocked"].start_ns() - rec.start_ns) < 1_000_000
    assert {"clocked", "inside"} <= {e.key for e in prof.key_averages()}


def test_span_times_into_a_dict_with_the_recorder_off():
    got: dict = {}
    for _ in range(2):
        with span("timed", got):
            time.sleep(0.002)
    assert 0.004 <= got["timed"] < 1.0
    with recording() as recs:
        with span("timed", got):
            pass
    assert [r.name for r in recs] == ["timed"]


def test_spanned_and_stage_open_spans():
    @spanned("decorated")
    def f(x):
        return x + 1

    stages: dict = {}
    with recording() as recs:
        assert f(1) == 2
        with stage(stages, "synced", "cpu"):
            pass
        with stage(None, "unsynced", "cpu"):
            pass
    assert [r.name for r in recs] == ["decorated", "synced", "unsynced"]
    assert set(stages) == {"synced"} and stages["synced"] >= 0
    assert f(2) == 3


def test_device_rows_leave_out_the_spans_ranges():
    """Where the profiler traces the card, a span's range has a device row
    that repeats its operations' time: device sums leave it out, and keep
    every other CUDA row (record_function blocks that are no span too)."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with span("rows.span"):
            pass
    rows = [SimpleNamespace(key=k, device_type=d) for k, d in (
        ("rows.span", DeviceType.CUDA), ("kernel_a", DeviceType.CUDA),
        ("other.range", DeviceType.CUDA), ("aten::add", DeviceType.CPU))]
    assert [e.key for e in profiling.device_rows(rows)] == ["kernel_a",
                                                            "other.range"]


def test_the_former_ranges_keep_their_names():
    """feature_graph, approx_graph and DPSR-Net's dpsr:* stages appear in
    a CPU profiler's table, as train/profile_step.py and chip_smoke.py
    read them."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 64, 3), generator=g) * 2 - 1
    model = DPSRNet2("DGCNN", k=6, in_features=3, num_classes=3,
                     dynamic=False, dpsr_res=(16, 16, 16), dpsr_sigma=3.0,
                     max_tris=3000, n_surface_samples=64,
                     normals_smoothing_sigma=2.0, generator=g).eval()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        feature_knn(x, 4)
        approx_knn(x, 4, False, 0.9)
        with torch.no_grad():
            model(x)
    keys = {e.key for e in prof.key_averages()}
    assert {"feature_graph", "approx_graph", "dpsr:seg_net",
            "dpsr:splat_normals", "dpsr:psr",
            "dpsr:marching_sampling"} <= keys


# ---- serving ----

def _volume(seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(-700, 80, SHAPE).astype(np.float32)
    zz, yy, _ = np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij")
    img[np.abs(zz - (20 + 0.2 * yy)) < 1.0] = -300.0
    mask = np.ones(SHAPE, bool)
    mask[..., -4:] = False
    return img, mask


@pytest.fixture(scope="module")
def served():
    model = DGCNNSeg(k=8, in_features=3, num_classes=4, dynamic=False,
                     generator=torch.Generator().manual_seed(0)).eval()

    def apply(x):
        third = 1 + 1 * (x[..., 0] >= -1 / 3) + 1 * (x[..., 0] >= 1 / 3)
        return model(x) + 50.0 * torch.nn.functional.one_hot(third, 4)
    return apply, [_volume(0), _volume(1)]


def _serving_names(recs):
    return [r.name for r in sorted(recs, key=lambda r: r.start_ns)
            if r.name.startswith("serving.")]


def test_segment_case_yields_the_span_tree_once_a_case(served):
    apply, vols = served
    with recording() as recs:
        for i, (v, m) in enumerate(vols):
            segment_case(v, m, apply, case_generator(0, i), **CFG)
    assert _serving_names(recs) == (DISPATCH + HOST) * 2
    ids = {r.id: r for r in recs}
    for r in recs:
        parent = ids[r.parent].name if r.parent >= 0 else None
        if r.name in DISPATCH[1:]:
            assert parent == "serving.dispatch"
        elif r.name in ("serving.components", "serving.labelmap"):
            assert parent == "serving.host_half"
        elif r.name.startswith("serving."):
            assert parent is None
        elif r.name == "edgeconv.kernels":
            assert parent == "serving.ensemble"


def test_cnn_mode_puts_the_cnn_inside_the_keypoints():
    vol, mask = _volume(2)
    vol = (vol[:32, :32, :32] + 700.0) / 400.0
    cnn = MobileNetASPP(num_classes=4,
                        generator=torch.Generator().manual_seed(0)).eval()
    model = DGCNNSeg(k=8, in_features=3, num_classes=4, dynamic=False,
                     generator=torch.Generator().manual_seed(1)).eval()
    with recording() as recs:
        segment_case(vol, mask[:32, :32, :32], model, case_generator(0, 0),
                     kp_mode="cnn", cnn_model=cnn, max_kpts=300,
                     sample_points=64, n_runs_min=2, subset_batch=2,
                     grid_res=(8, 8, 8), device="cpu")
    ids = {r.id: r for r in recs}
    (cnn_span,) = [r for r in recs if r.name == "serving.cnn"]
    assert ids[cnn_span.parent].name == "serving.keypoints"
    depthwise = [r for r in recs if r.name == "cnn.depthwise"]
    assert len(depthwise) == 8       # the blocks' seven stride-1 layers
    assert all(r.parent == cnn_span.id for r in depthwise)   # and block 5


def test_segment_cases_threaded_spans_and_timings(served):
    """Threaded, the fetch and the host half run in spans on the two
    worker threads; the timings hold the spans' seconds, with the recorder
    off too."""
    apply, vols = served
    vols = vols + vols[:1]
    main = threading.get_native_id()
    timings: list = []
    with recording() as recs:
        segment_cases([v for v, _ in vols], [m for _, m in vols], apply,
                      seed=3, window=2, timings=timings, **CFG)
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    assert {r.tid for r in by["serving.dispatch"]} == {main}
    fetch = {r.tid for r in by["serving.fetch"]}
    host = {r.tid for r in by["serving.host_half"]}
    assert len(fetch) == len(host) == 1 and main not in fetch | host
    assert fetch != host
    secs = sorted(1e-9 * (r.end_ns - r.start_ns)
                  for r in by["serving.dispatch"])
    assert sorted(t["dispatch_s"] for t in timings) == pytest.approx(secs)

    off: list = []
    segment_cases([v for v, _ in vols], [m for _, m in vols], apply, seed=3,
                  window=2, timings=off, **CFG)
    keys = set(TIMING_KEYS.values())
    assert [set(t) for t in off] == [keys] * 3
    for t in off:
        stages = sum(t[k] for k in ("upload_s", "keypoints_s", "ensemble_s",
                                    "surface_s", "copy_out_s"))
        assert 0 < stages <= t["dispatch_s"]
        assert t["fetch_s"] >= 0 and t["host_s"] > 0


# ---- the train step ----

def test_train_step_spans():
    from portbench.loops import train as train_loop
    from portbench.tests.conftest import small_cell
    cfg = small_cell("dgcnn_k40.train").config
    trainer, _, store, _, out_dir = train_loop.build(cfg, 3, torch.device(
        "cpu"))
    _, step = train_loop.step_calls(trainer, store, cfg, 3, "cpu")
    step()
    with recording() as recs:
        step()
    names = [r.name for r in sorted(recs, key=lambda r: r.start_ns)
             if r.name.startswith("train.")]
    assert names == ["train.sample", "train.forward", "train.loss",
                     "train.backward", "train.optimizer"]
    ids = {r.id: r for r in recs}
    parents = {ids[r.parent].name for r in recs
               if r.name == "edgeconv.kernels"}
    assert parents == {"train.forward", "train.backward"}


# ---- the benchmark's attribution ----

def _rec(name, tid, s, e, i, parent=-1):
    return Record(name, tid, s, e, i, parent, 1000 + tid)


def _trace():
    """Main thread 1: a (0-100) holding b (10-40) and c (50-90); thread 2:
    w (20-60); thread 3 opens no span. Launches (runtime start, tid,
    corr): 15 on 1 (b); 55 on 1 (c); 30 on 2 (w; the record names the
    thread by its ident, 1002); 70 on 3 (no span on 3: on any thread the
    innermost open at 70 is c); 95 on 1 (a); a device operation with no
    runtime record after the one launched at 55; a cudaStreamSynchronize
    at 60 on 1 (in c) and at 25 on 2 (in w); a pageable copy launched at 12
    on 1 (in b)."""
    spans = pspans.Spans([_rec("a", 1, 0, 100, 0), _rec("b", 1, 10, 40, 1, 0),
                          _rec("c", 1, 50, 90, 2, 0), _rec("w", 2, 20, 60, 3)])
    runtime = [(15, 16, 1, "cudaLaunchKernel", 11),
               (55, 56, 1, "cudaLaunchKernel", 12),
               (30, 31, 1002, "cudaLaunchKernel", 13),
               (70, 71, 3, "cudaLaunchKernel", 14),
               (95, 96, 1, "cudaLaunchKernel", 15),
               (60, 65, 1, "cudaStreamSynchronize", 16),
               (25, 26, 2, "cudaStreamSynchronize", 17),
               (12, 14, 1, "cudaMemcpyAsync", 18)]
    device = [(20, 30, "k_b", 11, 7), (60, 70, "k_c", 12, 7),
              (72, 75, "orphan", 0, 7), (40, 45, "k_w", 13, 7),
              (80, 85, "k_any", 14, 7), (100, 110, "k_a", 15, 7),
              (14, 18, "Memcpy HtoD (Pageable -> Device)", 18, 7)]
    return pspans.SpanTrace(spans, runtime, device, (0, 120),
                            waits=[(5, 12), (52, 58)])


def test_attribution_by_correlation_thread_and_stream_order():
    t = _trace()
    got = {op[2]: (t.spans.records[i].name if i >= 0 else None, h)
           for op, i, h in zip(t.device, t.owner, t.how)}
    assert got == {"k_b": ("b", "thread"), "k_c": ("c", "thread"),
                   "k_w": ("w", "thread"), "k_any": ("c", "any"),
                   "k_a": ("a", "thread"), "orphan": ("c", "stream"),
                   "Memcpy HtoD (Pageable -> Device)": ("b", "thread")}
    assert t.launches("a") == 6 and t.launches("c") == 3
    assert t.device_s("a") == pytest.approx(1e-9 * (10 + 10 + 3 + 5 + 10 + 4))
    assert t.coverage() == 1.0
    assert t.syncs("a") == 2            # the sync in c, the pageable copy
    assert t.syncs("w") == 1 and t.syncs("b") == 1
    assert t.waits_s("a") == pytest.approx(1e-9 * 13)
    assert t.waits_s("b") == pytest.approx(1e-9 * 2)
    assert t.waits_s("w") == pytest.approx(1e-9 * 6)
    report = t.report(per=2)
    assert report["by_span"]["c"]["launches"] == 1.5
    assert report["by_span"]["a"]["queue_full_ms"] == pytest.approx(6.5e-6)


def test_attribution_with_spans_missing():
    """Operations launched where no span is open on any thread count
    against the coverage."""
    t = pspans.SpanTrace(pspans.Spans([_rec("a", 1, 0, 10, 0)]),
                         [(5, 6, 1, "cudaLaunchKernel", 1),
                          (20, 21, 1, "cudaLaunchKernel", 2)],
                         [(6, 16, "in", 1, 7), (22, 52, "out", 2, 7)],
                         (0, 60))
    assert t.how == ["thread", "none"]
    assert t.coverage() == pytest.approx(10 / 40)


def test_idle_overlap():
    """Busy 14-18, 20-30, 40-45, 60-70, 72-75, 80-85, 100-110 of the window
    0-120; a (0-100) holds 63 idle, c (50-90) 22, w (20-60) 25."""
    t = _trace()
    assert t.gaps == [(0, 14), (18, 20), (30, 40), (45, 60), (70, 72),
                      (75, 80), (85, 100), (110, 120)]
    assert t.idle_s("a") == pytest.approx(1e-9 * 63)
    assert t.idle_s("c") == pytest.approx(1e-9 * 22)
    assert t.idle_s("w") == pytest.approx(1e-9 * 25)
    assert pspans.overlap([(0, 5), (10, 20)], [(3, 12), (15, 30)]) == 9
    assert pspans.union([(0, 5), (3, 8), (10, 12)]) == [(0, 8), (10, 12)]


# the synthetic trace's spans a, b, c, w under the program's names, by cell
RENAMED = {
    "mobilenet_aspp.serve_stream": {"a": "serving.dispatch",
                                    "b": "serving.upload",
                                    "c": "cnn.depthwise",
                                    "w": "serving.fetch"},
    "mobilenet_aspp.serve_one": {"a": "serving.host_half",
                                 "b": "serving.components",
                                 "c": "serving.labelmap",
                                 "w": "serving.dispatch"},
    "dgcnn_k40.train": {"a": "train.backward", "b": "train.sample",
                        "c": "edgeconv.kernels", "w": "train.optimizer"}}


def test_new_readers_follow_the_manifest_and_read_spans():
    """Every new reader is found by name as the harness finds readers; on a
    stock run (no spans) each reads nothing; on a run with the spans of a
    synthetic trace each reads a number. BENCHMARK.json lists the four
    that read segment_cases' timings, within the contract's checks."""
    from portbench.tests import test_manifest
    man = common.load_manifest()
    test_manifest.test_metrics(man)
    listed = {m["name"] for m in man["per_layer"]}
    assert set(NEW_METRICS[:4]) <= listed
    assert not set(NEW_METRICS[4:]) & listed
    stock = common.TraceSummary(1.0, 10.0, {}, {})
    base = _trace()
    timings = [{"upload_s": 0.001, "keypoints_s": 0.002, "ensemble_s": 0.003,
                "surface_s": 0.004, "dispatch_s": 0.011}]
    cell_of = {n: c for c, ms in pspans.PENDING.items() for n, _ in ms}
    for name in NEW_METRICS:
        assert test_manifest.NAME.match(name), name
        cell = common.resolve(cell_of.get(name,
                                          "mobilenet_aspp.serve_stream"))
        read = common.metric_reader(name)
        for trace in (None, stock):
            run = common.Run(cell.config, cell.traffic, 10.0, cases=2,
                             trace=trace, trace_cases=2, trace_steps=2)
            assert read(run) is None, name
        names = RENAMED[cell.name]
        spans = pspans.Spans([Record(names[r.name], *r[1:])
                              for r in base.spans.records])
        program = pspans.SpanTrace(spans, base.runtime, base.device,
                                   base.window)
        trace = pspans.SpanSummary(1.0, 10.0, {"knn_kernel": 1.0}, {},
                                   program=program)
        run = common.Run(cell.config, cell.traffic, 10.0, cases=2,
                         trace=trace, trace_cases=2, trace_steps=2,
                         timings=timings)
        run.records = spans.records
        value = read(run)
        assert value is not None and np.isfinite(value) and value > 0, name


# ---- the card ----

@pytest.mark.cuda
def test_span_over_the_card_trace():
    """A span around torch.cuda._sleep after a sync, traced by the
    benchmark's SpanTracer: the launch's runtime record lies inside the
    span on the span's thread, the kernel starts after the span's start,
    and the attribution gives the kernel to the span."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    tracer = pspans.SpanTracer(True, True)
    tracer.start()
    torch.cuda.synchronize()
    with span("card.sleep"):
        torch.cuda._sleep(2_000_000)
    torch.cuda.synchronize()
    tracer.stop()
    program = tracer.summary().program
    (rec,) = [r for r in program.spans.records if r.name == "card.sleep"]
    (k,) = [i for i, op in enumerate(program.device) if "spin_kernel" in op[2]]
    op = program.device[k]
    (launch,) = [r for r in program.runtime if r[4] == op[3]]
    assert rec.start_ns <= launch[0] <= launch[1] <= rec.end_ns
    assert rec.tid == threading.get_native_id()
    assert launch[2] in (rec.tid, pspans.int32(rec.ident))
    assert op[0] >= rec.start_ns
    assert program.spans.records[program.owner[k]].name == "card.sleep"
    assert program.how[k] == "thread"
