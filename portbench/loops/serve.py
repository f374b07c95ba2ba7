"""The serving windows: CT cases through the program's `segment_case`
(mode "one": a closed loop, one case at a time) or `segment_cases` (mode
"stream": chunks of `chunk` cases, pipelined with `window` cases in
flight and, with `pipeline_threads`, the fetch and host halves on worker
threads).

Set-up makes the configuration's pool of CTs and lung masks on the device
(from the configuration's `model_seed`, as the weights: every seed serves
the same work, in an order of its own) and hands the program copies in
host memory (as a caller's CTs arrive), the CNN and the point model with
the benchmark's weights (the last biases of both set so that their
classes share the work, `balance_classes`, `balance_points`; the point
model's logits with the class bias, portbench/gen/weights.py), and warms
up with `warm_cases` cases through the window's own call. Case i of the
window serves CT i mod pool with a CPU generator seeded from (seed, i).

The window: mode "one" starts cases until `seconds` have passed, each
timed from the call to its CaseResult (the last one started finishes and
counts); mode "stream" runs chunks until `seconds` have passed, the chunk
running at the close finished and counted with its time. The end-to-end
values: "one" the 90th percentile of every case's latency, "stream" the
cases returned over the window. With tracing, that window runs untraced
(the program's counters and the rates are read from it) and a second
window of as many seconds runs under the profiler (the device's metrics).

Afterwards the reference judges every case's keypoints
(reference/serving.py), and for case 0 and a share `judge_share` of the
others drawn from the seed, the labels (reference/serving.py) and the
meshes and labelmap (reference/surface.py); the limits are LIMITS.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from ..common import Check, Outcome, Run, Tracer, derive_seed, tf32
from ..gen.ct import make_pool
from ..gen.weights import ClassBias, bands, class_bias, seeded_state, shapes_of
from ..reference import serving as ref
from ..reference import surface

# the limits of the numbers compared (PERF.md gives the readings they were
# set from)
LIMITS = {"outside_mask": 0, "kp_gap": 3e-5, "label_gap": 1e-5,
          "surface_gap": 0.1}
MODELS = ("MobileNetASPP", "DGCNNSeg")


def case_generator(seed: int, i: int) -> torch.Generator:
    """Case i's CPU generator (i < 0: the warm-up's cases)."""
    stream = ("case", i) if i >= 0 else ("warm", -i)
    return torch.Generator().manual_seed(derive_seed(seed, *stream))


def sampled(seed: int, i: int, share: float) -> bool:
    """Whether case i's labels, meshes and labelmap are judged: case 0,
    and each other case with probability `share`, drawn from the seed."""
    return i == 0 or derive_seed(seed, "judge", i) < share * 2.0 ** 63


def build(config: dict, seed: int, device):
    """(cnn, served point model, the CNN's state, the point model's state,
    the pool, the class-bias bands). The weights and the pool's CTs come
    from the configuration's `model_seed`, so every seed serves the same
    work; the seed orders the pool (case i serves pool[i mod size])."""
    from fissure_segmentation_tpu_torch.models import DGCNNSeg, MobileNetASPP
    pcfg = config["point_model"]
    if (config["model"], pcfg["model"]) != MODELS:
        raise ValueError(f"the serving loop serves {MODELS}, not "
                         f"{(config['model'], pcfg['model'])}")
    fixed = config["model_seed"]
    pool = make_pool(derive_seed(fixed, "pool"), config["ct_pool"],
                     tuple(config["ct_shape"]), device)
    cnn = MobileNetASPP(num_classes=config["num_classes"])
    cnn_state = seeded_state(shapes_of(cnn), derive_seed(fixed, "cnn"),
                             device)
    soft = balance_classes(cnn_state, pool[0][0], pool[0][1], config)
    cnn.load_state_dict(cnn_state)
    cnn = cnn.to(device).eval()
    net = DGCNNSeg(k=pcfg["k"], in_features=pcfg["in_features"],
                   num_classes=pcfg["num_classes"],
                   dynamic=not pcfg["static_graph"],
                   dtype=None if pcfg["compute_dtype"] == "float32"
                   else torch.bfloat16)
    point_state = seeded_state(shapes_of(net), derive_seed(fixed, "points"),
                               device)
    band_list = bands(pool[0][2], tuple(config["ct_shape"]))
    balance_points(point_state, soft, pool[0][1], band_list, config,
                   derive_seed(fixed, "balance"))
    del soft
    net.load_state_dict(point_state)
    model = ClassBias(net.to(device).eval(), band_list, pcfg["class_bias"])
    order = np.random.default_rng(derive_seed(seed, "order")).permutation(
        len(pool))
    pool = [pool[j] for j in order]
    return cnn, model, cnn_state, point_state, pool, band_list


@torch.no_grad()
def balance_classes(cnn_state: dict, vol: torch.Tensor, mask: torch.Tensor,
                    config: dict) -> torch.Tensor:
    """Set the CNN's last bias so that every class's mean logit over the
    lung voxels of the whole volume `vol` is 0: random weights then split
    the lungs among the classes instead of giving one class all of them.
    The logits are the reference's (whole-volume: the ASPP's pooled branch
    sees the whole volume, so a crop would not do). Returns the balanced
    CNN's (D, H, W, C) softmax of `vol`."""
    from ..reference import mobilenet_aspp
    with tf32(False):
        logits = mobilenet_aspp.logits_volume(cnn_state, vol, config)
    shift = logits[:, mask].mean(1)
    cnn_state["Conv_2.bias"] -= shift
    logits -= shift[:, None, None, None]
    return torch.softmax(logits, dim=0).permute(1, 2, 3, 0)


@torch.no_grad()
def balance_points(point_state: dict, soft: torch.Tensor, mask, band_list,
                   config: dict, seed: int) -> None:
    """Set the point model's last bias so that every class's mean logit
    (the reference's, one group of subsets of the CT's keypoints, drawn
    from `seed`) over the keypoints outside the class-bias bands is 0:
    there the network's own decisions then split the keypoints among the
    classes instead of giving one class all of them, and its near ties are
    judged."""
    from ..reference import dgcnn
    serving, pcfg = config["serving"], config["point_model"]
    gen = torch.Generator().manual_seed(seed)
    with tf32(False):
        scores = ref.score_draw(gen, soft.shape[:3].numel(), soft.device)
        kp, _ = ref.select(soft, mask, scores, serving["max_kpts"])
        pc = ref.grid_points(kp, soft.shape[:3], len(kp))
        rows = ref.subset_draw(gen, len(kp), serving["sample_points"],
                               1)[:serving["subset_batch"]]
        x = pc[rows.to(pc.device)]
        logits = dgcnn.forward(point_state, x, pcfg, train=False)
    free = class_bias(x, torch.zeros_like(logits), band_list, 1.0).eq(
        0).all(-1)
    last = f"SharedMLP_{1 + len(pcfg['head_widths'])}.Dense_0.bias"
    point_state[last] -= logits[free].mean(0)


def serving_kwargs(config: dict, cnn, device) -> dict:
    """segment_case's keywords for the configuration."""
    s = config["serving"]
    return dict(device=device, kp_mode=s["kp_mode"], cnn_model=cnn,
                max_kpts=s["max_kpts"], sample_points=s["sample_points"],
                n_runs_min=s["n_runs_min"], subset_batch=s["subset_batch"],
                grid_res=tuple(s["grid_res"]), sig=s["sig"],
                k_normals=s["k_normals"], max_tris=s["max_tris"],
                class_cap=s["class_cap"], make_labelmap=s["make_labelmap"])


def serve_cases(traffic: dict, host: list, model, seed: int, cases, kw,
                timings=None) -> list:
    """The window's call on `cases` (indices; case i serves CT i mod the
    pool with its own generator): one segment_cases call in mode "stream",
    a segment_case call a case in mode "one"; their CaseResults."""
    from fissure_segmentation_tpu_torch.serving import (segment_case,
                                                        segment_cases)
    cases = list(cases)
    vols = [host[i % len(host)][0] for i in cases]
    masks = [host[i % len(host)][1] for i in cases]
    gens = [case_generator(seed, i) for i in cases]
    if traffic["mode"] == "stream":
        return segment_cases(vols, masks, model, generators=gens,
                             window=traffic["window"], timings=timings,
                             pipeline_threads=traffic["pipeline_threads"],
                             **kw)
    return [segment_case(v, m, model, g, **kw)
            for v, m, g in zip(vols, masks, gens)]


def answer_of(res, judged: bool) -> tuple:
    """What the reference judges of a CaseResult: (kpts, labels, and for a
    judged case (meshes, labelmap), else None)."""
    return (torch.from_numpy(np.asarray(res.kpts)),
            torch.from_numpy(np.asarray(res.labels)),
            (res.meshes, res.labelmap) if judged else None)


def serve_window(serve, first: int, seconds: float, size: int, keep,
                 tracer) -> tuple:
    """Serve from case `first` on, `size` cases a call, until `seconds`
    have passed: ({i: keep(i, result)}, latencies of the calls, the
    program's timings, the window's seconds)."""
    answers, latencies, timings = {}, [], []
    tracer.start()
    t0 = time.perf_counter()
    n = first
    while time.perf_counter() - t0 < seconds:
        c0 = time.perf_counter()
        out = serve(n, size, timings)
        latencies.append(time.perf_counter() - c0)
        for j, res in enumerate(out):
            answers[n + j] = keep(n + j, res)
        n += size
    window = time.perf_counter() - t0
    tracer.stop()
    return answers, latencies, timings, window


def run(ctx) -> Outcome:
    config, traffic, device = ctx.config, ctx.traffic, ctx.device
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])
    cnn, model, cnn_state, point_state, pool, band_list = build(
        config, ctx.seed, device)
    ctx.mark("pool, weights, models")
    host = [(img.cpu().numpy(), mask.cpu().numpy()) for img, mask, _ in pool]
    kw = serving_kwargs(config, cnn, device)
    stream = traffic["mode"] == "stream"
    size = traffic["chunk"] if stream else 1

    def serve(first: int, n: int, timings=None):
        return serve_cases(traffic, host, model, ctx.seed,
                           range(first, first + n), kw, timings)

    def keep(i, res):
        return answer_of(res, sampled(ctx.seed, i, traffic["judge_share"]))

    # warm-up: the window's own call, on cases the window does not serve
    warm = -traffic["warm_cases"]
    for first in range(warm, 0, size):
        serve(first, min(size, -first))
    if cuda:
        torch.cuda.synchronize()
    ctx.mark("warm cases")
    ctx.setup_done()

    answers, latencies, timings, window = serve_window(
        serve, 0, ctx.seconds, size, keep, Tracer(False, cuda))
    run_rec = Run(config, traffic, window, cases=len(answers),
                  timings=timings)
    if ctx.trace:
        tracer = Tracer(True, cuda)
        traced, _, _, _ = serve_window(serve, len(answers), ctx.seconds,
                                       size, keep, tracer)
        run_rec.trace, run_rec.trace_cases = tracer.summary(), len(traced)
        answers.update(traced)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if stream:
        values = {"serve_cases_per_s": len(answers) / window}
    else:
        values = {"case_p90_s": statistics.quantiles(latencies, n=10)[-1]
                  if len(latencies) > 1 else latencies[0]}

    del cnn, model
    if cuda:
        torch.cuda.empty_cache()
    numbers = judge(ctx.seed, config, answers, pool, cnn_state, point_state,
                    band_list)
    checks = [Check(k, numbers[k], LIMITS[k]) for k in LIMITS]
    return Outcome(len(answers), 0, values, checks, run_rec, peak)


def judge(seed, config, answers, pool, cnn_state, point_state, band_list,
          labelled=None) -> dict:
    """The worst of each number over the answers {i: (kpts, labels,
    (meshes, labelmap) or None)}: the keypoints of every case; the labels
    of the cases in `labelled` (default: those carrying meshes), the
    meshes and labelmap of the cases that carry them; judged by the
    reference with TF32 off."""
    from ..reference import mobilenet_aspp
    worst = {"surface_gap": 0.0}
    softs: dict = {}
    with tf32(False):
        for i in sorted(answers):
            kpts, labels, surf = answers[i]
            vol, mask, _ = pool[i % len(pool)]
            if i % len(pool) not in softs:
                with torch.no_grad():
                    softs[i % len(pool)] = mobilenet_aspp.softmax_volume(
                        cnn_state, vol, config)
            got = ref.judge(kpts, labels, vol, mask, softs[i % len(pool)],
                            case_generator(seed, i), config, point_state,
                            band_list, labels_too=surf is not None
                            if labelled is None else i in labelled)
            if surf is not None:
                got.update(surface.judge_surfaces(
                    kpts.numpy(), labels.numpy(), surf[0],
                    np.asarray(surf[1]), config["serving"], vol.device))
            for key, v in got.items():
                worst[key] = max(worst.get(key, v), v)
    return worst
