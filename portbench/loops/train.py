"""The training window: a closed loop of the program's train steps.

Set-up builds one ModelTrainer (the program's DGCNNSeg with the
benchmark's weights, its Adam, its device store sampler `batch_fn`) and
drives it through the traffic's `first_steps` steps by the window's own
call; those steps are the ones the reference follows. The step's call:
case indices (the first `batch` of a permutation of the store's cases,
so a batch's rows all differ), `trainer.batch_fn`, `trainer.train_step`.
The window then runs that call until `seconds` have passed on the host
clock and ends in a sync; clouds/s = batch x steps / window.

With tracing, that window runs untraced (the rate is read from it) and a
second window of as many seconds runs under the profiler (the device's
activity), with CUDA events around each `batch_fn` call timing the
sampler (`sampler_ms`).
"""
from __future__ import annotations

import shutil
import tempfile
import time

import torch

from ..common import Check, Outcome, Run, Tracer, derive_seed, tf32
from ..gen.points import class_weights, make_store
from ..gen.weights import seeded_state, shapes_of
from ..reference import train as ref

# the limits of the numbers compared (PERF.md gives the readings they were
# set from)
LIMITS = {"loss_gap": 0.15, "grad_gap": 0.4, "grad_gap_median": 0.016,
          "change_gap": 0.2, "change_gap_median": 0.05}


class _Data:
    """What ModelTrainer asks of a dataset: its size, the sampler's
    settings and the device store."""

    def __init__(self, store, sample_points):
        self.store, self.sample_points = store, sample_points
        self.do_augmentation, self.binary = True, False

    def __len__(self):
        return self.store.coords.shape[0]

    def to_store(self, device=None):
        return self.store


def build(cfg: dict, seed: int, device, mark=lambda what: None):
    """(trainer, the initial state, the store tensors, the class weights,
    its output directory); `mark(what)` notes each step's end."""
    from fissure_segmentation_tpu_torch.data.store import PointCloudStore
    from fissure_segmentation_tpu_torch.losses import get_loss_fn
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    from fissure_segmentation_tpu_torch.train.trainer import (ModelTrainer,
                                                              TrainConfig)
    if cfg["model"] != "DGCNNSeg":
        raise ValueError(f"the training loop trains DGCNNSeg, not "
                         f"{cfg['model']}")
    mark("the port's modules")
    coords, labels, valid = make_store(
        derive_seed(seed, "store"), cfg["store_cases"],
        cfg["points_per_case"], device, cfg["fissure_fraction"],
        cfg["jitter"])
    weights = class_weights(labels, valid, cfg["num_classes"])
    mark("store")
    store = PointCloudStore(coords, coords.new_zeros((*coords.shape[:2], 0)),
                            labels, valid)
    dtype = {"bfloat16": torch.bfloat16, "float32": None}[
        cfg["compute_dtype"]]
    model = DGCNNSeg(k=cfg["k"], in_features=cfg["in_features"],
                     num_classes=cfg["num_classes"],
                     dynamic=not cfg["static_graph"], dtype=dtype)
    state = seeded_state(shapes_of(model), derive_seed(seed, "weights"),
                         device)
    model.load_state_dict(state)
    mark("weights")
    out_dir = tempfile.mkdtemp(prefix="portbench_train_")
    trainer = ModelTrainer(
        model, _Data(store, cfg["sample_points"]),
        get_loss_fn(cfg["loss"], weights), out_dir,
        TrainConfig(lr=cfg["lr"], batch_size=cfg["batch"],
                    weight_decay=cfg["weight_decay"], scheduler="none"),
        device=device)
    opt = trainer.optimizer.defaults
    if (tuple(opt["betas"]) != tuple(cfg["betas"])
            or opt["eps"] != cfg["adam_eps"]):
        raise RuntimeError("the program's Adam is not the configuration's")
    return trainer, state, (coords, labels, valid), weights, out_dir


def step_calls(trainer, store, cfg: dict, seed: int, device):
    """(draw, step): the window's call, one batch from the sampler (the
    first `batch` cases of a permutation of the store's, so a batch's rows
    all differ) and one step on it; from a generator seeded from `seed`."""
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, "steps"))

    def draw():
        idx = torch.randperm(store[0].shape[0], generator=gen,
                             device=device)[:cfg["batch"]]
        return trainer.batch_fn(gen, idx, True)

    def step():
        return trainer.train_step(*draw())[0]
    return draw, step


def first_steps(trainer, state: dict, n: int, step) -> dict:
    """Run `n` steps by `step()` (-> the loss) and read what the reference
    is compared on: each step's loss, the first step's gradient as Adam got
    it (its first moment after one step / (1 - beta1); zero where the step
    left no state) and each parameter's change over the steps."""
    params = dict(trainer.model.named_parameters())
    b1 = trainer.optimizer.defaults["betas"][0]
    losses, grad1 = [], None
    for t in range(n):
        losses.append(float(step()))
        if t == 0:
            opt = trainer.optimizer.state
            grad1 = {k: (opt[p]["exp_avg"] / (1 - b1)
                         if "exp_avg" in opt.get(p, {}) else
                         torch.zeros_like(p)).detach().clone()
                     for k, p in params.items()}
    change = {k: p.detach() - state[k] for k, p in params.items()}
    return {"loss": losses, "grad1": grad1, "change": change}


def run(ctx) -> Outcome:
    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    cuda = device.type == "cuda"
    trainer, state, store, weights, out_dir = build(cfg, ctx.seed, device,
                                                    ctx.mark)
    ctx.mark("trainer")
    names = [n for n, _ in trainer.model.named_parameters()]
    draw, step = step_calls(trainer, store, cfg, ctx.seed, device)

    got = first_steps(trainer, state, traffic["first_steps"], step)
    if cuda:
        torch.cuda.synchronize()
    ctx.mark("first steps")
    ctx.setup_done()

    steps, window, window_losses, _ = train_window(
        trainer, draw, step, ctx.seconds, Tracer(False, cuda))
    run_rec = Run(cfg, traffic, window, steps=steps)
    if ctx.trace:
        tracer = Tracer(True, cuda)
        run_rec.trace_steps, _, traced, sampler = train_window(
            trainer, draw, step, ctx.seconds, tracer)
        run_rec.trace = tracer.summary()
        run_rec.spans["sampler_ms"] = sampler
        window_losses += traced
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())

    # the reference, once the program's state is freed
    del trainer, window_losses
    shutil.rmtree(out_dir, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    readings = reference_readings(cfg, traffic, ctx.seed, state, store,
                                  weights, names, device)
    numbers = ref.compare(got, readings, names)
    checks = [Check(k, numbers[k], LIMITS[k]) for k in LIMITS]
    values = {"train_clouds_per_s": cfg["batch"] * steps / window}
    return Outcome(steps + run_rec.trace_steps, failed, values, checks,
                   run_rec, peak)


def train_window(trainer, draw, step, seconds: float, tracer) -> tuple:
    """Steps until `seconds` have passed on the host clock, ending in a
    sync: (steps, the window's seconds, the losses, and under the profiler
    the sampler's device ms a step, from CUDA events around each call)."""
    cuda = trainer.device.type == "cuda"
    timed = tracer.on and cuda
    losses, sampler = [], []
    tracer.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if timed:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            x, y = draw()
            ev[1].record()
            sampler.append(ev)
            losses.append(trainer.train_step(x, y)[0])
        else:
            losses.append(step())
    if cuda:
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    tracer.stop()
    return (len(losses), window, losses,
            [a.elapsed_time(b) for a, b in sampler])


def reference_readings(cfg, traffic, seed, state, store, weights, names,
                       device, quant=None) -> dict:
    """The reference's first steps from the same inputs (`quant`: the
    precision of the control)."""
    with tf32(False):
        gen = torch.Generator(device=device).manual_seed(
            derive_seed(seed, "steps"))
        batches = [ref.draw_batch(gen, store, cfg)
                   for _ in range(traffic["first_steps"])]
        return ref.train_steps(state, names, batches, weights, cfg, quant)
