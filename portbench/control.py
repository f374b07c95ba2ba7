"""Readings that set the limits of `correct`: for each seed, the numbers
compared for the program, for the control (the reference put in the
program's place at the next precision below the configuration's), and
for the program with a fault planted.

    python3 -m portbench.control --workload <name> --seeds 1 2 3 ... [--faults]

Training cells: the program's first steps (no window: set-up's steps
are what is compared) against the reference; the control is the
reference with the products' operands in scaled float8 e4m3 (the
configuration computes in bfloat16); the faults: a step that leaves the
state unchanged, and a step on half the batch (the loss its mean over the
rest). Serving cells: the cases a run of `run_cases` cases would judge
in full (case 0 and a share drawn from the seed), served by the window's
own call, against the reference; the control is the reference's own
answer computed with TF32 on (the configuration computes in float32 with
TF32 off) over all `run_cases` cases, and the reference's point model
with TF32 on in the program's place ("ensemble_tf32", the program's path
otherwise); the faults: one answer's label altered where it is
produced, and the meshes and labelmap shifted by two cells of the
surface grid. Each reading, with whether the harness's checks pass it
(`correct`), is printed as one JSON line; the benchmark's runs never run
this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import time

import numpy as np
import torch

from portbench import common


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with `fault` planted in its timed path."""
    if fault is None:
        yield
        return
    from fissure_segmentation_tpu_torch import serving
    from fissure_segmentation_tpu_torch.train.trainer import ModelTrainer
    if fault == "unchanged":
        orig = ModelTrainer.train_step

        def step(self, x, y, epoch=None):
            self.model.train()
            loss, comps = self._loss(self._forward(x, True), y, 0)
            return loss.detach(), comps
        ModelTrainer.train_step = step
        restore = (ModelTrainer, "train_step", orig)
    elif fault == "half_batch":
        orig = ModelTrainer.train_step

        def step(self, x, y, epoch=None):
            h = x.shape[0] // 2
            return orig(self, x[h:], y[h:], epoch)
        ModelTrainer.train_step = step
        restore = (ModelTrainer, "train_step", orig)
    elif fault == "surface_shifted":
        orig = serving._finish_case

        def finish(fetched, **kw):
            res = orig(fetched, **kw)
            d = fetched.shape[0]
            shift = round(2 * (d - 1) / (fetched.grid_res[0] - 1))
            res.meshes = [(t + np.array([0, 0, shift], t.dtype), v)
                          for t, v in res.meshes]
            if res.labelmap is not None:
                res.labelmap = np.roll(res.labelmap, shift, axis=0)
            return res
        serving._finish_case = finish
        restore = (serving, "_finish_case", orig)
    elif fault == "altered_answer":
        orig = serving._finish_case

        def finish(fetched, **kw):
            res = orig(fetched, **kw)
            if len(res.labels):
                res.labels[0] = (res.labels[0] + 1) % fetched.num_fg_classes
            return res
        serving._finish_case = finish
        restore = (serving, "_finish_case", orig)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        setattr(*restore)


def train_readings(cell, seed: int, device, fault=None,
                   detail: bool = False) -> dict:
    from .loops import train as loop
    from .reference import train as ref
    cfg, traffic = cell.config, cell.traffic
    with planted(fault):
        trainer, state, store, weights, out_dir = loop.build(cfg, seed,
                                                             device)
        names = [n for n, _ in trainer.model.named_parameters()]
        _, step = loop.step_calls(trainer, store, cfg, seed, device)
        got = loop.first_steps(trainer, state, traffic["first_steps"], step)
    del trainer
    shutil.rmtree(out_dir, ignore_errors=True)
    ref_read = loop.reference_readings(cfg, traffic, seed, state, store,
                                       weights, names, device)
    out = {"program" if fault is None else fault:
           _train_numbers(ref, got, ref_read, names, detail)}
    if fault is None:
        for quant in ("float8", "bfloat16"):
            ctl = loop.reference_readings(cfg, traffic, seed, state, store,
                                          weights, names, device, quant)
            out[f"reference_{quant}"] = _train_numbers(ref, ctl, ref_read,
                                                       names, detail)
    return out


def _train_numbers(ref, got, ref_read, names, detail: bool) -> dict:
    """The numbers compared; with `detail` also each step's loss gap and
    each leaf's gaps of the first gradient's norm and of the change's."""
    out = ref.compare(got, ref_read, names)
    if detail:
        out["loss_gaps"] = [abs(a - b) / abs(b) for a, b in
                            zip(got["loss"], ref_read["loss"])]
        for what in ("grad1", "change"):
            out[what] = {k: ref.worst_leaf(got[what], ref_read[what], [k])
                         for k in names}
            out[what + "_norm"] = {k: float(torch.linalg.vector_norm(
                ref_read[what][k])) for k in names}
    return out


class ReferenceNet(torch.nn.Module):
    """The reference's point model with TF32 on, in the program's place."""

    def __init__(self, state: dict, cfg: dict):
        super().__init__()
        self.state, self.cfg = state, cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from .reference import dgcnn
        with common.tf32(True):
            return dgcnn.forward(self.state, x, self.cfg, train=False)


def serve_readings(cell, seed: int, device, fault=None,
                   detail: bool = False) -> dict:
    """The program, the faults and the ensemble control on the cases a run
    of `run_cases` cases judges in full; the control over the keypoints of
    all `run_cases` cases and the labels of those."""
    from .gen.weights import ClassBias
    from .loops import serve as loop
    from .reference import mobilenet_aspp
    from .reference import serving as ref
    config, traffic = cell.config, cell.traffic
    cnn, model, cnn_state, point_state, pool, band_list = loop.build(
        config, seed, device)
    n_cases = traffic["run_cases"]
    idx = [i for i in range(n_cases)
           if loop.sampled(seed, i, traffic["judge_share"])]
    host = [(img.cpu().numpy(), mask.cpu().numpy()) for img, mask, _ in pool]
    kw = loop.serving_kwargs(config, cnn, device)
    models = {"program" if fault is None else fault: model}
    if fault is None:
        pcfg = config["point_model"]
        models["ensemble_tf32"] = ClassBias(
            ReferenceNet(point_state, pcfg), band_list, pcfg["class_bias"])
    answers = {}
    for name, m in models.items():
        with planted(fault), common.tf32(config["tf32"]):
            res = loop.serve_cases(traffic, host, m, seed, idx, kw)
        answers[name] = {i: loop.answer_of(r, True)
                         for i, r in zip(idx, res)}
    del cnn, model, models, res
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {name: loop.judge(seed, config, a, pool, cnn_state, point_state,
                            band_list)
           for name, a in answers.items()}
    del answers
    if fault is None:
        ctl, softs = {}, {}
        with common.tf32(True), torch.no_grad():
            for i in range(n_cases):
                vol, mask, _ = pool[i % len(pool)]
                if i % len(pool) not in softs:
                    softs[i % len(pool)] = mobilenet_aspp.softmax_volume(
                        cnn_state, vol, config)
                kp, lab = ref.answer(cnn_state, point_state, vol, mask,
                                     loop.case_generator(seed, i), config,
                                     band_list, softs[i % len(pool)],
                                     labels=i in idx)
                ctl[i] = (kp, lab, None)
        del softs
        out["control_tf32"] = loop.judge(seed, config, ctl, pool, cnn_state,
                                         point_state, band_list,
                                         labelled=set(idx))
    return out


def readings(cell, seed: int, device, faults: bool,
             detail: bool = False) -> dict:
    kind = cell.traffic["loop"]
    fn = {"train": train_readings, "serve": serve_readings}[kind]
    out = fn(cell, seed, device, None, detail)
    if faults:
        for fault in {"train": ("unchanged", "half_batch"),
                      "serve": ("altered_answer", "surface_shifted")}[kind]:
            out.update(fn(cell, seed, device, fault, detail))
    limits = common.loop_module(cell.traffic).LIMITS
    for numbers in out.values():
        numbers["correct"] = all(numbers[k] <= v for k, v in limits.items()
                                 if k in numbers)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--detail", action="store_true",
                    help="each step's and each leaf's readings too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs an NVIDIA card", file=sys.stderr)
        return 1
    cell = common.resolve(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, torch.device("cuda"), args.faults,
                       args.detail)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
