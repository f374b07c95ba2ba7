"""The canonical train steps on one NVIDIA card: timing harness and
profile.

    python -m fissure_segmentation_tpu_torch.train.profile_step [--model DGCNN|PointTransformer] [--amp]

The step is DGCNNSeg(k=40, static) or PointTransformerSeg at its full
width, batch 32 x 2048 points of the synthetic point cases, f32 (DGCNN with
`--amp`: the bf16 compute dtype), NNU loss + Adam with L2
(`canonical_data`, `make_step`); `time_steps` times warm steps with the
host clock around a sync. chip_smoke.py phases 7, 11 and 17 time them
through these helpers. Run as a script it prints, for DGCNN in each routing
(FSEG_FUSED_EDGE=0 and 1), for PointTransformer once:
  * ms/step (`time_steps` over 10 warm steps);
  * a torch.profiler table of 3 warm steps (device time per kernel) and the
    summed kernel time per step against the timed ms/step (the device's
    busy share);
  * the device time per step of the port's kernels (K1-K4 and the fused
    EdgeConv's gather-reduce for DGCNN, K5 for PointTransformer) and of the
    sorts (DGCNN: the transposed graph
    that K2 and K3 build and the batch sampler's; PointTransformer: the
    stable sorts of `knn_query` and the batch sampler's).
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from ..data.dataset import PointDataset
from ..data.synthetic import make_synthetic_dataset
from ..losses import get_loss_fn
from ..models import DGCNNSeg, PointTransformerSeg
from .trainer import ModelTrainer, TrainConfig

KERNELS = {
    "DGCNN": {"K1 knn": "knn_kernel",
              "K2 scatter_rows": "scatter_rows_kernel",
              "K3 scatter_routed": "scatter_routed_kernel",
              "K4 scatter_count": "count_kernel",
              "gather_reduce": "gather_reduce_kernel"},
    "PointTransformer": {"K5 fps": "fps_kernel"}}
STEPS, BATCH, WARM = 10, 32, 2


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def canonical_data(device="cuda"):
    """Four synthetic point cases of 8000 points, 2048-point subsets, and
    the NNU loss with their class weights -> (dataset, loss_fn)."""
    ds = PointDataset(make_synthetic_dataset(4, n_points=8000),
                      sample_points=2048)
    loss_fn = get_loss_fn("nnunet", torch.as_tensor(ds.get_class_weights(),
                                                    device=device))
    return ds, loss_fn


def make_step(ds, loss_fn, out_dir: str, device="cuda", batch: int = BATCH,
              model: str = "DGCNN", dtype: torch.dtype | None = None):
    """A fresh DGCNNSeg(k=40, static, `dtype`) or PointTransformerSeg (full
    width, f32) from seed 0 and its trainer; returns step() -> (loss,
    components), one Adam step on a newly sampled batch. DGCNN's EdgeConv
    routing is FSEG_FUSED_EDGE's at each call."""
    gen0 = torch.Generator().manual_seed(0)
    if model == "DGCNN":
        net = DGCNNSeg(k=40, in_features=ds.n_features,
                       num_classes=ds.num_classes, generator=gen0,
                       dtype=dtype)
    elif model == "PointTransformer":
        net = PointTransformerSeg(in_features=ds.n_features,
                                  num_classes=ds.num_classes, generator=gen0)
    else:
        raise ValueError(f"make_step: unknown model {model!r}")
    trainer = ModelTrainer(net, ds, loss_fn, out_dir,
                           TrainConfig(batch_size=batch), device=device)
    gen = torch.Generator(device=device).manual_seed(1)

    def step():
        idx = torch.randint(0, len(ds), (batch,), generator=gen,
                            device=device)
        return trainer.train_step(*trainer.batch_fn(gen, idx, True))
    return step


def time_steps(step, steps: int = STEPS):
    """Host clock around `steps` back-to-back steps ending in a sync (warm
    the step up first). Returns (ms per step, peak device bytes over the
    steps, the losses)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step()[0] for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    return ms, torch.cuda.max_memory_allocated(), losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="DGCNN",
                    choices=sorted(KERNELS))
    ap.add_argument("--amp", action="store_true",
                    help="DGCNN in the bf16 compute dtype (--amp true)")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.amp and args.model == "DGCNN" else None
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    ds, loss_fn = canonical_data()
    tmp = tempfile.mkdtemp()
    routings = ("0", "1") if args.model == "DGCNN" else (None,)
    for fused in routings:
        if fused is None:
            name = args.model
        else:
            os.environ["FSEG_FUSED_EDGE"] = fused
            name = "fused" if fused == "1" else "unfused"
            if dtype is not None:
                name += " bf16"
        step = make_step(ds, loss_fn, tmp, model=args.model, dtype=dtype)
        for _ in range(WARM):
            step()
        ms, _, _ = time_steps(step)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
        avg = prof.key_averages()
        busy = sum(e.self_device_time_total for e in avg
                   if e.device_type == DeviceType.CUDA) / 3 / 1e3
        print(f"{name}: {ms:.2f} ms/step ({BATCH * 1e3 / ms:.1f} "
              f"clouds/s); kernels {busy:.2f} ms/step, busy share "
              f"{busy / ms:.3f} on {card}", flush=True)
        for label, key in KERNELS[args.model].items():
            t = sum(e.self_device_time_total for e in avg
                    if e.device_type == DeviceType.CUDA and key in e.key)
            print(f"  {label:18s} {t / 3 / 1e3:.3f} ms/step", flush=True)
        sort = sum(e.self_device_time_total for e in avg
                   if e.device_type == DeviceType.CUDA
                   and "sort" in e.key.lower())
        print(f"  {'sorts':18s} {sort / 3 / 1e3:.3f} ms/step (every kernel "
              "named *sort*, searchsorted included)", flush=True)
        print(avg.table(sort_by="self_device_time_total", row_limit=22,
                        max_name_column_width=60), flush=True)
    os.environ.pop("FSEG_FUSED_EDGE", None)
    shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
