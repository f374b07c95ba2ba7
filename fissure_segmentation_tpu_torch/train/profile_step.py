"""The canonical train steps on one NVIDIA card: timing harness and
profile.

    python -m fissure_segmentation_tpu_torch.train.profile_step [--model DGCNN|PointTransformer|PCAE|CNN|CNNv3|DPSR|DPSRv1|DGSSM] [--amp] [--dynamic] [--knn_recall R]

The step is DGCNNSeg(k=40, static; `--dynamic`: the dynamic graph, the
default run's; `--knn_recall`: its approximate graphs, whose device time
it also prints) or PointTransformerSeg at its full width, batch 32 x 2048
points of the synthetic point cases, f32 (DGCNN with `--amp`: the bf16
compute dtype), NNU loss + Adam with L2
(`canonical_data`, `make_step`); `--model PCAE` is the PC-AE's step at
the JAX entry's defaults with `--mesh` (train_pc_ae.make_step: 32 x 1024
points of the synthetic meshes, k = 20, latent 512, f32, dynamic graph,
the regularized mesh loss); `--model CNN` / `CNNv3` is train_seg_cnn's
step at its defaults (MobileNetASPP / LR-ASPP, 32 patches of 96^3 at 1.5
mm, nnunet, f32; train_seg_cnn.make_step), whose device time
`cnn_device_time` also sums by kind (K6, its wgrad, cuDNN's convolutions,
the matrix products, the rest); `--model DPSR` / `DPSRv1` is
train_dpsr_net's step at the JAX entry's defaults (32 x 1024 points, DGCNN
k = 20 dynamic, 128^3, v2 / v1, the Chamfer term on;
train_dpsr_net.make_step), `--model DGSSM` train_dgcnn_ssm's with
--predict_affine (32 x 1024, k = 20 dynamic, every head;
train_dgcnn_ssm.make_step); `time_steps` times warm steps with the
host clock around a sync. chip_smoke.py phases 7, 11 and 17 time them
through these helpers. Run as a script it prints, for DGCNN in each routing
(FSEG_FUSED_EDGE=0 and 1), for PointTransformer once:
  * ms/step (`time_steps` over 10 warm steps);
  * a torch.profiler table of 3 warm steps (device time per kernel) and the
    summed kernel time per step against the timed ms/step (the device's
    busy share);
  * the device time per step of the port's kernels (K1-K4, the graph
    transpose's four kernels, the fused EdgeConv's gather-reduce and the
    approximate top-k's row selection for DGCNN, K5 for PointTransformer)
    and of the sorts (DGCNN: the batch sampler's, the graph transpose being
    a kernel of its own; PointTransformer: the stable sorts of `knn_query`
    and the batch sampler's); with `--dynamic`, the device time of the two feature-space
    graphs (`ops/knn.py:feature_knn`'s "feature_graph" range: the matmul,
    the elementwise passes and the fused row selection,
    `kernels/approx_topk.py:select_rows`).
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
from ..models import DGCNNSeg, PointNetSeg, PointTransformerSeg
from ..utils.profiling import device_rows
from .trainer import ModelTrainer, TrainConfig

KERNELS = {
    "DGCNN": {"K1 knn": "knn_kernel",
              "graph transpose": "transpose_",
              "K2 scatter_rows": "scatter_rows_kernel",
              "K3 scatter_routed": "scatter_routed_",
              "K4 scatter_count": "count_",
              "gather_reduce": "gather_reduce_",
              "select_rows": "select_rows"},
    "PointTransformer": {"K5 fps": "fps_kernel"},
    "PCAE": {"K1 knn": "knn_kernel",
             "graph transpose": "transpose_",
             "K2 scatter_rows": "scatter_rows_kernel",
             "select_rows": "select_rows"},
    "CNN": {"K6 forward (strides 1 and 2), recompute, dgrad":
            "depthwise_tiled",
            "K6 wgrad": "depthwise_wgrad"}}
KERNELS["CNNv3"] = KERNELS["CNN"]
KERNELS["DPSR"] = KERNELS["DPSRv1"] = KERNELS["DGCNN"]
KERNELS["DGSSM"] = KERNELS["PCAE"]


def cnn_device_time(avg, steps: int) -> dict:
    """Device ms a step of a CNN step's profile (`key_averages()` over
    `steps` steps) by kind of kernel: K6 (the forward at strides 1 and 2,
    the checkpoints' recomputation and the dgrad, one kernel), K6's wgrad
    (both passes, both strides), cuDNN's convolutions (the dense, the
    dilated and the 5x5x5 grouped ones, forward and backward), the matrix
    products (the 1x1x1 convolutions), and every other kernel (BatchNorm,
    activations, resizes, the stride-2 dgrad's stuffing, the loss, Adam);
    "total" is their sum."""
    kinds = {"k6": 0.0, "k6_wgrad": 0.0, "cudnn_conv": 0.0, "matmul": 0.0,
             "other": 0.0}
    for e in device_rows(avg):
        key = e.key.lower()
        if "depthwise_tiled" in key or "depthwise_simple" in key:
            kind = "k6"
        elif "depthwise_wgrad" in key:
            kind = "k6_wgrad"
        elif "conv" in key or "cudnn" in key or "implicit" in key:
            kind = "cudnn_conv"
        elif "gemm" in key or "xmma" in key or "cutlass" in key:
            kind = "matmul"
        else:
            kind = "other"
        kinds[kind] += e.self_device_time_total / steps / 1e3
    kinds["total"] = sum(kinds.values())
    return kinds
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
              model: str = "DGCNN", dtype: torch.dtype | None = None,
              dynamic: bool = False, **options):
    """A fresh DGCNNSeg(k=40, `dynamic`, `dtype`), PointNetSeg(`dtype`) or
    PointTransformerSeg (full width, f32) from seed 0 and its trainer, with
    the model's other `options` (DGCNN's `spatial_transformer` and
    `image_feat_module`, PointNet's T-Nets); returns step() -> (loss,
    components), one Adam step on a newly sampled batch. DGCNN's EdgeConv
    routing is FSEG_FUSED_EDGE's at each call."""
    gen0 = torch.Generator().manual_seed(0)
    if model == "DGCNN":
        net = DGCNNSeg(k=40, in_features=ds.n_features,
                       num_classes=ds.num_classes, generator=gen0,
                       dtype=dtype, dynamic=dynamic, **options)
    elif model == "PointNet":
        net = PointNetSeg(in_features=ds.n_features,
                          num_classes=ds.num_classes, generator=gen0,
                          dtype=dtype, **options)
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
    ap.add_argument("--dynamic", action="store_true",
                    help="DGCNN with the dynamic graph (the default run's)")
    ap.add_argument("--knn_recall", type=float, default=None,
                    help="DGCNN's approximate graphs at this recall "
                         "(train_point_seg --knn_recall)")
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
    if args.model == "PCAE":
        from .. import train_pc_ae
        from ..cli import get_pc_ae_train_parser
        pc_args = get_pc_ae_train_parser().parse_args(["--ds", "synthetic",
                                                       "--mesh"])
    elif args.model.startswith("CNN"):
        from .. import train_seg_cnn
        from ..cli import get_seg_cnn_train_parser
        cnn_args = get_seg_cnn_train_parser().parse_args(
            ["--ds", "synthetic", "--model",
             "v3" if args.model == "CNNv3" else "v1"])
    elif args.model.startswith("DPSR"):
        from .. import train_dpsr_net
        from ..cli import get_dpsr_train_parser
        fam_args = get_dpsr_train_parser().parse_args(
            ["--ds", "synthetic", "--dpsr_version",
             "1" if args.model == "DPSRv1" else "2"])
    elif args.model == "DGSSM":
        from .. import train_dgcnn_ssm
        from ..cli import get_dgcnn_ssm_train_parser
        fam_args = get_dgcnn_ssm_train_parser().parse_args(
            ["--ds", "synthetic", "--predict_affine"])
    else:
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
            if args.dynamic:
                name += " dynamic"
            if args.knn_recall is not None:
                name += f" knn_recall {args.knn_recall}"
        if args.model == "PCAE":
            step = train_pc_ae.make_step(pc_args, tmp)
        elif args.model.startswith("CNN"):
            step = train_seg_cnn.make_step(cnn_args, tmp)
        elif args.model.startswith("DPSR"):
            step = train_dpsr_net.make_step(fam_args, tmp)
        elif args.model == "DGSSM":
            step = train_dgcnn_ssm.make_step(fam_args, tmp)
        else:
            recall = ({} if args.knn_recall is None
                      else {"knn_recall": args.knn_recall})
            step = make_step(ds, loss_fn, tmp, model=args.model, dtype=dtype,
                             dynamic=args.dynamic, **recall)
        for _ in range(WARM):
            step()
        ms, _, _ = time_steps(step)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
        avg = prof.key_averages()
        # the spans' ranges ("feature_graph", "approx_graph", DPSR-Net's
        # "dpsr:*", the train step's) carry their kernels' time again
        busy = sum(e.self_device_time_total
                   for e in device_rows(avg)) / 3 / 1e3
        unit = "patches" if args.model.startswith("CNN") else "clouds"
        print(f"{name}: {ms:.2f} ms/step ({BATCH * 1e3 / ms:.1f} "
              f"{unit}/s); kernels {busy:.2f} ms/step, busy share "
              f"{busy / ms:.3f} on {card}", flush=True)
        if args.model.startswith("CNN"):
            print(f"  by kind, ms/step: {cnn_device_time(avg, 3)}",
                  flush=True)
        for e in avg:
            if e.key.startswith("dpsr:") and \
                    e.device_type == DeviceType.CUDA:
                print(f"  {e.key:22s} {e.self_device_time_total / 3 / 1e3:.3f}"
                      " ms/step (device time under the forward's range)",
                      flush=True)
        for label, key in KERNELS[args.model].items():
            t = sum(e.self_device_time_total for e in device_rows(avg)
                    if key in e.key)
            print(f"  {label:18s} {t / 3 / 1e3:.3f} ms/step", flush=True)
        sort = sum(e.self_device_time_total for e in device_rows(avg)
                   if "sort" in e.key.lower())
        print(f"  {'sorts':18s} {sort / 3 / 1e3:.3f} ms/step (every kernel "
              "named *sort*, searchsorted included)", flush=True)
        if args.dynamic or args.model in ("PCAE", "DPSR", "DPSRv1",
                                          "DGSSM"):
            graph = sum(e.self_device_time_total for e in avg
                        if e.key == "feature_graph")
            print(f"  {'feature graphs':18s} {graph / 3 / 1e3:.3f} ms/step "
                  "(device time under ops/knn.py:feature_knn)", flush=True)
        if args.knn_recall is not None:
            graph = sum(e.self_device_time_total for e in avg
                        if e.key == "approx_graph")
            print(f"  {'approximate graphs':18s} {graph / 3 / 1e3:.3f} "
                  "ms/step (device time under ops/knn.py:approx_knn)",
                  flush=True)
        print(avg.table(sort_by="self_device_time_total", row_limit=22,
                        max_name_column_width=60), flush=True)
    os.environ.pop("FSEG_FUSED_EDGE", None)
    shutil.rmtree(tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
