"""Train and test point segmentation (DGCNN, PointNet or PointTransformer)
with cross-validation (counterpart of train_point_seg.py).

    python -m fissure_segmentation_tpu_torch.train_point_seg \\
        --ds synthetic --fold 0 --epochs 3 --pts 2048 --k 40 --output OUT
    python -m fissure_segmentation_tpu_torch.train_point_seg --output OUT \\
        --test_only | --speed | --copd
    python -m fissure_segmentation_tpu_torch.train_point_seg \\
        --model PointTransformer --ds synthetic --pts 2048 --batch 32 \\
        --epochs 3 --fold 0 --output results/torch_pt_run

The flags are the JAX entry's (the port's copy in `cli/`). The default run
trains each fold (`model.pt`, history.csv, train_time.csv) and then tests
it (`train/evaluation.py:test_pipeline` on the fold's validation cases:
fold*/test/test_results.csv, dice_ and assd_per_instance.csv,
inference_time.csv and the per-case artifacts, then cv_results.csv).
`--train_only` skips the test, `--test_only` the training; `--speed` times
10 ensembles of case 0 with fold 0's model (inference_time.csv in the
output directory); `--copd` tests the trained folds on the COPD cohort
(the synthetic one: 6 cases, seed 777, ids COPD00...) and forces
test_only. The three test modes take the trained run's arguments from its
commandline_args.json. Everything runs on CUDA card `--gpu`; without a
card it raises, unless the caller of `run` or `main` passes
``device="cpu"`` (as the tests do).

DGCNN builds its graphs dynamically (the JAX default; `--static`: one
coordinate graph shared by the three EdgeConvs). `--amp true` (the CLI
default) trains DGCNN and PointNet with the bf16 compute dtype
(`DGCNNSeg(dtype=torch.bfloat16)`, `PointNetSeg(dtype=torch.bfloat16)`:
float32 parameters, Adam and loss, bf16 products; PointNet's T-Nets and
logits head stay float32), as the JAX entry does; `--amp false` trains
them in float32. `--transformer` turns on DGCNN's spatial transformer or
PointNet's input T-Net, `--img_feat_extractor` DGCNN's image-feature stem.
PointTransformer trains in float32 whatever `--amp` says (as in the JAX
package, which keeps it out of bf16), and `--k`, `--static`,
`--transformer`, `--img_feat_extractor` and `--knn_recall` do not apply to
it; PointNet takes neither `--k` nor `--static`. `--knn_recall R` builds
DGCNN's graphs approximately at recall target R
(`DGCNNSeg(knn_recall=R)`, ops/knn.py).

`--dp` trains each fold data-parallel, as the JAX entry does over every
local device: one NCCL rank a visible card (parallel/mesh.py:spawn), each
rank training on its share of every batch with the global batch's loss
and BatchNorm statistics (train/trainer.py, `group=`); the batch size must
divide by the number of cards. With one card it trains as without `--dp`.
`run(args, device="cpu", world_size=n)` trains over n gloo ranks on the CPU
(the tests). The test half and `--speed` run once, in the calling process,
after the ranks have written the fold. `--visualize N` draws the first
validation cloud's labels and prediction every N epochs
(fold*/visualizations/epoch{E}.png, utils/visualization.py; rank 0 only
under `--dp`, and only where matplotlib imports). The op_count.csv
artifact is not written. The test
modes read each fold's `model.pt`, or the JAX package's `model.fst` where
only that exists (`models/weights.py:load_fold_model`).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .cli import (get_point_segmentation_parser, load_args_for_testing,
                  store_args)
from .data.dataset import PointDataset, create_split, load_split_file
from .data.synthetic import make_synthetic_dataset
from .losses import get_loss_fn
from .models import (ensemble_predict, get_point_seg_model_class,
                     load_fold_model)
from .parallel.mesh import spawn
from .train import evaluation
from .train.cross_val import cross_val_training
from .train.trainer import ModelTrainer, TrainConfig
from .utils.visualization import point_seg_visualization


def build_dataset(args) -> PointDataset:
    copd = bool(args.copd)
    kwargs = dict(sample_points=args.pts, exclude_rhf=args.exclude_rhf,
                  lobes=args.data == "lobes", binary=args.binary, copd=copd)
    if args.ds == "synthetic" or args.data_dir is None:
        if copd:
            # a cohort of its own stands in for the COPD transfer-validation
            # data: the validation set of every fold
            cases = make_synthetic_dataset(6, n_points=8000, gt_surfaces=True,
                                           seed=777)
            for i, c in enumerate(cases):
                c["case_id"] = f"COPD{i:02d}"
            return PointDataset(cases, **kwargs)
        cases = make_synthetic_dataset(20, n_points=8000, gt_surfaces=True)
        return PointDataset(cases, **kwargs)
    return PointDataset.from_folder(args.data_dir, **kwargs)


def build_model(args, ds: PointDataset, generator: torch.Generator):
    """The JAX build_model's arguments (train_point_seg.py:70-87): DGCNN and
    PointNet in bf16 under --amp, PointTransformer in float32."""
    cls = get_point_seg_model_class(args.model)
    kwargs = dict(in_features=ds.n_features, num_classes=ds.num_classes,
                  generator=generator)
    if args.amp and args.model != "PointTransformer":
        kwargs.update(dtype=torch.bfloat16)
    if args.model == "DGCNN":
        kwargs.update(k=args.k, spatial_transformer=args.transformer,
                      dynamic=not args.static,
                      image_feat_module=args.img_feat_extractor,
                      knn_recall=args.knn_recall)
    elif args.model == "PointNet":
        kwargs.update(spatial_transform=args.transformer)
    return cls(**kwargs)


def default_device(args) -> torch.device:
    """CUDA card `--gpu`; raises without a card (the CPU only when a caller
    passes device="cpu")."""
    if not torch.cuda.is_available():
        raise RuntimeError("train_point_seg: no CUDA card found; pass "
                           "device='cpu' to run() or main() to train on "
                           "the CPU")
    return torch.device("cuda", args.gpu)


def speed_test(ds: PointDataset, model, out_dir: str, sample_points: int,
               device, n_runs_min: int = 50, repeats: int = 10) -> list:
    """Inference timing: `repeats` ensembles of case 0's full cloud after a
    warm-up, each ending in a sync (the subset draw is timed, as in the JAX
    entry, where it runs on the device); inference_time.csv in `out_dir`.
    Returns the times in seconds."""
    x, _ = ds.get_full_pointcloud(0)
    pc = torch.as_tensor(np.asarray(x, np.float32), device=device)
    gen = torch.Generator().manual_seed(42)

    def once():
        ensemble_predict(model, pc, sample_points, n_runs_min, generator=gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    once()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    evaluation.write_speed_results(out_dir, times)
    print(f"inference: {np.mean(times) * 1e3:.1f} +- "
          f"{np.std(times) * 1e3:.1f} ms")
    return times


def dp_world_size(args, device: torch.device,
                  world_size: int | None = None) -> int:
    """The ranks `--dp` trains over: `world_size` if given, else one a
    visible card (1 on the CPU, and without `--dp`)."""
    if not args.dp:
        return 1
    if world_size is not None:
        return world_size
    return torch.cuda.device_count() if device.type == "cuda" else 1


def make_trainer(args, ds: PointDataset, train_ds, fold_dir: str,
                 cfg: TrainConfig, fold: int, device,
                 group=None) -> ModelTrainer:
    """The fold's trainer: its model from the fold's seed, the loss on
    `device`, the visualization hook under `--visualize`."""
    seed = cfg.seed + fold
    model = build_model(args, ds, torch.Generator().manual_seed(seed))
    class_weights = torch.as_tensor(ds.get_class_weights(), device=device)
    vis = args.visualize
    return ModelTrainer(model, train_ds, get_loss_fn(args.loss, class_weights),
                        fold_dir, TrainConfig(**{**cfg.__dict__, "seed": seed}),
                        device=device,
                        visualization_fn=point_seg_visualization if vis
                        else None,
                        visualize_every=int(vis) if vis else 1, group=group)


def _train_fold_rank(mesh, args, ds, train_ds, fold_dir, cfg, fold) -> None:
    """One `--dp` rank: train the fold over the mesh's group (rank 0
    writes it)."""
    make_trainer(args, ds, train_ds, fold_dir, cfg, fold, mesh.device,
                 mesh.group).run()


def train_fold_dp(args, ds, train_ds, fold_dir: str, cfg: TrainConfig,
                  fold: int, device: torch.device, world_size: int) -> None:
    """Train one fold over `world_size` spawned ranks: NCCL with card i for
    rank i, or gloo on the CPU."""
    if device.type == "cuda":
        if world_size > torch.cuda.device_count():
            raise ValueError(f"--dp: {world_size} ranks for "
                             f"{torch.cuda.device_count()} cards (NCCL takes "
                             "one card a rank)")
        from .kernels import _build
        _build.build()      # once, here, not in every rank at once
        backend, devices = "nccl", [f"cuda:{i}" for i in range(world_size)]
    else:
        backend, devices = "gloo", "cpu"
    # the ranks share this process's intra-op threads
    spawn(_train_fold_rank, world_size, backend, devices,
          args=(args, ds, train_ds, fold_dir, cfg, fold), timeout_s=900.0,
          threads=max(1, torch.get_num_threads() // world_size))


def run(args, device=None, world_size: int | None = None) -> dict:
    """Train and/or test the folds `args` asks for; returns {fold: trained
    model} (the best snapshot, the one written as model.pt).
    `world_size`: the ranks `--dp` trains over (default: the visible
    cards)."""
    device = default_device(args) if device is None else torch.device(device)
    os.makedirs(args.output, exist_ok=True)
    if args.test_only or args.copd or args.speed:
        # the trained run's arguments, with the test-time overrides
        args = load_args_for_testing(args.output, args)
    else:
        store_args(args, args.output)
    if args.copd:
        print("Validating with COPD dataset")
        args.test_only = True
        args.speed = False
    ds = build_dataset(args)
    model_cls = get_point_seg_model_class(args.model)

    if args.speed:
        model = load_fold_model(os.path.join(args.output, "fold0"),
                                model_cls).to(device)
        speed_test(ds, model, args.output, args.pts, device)
        return {}

    split = load_split_file(args.split) if args.split else \
        create_split(ds.ids, k=5)
    cfg = TrainConfig(epochs=args.epochs, lr=args.lr, batch_size=args.batch,
                      weight_decay=args.wd, scheduler=args.scheduler)
    n_ranks = dp_world_size(args, device, world_size)

    models = {}

    def train_fn(train_ds, fold_dir, fold):
        if n_ranks > 1:
            train_fold_dp(args, ds, train_ds, fold_dir, cfg, fold, device,
                          n_ranks)
            models[fold] = load_fold_model(fold_dir, model_cls).to(device)
            return
        models[fold] = make_trainer(args, ds, train_ds, fold_dir, cfg, fold,
                                    device).run()

    def test_fn(val_ds, fold_dir, fold):
        model = load_fold_model(fold_dir, model_cls).to(device)
        val_ds.do_augmentation = False
        return evaluation.test_pipeline(
            val_ds, model, os.path.join(fold_dir, "test"),
            sample_points=args.pts, copd=args.copd, device=device)

    cross_val_training(ds, split, args.output, train_fn, test_fn,
                       test_only=args.test_only, train_only=args.train_only,
                       folds=None if args.fold is None else [args.fold],
                       results_suffix="_copd" if args.copd else "")
    return models


def main(argv=None, device=None) -> int:
    args = get_point_segmentation_parser().parse_args(argv)
    run(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
