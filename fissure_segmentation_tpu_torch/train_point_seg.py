"""Train DGCNN point segmentation with cross-validation (counterpart of the
training half of train_point_seg.py:34-190).

    python -m fissure_segmentation_tpu_torch.train_point_seg \\
        --ds synthetic --pts 2048 --k 40 --static --batch 32 --amp false \\
        --epochs 3 --fold 0 --train_only --output results/torch_run

The flags are the JAX entry's (`fissure_segmentation_tpu.cli`, which imports
no jax). Training runs on the first CUDA card if there is one (`--gpu`
picks it), else on the CPU. Each fold writes `model.pt`
(models/weights.py:save_model), history.csv and train_time.csv.

Not ported yet, each raising NotImplementedError: `--amp true` (the CLI
default, bf16), the dynamic graph (every run without `--static`),
`--transformer`, `--img_feat_extractor`, `--knn_recall`, `--dp`,
`--visualize`, `--speed`, `--copd`, models other than DGCNN, and testing —
every run without `--train_only` (train/evaluation.py:test_pipeline,
metrics.py). The op_count.csv artifact is not written.
"""
from __future__ import annotations

import os
import sys

import torch

from fissure_segmentation_tpu.cli import (get_point_segmentation_parser,
                                          store_args)

from .data.dataset import (PointDataset, create_split, load_split_file)
from .data.synthetic import make_synthetic_dataset
from .losses import get_loss_fn
from .models import DGCNNSeg
from .train.cross_val import cross_val_training
from .train.trainer import ModelTrainer, TrainConfig


def check_supported(args) -> None:
    """Raise NotImplementedError for every option this port does not take."""
    unported = {
        "--amp true (bf16; pass --amp false)": args.amp,
        "the dynamic graph (pass --static)": not args.static,
        "--transformer": args.transformer,
        "--img_feat_extractor": args.img_feat_extractor,
        "--knn_recall": args.knn_recall is not None,
        "--dp": args.dp,
        "--visualize": args.visualize is not None,
        "--speed": args.speed,
        "--copd": args.copd,
        "--test_only": args.test_only,
        "testing (pass --train_only)": not args.train_only,
        f"--model {args.model}": args.model != "DGCNN",
    }
    for what, on in unported.items():
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


def build_dataset(args) -> PointDataset:
    kwargs = dict(sample_points=args.pts, exclude_rhf=args.exclude_rhf,
                  lobes=args.data == "lobes", binary=args.binary)
    if args.ds == "synthetic" or args.data_dir is None:
        cases = make_synthetic_dataset(20, n_points=8000, gt_surfaces=True)
        return PointDataset(cases, **kwargs)
    return PointDataset.from_folder(args.data_dir, **kwargs)


def build_model(args, ds: PointDataset, generator: torch.Generator):
    return DGCNNSeg(k=args.k, in_features=ds.n_features,
                    num_classes=ds.num_classes, generator=generator)


def default_device(args) -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", args.gpu)
    return torch.device("cpu")


def run(args, device=None):
    check_supported(args)
    device = default_device(args) if device is None else torch.device(device)
    os.makedirs(args.output, exist_ok=True)
    store_args(args, args.output)
    ds = build_dataset(args)
    class_weights = torch.as_tensor(ds.get_class_weights(), device=device)
    loss_fn = get_loss_fn(args.loss, class_weights)
    split = load_split_file(args.split) if args.split else \
        create_split(ds.ids, k=5)
    cfg = TrainConfig(epochs=args.epochs, lr=args.lr, batch_size=args.batch,
                      weight_decay=args.wd, scheduler=args.scheduler)

    def train_fn(train_ds, fold_dir, fold):
        seed = cfg.seed + fold
        model = build_model(args, ds, torch.Generator().manual_seed(seed))
        trainer = ModelTrainer(model, train_ds, loss_fn, fold_dir,
                               TrainConfig(**{**cfg.__dict__, "seed": seed}),
                               device=device)
        trainer.run()

    return cross_val_training(
        ds, split, args.output, train_fn, None, train_only=True,
        folds=None if args.fold is None else [args.fold])


def main(argv=None) -> int:
    args = get_point_segmentation_parser().parse_args(argv)
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
