"""Train point segmentation (DGCNN or PointTransformer) with
cross-validation (counterpart of the training half of
train_point_seg.py:34-190).

    python -m fissure_segmentation_tpu_torch.train_point_seg \\
        --ds synthetic --pts 2048 --k 40 --static --batch 32 --amp false \\
        --epochs 3 --fold 0 --train_only --output results/torch_run
    python -m fissure_segmentation_tpu_torch.train_point_seg \\
        --model PointTransformer --ds synthetic --pts 2048 --batch 32 \\
        --epochs 3 --fold 0 --train_only --output results/torch_pt_run

The flags are the JAX entry's (the port's copy in `cli/`). Training runs on
CUDA card `--gpu`; without a card it raises, unless the caller of `run` or
`main` passes ``device="cpu"`` (as the tests do). Each fold writes
`model.pt` (models/weights.py:save_model), history.csv and train_time.csv.

PointTransformer trains in float32 whatever `--amp` says (as in the JAX
package, which keeps it out of bf16), and `--k`, `--static`,
`--transformer`, `--img_feat_extractor` and `--knn_recall` do not apply to
it. Not ported yet, each raising NotImplementedError: for DGCNN `--amp
true` (the CLI default, bf16), the dynamic graph (every run without
`--static`), `--transformer`, `--img_feat_extractor`, `--knn_recall`; for
every model `--dp`, `--visualize`, `--speed`, `--copd`, PointNet, and
testing — every run without `--train_only` (train/evaluation.py:
test_pipeline, metrics.py). The op_count.csv artifact is not written.
"""
from __future__ import annotations

import os
import sys

import torch

from .cli import get_point_segmentation_parser, store_args
from .data.dataset import (PointDataset, create_split, load_split_file)
from .data.synthetic import make_synthetic_dataset
from .losses import get_loss_fn
from .models import get_point_seg_model_class
from .train.cross_val import cross_val_training
from .train.trainer import ModelTrainer, TrainConfig


def check_supported(args) -> None:
    """Raise NotImplementedError for every option this port does not take."""
    dgcnn = args.model == "DGCNN"
    unported = {
        "--amp true (bf16; pass --amp false)": dgcnn and args.amp,
        "the dynamic graph (pass --static)": dgcnn and not args.static,
        "--transformer": dgcnn and args.transformer,
        "--img_feat_extractor": dgcnn and args.img_feat_extractor,
        "--knn_recall": dgcnn and args.knn_recall is not None,
        "--dp": args.dp,
        "--visualize": args.visualize is not None,
        "--speed": args.speed,
        "--copd": args.copd,
        "--test_only": args.test_only,
        "testing (pass --train_only)": not args.train_only,
        f"--model {args.model}": args.model not in ("DGCNN",
                                                    "PointTransformer"),
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
    """The JAX build_model's arguments (train_point_seg.py:70-87), float32."""
    cls = get_point_seg_model_class(args.model)
    kwargs = dict(in_features=ds.n_features, num_classes=ds.num_classes,
                  generator=generator)
    if args.model == "DGCNN":
        kwargs.update(k=args.k)
    return cls(**kwargs)


def default_device(args) -> torch.device:
    """CUDA card `--gpu`; raises without a card (the CPU only when a caller
    passes device="cpu")."""
    if not torch.cuda.is_available():
        raise RuntimeError("train_point_seg: no CUDA card found; pass "
                           "device='cpu' to run() or main() to train on "
                           "the CPU")
    return torch.device("cuda", args.gpu)


def run(args, device=None) -> dict:
    """Train the folds `args` asks for; returns {fold: trained model} (the
    best snapshot, the one written as model.pt)."""
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

    models = {}

    def train_fn(train_ds, fold_dir, fold):
        seed = cfg.seed + fold
        model = build_model(args, ds, torch.Generator().manual_seed(seed))
        trainer = ModelTrainer(model, train_ds, loss_fn, fold_dir,
                               TrainConfig(**{**cfg.__dict__, "seed": seed}),
                               device=device)
        models[fold] = trainer.run()

    cross_val_training(ds, split, args.output, train_fn, None,
                       train_only=True,
                       folds=None if args.fold is None else [args.fold])
    return models


def main(argv=None, device=None) -> int:
    args = get_point_segmentation_parser().parse_args(argv)
    run(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
