"""Train and test the 3-D segmentation CNNs (MobileNetASPP "v1", LR-ASPP
"v3") with cross-validation (counterpart of train_seg_cnn.py).

    python -m fissure_segmentation_tpu_torch.train_seg_cnn --ds synthetic \\
        --fold 0 --epochs 2 --output OUT [--model v3]
    python -m fissure_segmentation_tpu_torch.train_seg_cnn --output OUT \\
        --test_only --fold 0

The flags are the JAX entry's (the port's copy in `cli/`): `--model v1`,
`--patch_size 96`, `--spacing 1.5`, batch 32, the nnunet loss, Adam with
`--wd 1e-5`, the plateau or cosine scheduler. The dataset is 8 synthetic
64^3 cases or `--data_dir`'s NIfTI folder (data/image_dataset.py),
resampled to `--spacing`. Each fold trains (`train/image_trainer.py`:
fold*/train_time.csv and fold*/model.fst) and is then tested: sliding-
window inference over each validation case (`predict_all_patches`, 50 %
overlap, Gaussian blending), the argmax's Dice per class
(fold*/test/test_dice.csv), then cv_results.csv over the folds; the run
writes op_count.csv (utils/profiling.py, one full patch),
cross_val_split.json and commandline_args.json, the JAX entry's files and
layouts. The CNN trains in float32 (as the JAX entry does, whatever
`--amp` says). `--test_only` reads each fold's model (model.pt or
model.fst, of either package). `--offline` re-runs the command detached.
Everything runs on CUDA card `--gpu`; without a card it raises, unless the
caller of `run` or `main` passes ``device="cpu"`` (as the tests do).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .cli import get_seg_cnn_train_parser, load_args_for_testing, store_args
from .data.dataset import create_split, load_split_file, save_split_file
from .data.image_dataset import ImageDataset
from .data.synthetic import make_synthetic_image_case
from .losses import get_loss_fn
from .metrics import batch_dice
from .models import get_seg_cnn_model_class, predict_all_patches
from .models.weights import load_fold_model
from .train.image_trainer import ImageTrainer
from .train.trainer import TrainConfig
from .utils.detached_run import maybe_run_detached_cli
from .utils.profiling import param_and_op_count


def default_device(args) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("train_seg_cnn: no CUDA card found; pass "
                           "device='cpu' to run() or main() to run on the "
                           "CPU")
    return torch.device("cuda", args.gpu)


def build_dataset(args) -> ImageDataset:
    ps = (args.patch_size,) * 3
    if args.ds == "synthetic" or getattr(args, "data_dir", None) is None:
        cases = [make_synthetic_image_case(i, shape=(64, 64, 64))
                 for i in range(8)]
        return ImageDataset([c["image"] for c in cases],
                            [c["labels"] for c in cases],
                            [(c["case_id"], c["sequence"]) for c in cases],
                            resample_spacing=args.spacing, patch_size=ps,
                            exclude_rhf=args.exclude_rhf, binary=args.binary)
    return ImageDataset.from_folder(args.data_dir, copd=args.copd,
                                    resample_spacing=args.spacing,
                                    patch_size=ps, exclude_rhf=args.exclude_rhf,
                                    binary=args.binary)


def build_model(args, num_classes: int, seed: int = 0):
    cls = get_seg_cnn_model_class(args.model)
    return cls(num_classes=num_classes, patch_size=(args.patch_size,) * 3,
               generator=torch.Generator().manual_seed(seed))


def test_cnn(ds: ImageDataset, model, out_dir: str, device="cpu") -> dict:
    """Sliding-window inference of every case of `ds` and the Dice of its
    argmax per class; the mean over the cases in test_dice.csv."""
    os.makedirs(out_dir, exist_ok=True)
    model = model.to(device).eval()
    dices = []
    for i in range(len(ds)):
        img, lbl = ds[i]
        soft = predict_all_patches(model, torch.from_numpy(img).to(device),
                                   ds.num_classes, patch_size=ds.patch_size)
        pred = soft.argmax(-1)
        d = batch_dice(pred.reshape(1, -1),
                       torch.from_numpy(lbl).to(device).reshape(1, -1),
                       ds.num_classes)
        dices.append(d.cpu().numpy())
    mean = np.stack(dices).mean(0)   # (classes,)
    with open(os.path.join(out_dir, "test_dice.csv"), "w") as f:
        f.write(",".join(f"class{c}" for c in range(ds.num_classes)) + "\n")
        f.write(",".join(str(v) for v in mean) + "\n")
    print("mean dice per class:", mean)
    return {"dice": float(mean[1:].mean())}


def make_step(args, out_dir: str, device="cuda", seed: int = 0):
    """One train step of a fresh CNN (`args.model`, seed `seed`) on a
    newly cropped and augmented batch of `args.batch` patches of the
    dataset `args` names: step() -> (loss, components). The harness
    chip_smoke.py times the step with."""
    ds = build_dataset(args)
    model = build_model(args, ds.num_classes, seed)
    loss_fn = get_loss_fn(args.loss, torch.as_tensor(
        ds.get_class_weights(), dtype=torch.float32, device=device))
    trainer = ImageTrainer(model, ds, loss_fn, out_dir,
                           TrainConfig(lr=args.lr, batch_size=args.batch,
                                       weight_decay=args.wd, seed=seed),
                           device=device)
    rng = np.random.default_rng(seed)

    def step():
        idx = rng.integers(0, len(ds), args.batch).tolist()
        return trainer.train_step(*ds.crop_batch(rng, idx, trainer.device))
    return step


def run(args, device=None) -> dict:
    """Train and/or test the folds `args` asks for; returns {fold: trained
    model} (the best epoch's, the one written as model.fst)."""
    device = default_device(args) if device is None else torch.device(device)
    os.makedirs(args.output, exist_ok=True)
    if args.test_only:
        args = load_args_for_testing(args.output, args)
    else:
        store_args(args, args.output)

    ds = build_dataset(args)
    loss_fn = get_loss_fn(args.loss, torch.as_tensor(
        ds.get_class_weights(), dtype=torch.float32, device=device))

    if not args.test_only:
        # op_count.csv, counted at one full patch
        model = build_model(args, ds.num_classes).to(device)
        x0 = torch.zeros((1, *model.patch_size, 1), device=device)
        counts = param_and_op_count(model, x0, out_dir=args.output)
        print(f"model: {counts['params']:,} params, "
              f"{counts['flops'] / 1e9:.2f} GFLOP / patch")

    case_ids = [list(i) for i in ds.ids]
    split = load_split_file(args.split) if args.split else \
        create_split(case_ids, k=5)
    save_split_file(split, os.path.join(args.output, "cross_val_split.json"))

    models, fold_metrics = {}, []
    folds = range(len(split)) if args.fold is None else [args.fold]
    for fold in folds:
        print(f"------------ FOLD {fold} ----------------------")
        fold_dir = os.path.join(args.output, f"fold{fold}")
        train_ds, val_ds = ds.split_data_set(split[fold])

        if not args.test_only:
            cfg = TrainConfig(epochs=args.epochs, lr=args.lr,
                              batch_size=args.batch, weight_decay=args.wd,
                              scheduler=args.scheduler, seed=fold)
            trainer = ImageTrainer(build_model(args, ds.num_classes, fold),
                                   train_ds, loss_fn, fold_dir, cfg,
                                   device=device)
            models[fold] = trainer.run()

        if not args.train_only:
            fold_metrics.append(test_cnn(
                val_ds, load_fold_model(fold_dir),
                os.path.join(fold_dir, "test"), device))

    if fold_metrics:
        with open(os.path.join(args.output, "cv_results.csv"), "w") as f:
            f.write("fold,dice\n")
            for i, m in enumerate(fold_metrics):
                f.write(f"{i},{m['dice']}\n")
            f.write(f"mean,{np.mean([m['dice'] for m in fold_metrics])}\n")
    return models


def main(argv=None, device=None) -> int:
    args = get_seg_cnn_train_parser().parse_args(argv)
    maybe_run_detached_cli(args)
    run(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
