"""Train and test DPSR-Net: point segmentation trained end to end through a
differentiable Poisson surface reconstruction, supervised by the
segmentation labels and the ground-truth fissure surfaces (counterpart of
the JAX entry train_dpsr_net.py).

    python -m fissure_segmentation_tpu_torch.train_dpsr_net --ds synthetic \\
        --fold 0 --epochs 3 --output OUT [--dpsr_version 1]

The flags are the JAX entry's (the port's copy in `cli/`): DGCNN with
k = 20 and the dynamic graph, 1024 points, batch 32, a 128^3 PSR grid,
sigma 10 for the normals and the solver, v2 (SoftMesh) by default, f32.
Per fold the net trains with the DPSR loss, whose Chamfer term between
each fissure class's surface samples (min(2048, 2 * pts) of them, from a
triangle budget of max(2048, 8 * res0 * res1)) and the GT surface
switches on at epoch fraction 0.1; then the seg net alone is tested by the
point-segmentation test pipeline (fold*/test/, as train_point_seg). Writes
op_count.csv (one batch-1 forward of the whole model, PSR and marching
included), cross_val_split.json, fold*/model.pt, history.csv,
train_time.csv and cv_results.csv. `--test_only` reads each fold's
model.pt, or the JAX package's model.fst where only that exists.
Everything runs on CUDA card `--gpu`; without a card it raises, unless the
caller of `run` or `main` passes ``device="cpu"`` (as the tests do).

Real-data training raises, as the JAX entry does (it needs the
`*_mesh_*` directories, which neither entry reads).
"""
from __future__ import annotations

import os
import sys

import torch

from .cli import get_dpsr_train_parser, load_args_for_testing, store_args
from .data.dataset import create_split, load_split_file, save_split_file
from .data.mesh_dataset import PointToMeshDS, sample_mesh_batch
from .data.store import sample_batch
from .data.synthetic import make_synthetic_mesh_dataset
from .losses import get_loss_fn
from .models.dpsr_net import DPSRNet, DPSRNet2
from .models.weights import load_fold_model
from .train.cross_val import write_cv_results
from .train.evaluation import test_pipeline
from .train.trainer import ModelTrainer, TrainConfig
from .utils.detached_run import maybe_run_detached_cli
from .utils.profiling import param_and_op_count

CHAMFER_START = 0.1     # epoch fraction (the reference's dpsr_loss.py:29)


def default_device(args) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("train_dpsr_net: no CUDA card found; pass "
                           "device='cpu' to run() or main() to run on the "
                           "CPU")
    return torch.device("cuda", args.gpu)


def build_dataset(args) -> PointToMeshDS:
    if args.ds == "synthetic" or args.data_dir is None:
        cases, meshes, sizes = make_synthetic_mesh_dataset(
            n_cases=10, grid_n=20, n_points=4000, gt_surfaces=True)
        return PointToMeshDS(cases, meshes, sizes, sample_points=args.pts,
                             exclude_rhf=args.exclude_rhf,
                             binary=args.binary)
    raise NotImplementedError("real-data DPSR training needs *_mesh_* dirs; "
                              "use PointToMeshDS with load_meshes")


def build_model(args, ds, generator: torch.Generator | None = None):
    """DPSRNet2 (v2, SoftMesh) or DPSRNet (`--dpsr_version 1`)."""
    common = dict(seg_net_class=args.model, k=args.k,
                  in_features=ds.n_features, num_classes=ds.num_classes,
                  spatial_transformer=args.transformer,
                  dynamic=not args.static,
                  image_feat_module=args.img_feat_extractor,
                  dpsr_res=tuple(args.res), dpsr_sigma=args.sigma,
                  # the triangle budget grows with the grid's surface area
                  # (the reference's fixed 100k at 128^3 is about 8 r^2)
                  max_tris=max(2048, 8 * args.res[0] * args.res[1]),
                  n_surface_samples=min(2048, 2 * args.pts),
                  generator=generator)
    if getattr(args, "dpsr_version", 2) == 1:
        return DPSRNet(**common)
    return DPSRNet2(normals_smoothing_sigma=args.normals_sigma, **common)


def make_loss(args, ds, device):
    """The DPSR loss with the Chamfer switch at epoch fraction 0.1; the
    predicted (B, C-1, S, 3) samples and the targets are flattened over
    the classes so each class meets its own GT surface."""
    base = get_loss_fn("dpsr", torch.as_tensor(ds.get_class_weights(),
                                               device=device),
                       term_weights=args.loss_weights)

    def loss_fn(out, y, epoch: int):
        pred_seg, pred_pts, pred_valid = out
        b, c1, s, _ = pred_pts.shape
        targ_seg, targ_pts, targ_valid = y
        frac = epoch / max(args.epochs, 1)
        total, comps = base(
            (pred_seg, pred_pts.reshape(b * c1, s, 3),
             pred_valid.reshape(b * c1, s)),
            (targ_seg, targ_pts.reshape(b * c1, -1, 3),
             targ_valid.reshape(b * c1, -1)),
            current_epoch_fraction=1.0 if frac >= CHAMFER_START else 0.0)
        return total, comps
    return loss_fn


def batch_fn_for(train_ds: PointToMeshDS, args, n_surf: int, device):
    """The trainer's ``batch_fn(generator, case_idx, train)``: the points
    (no augmentation, as the JAX entry) and each fissure class's GT
    surface samples, (x, (labels, surfaces (B, C-1, S, 3), valid))."""
    point_store = train_ds.to_store(device=device)
    class_stores = [train_ds.class_mesh_store(label, device=device)
                    for label in range(1, train_ds.num_classes)]

    def batch_fn(generator, case_idx, train):
        x, y = sample_batch(point_store, case_idx, args.pts, generator,
                            augment=False, binary=train_ds.binary)
        surf = torch.stack([sample_mesh_batch(cs, case_idx, n_surf,
                                              generator, augment=False)[0]
                            for cs in class_stores], dim=1)
        return x, (y, surf, torch.ones(surf.shape[:-1], dtype=torch.bool,
                                       device=surf.device))
    return batch_fn


def make_trainer(args, train_ds, ds, fold_dir: str, device, seed: int):
    model = build_model(args, ds, torch.Generator().manual_seed(seed))
    cfg = TrainConfig(epochs=args.epochs, lr=args.lr, batch_size=args.batch,
                      weight_decay=args.wd, scheduler=args.scheduler,
                      seed=seed)
    return ModelTrainer(
        model, train_ds, make_loss(args, ds, device), fold_dir, cfg,
        device=device,
        batch_fn=batch_fn_for(train_ds, args, model.n_surface_samples,
                              device),
        init_input=torch.zeros((1, args.pts, ds.n_features)),
        epoch_in_loss=True)


def make_step(args, out_dir: str, device="cuda", seed: int = 0):
    """One Adam step of a fresh model (seed `seed`) on a newly sampled
    batch of fold 0's training set, at the last epoch's loss (the Chamfer
    term on): step() -> (loss, components). The harness chip_smoke.py
    times the step with."""
    ds = build_dataset(args)
    split = create_split([list(i) for i in ds.ids], k=5)
    train_ds, _ = ds.split_data_set(split[0])
    trainer = make_trainer(args, train_ds, ds, out_dir, device, seed)
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    trainer.current_epoch = args.epochs - 1

    def step():
        idx = torch.randint(0, len(train_ds), (args.batch,), generator=gen,
                            device=trainer.device)
        return trainer.train_step(*trainer.batch_fn(gen, idx, True))
    return step


def run(args, device=None) -> dict:
    """Train and/or test the folds `args` asks for; returns {fold: trained
    model} (the best snapshot, the one written as model.pt)."""
    device = default_device(args) if device is None else torch.device(device)
    os.makedirs(args.output, exist_ok=True)
    if args.test_only:
        args = load_args_for_testing(args.output, args)
    else:
        store_args(args, args.output)
    ds = build_dataset(args)

    if not args.test_only:
        # op_count.csv: the whole path at the configured grid, batch 1
        model = build_model(args, ds).to(device)
        counts = param_and_op_count(
            model, torch.zeros((1, args.pts, ds.n_features), device=device),
            out_dir=args.output)
        print(f"model: {counts['params']:,} params, "
              f"{counts['flops'] / 1e9:.2f} GFLOP / fwd batch-1")

    split = load_split_file(args.split) if args.split else \
        create_split([list(i) for i in ds.ids], k=5)
    save_split_file(split, os.path.join(args.output, "cross_val_split.json"))

    models, fold_metrics = {}, []
    folds = range(len(split)) if args.fold is None else [args.fold]
    for fold in folds:
        print(f"------------ FOLD {fold} ----------------------")
        fold_dir = os.path.join(args.output, f"fold{fold}")
        train_ds, val_ds = ds.split_data_set(split[fold])
        if not args.test_only:
            trainer = make_trainer(args, train_ds, ds, fold_dir, device,
                                   fold)
            models[fold] = trainer.run()

        if not args.train_only:
            model = load_fold_model(fold_dir, (DPSRNet if getattr(
                args, "dpsr_version", 2) == 1 else DPSRNet2))
            # the test reads the seg logits only: the seg net alone
            val_ds.do_augmentation = False
            fold_metrics.append(test_pipeline(
                val_ds, model.seg_net.to(device).eval(),
                os.path.join(fold_dir, "test"), sample_points=args.pts,
                device=device))

    if fold_metrics:
        write_cv_results(os.path.join(args.output, "cv_results.csv"),
                         fold_metrics)
    return models


def main(argv=None, device=None) -> int:
    args = get_dpsr_train_parser().parse_args(argv)
    maybe_run_detached_cli(args)
    run(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
