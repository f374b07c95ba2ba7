"""Train and test DG-SSM: a multi-head classification DGCNN regressing a
statistical shape model's mode coefficients and a similarity transform
from keypoint clouds (counterpart of the JAX entry train_dgcnn_ssm.py).

    python -m fissure_segmentation_tpu_torch.train_dgcnn_ssm --ds synthetic \\
        --fold 0 --epochs 3 --output OUT [--predict_affine] [--lssm]

The flags are the JAX entry's (the port's copy in `cli/`): k = 20, the
dynamic graph, 1024 points, batch 32, alpha 3, target variance 0.95, f32.
Per fold the SSM is fitted by PCA (`--lssm`: the localized SSM) on the
training split's normalized corresponding points and written as
fold*/ssm.npz (the JAX package's file); the regressor trains with the
DG-SSM loss (Chamfer + coefficient MSE + affine MSE, the target
coefficients projected from the target shape), the heads switched on by
`--head_schedule` (the epoch from which each head is active); then each
validation case's full cloud is predicted by averaging 20 random subsets
and its decoded shape compared with its corresponding points
(fold*/test/corr_point_distance.csv, cv_results.csv). op_count.csv is
counted for the first trained fold. `--test_only` reads each fold's
ssm.npz and model.pt, or the JAX package's model.fst where only that
exists. Everything runs on CUDA card `--gpu`; without a card it raises,
unless the caller of `run` or `main` passes ``device="cpu"`` (as the
tests do).

The synthetic corresponding points are built directly (the same (u, v)
fissure parameters in every case), so the CPD registration is not on this
path. Not ported: real-data training (the JAX entry raises too).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .cli import get_dgcnn_ssm_train_parser, load_args_for_testing, store_args
from .data.dataset import create_split, load_split_file, save_split_file
from .data.mesh_dataset import CorrespondingPointDataset
from .data.synthetic import (_FISSURES, _LUNGS, _surface_z,
                             make_synthetic_dataset)
from .losses import get_loss_fn
from .losses.dgssm import corresponding_point_distance
from .models.dg_ssm import DGSSM, dgssm_ensemble_predict
from .models.dgcnn_cls import HEADS
from .models.weights import load_fold_model
from .shape_model import fit_lssm, fit_ssm, load_ssm, save_ssm, ssm_project
from .train.trainer import ModelTrainer, TrainConfig
from .utils.detached_run import maybe_run_detached_cli
from .utils.device import resolve_device
from .utils.profiling import param_and_op_count

TEST_RUNS = 20          # subsets averaged per validation case


def default_device(args) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("train_dgcnn_ssm: no CUDA card found; pass "
                           "device='cpu' to run() or main() to run on the "
                           "CPU")
    return torch.device("cuda", args.gpu)


def synthetic_correspondences(cases: list[dict], exclude_rhf: bool):
    """(n_cases, P, 3) world-coordinate corresponding points and their
    (P,) fissure labels: a 16 x 16 (u, v) lattice on each fissure surface,
    the same lattice in every case."""
    corr, labels = [], []
    for c in cases:
        pts, lbl = [], []
        for f, (lung, _, _) in _FISSURES.items():
            if f == 3 and exclude_rhf:
                continue
            cen, ax = _LUNGS[lung]
            u = np.linspace(-0.55, 0.55, 16)
            uu, vv = np.meshgrid(u, u)
            x = cen[0] + uu.ravel() * ax[0]
            y = cen[1] + vv.ravel() * ax[1]
            z = _surface_z(c["surface_params"][f], x, y, cen[0])
            d, h, w = c["shape"]
            scale = np.array([w, h, d], np.float32) - 1
            pts.append(np.stack([x, y, z], -1).astype(np.float32) * scale)
            lbl.append(np.full(len(x), f, np.int32))
        corr.append(np.concatenate(pts))
        labels.append(np.concatenate(lbl))
    return np.stack(corr), labels[0]


def build_dataset(args) -> CorrespondingPointDataset:
    if args.ds == "synthetic" or args.data_dir is None:
        cases = make_synthetic_dataset(12, n_points=3000, with_feature=False)
        corr, labels = synthetic_correspondences(cases, args.exclude_rhf)
        prereg = [{"rotation": np.eye(3, dtype=np.float32),
                   "translation": np.zeros(3, np.float32), "scale": 1.0}
                  for _ in cases]
        return CorrespondingPointDataset(cases, corr, prereg,
                                         corr_labels=labels,
                                         sample_points=args.pts,
                                         do_augmentation=True)
    raise NotImplementedError(
        "real-data DG-SSM needs corresponding points from "
        "shape_model.generate_corresponding_points (not ported yet)")


def fit_shape_model(args, train_ds: CorrespondingPointDataset):
    shapes = train_ds.get_normalized_corr_datamatrix_with_affine_reg()
    fit = fit_lssm if args.lssm else fit_ssm
    return fit(shapes, alpha=args.alpha,
               target_variance=args.target_variance)


def build_model(args, ssm_modes: int,
                generator: torch.Generator | None = None) -> DGSSM:
    return DGSSM(k=args.k, in_features=3, ssm_modes=ssm_modes,
                 dynamic=not args.static,
                 predict_affine_params=args.predict_affine,
                 only_affine=args.only_affine, active_heads=HEADS,
                 generator=generator)


def make_loss(args, ssm):
    """The DG-SSM loss with the target coefficients projected from the
    target shape."""
    base = get_loss_fn("ssm", term_weights=args.loss_weights)

    def loss_fn(out, y):
        t_corr, t_params = y
        return base(out, (t_corr, ssm_project(ssm, t_corr), t_params))
    return loss_fn


def head_schedule_callback(schedule: dict):
    """``epoch_callback``: the heads whose scheduled epoch has come."""
    def epoch_callback(trainer, epoch):
        active = tuple(h for h in HEADS if epoch >= schedule.get(h, 0))
        if active == trainer.model.active_heads:
            return False
        print(f"epoch {epoch}: active heads {active}")
        trainer.model.active_heads = active
        return True
    return epoch_callback


def make_trainer(args, train_ds, ssm, fold_dir: str, device, seed: int):
    ssm = ssm.to(device)
    model = build_model(args, ssm.num_modes,
                        torch.Generator().manual_seed(seed))
    store = train_ds.to_store(device=device)
    corr_pts, corr_params = (torch.as_tensor(a, device=device)
                             for a in train_ds.corr_targets())

    def batch_fn(generator, case_idx, train):
        aug = train_ds.augment_correspondingly
        train_ds.augment_correspondingly = train and aug
        try:
            return train_ds.sample_batch(store, case_idx, corr_pts,
                                         corr_params, generator)
        finally:
            train_ds.augment_correspondingly = aug

    cfg = TrainConfig(epochs=args.epochs, lr=args.lr, batch_size=args.batch,
                      weight_decay=args.wd, scheduler=args.scheduler,
                      seed=seed)
    return ModelTrainer(
        model, train_ds, make_loss(args, ssm), fold_dir, cfg, device=device,
        batch_fn=batch_fn, forward_fn=lambda m, x, train: m(x, ssm),
        init_input=torch.zeros((1, args.pts, 3)),
        epoch_callback=head_schedule_callback(args.head_schedule or {}))


def make_step(args, out_dir: str, device="cuda", seed: int = 0):
    """One Adam step of a fresh model (seed `seed`, every head active) on
    a newly sampled, augmented batch of fold 0's training set: step() ->
    (loss, components). The harness chip_smoke.py times the step with."""
    ds = build_dataset(args)
    split = create_split([list(i) for i in ds.ids], k=5)
    train_ds, _ = ds.split_data_set(split[0])
    trainer = make_trainer(args, train_ds, fit_shape_model(args, train_ds),
                           out_dir, device, seed)
    gen = torch.Generator(device=trainer.device).manual_seed(seed)

    def step():
        idx = torch.randint(0, len(train_ds), (args.batch,), generator=gen,
                            device=trainer.device)
        return trainer.train_step(*trainer.batch_fn(gen, idx, True))
    return step


def test_dgssm(val_ds: CorrespondingPointDataset, model: DGSSM, ssm,
               out_dir: str, sample_points: int, n_runs: int = TEST_RUNS,
               device=None) -> dict:
    """Each case's full cloud predicted from `n_runs` random subsets
    (generator seeded with the case index), its decoded shape against its
    corresponding points; corr_point_distance.csv (mean, std over the
    cases). Runs on `device` (default: the first CUDA card; the CPU only
    when asked for)."""
    device = resolve_device(device, "test_dgssm")
    os.makedirs(out_dir, exist_ok=True)
    model = model.to(device).eval()
    ssm = ssm.to(device)
    corr_pts, _ = val_ds.corr_targets()
    dists = []
    for i in range(len(val_ds)):
        x, _ = val_ds.get_full_pointcloud(i)
        pc = torch.as_tensor(np.asarray(x, np.float32), device=device)[None]
        recon, _, _ = dgssm_ensemble_predict(
            model, ssm, pc, sample_points=sample_points, n_runs_min=n_runs,
            generator=torch.Generator(device=device).manual_seed(i))
        d = corresponding_point_distance(
            recon[0], torch.as_tensor(corr_pts[i], device=device))
        dists.append(float(d.mean()))
    mean, std = float(np.mean(dists)), float(np.std(dists))
    with open(os.path.join(out_dir, "corr_point_distance.csv"), "w") as f:
        f.write("mean,std\n")
        f.write(f"{mean},{std}\n")
    print(f"corresponding point distance: {mean:.4f} +- {std:.4f}")
    return {"corr_dist": mean}


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
    split = load_split_file(args.split) if args.split else \
        create_split([list(i) for i in ds.ids], k=5)
    save_split_file(split, os.path.join(args.output, "cross_val_split.json"))

    models, fold_metrics = {}, []
    folds = list(range(len(split)) if args.fold is None else [args.fold])
    for fold in folds:
        print(f"------------ FOLD {fold} ----------------------")
        fold_dir = os.path.join(args.output, f"fold{fold}")
        os.makedirs(fold_dir, exist_ok=True)
        train_ds, val_ds = ds.split_data_set(split[fold])
        ssm_path = os.path.join(fold_dir, "ssm.npz")
        if args.test_only:
            ssm = load_ssm(ssm_path)
        else:
            ssm = fit_shape_model(args, train_ds)
            save_ssm(ssm, ssm_path)
        print(f"SSM: {ssm.num_modes} modes")

        if not args.test_only:
            if fold == folds[0]:
                # op_count.csv: the mode count depends on the fit, so it
                # is written once, for the first trained fold
                model = build_model(args, ssm.num_modes).to(device)
                ssm_d = ssm.to(device)
                counts = param_and_op_count(
                    _WithSSM(model, ssm_d),
                    torch.zeros((1, args.pts, 3), device=device),
                    out_dir=args.output)
                print(f"model: {counts['params']:,} params, "
                      f"{counts['flops'] / 1e9:.2f} GFLOP / fwd batch-1")
            trainer = make_trainer(args, train_ds, ssm, fold_dir, device,
                                   fold)
            models[fold] = trainer.run()

        if not args.train_only:
            model = load_fold_model(fold_dir, DGSSM)
            fold_metrics.append(test_dgssm(
                val_ds, model, ssm, os.path.join(fold_dir, "test"),
                sample_points=args.pts, device=device))

    if fold_metrics:
        vals = [m["corr_dist"] for m in fold_metrics]
        with open(os.path.join(args.output, "cv_results.csv"), "w") as f:
            f.write("fold,corr_point_dist\n")
            for i, v in enumerate(vals):
                f.write(f"{i},{v}\n")
            f.write(f"mean,{np.mean(vals)}\n")
    return models


class _WithSSM(torch.nn.Module):
    """`model(x, ssm)` as a one-argument module, for op_count."""

    def __init__(self, model: DGSSM, ssm):
        super().__init__()
        self.model, self.ssm = model, ssm

    def forward(self, x):
        return self.model(x, self.ssm)


def main(argv=None, device=None) -> int:
    args = get_dgcnn_ssm_train_parser().parse_args(argv)
    maybe_run_detached_cli(args)
    run(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
