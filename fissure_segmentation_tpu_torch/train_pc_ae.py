"""Train and test the point-cloud autoencoder, the PC-AE (DGCNN encoder +
Folding or Deforming decoder), with cross-validation on surface samples of
ground-truth meshes (counterpart of train_pc_ae.py).

    python -m fissure_segmentation_tpu_torch.train_pc_ae --ds synthetic \\
        --fold 0 --epochs 3 --mesh --output OUT
    python -m fissure_segmentation_tpu_torch.train_pc_ae --output OUT \\
        --test_only --fold 0

The flags are the JAX entry's (the port's copy in `cli/`): k = 20, 1024
points, latent 512, the plane template, batch 32 by default. Without
`--mesh` the decoder returns points and the loss is the Chamfer distance
to the input samples; with `--mesh` it returns the plane mesh and the loss
is the regularized mesh loss (`--loss_weights`: chamfer, edge length,
normal consistency, Laplacian) against a dense sample of the GT mesh. Each
fold trains (`model.pt`, history.csv, train_time.csv) and is then tested:
the mean Chamfer distance between the decoded validation objects and 4096
samples of their GT surfaces (fold*/test/reconstruction_chamfer.csv), then
cv_results.csv over the folds, in the JAX entry's layouts. `--test_only`
reads each fold's `model.pt`, or the JAX package's `model.fst` where only
that exists. The model trains in float32, as the JAX entry's does.
Everything runs on CUDA card `--gpu`; without a card it raises, unless the
caller of `run` or `main` passes ``device="cpu"`` (as the tests do).

Not written: op_count.csv. `--dp` and `--visualize` are taken and have no
effect, as in the JAX entry, whose generic parser gives them to every
entry and whose PC-AE run reads neither.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .cli import get_pc_ae_train_parser, load_args_for_testing, store_args
from .data.dataset import create_split, load_split_file, save_split_file
from .data.mesh_dataset import SampleFromMeshDS, sample_mesh_batch
from .data.synthetic import make_synthetic_mesh_dataset
from .losses import chamfer_distance, get_loss_fn
from .losses.mesh import MeshTopology
from .models.folding_net import DGCNNFoldingNet, folding_points_for
from .models.weights import load_fold_model
from .ops.marching import sample_points_on_triangles
from .train.trainer import ModelTrainer, TrainConfig
from .utils.device import resolve_device

EVAL_SEED = 7          # the JAX entry's PRNGKey(7)


def default_device(args) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("train_pc_ae: no CUDA card found; pass "
                           "device='cpu' to run() or main() to run on the "
                           "CPU")
    return torch.device("cuda", args.gpu)


def build_dataset(args) -> SampleFromMeshDS:
    if args.ds == "synthetic" or args.data_dir is None:
        cases, meshes, sizes = make_synthetic_mesh_dataset(
            n_cases=12, grid_n=24, n_points=400, with_feature=False)
        ids = [(c["case_id"], c["sequence"]) for c in cases]
        return SampleFromMeshDS(meshes, ids, sizes, sample_points=args.pts,
                                fixed_object=args.obj,
                                exclude_rhf=args.exclude_rhf,
                                mesh_as_target=args.mesh)
    return SampleFromMeshDS.from_folder(
        args.data_dir, sample_points=args.pts, fixed_object=args.obj,
        exclude_rhf=args.exclude_rhf, mesh_as_target=args.mesh,
        lobes=args.data == "lobes")


def build_model(args, generator: torch.Generator | None = None):
    return DGCNNFoldingNet(k=args.k, n_embedding=args.latent,
                           shape_type=args.shape, n_input_points=args.pts,
                           decode_mesh=args.mesh, deform=args.deform,
                           static=args.static, dec_depth=args.dec_depth,
                           generator=generator)


def make_loss(args, model: DGCNNFoldingNet):
    """Chamfer to the input samples, or with --mesh the regularized mesh
    loss over the decoder's fixed plane topology."""
    if not args.mesh:
        return get_loss_fn("chamfer")
    _, faces = folding_points_for(args.shape, model.m, decode_mesh=True)
    faces = np.asarray(faces)
    topo = MeshTopology.from_faces(faces, model.m)
    base = get_loss_fn("mesh", term_weights=args.loss_weights)

    def wrapped(out, y):
        verts = out[0] if isinstance(out, tuple) else out
        return base(verts, y, faces=faces, topo=topo)
    return wrapped


def batch_fn_for(ds: SampleFromMeshDS, store):
    """The trainer's ``batch_fn(generator, item_idx, train)``: samples of
    the store's meshes, augmented only in training."""
    def batch_fn(generator, item_idx, train):
        aug = ds.do_augmentation
        ds.do_augmentation = train and aug
        try:
            return ds.sample_batch(store, item_idx, generator)
        finally:
            ds.do_augmentation = aug
    return batch_fn


def make_step(args, out_dir: str, device="cuda", seed: int = 0):
    """One Adam step of a fresh PC-AE (seed `seed`) on a newly sampled
    batch of `args.batch` items of the dataset `args` names: step() ->
    (loss, components). The harness chip_smoke.py times the step with."""
    ds = build_dataset(args)
    model = build_model(args, torch.Generator().manual_seed(seed))
    trainer = ModelTrainer(
        model, ds, make_loss(args, model), out_dir,
        TrainConfig(lr=args.lr, batch_size=args.batch, weight_decay=args.wd),
        device=device, batch_fn=batch_fn_for(ds, ds.to_store(device=device)))
    gen = torch.Generator(device=trainer.device).manual_seed(seed)

    def step():
        idx = torch.randint(0, len(ds), (args.batch,), generator=gen,
                            device=trainer.device)
        return trainer.train_step(*trainer.batch_fn(gen, idx, True))
    return step


def evaluate_reconstruction(ds: SampleFromMeshDS, model, out_dir: str,
                            n_eval_samples: int = 4096, device=None,
                            draws: list | None = None) -> dict:
    """The mean Chamfer distance between each item's reconstruction (from
    `ds.sample_points` unaugmented surface samples) and `n_eval_samples`
    samples of its GT surface; reconstruction_chamfer.csv in `out_dir`.

    :param device: where to run (default: the first CUDA card; the CPU
        only when asked for)
    :param draws: per item {"input": (u (1, S), uv (1, S, 2)), "eval": (u
        (n_eval_samples,), uv (n_eval_samples, 2))} to use instead of a
        generator seeded with EVAL_SEED (tests inject the JAX entry's)
    """
    device = resolve_device(device, "evaluate_reconstruction")
    os.makedirs(out_dir, exist_ok=True)
    store = ds.to_store(device=device)
    gen = torch.Generator(device=device).manual_seed(EVAL_SEED)
    model = model.to(device).eval()
    dists = []
    with torch.no_grad():
        for item in range(len(ds)):
            d = (draws[item] if draws is not None else {})
            idx = torch.tensor([item], device=device)
            samples, _ = sample_mesh_batch(store, idx, ds.sample_points, gen,
                                           augment=False, draws=d)
            out = model(samples)
            verts = out[0] if isinstance(out, tuple) else out
            target = sample_points_on_triangles(
                store.tris[item], store.valid[item], n_eval_samples, gen,
                d.get("eval"))
            dists.append(float(chamfer_distance(verts, target[None])))
    mean, std = float(np.mean(dists)), float(np.std(dists))
    with open(os.path.join(out_dir, "reconstruction_chamfer.csv"), "w") as f:
        f.write("mean_chamfer,std_chamfer\n")
        f.write(f"{mean},{std}\n")
    print(f"reconstruction chamfer: {mean:.5f} +- {std:.5f}")
    return {"chamfer": mean}


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
            model = build_model(args, torch.Generator().manual_seed(fold))
            loss_fn = make_loss(args, model)
            batch_fn = batch_fn_for(train_ds,
                                    train_ds.to_store(device=device))
            cfg = TrainConfig(epochs=args.epochs, lr=args.lr,
                              batch_size=args.batch, weight_decay=args.wd,
                              scheduler=args.scheduler, seed=fold)
            trainer = ModelTrainer(model, train_ds, loss_fn, fold_dir, cfg,
                                   device=device, batch_fn=batch_fn)
            models[fold] = trainer.run()

        if not args.train_only:
            model = load_fold_model(fold_dir, DGCNNFoldingNet)
            fold_metrics.append(evaluate_reconstruction(
                val_ds, model, os.path.join(fold_dir, "test"),
                device=device))

    if fold_metrics:
        vals = [m["chamfer"] for m in fold_metrics]
        with open(os.path.join(args.output, "cv_results.csv"), "w") as f:
            f.write("fold,chamfer\n")
            for i, v in enumerate(vals):
                f.write(f"{i},{v}\n")
            f.write(f"mean,{np.mean(vals)}\n")
    return models


def main(argv=None, device=None) -> int:
    run(get_pc_ae_train_parser().parse_args(argv), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
