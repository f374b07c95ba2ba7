"""Rigid-transform recovery experiments (counterpart of
affine_experiments.py): can a global point-cloud network recover a known
random rigid transform of a fixed shape?

    python -m fissure_segmentation_tpu_torch.affine_experiments \\
        --model OpenDGCNN|DGCNN|PointNet --epochs 100 --steps 10 \\
        --output results/affine_experiments

Each model runs the JAX entry's grid of nine runs (rotation, translation
or both; the point loss, the parameter loss or both), each training from the
same seed on fresh random transforms every step: 8 transforms a step of a
fixed 1024-point target (a synthetic fissure surface in the unit sphere),
`models/affine.py` at k = 40, Adam at 1e-3. A run writes
`<output>/<model>_sanity_check/<tag>/training_progression.csv`: a row each
of loss, angle_rmse, trans_rmse_mm and corr_err_mm (the translation and
corresponding-point errors in the shape's units via its scale), a column an
epoch, as the JAX entry writes them.

Everything runs on a CUDA card; without one it raises, unless the caller
of `run_example` or `main` passes ``device="cpu"``. The step's metrics are
summed on the device and fetched once an epoch, as the JAX entry fetches
them.
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch

from .data.augmentation import compose_transform
from .data.synthetic import make_synthetic_case
from .losses.dgssm import corresponding_point_distance
from .models.affine import (AFFINE_MODELS, random_transformation,
                            rotate_around_center)
from .utils.detached_run import maybe_run_detached_cli
from .utils.device import resolve_device

N_TRANSFORMS = 8
LR = 1e-3


def normalized_target_shape(rng: np.random.Generator, n_points: int = 1024):
    """A fixed target shape in the unit sphere (a synthetic fissure-like
    surface), and its scale."""
    case = make_synthetic_case(int(rng.integers(1 << 31)), n_points=n_points,
                               with_feature=False)
    pts = case["coords"][:n_points].astype(np.float32)
    pts = pts - pts.mean(0, keepdims=True)
    scale = np.sqrt((pts ** 2).sum(-1)).max()
    return pts / scale, float(scale)


def make_train_step(model, optimizer, target_shape: torch.Tensor,
                    do_rotation: bool, do_translation: bool,
                    use_point_loss: bool, use_param_loss: bool,
                    n_transforms: int = N_TRANSFORMS):
    """``step(generator, draws=None) -> metrics``: draw `n_transforms`
    transforms (or take `draws`, `random_transformation`'s), move the
    target by each, regress them back, one Adam step; the metrics (loss,
    angle_rmse, trans_rmse, corr_err) are device scalars."""
    target = target_shape[None]

    def step(generator, draws=None) -> dict:
        t, log_rot, trans = random_transformation(
            generator, n_transforms, rotation=do_rotation,
            translation=do_translation, draws=draws,
            device=target.device)
        shapes = rotate_around_center(target, t)
        model.train()
        rot_p, tr_p = model(shapes)
        pred_t = compose_transform(rot_p, tr_p,
                                   torch.ones_like(tr_p[..., :1]))
        pred_shapes = rotate_around_center(target, pred_t)
        pts_ls = ((pred_shapes - shapes) ** 2).mean()
        par_ls = ((torch.cat([rot_p, tr_p], -1)
                   - torch.cat([log_rot, trans], -1)) ** 2).mean()
        loss = (pts_ls * use_point_loss + par_ls * use_param_loss) / \
            (use_point_loss + use_param_loss)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            return dict(
                loss=loss.detach(),
                angle_rmse=torch.sqrt(((rot_p - log_rot) ** 2).mean()),
                trans_rmse=torch.sqrt(((tr_p - trans) ** 2).sum(-1)).mean(),
                corr_err=corresponding_point_distance(pred_shapes,
                                                      shapes).mean())
    return step


def build_example(model_name: str, do_rotation=True, do_translation=True,
                  use_point_loss=True, use_param_loss=False, seed: int = 42,
                  device=None):
    """(step, the target's scale, the transforms' generator) of one run on
    `device`: the model seeded from `seed`, the generator from seed + 1."""
    device = resolve_device(device, "affine_experiments")
    target_np, scale = normalized_target_shape(np.random.default_rng(seed))
    target = torch.as_tensor(target_np, device=device)
    model = AFFINE_MODELS[model_name](
        k=40, do_rotation=do_rotation, do_translation=do_translation,
        generator=torch.Generator().manual_seed(seed)).to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=LR)
    step = make_train_step(model, optimizer, target, do_rotation,
                           do_translation, use_point_loss, use_param_loss)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    return step, scale, generator


def run_example(model_name: str, epochs: int, steps_per_epoch: int,
                out_root: str, do_rotation=True, do_translation=True,
                use_point_loss=True, use_param_loss=False, seed: int = 42,
                device=None) -> list[dict]:
    """One run of the grid; returns the per-epoch metrics (also written to
    training_progression.csv)."""
    tag = (f"{model_name}{'_rot' if do_rotation else ''}"
           f"{'_translation' if do_translation else ''}"
           f"{'_pointloss' if use_point_loss else ''}"
           f"{'_paramloss' if use_param_loss else ''}")
    out_dir = os.path.join(out_root, f"{model_name}_sanity_check", tag)
    os.makedirs(out_dir, exist_ok=True)
    step, scale, generator = build_example(
        model_name, do_rotation, do_translation, use_point_loss,
        use_param_loss, seed, device)

    history: list[dict] = []
    for epoch in range(epochs):
        acc = None
        for _ in range(steps_per_epoch):
            m = step(generator)
            acc = m if acc is None else {k: acc[k] + m[k] for k in m}
        fetched = torch.stack(list(acc.values())).cpu().tolist()
        hist = {k: v / steps_per_epoch for k, v in zip(acc, fetched)}
        hist["trans_rmse_mm"] = hist.pop("trans_rmse") * scale
        hist["corr_err_mm"] = hist.pop("corr_err") * scale
        history.append(hist)
        print(f"EPOCH {epoch}: " + " | ".join(
            f"{k}={v:.4f}" for k, v in hist.items()), flush=True)

    with open(os.path.join(out_dir, "training_progression.csv"), "w",
              newline="") as f:
        writer = csv.writer(f)
        for k in history[0]:
            writer.writerow([k] + [h[k] for h in history])
    return history


GRID = [(rot, trans, point, param)
        for rot in (False, True) for trans in (False, True)
        if rot or trans
        for param in (False, True) for point in (False, True)
        if param or point]


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(
        description="rigid-transform recovery sanity checks")
    parser.add_argument("--model", default="OpenDGCNN",
                        choices=sorted(AFFINE_MODELS))
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--output", default="results/affine_experiments")
    parser.add_argument("--offline", action="store_true")
    args = parser.parse_args(argv)
    maybe_run_detached_cli(args)
    device = resolve_device(device, "affine_experiments")
    for do_rotation, do_translation, use_point_loss, use_param_loss in GRID:
        run_example(args.model, args.epochs, args.steps, args.output,
                    do_rotation, do_translation, use_point_loss,
                    use_param_loss, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
