"""Shape-model sanity probes (counterpart of shape_sanity_checks.py):

    python -m fissure_segmentation_tpu_torch.shape_sanity_checks \
        [--probe weights|eigenvectors|dgssm|all]

  * weights: can Adam recover a weight vector equal to the SSM encoding of
    a target shape (24 shapes, 300 steps each)?
  * eigenvectors: can Adam recover the eigenvector matrix itself from the
    reconstruction objective (5000 steps)?
  * dgssm: can a DG-SSM (k = 10, static graph) recover known random rigid
    rotations of a fixed shape from the corresponding-point loss (8 x 256
    points a step, 30 epochs of 10 steps)?

All three run on synthetic corresponding-point shapes and print the same
error-against-baseline numbers as the JAX entry, on the first CUDA card
(raising without one) unless a probe is given `device="cpu"`. The 24
per-shape weight fits run as one batch: each shape's loss and Adam update
depend on its own weights only. Random draws come from `generator` (a
torch.Generator on the probe's device, seeded 0 by default) or are
injected (`m0`, `draws`), since JAX's draws cannot be replayed in torch.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .losses.dgssm import corresponding_point_distance
from .shape_model.ssm import fit_ssm, ssm_decode, ssm_project
from .utils.device import resolve_device


def make_shapes(n: int = 24, p: int = 256, seed: int = 0) -> np.ndarray:
    """Synthetic corresponding-point shapes: a smooth height-field sheet with
    low-rank random deformation modes (stand-in for the registered fissure
    shapes of CorrespondingPointDataset)."""
    rng = np.random.default_rng(seed)
    g = int(np.sqrt(p))
    xs, ys = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g),
                         indexing="ij")
    base = np.stack([xs, ys, 0.5 + 0.2 * xs + 0.1 * ys ** 2], -1).reshape(-1, 3)
    modes = rng.normal(0, 1, (4, len(base), 3)) * \
        np.array([0.05, 0.03, 0.02, 0.01])[:, None, None]
    w = rng.normal(0, 1, (n, 4))
    shapes = base[None] + np.einsum("nm,mpc->npc", w, modes)
    shapes += rng.normal(0, 0.002, shapes.shape)
    return shapes.astype(np.float32)[:, :p]


def _generator(generator, dev):
    return generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)


def sanity_check_weights(n_iter: int = 300, lr: float = 0.1, verbose=True,
                         device=None):
    """Adam recovers per-shape SSM weights.

    :return: (mean error to the PCA-optimal reconstruction, mean baseline:
        the targets' distance to it)
    """
    dev = resolve_device(device, "sanity_check_weights")
    shapes = make_shapes()
    ssm = fit_ssm(shapes).to(dev)
    targets = torch.as_tensor(shapes, device=dev)
    w = torch.zeros((len(shapes), ssm.num_modes), device=dev,
                    requires_grad=True)
    opt = torch.optim.Adam([w], lr=lr)
    for _ in range(n_iter):
        opt.zero_grad(set_to_none=True)
        rec = ssm_decode(ssm, w)
        ((rec - targets) ** 2).mean(dim=(1, 2)).sum().backward()
        opt.step()
    with torch.no_grad():
        rec = ssm_decode(ssm, w)
        optimal = ssm_decode(ssm, ssm_project(ssm, targets))
        diffs = corresponding_point_distance(rec, optimal).mean(-1)
        baselines = corresponding_point_distance(targets, optimal).mean(-1)
    diffs, baselines = diffs.cpu().numpy(), baselines.cpu().numpy()
    if verbose:
        for d, b in zip(diffs, baselines):
            print(f"Error: {d:.4f} | Baseline: {b:.4f}")
    return float(np.mean(diffs)), float(np.mean(baselines))


def sanity_check_eigenvectors(n_iter: int = 5000, lr: float = 0.02,
                              verbose=True, device=None,
                              generator: torch.Generator | None = None,
                              m0: torch.Tensor | None = None):
    """Adam recovers an eigenvector matrix whose autoencoding matches the
    PCA optimum.

    :param m0: (F, M) start matrix to use instead of 0.1 * a normal draw
        from `generator`
    :return: (reconstruction error, PCA-optimal error)
    """
    dev = resolve_device(device, "sanity_check_eigenvectors")
    shapes_np = make_shapes()
    ssm = fit_ssm(shapes_np).to(dev)
    shapes = torch.as_tensor(shapes_np, device=dev)
    flat = shapes.reshape(len(shapes), -1)
    mean = flat.mean(0, keepdim=True)
    with torch.no_grad():
        optimal = ssm_decode(ssm, ssm_project(ssm, shapes))
        optimal_err = float(corresponding_point_distance(shapes,
                                                         optimal).mean())
    if m0 is None:
        m0 = 0.1 * torch.randn((flat.shape[1], ssm.num_modes), device=dev,
                               generator=_generator(generator, dev))
    m = m0.detach().to(device=dev, dtype=torch.float32).clone()
    m.requires_grad_(True)
    opt = torch.optim.Adam([m], lr=lr)
    for _ in range(n_iter):
        opt.zero_grad(set_to_none=True)
        proj = (flat - mean) @ m
        rec = mean + proj @ m.T
        ((rec - flat) ** 2).mean().backward()
        opt.step()
    with torch.no_grad():
        rec = (mean + ((flat - mean) @ m) @ m.T).reshape(shapes.shape)
        err = float(corresponding_point_distance(shapes, rec).mean())
    if verbose:
        print(f"Adam-fit reconstruction error: {err:.5f} | "
              f"PCA optimum: {optimal_err:.5f}")
    return err, optimal_err


def dgssm_rigid_toy_example(epochs: int = 30, steps: int = 10,
                            verbose=True, device=None,
                            generator: torch.Generator | None = None,
                            draws: torch.Tensor | None = None):
    """DG-SSM recovers random rigid rotations of a fixed shape: train on
    rotated copies with the corresponding-point loss; the error must fall
    towards the SSM baseline.

    :param draws: (epochs * steps, 8, 3) uniforms in [0, 1) for the
        rotation vectors ((u * 2 - 1) * 1.5), instead of drawing them from
        `generator`
    :return: the per-epoch mean corresponding-point errors
    """
    from .data.augmentation import compose_transform, transform_points
    from .models import DGSSM

    dev = resolve_device(device, "dgssm_rigid_toy_example")
    gen = _generator(generator, dev)
    shapes = make_shapes(n=16, p=256)
    ssm = fit_ssm(shapes).to(dev)
    target = torch.as_tensor(shapes[0], device=dev)
    # the model's weights from a CPU generator seeded 0, as JAX's toy
    # initializes from PRNGKey(0)
    model = DGSSM(k=10, in_features=3, ssm_modes=ssm.num_modes,
                  dynamic=False, generator=torch.Generator().manual_seed(0)
                  ).to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    center = target.mean(0)
    zeros, ones = torch.zeros((8, 3), device=dev), torch.ones((8, 1),
                                                             device=dev)
    errs = []
    for e in range(epochs):
        acc = torch.zeros((), device=dev)
        for s in range(steps):
            u = (torch.rand((8, 3), generator=gen, device=dev)
                 if draws is None else draws[e * steps + s].to(dev))
            t = compose_transform((u * 2 - 1) * 1.5, zeros, ones)
            batch = transform_points(target[None] - center, t) + center
            opt.zero_grad(set_to_none=True)
            pred, _, _ = model(batch, ssm)
            ((pred - batch) ** 2).mean().backward()
            opt.step()
            acc += corresponding_point_distance(pred.detach(), batch).mean()
        errs.append(float(acc) / steps)
        if verbose and e % 5 == 0:
            print(f"EPOCH {e}: corr-point error {errs[-1]:.4f}")
    return errs


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description="shape-model sanity probes")
    parser.add_argument("--probe", default="all",
                        choices=["weights", "eigenvectors", "dgssm", "all"])
    args = parser.parse_args(argv)
    if args.probe in ("weights", "all"):
        sanity_check_weights(device=device)
    if args.probe in ("eigenvectors", "all"):
        sanity_check_eigenvectors(device=device)
    if args.probe in ("dgssm", "all"):
        dgssm_rigid_toy_example(device=device)


if __name__ == "__main__":
    main()
