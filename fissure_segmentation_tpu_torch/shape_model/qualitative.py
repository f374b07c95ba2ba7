"""Qualitative SSM evaluation (counterpart of shape_model/qualitative.py):
reconstruction overlays, random-sample galleries, latent-space
interpolation strips and sampled-shape export.

Decoding runs on the SSM's tensors; the plots are matplotlib's, imported at
the call (a machine without matplotlib runs the rest). Random samples draw
from `generator` (default: a generator seeded 0 on the SSM's device, as
the JAX package falls back to PRNGKey(0)) or take `draws`, (n, M)
uniforms in [0, 1).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.visualization import point_cloud_on_axis
from .ssm import SSMParams, ssm_decode, ssm_project, ssm_random_samples


def _new_3d_axis(n_cols: int = 1, idx: int = 1, fig=None, figsize=None):
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    if fig is None:
        fig = plt.figure(figsize=figsize)
    return fig, fig.add_subplot(1, n_cols, idx, projection="3d")


def _finish(fig, savepath, show):
    from matplotlib import pyplot as plt
    if savepath is not None:
        fig.savefig(savepath, bbox_inches="tight", dpi=300)
    if show:  # pragma: no cover - interactive only
        plt.show()
    else:
        plt.close(fig)


def _random_decoded(params: SSMParams, n_samples: int, generator, draws):
    if generator is None and draws is None:
        generator = torch.Generator(
            device=params.eigenvalues.device).manual_seed(0)
    weights = ssm_random_samples(params, n_samples, generator=generator,
                                 draws=draws)
    return ssm_decode(params, weights).cpu().numpy()


def visualize_reconstruction(pred: np.ndarray, targ: np.ndarray,
                             savepath: str | None = None,
                             show: bool = False) -> None:
    """Prediction (red) vs target (blue) point clouds on one 3-D axis."""
    fig, ax = _new_3d_axis()
    point_cloud_on_axis(ax, np.asarray(pred), c="r",
                        title="SSM reconstruction", label="prediction")
    point_cloud_on_axis(ax, np.asarray(targ), c="b",
                        title="SSM reconstruction", label="target")
    _finish(fig, savepath, show)


def visualize_ssm_samples(params: SSMParams, n_samples: int, out_dir: str,
                          generator: torch.Generator | None = None,
                          show: bool = False,
                          draws: torch.Tensor | None = None) -> np.ndarray:
    """Decode `n_samples` random SSM samples and save one plot per sample.

    :return: the decoded (n_samples, N, 3) shapes
    """
    os.makedirs(out_dir, exist_ok=True)
    samples = _random_decoded(params, n_samples, generator, draws)
    for i, sample in enumerate(samples):
        fig, ax = _new_3d_axis()
        point_cloud_on_axis(ax, sample, c="r", title="SSM sample")
        _finish(fig, os.path.join(out_dir, f"smpl_{i}.png"), show)
    return samples


def latent_interpolation(shape_from: np.ndarray, shape_to: np.ndarray,
                         params: SSMParams, steps: int,
                         savepath: str | None = None,
                         show: bool = False) -> np.ndarray:
    """Linear interpolation strip in SSM weight space between two training
    shapes, flanked by the originals: columns = [shape_from,
    decode(w_from), ... steps ..., decode(w_to), shape_to].

    :return: the (steps+2, N, 3) decoded interpolated shapes
    """
    n_cols = steps + 4
    fig, ax0 = _new_3d_axis(n_cols, 1, figsize=(3 * n_cols, 5))
    point_cloud_on_axis(ax0, np.asarray(shape_from), c="b",
                        title="Training Shape 1")

    dev = params.mean_shape.device

    def on_dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)
    w_from = ssm_project(params, on_dev(shape_from)[None])[0]
    w_to = ssm_project(params, on_dev(shape_to)[None])[0]
    fracs = torch.arange(steps + 2, device=dev) / (steps + 1)
    weights = w_from[None] + fracs[:, None] * (w_to - w_from)[None]
    decoded = ssm_decode(params, weights).cpu().numpy()

    for s, shape in enumerate(decoded):
        _, ax = _new_3d_axis(n_cols, s + 2, fig=fig)
        title = ("Reconstruction 1" if s == 0 else
                 "Reconstruction 2" if s == steps + 1 else
                 f"Interpolation {s}")
        point_cloud_on_axis(ax, shape, c="r", title=title)

    _, ax1 = _new_3d_axis(n_cols, n_cols, fig=fig)
    point_cloud_on_axis(ax1, np.asarray(shape_to), c="b",
                        title="Training Shape 2")
    _finish(fig, savepath, show)
    return decoded


def sample_shapes_to_npz(params: SSMParams, n_samples: int, out_dir: str,
                         generator: torch.Generator | None = None,
                         objects_per_shape: int = 2,
                         draws: torch.Tensor | None = None) -> list[str]:
    """Decode random SSM samples and write per-case shape files
    (SMPL{i:03d}_fixed.npz: the flat point vector split evenly into
    `objects_per_shape` objects, with an identity similarity transform
    stored as flat scale/rotation/translation arrays).

    :return: list of written file paths
    """
    os.makedirs(out_dir, exist_ok=True)
    shapes = _random_decoded(params, n_samples, generator, draws)
    n_pts = shapes.shape[1] // objects_per_shape
    paths = []
    for i, s in enumerate(shapes):
        objs = np.stack([s[j * n_pts:(j + 1) * n_pts]
                         for j in range(objects_per_shape)])
        path = os.path.join(out_dir, f"SMPL{i:03d}_fixed.npz")
        np.savez_compressed(path, shape=objs, scale=np.float32(1.0),
                            rotation=np.eye(3, dtype=np.float32),
                            translation=np.zeros(3, np.float32))
        paths.append(path)
    return paths


def load_shape_npz(path: str):
    """Read a shape file written by sample_shapes_to_npz: returns (shape
    (O, P, 3), transform dict with scale/rotation/translation)."""
    with np.load(path) as z:
        return z["shape"], {"scale": float(z["scale"]),
                            "rotation": z["rotation"],
                            "translation": z["translation"]}
