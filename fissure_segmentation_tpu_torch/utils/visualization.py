"""The test pipeline's point-cloud plot, the trainer's per-epoch figure
and the figure scripts' slice overlays (copies of `plot_point_cloud`,
`point_seg_visualization`, `visualize_with_overlay`, `legend_figure` and
their helpers from the JAX package's utils/visualization.py, held equal to
the originals by tests/test_torch_repairs.py,
tests/test_torch_baselines.py and tests/test_torch_parallel_train.py).

matplotlib is imported at the call, never with the module: a machine
without it (`matplotlib_available()` is False) runs everything else, and the
caller skips the plots.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np

_FISSURE_COLORS = {1: "tab:red", 2: "tab:blue", 3: "tab:green",
                   4: "tab:orange", 5: "tab:purple"}


def matplotlib_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def color_for_label(lbl: int) -> str:
    return _FISSURE_COLORS.get(int(lbl), "tab:gray")


def point_cloud_on_axis(ax, pc: np.ndarray, c=None, label: str = "",
                        alpha: float = 1.0, s: float = 1.0, cmap=None,
                        title: str = ""):
    """pc: (N, 3) xyz."""
    pc = np.asarray(pc)
    ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], c=c, label=label, alpha=alpha,
               s=s, cmap=cmap)
    if title:
        ax.set_title(title)
    if label:
        ax.legend()


def plot_point_cloud(pc: np.ndarray, labels: np.ndarray | None = None,
                     path: str | None = None, show: bool = False,
                     title: str = ""):
    """Labeled keypoint cloud scatter (per-fissure colors)."""
    plt = _plt()
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    pc = np.asarray(pc)
    if labels is None:
        point_cloud_on_axis(ax, pc, c="tab:gray")
    else:
        labels = np.asarray(labels)
        for lbl in np.unique(labels):
            mask = labels == lbl
            point_cloud_on_axis(ax, pc[mask],
                                c=color_for_label(lbl) if lbl else "lightgray",
                                label=f"label {lbl}", alpha=0.6 if lbl else 0.1)
    ax.set_title(title)
    _finish(fig, path, show)


def _first_leaf(tree):
    """The first array of a nested dict/tuple/list (jax.tree.leaves order:
    dict keys sorted)."""
    if isinstance(tree, dict):
        return _first_leaf(tree[sorted(tree)[0]])
    if isinstance(tree, (tuple, list)):
        return _first_leaf(tree[0])
    return tree


def point_seg_visualization(x: np.ndarray, y, out, epoch: int, out_dir: str):
    """The trainer's per-epoch visualization (the reference ModelTrainer's
    `visualization_fn` hook): ground truth against predicted labels of the
    first validation cloud, written to
    `<out_dir>/visualizations/epoch{N}.png`; nothing where matplotlib does
    not import.

    :param x: (B, N, F) validation batch, the first 3 features xyz
    :param y: (B, N) int labels (nested targets: the first leaf)
    :param out: (B, N, C) logits (nested outputs: the first leaf)
    """
    if not matplotlib_available():
        return
    plt = _plt()
    y = _first_leaf(y)
    out = _first_leaf(out)
    pc = np.asarray(x)[0, :, :3]
    gt = np.asarray(y)[0]
    pred = np.argmax(np.asarray(out)[0], axis=-1)
    fig = plt.figure(figsize=(10, 5))
    for i, (lab, title) in enumerate([(gt, "ground truth"),
                                      (pred, f"prediction (epoch {epoch})")]):
        ax = fig.add_subplot(1, 2, i + 1, projection="3d")
        for lbl in np.unique(lab):
            m = lab == lbl
            point_cloud_on_axis(ax, pc[m],
                                c=color_for_label(lbl) if lbl else "lightgray",
                                alpha=0.6 if lbl else 0.1, title=title)
    path = os.path.join(out_dir, "visualizations", f"epoch{epoch}.png")
    _finish(fig, path, show=False)


def _finish(fig, path, show):
    plt = _plt()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=120, bbox_inches="tight")
    if show:  # pragma: no cover - interactive
        plt.show()
    plt.close(fig)


def visualize_with_overlay(image: np.ndarray, segmentation: np.ndarray,
                           title: str = "", alpha: float = 0.5, ax=None,
                           path: str | None = None, show: bool = False,
                           colors=None, spacing=None):
    """2-D image + translucent label overlay (visualization.py:78-113).

    :param colors: optional sequence of matplotlib colors; label L uses
        colors[L-1] (reference qualitative.py:73,116 passes explicit
        per-model / per-class colors); default is color_for_label
    :param spacing: optional (row, col) pixel spacing -> anisotropic aspect
    """
    plt = _plt()
    fig = None
    if ax is None:
        fig, ax = plt.subplots()
    aspect = 1.0 if spacing is None else spacing[0] / spacing[1]
    ax.imshow(np.asarray(image), cmap="gray", aspect=aspect)
    seg = np.asarray(segmentation)
    overlay = np.zeros((*seg.shape, 4), np.float32)
    from matplotlib.colors import to_rgba
    for lbl in np.unique(seg):
        if lbl == 0:
            continue
        color = (colors[(int(lbl) - 1) % len(colors)] if colors is not None
                 else color_for_label(lbl))
        overlay[seg == lbl] = to_rgba(color, alpha)
    ax.imshow(overlay, aspect=aspect)
    ax.set_title(title)
    ax.axis("off")
    if fig is not None:
        _finish(fig, path, show)
    return ax


def legend_figure(labels, colors, path: str | None = None, show: bool = False):
    """Standalone color legend (reference visualization.py legend_figure,
    used by qualitative.py:76,120)."""
    plt = _plt()
    from matplotlib.patches import Patch
    fig, ax = plt.subplots(figsize=(2, 0.4 * len(labels) + 0.4))
    handles = [Patch(color=c, label=l) for l, c in zip(labels, colors)]
    ax.legend(handles=handles, loc="center", frameon=False)
    ax.axis("off")
    _finish(fig, path, show)
