"""Qualitative figure generation: slice overlays and keypoint plots
(counterpart of qualitative_plots.py; host code, matplotlib imported at
the call):

    python -m fissure_segmentation_tpu_torch.qualitative_plots \
        [--output DIR] [--slices S ...] [--seed 0]

renders CT slices with fissure-label overlays, keypoint scatter over
slices, the model-comparison and per-class overlays, the learning-rate
schedules and the runtime-against-ASSD pareto figure of the reference's
published numbers, from the port's synthetic cases.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

CLASS_COLORS = {1: "tab:red", 2: "tab:blue", 3: "tab:green"}


def slice_with_overlay(ax, img: np.ndarray, labels: np.ndarray | None,
                       slice_num: int, slice_dim: int = 0, alpha: float = 1.0):
    """One z/y/x slice with colored label overlay (qualitative.py
    visualize_with_overlay usage)."""
    sl = [slice(None)] * 3
    sl[slice_dim] = slice_num
    ax.imshow(img[tuple(sl)], cmap="gray")
    if labels is not None:
        lab = labels[tuple(sl)]
        for lbl, color in CLASS_COLORS.items():
            ys, xs = np.nonzero(lab == lbl)
            ax.scatter(xs, ys, s=1, c=color, alpha=alpha)
    ax.axis("off")


def plot_keypoints_on_slice(ax, img: np.ndarray, kpts_zyx: np.ndarray,
                            labels: np.ndarray | None, slice_num: int,
                            slice_dim: int = 0, thickness: float = 1.5):
    """Keypoints within `thickness` of a slice (keypoint_plots.py:21-49)."""
    sl = [slice(None)] * 3
    sl[slice_dim] = slice_num
    ax.imshow(img[tuple(sl)], cmap="gray")
    near = np.abs(kpts_zyx[:, slice_dim] - slice_num) < thickness
    pts = kpts_zyx[near]
    axes2d = [a for a in range(3) if a != slice_dim]
    cs = None
    if labels is not None:
        cs = [CLASS_COLORS.get(int(l), "yellow") for l in labels[near]]
    ax.scatter(pts[:, axes2d[1]], pts[:, axes2d[0]], s=2, c=cs or "yellow")
    ax.axis("off")


def cosine_lr_trace(epochs: int, lr: float, t_max: int | None = None,
                    warm_restarts: bool = False,
                    eta_min_frac: float = 0.05) -> np.ndarray:
    """Per-epoch learning-rate trace of the cosine schedules, closed form.

    Counterpart of the reference's thesis/cosine_annealing.py:7-26 figure
    code (which steps torch CosineAnnealingLR / ...WarmRestarts): plain
    cosine matches train/trainer.py:_cosine_lr; warm restarts restart the
    cosine every `t_max` epochs.
    """
    eta_min = lr * eta_min_frac
    e = np.arange(1, epochs + 1, dtype=np.float64)
    if warm_restarts:
        t_max = t_max or (epochs // 4 + 1)
        e = e % t_max
    else:
        t_max = epochs
    return eta_min + (lr - eta_min) * (1 + np.cos(np.pi * e / t_max)) / 2


def plot_lr_schedules(out_dir: str, epochs: int = 1000, lr: float = 1e-3,
                      t_max: int | None = None) -> None:
    """The thesis cosine-annealing figures (cosine_annealing.py __main__):
    plain / warm-restarts / both-in-one."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    traces = {"cosine_annealing": [(False, "cosine annealing")],
              "cosine_annealing_warm_restarts": [(True, "with warm restarts")],
              "cosine_annealing_both": [(False, "cosine annealing"),
                                        (True, "with warm restarts")]}
    for name, spec in traces.items():
        fig = plt.figure(figsize=(5, 3.5))
        for wr, label in spec:
            plt.plot(cosine_lr_trace(epochs, lr, t_max, warm_restarts=wr),
                     label=label)
        if len(spec) > 1:
            plt.legend(loc="upper right")
        plt.xlabel("epoch")
        plt.ylabel("learning rate")
        fig.savefig(os.path.join(out_dir, f"{name}.png"), dpi=150,
                    bbox_inches="tight")
        plt.close(fig)


def slice_3d(img: np.ndarray, slice_num: int, slice_dim: int):
    """One slice along `slice_dim` (reference qualitative.py:30-32)."""
    index = tuple([slice(None)] * slice_dim + [slice_num])
    return img[index]


def fissure_window_level(img: np.ndarray, mask: np.ndarray | None = None,
                         low: float = -1024, high: float = -600) -> np.ndarray:
    """Clamp HU to the fissure window; out-of-mask voxels -> high+1
    (reference qualitative.py:35-40)."""
    out = np.clip(np.asarray(img, np.float32), low, high)
    if mask is not None:
        out[np.asarray(mask) == 0] = high + 1
    return out


def crop_to_lung_indices(img: np.ndarray):
    """Tight bounding slices of the non-max (in-lung) region
    (reference qualitative.py:43-46). Meaningful after fissure_window_level
    with a mask set out-of-lung voxels to the image maximum; a constant
    image yields full-range slices instead of crashing."""
    nz = np.nonzero(img != img.max())
    if any(len(d) == 0 for d in nz):
        return tuple(slice(0, s) for s in img.shape)
    return tuple(slice(int(d.min()), int(d.max()) + 1) for d in nz)


def multi_model_overlay(img: np.ndarray, label_maps: dict, slice_num: int,
                        slice_dim: int = 2, out_dir: str = ".",
                        fig_name: str = "keypoint_qualitative_comparison",
                        patid: str = "case", alpha: float = 0.5):
    """One CT slice with each model's binarized prediction in its own color
    (reference qualitative.py:49-82) + a separate legend figure and an
    unlabeled slice for side-by-side layout."""
    import matplotlib
    import matplotlib.pyplot as plt
    from .utils.visualization import legend_figure, visualize_with_overlay

    img_slice = slice_3d(img, slice_num, slice_dim)
    combined = np.zeros_like(img_slice, dtype=int)
    for i, label in enumerate(label_maps.values()):
        combined[slice_3d(np.asarray(label), slice_num, slice_dim) != 0] = i + 1

    colors = matplotlib.colormaps["tab10"].colors
    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots()
    visualize_with_overlay(img_slice, combined, alpha=alpha, ax=ax,
                           colors=colors)
    fig.savefig(os.path.join(out_dir, f"{fig_name}_{patid}_slice{slice_num}.png"),
                dpi=150, bbox_inches="tight")
    plt.close(fig)
    legend_figure(list(label_maps.keys()), colors[:len(label_maps)],
                  path=os.path.join(out_dir, f"{fig_name}_legend.png"))
    fig, ax = plt.subplots()
    visualize_with_overlay(img_slice, np.zeros_like(combined), ax=ax)
    fig.savefig(os.path.join(out_dir, f"{patid}_slice{slice_num}.png"),
                dpi=150, bbox_inches="tight")
    plt.close(fig)


def multi_class_overlay(img: np.ndarray, label_map: np.ndarray,
                        model_name: str, patid: str, slices,
                        slice_dim: int = 2, out_dir: str = ".",
                        spacing=None, alpha: float = 0.5,
                        class_names=("LOF", "ROF", "RHF"),
                        mask: np.ndarray | None = None,
                        low: float = -1024, high: float = -600):
    """Per-class fissure overlays on lung-cropped, fissure-windowed slices
    (reference qualitative.py:85-126). With `mask`, out-of-lung voxels are
    set just above the window (fissure_window_level) which is also what
    makes the subsequent lung crop tight."""
    import matplotlib.pyplot as plt
    from .utils.visualization import legend_figure, visualize_with_overlay

    if mask is not None:
        img = fissure_window_level(img, mask, low=low, high=high)
    crop = crop_to_lung_indices(img)
    img_c = img[crop]
    lab_c = np.asarray(label_map)[crop]
    spacing2d = None
    if spacing is not None:
        spacing2d = [s for d, s in enumerate(spacing) if d != slice_dim]
    colors = [CLASS_COLORS[i + 1] for i in range(len(class_names))]
    os.makedirs(out_dir, exist_ok=True)
    for slice_num in slices:
        s_c = slice_num - crop[slice_dim].start
        if not 0 <= s_c < img_c.shape[slice_dim]:
            continue
        img_slice = slice_3d(img_c, s_c, slice_dim)
        lab_slice = slice_3d(lab_c, s_c, slice_dim)
        fig, ax = plt.subplots()
        visualize_with_overlay(img_slice, lab_slice, alpha=alpha, ax=ax,
                               colors=colors, spacing=spacing2d)
        fig.savefig(os.path.join(
            out_dir, f"{model_name}_{patid}_slice{slice_num}.png"),
            dpi=150, bbox_inches="tight")
        plt.close(fig)
    legend_figure(class_names, colors,
                  path=os.path.join(out_dir, "classes_legend.png"))


def pareto_frontier(xs, ys, max_x: bool = True, max_y: bool = True):
    """Pareto-efficient subset of (x, y) pairs (reference
    performance_time_plot.py:9-27 selection process)."""
    pairs = sorted(zip(xs, ys), reverse=max_y)
    front = [pairs[0]]
    for x, y in pairs[1:]:
        if (y >= front[-1][1]) if max_y else (y <= front[-1][1]):
            front.append((x, y))
    return front


def performance_time_plot(entries: dict, out_path: str,
                          xlabel: str = "runtime per case [s]",
                          ylabel: str = "mean ASSD [mm]"):
    """Runtime-vs-quality scatter with pareto frontier (reference
    performance_time_plot.py:30-60).

    :param entries: {model name: (runtime_s, assd_mm)}
    """
    import matplotlib
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    colors = matplotlib.colormaps["tab10"].colors
    xs, ys = [], []
    for i, (name, (t, a)) in enumerate(entries.items()):
        ax.scatter(t, a, color=colors[i % len(colors)], label=name, s=60)
        xs.append(t)
        ys.append(a)
    front = pareto_frontier(xs, ys, max_x=False, max_y=False)
    ax.plot([p[0] for p in front], [p[1] for p in front], zorder=0,
            c="gray", linestyle="--", label="pareto front")
    ax.set_xscale("log")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


# the reference pareto figure's published numbers
# (performance_time_plot.py:30-40: runtime s/case, ASSD mm on node2)
REFERENCE_PARETO = {
    "DGCNN (Förstner)": (1.352, 3.54),
    "DGCNN (Hessian)": (36.81, 5.05),
    "DGCNN (CNN)": (6.786, 3.07),
    "DGCNN+PC-AE (Förstner)": (0.418, 7.44),
    "DGCNN+PC-AE (Hessian)": (34.98, 8.66),
    "DGCNN+PC-AE (CNN)": (0.869, 5.05),
    "nnU-Net": (39.82, 2.39),
}


def main(argv=None):
    parser = argparse.ArgumentParser(description="qualitative figures")
    parser.add_argument("--output", default="results/plots/qualitative")
    parser.add_argument("--slices", type=int, nargs="+", default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .data.synthetic import make_synthetic_case, make_synthetic_image_case
    from .utils.coords import kpts_to_world

    os.makedirs(args.output, exist_ok=True)
    case = make_synthetic_image_case(args.seed)
    d = case["image"].shape[0]
    slices = args.slices or [d // 3, d // 2, 2 * d // 3]

    fig, axes = plt.subplots(1, len(slices), figsize=(4 * len(slices), 4))
    for ax, s in zip(np.atleast_1d(axes), slices):
        slice_with_overlay(ax, case["image"], case["labels"], s)
    fig.savefig(os.path.join(args.output, "fissure_overlay.png"), dpi=150,
                bbox_inches="tight")
    plt.close(fig)

    pc = make_synthetic_case(args.seed, n_points=4000, with_feature=False)
    world = np.asarray(kpts_to_world(pc["coords"], pc["shape"]))  # xyz
    kpts_zyx = world[:, ::-1] * np.asarray(case["image"].shape) / \
        np.asarray(pc["shape"])
    fig, axes = plt.subplots(1, len(slices), figsize=(4 * len(slices), 4))
    for ax, s in zip(np.atleast_1d(axes), slices):
        plot_keypoints_on_slice(ax, case["image"], kpts_zyx, pc["labels"], s)
    fig.savefig(os.path.join(args.output, "keypoints.png"), dpi=150,
                bbox_inches="tight")
    plt.close(fig)

    # model-comparison + per-class overlay figures (qualitative.py:49-126)
    labels = np.asarray(case["labels"])
    multi_model_overlay(np.asarray(case["image"]),
                        {"DGCNN": labels != 0,
                         "PointNet": np.roll(labels != 0, 2, axis=0)},
                        slices[len(slices) // 2], slice_dim=0,
                        out_dir=args.output, patid="synthetic")
    # HU-like rescale (preprocess_dataset.py does img*1000 for synthetic)
    # synthetic lungs sit around -600 "HU" with +350 fissure sheets, so a
    # wider window than the real-CT default keeps the structure visible
    multi_class_overlay(np.asarray(case["image"]) * 1000.0, labels, "DGCNN",
                        "synthetic", slices, slice_dim=0,
                        out_dir=args.output,
                        mask=np.asarray(case["lung_mask"]),
                        low=-1100, high=-100)

    # pareto figure over the reference's published numbers
    performance_time_plot(dict(REFERENCE_PARETO),
                          os.path.join(args.output, "performance_time.png"))

    plot_lr_schedules(args.output)
    print(f"wrote figures to {args.output}")


if __name__ == "__main__":
    main()
