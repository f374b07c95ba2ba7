"""Quality of the Hessian fissure-enhancement filter (counterpart of
keypoints/enhancement_eval.py): ROC-AUC and average precision of the
enhancement image against the GT fissure voxels (per fissure label, all,
and all but the RHF), and Dice, recall and accuracy over a threshold
sweep, with the plots where matplotlib is installed.

The JAX package scores with scikit-learn. The port computes the same two
numbers in numpy (`roc_auc`, `average_precision`: scikit-learn's
definitions, ties in the scores handled as it handles them), so it needs
neither package; the ROC curve of the plot is the same numpy pass.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.visualization import matplotlib_available


def _binary_clf_curve(gt: np.ndarray, scores: np.ndarray):
    """Cumulative false and true positives at each distinct score,
    descending (scikit-learn's _binary_clf_curve)."""
    order = np.argsort(scores, kind="mergesort")[::-1]
    s, y = scores[order], gt[order].astype(np.float64)
    distinct = np.where(np.diff(s))[0]
    ends = np.r_[distinct, y.size - 1]
    tps = np.cumsum(y)[ends]
    fps = 1 + ends - tps
    return fps, tps, s[ends]


def roc_curve(gt: np.ndarray, scores: np.ndarray):
    """(fpr, tpr), starting at (0, 0), one point a distinct score."""
    fps, tps, _ = _binary_clf_curve(gt, scores)
    fps, tps = np.r_[0, fps], np.r_[0, tps]
    return fps / fps[-1], tps / tps[-1]


def roc_auc(gt: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve, by the trapezoidal rule."""
    fpr, tpr = roc_curve(gt, scores)
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def average_precision(gt: np.ndarray, scores: np.ndarray) -> float:
    """sum_n (R_n - R_{n-1}) P_n over the distinct scores, descending."""
    fps, tps, _ = _binary_clf_curve(gt, scores)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def threshold_curves(pred_values: np.ndarray, labels: np.ndarray,
                     out_dir: str | None = None, show: bool = False):
    """ROC-AUC and average precision per label group.

    :param pred_values: (D, H, W) enhancement image (higher = fissure)
    :param labels: (D, H, W) int GT fissure labels
    :return: (roc_auc dict, avg_prec dict) keyed by label int, 'all' and
        'all_but_RHF'; a group with no positive or no negative voxel is
        left out
    """
    labels = np.asarray(labels).ravel()
    pred = np.asarray(pred_values, np.float64).ravel()
    groups = [int(v) for v in np.unique(labels) if v != 0]
    groups += ["all", "all_but_RHF"]
    plots = (out_dir is not None or show) and matplotlib_available()

    aucs, aps, curves = {}, {}, {}
    for lbl in groups:
        if lbl == "all":
            gt = labels != 0
        elif lbl == "all_but_RHF":
            gt = (labels != 0) & (labels != 3)
        else:
            gt = labels == lbl
        if not gt.any() or gt.all():
            continue
        aucs[lbl] = roc_auc(gt, pred)
        aps[lbl] = average_precision(gt, pred)
        if plots:
            fpr, tpr = roc_curve(gt, pred)
            step = max(1, len(fpr) // 2000)   # decimated for the plot
            curves[lbl] = (fpr[::step], tpr[::step])

    if plots:
        from ..utils.visualization import _plt
        plt = _plt()
        fig, ax = plt.subplots()
        for lbl, (fpr, tpr) in curves.items():
            ax.plot(fpr, tpr, label=f"{lbl} (AUC={aucs[lbl]:.3f})")
        ax.plot([0, 1], [0, 1], "k--", lw=0.5)
        ax.set_xlabel("false positive rate")
        ax.set_ylabel("true positive rate")
        ax.legend()
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            fig.savefig(os.path.join(out_dir, "roc.png"), dpi=300)
        if show:  # pragma: no cover - interactive
            plt.show()
        plt.close(fig)
    return aucs, aps


def fissure_candidates(enhanced: np.ndarray, gt_fissures: np.ndarray,
                       fixed_thresh: float | None = None, show: bool = False,
                       img_dir: str | None = None, img_prefix: str = ""):
    """Threshold sweep of the enhancement image: per threshold t the
    prediction is `enhanced > t`; foreground Dice, recall and accuracy,
    and the ROC/AP summary of `threshold_curves`.

    :return: (roc_auc, avg_prec, thresholds (T,), dice (T,), recall (T,),
        accuracy (T,))
    """
    enhanced = np.asarray(enhanced)
    gt_bin = np.asarray(gt_fissures) != 0
    aucs, aps = threshold_curves(enhanced, np.asarray(gt_fissures),
                                 out_dir=img_dir, show=show)

    thresholds = (np.linspace(0.0, 1.0, 21) if fixed_thresh is None
                  else np.asarray([fixed_thresh]))
    n_gt = gt_bin.sum()
    n_vox = gt_bin.size
    dices, recalls, accs = [], [], []
    for t in thresholds:
        pred = enhanced > t
        tp = np.count_nonzero(pred & gt_bin)
        n_pred = np.count_nonzero(pred)
        dices.append(2.0 * tp / max(n_pred + n_gt, 1))
        recalls.append(tp / max(n_gt, 1))
        accs.append(1.0 - (n_pred + n_gt - 2 * tp) / n_vox)

    if (img_dir is not None or show) and matplotlib_available():
        from ..utils.visualization import _plt
        plt = _plt()
        fig, ax = plt.subplots()
        ax.plot(thresholds, recalls, label="recall")
        ax.plot(thresholds, dices, label="dice")
        ax.plot(thresholds, accs, label="accuracy")
        ax.set_title("thresholding fissure-enhanced image")
        ax.set_xlabel("threshold")
        ax.legend()
        if img_dir is not None:
            os.makedirs(img_dir, exist_ok=True)
            fig.savefig(os.path.join(
                img_dir, f"{img_prefix}metrics_per_threshold.png"),
                dpi=300, bbox_inches="tight")
        if show:  # pragma: no cover - interactive
            plt.show()
        plt.close(fig)

    return (aucs, aps, thresholds, np.asarray(dices), np.asarray(recalls),
            np.asarray(accs))
