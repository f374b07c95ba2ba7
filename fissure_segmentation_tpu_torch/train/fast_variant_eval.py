"""Exact-versus-fast accuracy of the fast serving variant's model knobs
(counterpart of scripts/eval_fast_variant.py).

    python -m fissure_segmentation_tpu_torch.train.fast_variant_eval RUN_DIR

Runs the canonical synthetic evaluation (each fold's validation cases of
RUN_DIR/cross_val_split.json through `train/evaluation.py:test_pipeline`)
twice with each fold's own trained weights (RUN_DIR/fold*/model.pt, or a
JAX model.fst):

  exact:  float32 compute, exact kNN graphs
  fast:   bfloat16 compute, knn_recall=0.9 graphs (the approximate
          top-k's fused row selection on the card)

and writes RUN_DIR/fast_variant_eval/deltas.csv (metric, exact, fast,
delta: the mean over folds of each fold's mean over fissures, Dice without
the background) and deltas_per_fold.csv, in the JAX script's columns. The
fast variant's third knob, `approx_top_k` on the keypoint detector, never
enters this protocol (keypoints are dataset inputs). Runs on the card
unless `main` is given ``device="cpu"``.
"""
from __future__ import annotations

import os
import sys

import numpy as np

METRICS = ("dice", "assd", "hd")
VARIANTS = {"exact": dict(dtype=None, knn_recall=None),
            "fast": dict(dtype="bfloat16", knn_recall=0.9)}


def variant(model, dtype, knn_recall):
    """The fold's model rebuilt with another compute dtype and graph
    recall, its weights copied."""
    config = {k: v for k, v in model.config.items()
              if k not in ("dtype", "knn_recall")}
    other = type(model)(**config, dtype=dtype, knn_recall=knn_recall)
    other.load_state_dict(model.state_dict())
    return other.eval()


def fold_means(res: dict) -> dict:
    """A test_pipeline result's mean over fissures (Dice without the
    background), as the JAX script reduces it."""
    out = {}
    for metric in METRICS:
        v = np.asarray(res[metric], float)
        if metric == "dice":
            v = v[..., 1:]
        out[metric] = float(np.nanmean(v))
    return out


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run_dir = argv[0] if argv else "results/torch_h100_canonical_cv5_knn09"
    from ..data.dataset import PointDataset, load_split_file
    from ..data.synthetic import make_synthetic_dataset
    from ..models import load_fold_model
    from ..utils.device import resolve_device
    from .evaluation import test_pipeline
    dev = resolve_device(device, "fast_variant_eval")
    cases = make_synthetic_dataset(20, n_points=8000, gt_surfaces=True)
    ds = PointDataset(cases, sample_points=2048)
    split = load_split_file(os.path.join(run_dir, "cross_val_split.json"))
    out_root = os.path.join(run_dir, "fast_variant_eval")
    acc = {name: {m: [] for m in METRICS} for name in VARIANTS}
    for fold in range(len(split)):
        _, val_ds = ds.split_data_set(split[fold], fold_nr=fold)
        val_ds.do_augmentation = False
        model = load_fold_model(os.path.join(run_dir, f"fold{fold}"))
        for name, knobs in VARIANTS.items():
            res = test_pipeline(
                val_ds, variant(model, **knobs).to(dev),
                os.path.join(out_root, name, f"fold{fold}"),
                sample_points=2048, export_artifacts=False, device=dev)
            for metric, v in fold_means(res).items():
                acc[name][metric].append(v)
        print(f"fold {fold}: exact dice {acc['exact']['dice'][-1]:.4f} vs "
              f"fast {acc['fast']['dice'][-1]:.4f}", flush=True)
    n_cases = sum(len(s["val"]) for s in split)
    with open(os.path.join(out_root, "deltas.csv"), "w") as fh:
        fh.write(f"# {len(split)}-fold CV, {n_cases} cases\n")
        fh.write("metric,exact,fast,delta\n")
        for metric in METRICS:
            e = float(np.mean(acc["exact"][metric]))
            f = float(np.mean(acc["fast"][metric]))
            fh.write(f"{metric},{e:.6f},{f:.6f},{f - e:.6f}\n")
            print(f"{metric}: exact {e:.6f} fast {f:.6f} delta {f - e:+.6f}",
                  flush=True)
    with open(os.path.join(out_root, "deltas_per_fold.csv"), "w") as fh:
        fh.write("fold,metric,exact,fast,delta\n")
        for fold in range(len(split)):
            for metric in METRICS:
                e = acc["exact"][metric][fold]
                f = acc["fast"][metric][fold]
                fh.write(f"{fold},{metric},{e:.6f},{f:.6f},{f - e:.6f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
