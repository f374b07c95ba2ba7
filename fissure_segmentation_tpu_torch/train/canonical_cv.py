"""The canonical 5-fold synthetic cross-validation, run by the port and held
against the JAX package's committed run.

    python -m fissure_segmentation_tpu_torch.train.canonical_cv \\
        --output OUT [--reference results/demo_tpu_canonical_cv5]

It trains and tests every fold with the port's train_point_seg entry,
under the flags of the reference run's commandline_args.json (synthetic
cases, DGCNN static, bf16 (`--amp true`), k = 40, 2048 points, batch 16,
800 epochs of one step, cosine schedule; `--knn_recall` where the run set
it: results/demo_tpu_canonical_cv5_knn09 trains with 0.9) and its
cross_val_split.json,
then compares the two cv_results.csv files: for each class's mean Dice
(classes 0-3) and each fissure's mean ASSD (1-3), the port's mean over
folds must lie within BOUND_STDS of the reference's cross-fold standard
deviation of the reference's mean. It writes OUT/comparison.json (every
comparison with its gap and bound, and "pass") and prints it. It also
reports the paired per-case Dice difference (dice_per_instance.csv, the
same validation cases in both runs) for the record. Runs on the card
(train_point_seg's rule). The port's run on an H100 is committed as CSVs
under results/torch_h100_canonical_cv5 (`compare` re-reads it), the
knn09 run under results/torch_h100_canonical_cv5_knn09.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np

REFERENCE = "results/demo_tpu_canonical_cv5"
BOUND_STDS = 2.0
# the reference flags that train_point_seg's parser takes, in argv form
FLAGS = ("ds", "pts", "k", "batch", "epochs", "lr", "wd", "loss",
         "scheduler", "amp", "data", "model", "knn_recall")
SWITCHES = ("coords", "static", "exclude_rhf", "binary")


def reference_argv(ref_args: dict) -> list:
    argv = []
    for key in FLAGS:
        value = ref_args.get(key)
        if value is None:        # the parser's default
            continue
        argv += [f"--{key}", str(value).lower() if isinstance(value, bool)
                 else str(value)]
    for key in SWITCHES:
        if ref_args.get(key):
            argv.append(f"--{key}")
    return argv


def read_cv(path: str) -> dict:
    with open(path) as f:
        return {r[0]: np.asarray(r[1:], float) for r in csv.reader(f) if r}


def _per_case(fold_dir: str, name: str) -> dict:
    with open(os.path.join(fold_dir, "test", f"{name}_per_instance.csv")) as f:
        rows = list(csv.reader(f))
    return {r[0]: np.asarray(r[1:4], float) for r in rows[1:]}


def compare(ours_dir: str, ref_dir: str, n_folds: int) -> dict:
    """The bound on each class's Dice and each fissure's ASSD, and the
    paired per-case Dice differences."""
    ours = read_cv(os.path.join(ours_dir, "cv_results.csv"))
    ref = read_cv(os.path.join(ref_dir, "cv_results.csv"))
    rows, ok = [], True
    for metric, first in (("dice", 0), ("assd", 1)):
        for i, (m, r, s) in enumerate(zip(ours[f"mean_{metric}"],
                                          ref[f"mean_{metric}"],
                                          ref[f"std_{metric}"])):
            gap, bound = float(abs(m - r)), float(BOUND_STDS * s)
            rows.append({"metric": metric, "class": first + i,
                         "port": float(m), "jax": float(r),
                         "jax_fold_std": float(s), "gap": gap,
                         "bound": bound, "within": gap <= bound})
            ok &= gap <= bound
    diffs = []
    for fold in range(n_folds):
        a = _per_case(os.path.join(ours_dir, f"fold{fold}"), "dice")
        b = _per_case(os.path.join(ref_dir, f"fold{fold}"), "dice")
        diffs += [a[c] - b[c] for c in sorted(a) if c in b]
    diffs = np.asarray(diffs)
    paired = {"cases": int(len(diffs)),
              "mean_diff": diffs.mean(0).tolist(),
              "std_diff": diffs.std(0, ddof=1).tolist()
              if len(diffs) > 1 else None}
    return {"bound": f"|port - jax| <= {BOUND_STDS} x jax cross-fold std",
            "comparisons": rows, "paired_dice": paired, "pass": bool(ok)}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--output", required=True)
    ap.add_argument("--reference", default=REFERENCE)
    opts = ap.parse_args(argv)
    from .. import train_point_seg
    with open(os.path.join(opts.reference, "commandline_args.json")) as f:
        ref_args = json.load(f)
    run_argv = reference_argv(ref_args) + [
        "--split", os.path.join(opts.reference, "cross_val_split.json"),
        "--output", opts.output]
    print("train_point_seg", " ".join(run_argv), flush=True)
    train_point_seg.main(run_argv, device=device)
    with open(os.path.join(opts.reference, "cross_val_split.json")) as f:
        n_folds = len(json.load(f))
    result = compare(opts.output, opts.reference, n_folds)
    with open(os.path.join(opts.output, "comparison.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
