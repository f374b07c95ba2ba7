"""k-fold cross-validation harness (counterpart of train/cross_val.py).

Per fold: split the dataset, call `train_fn` (which builds a fresh model
for the fold) and `test_fn`, then aggregate the per-fold metric dicts into
cv_results{suffix}.csv. A COPD dataset splits into no training set: every
fold only tests.
"""
from __future__ import annotations

import csv
import os
from typing import Callable, Iterable

import numpy as np

from ..data.dataset import PointDataset, save_split_file


def cross_val_training(ds: PointDataset, split: list[dict], out_dir: str,
                       train_fn: Callable | None,
                       test_fn: Callable | None = None,
                       test_only: bool = False, train_only: bool = False,
                       folds: Iterable[int] | None = None,
                       results_suffix: str = ""):
    """Run k-fold CV.

    :param train_fn: ``train_fn(train_ds, fold_dir, fold)`` — trains and
        saves the fold's model; skipped when `test_only` or when the split
        gives no training set (COPD transfer validation)
    :param test_fn: ``test_fn(val_ds, fold_dir, fold)`` — returns a dict of
        per-class metric arrays; mean and std over folds go to
        ``cv_results{suffix}.csv``
    :param folds: fold indices to run (default: all)
    """
    os.makedirs(out_dir, exist_ok=True)
    split_path = os.path.join(out_dir, "cross_val_split.json")
    # never clobber the record of which cases each fold's model was
    # trained on when re-testing with another split
    if not (test_only and os.path.exists(split_path)):
        save_split_file(split, split_path)
    fold_metrics: list[dict] = []

    for fold in (range(len(split)) if folds is None else folds):
        print(f"------------ FOLD {fold} ----------------------")
        fold_dir = os.path.join(out_dir, f"fold{fold}")
        train_ds, val_ds = ds.split_data_set(split[fold], fold_nr=fold)

        if train_fn is not None and not test_only and train_ds is not None:
            train_fn(train_ds, fold_dir, fold)

        if test_fn is not None and not train_only:
            fold_metrics.append(test_fn(val_ds, fold_dir, fold))

    if fold_metrics:
        write_cv_results(
            os.path.join(out_dir, f"cv_results{results_suffix}.csv"),
            fold_metrics)
    return fold_metrics


def write_cv_results(path: str, fold_metrics: list[dict]) -> None:
    keys = sorted(fold_metrics[0])
    with open(path, "w") as f:
        w = csv.writer(f)
        for k in keys:
            vals = np.stack([np.asarray(m[k], dtype=np.float64)
                             for m in fold_metrics])
            w.writerow([f"mean_{k}"] + list(np.atleast_1d(vals.mean(0))))
            w.writerow([f"std_{k}"] + list(np.atleast_1d(vals.std(0))))
    print(f"wrote {path}")
