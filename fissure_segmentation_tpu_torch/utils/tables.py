"""Result aggregation: CSV -> dataframe / LaTeX tables, pareto plots.

Counterpart of reference thesis/tables.py (`csv_to_df:27`, ±-tables `:75`)
and performance_time_plot.py:30-40 (runtime-vs-ASSD pareto scatter).

A copy of the JAX package's utils/tables.py, which the port does not
import (held equal to it by tests/test_torch_repairs.py).
"""
from __future__ import annotations

import csv
import os
from glob import glob

import numpy as np


def read_results_csv(path: str) -> dict[str, list[float]]:
    """Parse a write_results CSV into {row_name: [per-class..., mean]}."""
    out = {}
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0] in ("Class", "Fissure"):
                continue
            try:
                out[row[0]] = [float(v) for v in row[1:]]
            except ValueError:
                continue
    return out


def collect_cv_results(experiment_dir: str, filename: str = "test_results.csv"):
    """Aggregate per-fold result CSVs (mean over folds per metric row)."""
    folds = sorted(glob(os.path.join(experiment_dir, "fold*", "test",
                                     filename))) or \
        sorted(glob(os.path.join(experiment_dir, "fold*", filename)))
    per_fold = [read_results_csv(f) for f in folds]
    if not per_fold:
        return {}
    keys = per_fold[0].keys()
    return {k: np.nanmean([np.asarray(p[k], float) for p in per_fold if k in p],
                          axis=0).tolist() for k in keys}


def pm_table(means: dict, stds: dict, metrics=("Dice", "ASSD", "HD95"),
             precision: int = 2) -> list[list[str]]:
    """mean ± std table rows (thesis/tables.py:75 format)."""
    rows = [["metric"] + [f"class {i}" for i in
                          range(len(next(iter(means.values()))))]]
    for m in metrics:
        mk, sk = f"Mean {m}", f"StdDev {m}"
        if mk not in means:
            continue
        rows.append([m] + [f"{mu:.{precision}f} ± {sd:.{precision}f}"
                           for mu, sd in zip(means[mk], stds.get(sk, means[mk]))])
    return rows


def to_latex(rows: list[list[str]]) -> str:
    """Minimal LaTeX tabular (thesis/tables.py csv->latex path)."""
    ncol = len(rows[0])
    lines = ["\\begin{tabular}{" + "l" * ncol + "}", "\\toprule",
             " & ".join(rows[0]) + " \\\\", "\\midrule"]
    for r in rows[1:]:
        lines.append(" & ".join(str(c) for c in r) + " \\\\")
    lines += ["\\bottomrule", "\\end{tabular}"]
    return "\n".join(lines)


def performance_time_plot(entries: list[dict], path: str,
                          baseline_entries: list[dict] | None = None):
    """Runtime-vs-ASSD pareto scatter (performance_time_plot.py:30-40).

    :param entries: [{'label', 'runtime_s', 'assd_mm'}, ...]
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 5))
    for e in entries:
        ax.scatter(e["runtime_s"], e["assd_mm"], marker="o", s=60)
        ax.annotate(e["label"], (e["runtime_s"], e["assd_mm"]),
                    textcoords="offset points", xytext=(6, 4), fontsize=8)
    for e in baseline_entries or []:
        ax.scatter(e["runtime_s"], e["assd_mm"], marker="x", s=60, c="gray")
        ax.annotate(e["label"], (e["runtime_s"], e["assd_mm"]),
                    textcoords="offset points", xytext=(6, 4), fontsize=8,
                    color="gray")
    ax.set_xscale("log")
    ax.set_xlabel("runtime per case [s]")
    ax.set_ylabel("mean ASSD [mm]")
    ax.grid(alpha=0.3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def collect_experiment_grid(root: str, filename: str = "test_results.csv"):
    """Aggregate a whole experiment grid (thesis/tables.py:93-231
    `get_all_tables`/`seg_table` counterpart).

    Layout: ``root/{experiment}/fold*/test/{filename}`` where experiment
    names follow the reference's ``{kp_mode}_{feature}`` convention (e.g.
    ``foerstner_image``, ``cnn_nofeat``). Returns
    {experiment: {metric_row: [per-class..., mean]}} for every experiment
    that has results.
    """
    out = {}
    for exp_dir in sorted(glob(os.path.join(root, "*"))):
        if not os.path.isdir(exp_dir):
            continue
        res = collect_cv_results(exp_dir, filename=filename)
        if res:
            out[os.path.basename(exp_dir)] = res
    return out


def seg_table(root: str, metrics=("Dice", "ASSD", "SDSD", "HD", "HD95"),
              copd: bool = False, precision: int = 2) -> list[list[str]]:
    """One mean±std row per experiment in the grid, mean-over-classes
    columns per metric (thesis/tables.py:213-231)."""
    filename = f"test_results{'_copd' if copd else ''}.csv"
    grid = collect_experiment_grid(root, filename=filename)
    header = ["experiment"] + list(metrics) + ["% missing"]
    rows = [header]
    for exp, res in grid.items():
        row = [exp]
        for m in metrics:
            mu = res.get(f"Mean {m}")
            sd = res.get(f"StdDev {m}")
            if mu is None:
                row.append("-")
                continue
            row.append(f"{np.nanmean(mu):.{precision}f} ± "
                       f"{np.nanmean(sd if sd is not None else 0):.{precision}f}")
        miss = res.get("proportion missing")
        row.append(f"{100 * np.nanmean(miss):.0f}" if miss is not None else "-")
        rows.append(row)
    return rows


def copd_comparison_table(root: str, metrics=("Dice", "ASSD"),
                          precision: int = 2) -> list[list[str]]:
    """In-distribution vs COPD columns + relative change per experiment
    (thesis/tables.py:640-709 `copd_comparison_table`/`copd_change_table`)."""
    indist = collect_experiment_grid(root, "test_results.csv")
    copd = collect_experiment_grid(root, "test_results_copd.csv")
    header = ["experiment"]
    for m in metrics:
        header += [f"{m}", f"{m} (COPD)", f"{m} change %"]
    rows = [header]
    for exp in indist:
        if exp not in copd:
            continue
        row = [exp]
        for m in metrics:
            a = np.nanmean(indist[exp].get(f"Mean {m}", [np.nan]))
            b = np.nanmean(copd[exp].get(f"Mean {m}", [np.nan]))
            change = (b - a) / a * 100 if np.isfinite(a) and a else np.nan
            row += [f"{a:.{precision}f}", f"{b:.{precision}f}",
                    f"{change:+.1f}"]
        rows.append(row)
    return rows


def comparative_bar_plot(root_per_model: dict, path: str,
                         metric: str = "ASSD"):
    """Grouped bar chart comparing models across experiments
    (thesis/tables.py:233-377 `bar_plot`/`comparative_bar_plot`)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grids = {mdl: collect_experiment_grid(root)
             for mdl, root in root_per_model.items()}
    exps = sorted({e for g in grids.values() for e in g})
    if not exps:
        raise ValueError("no experiment results found")
    width = 0.8 / max(len(grids), 1)
    fig, ax = plt.subplots(figsize=(1.2 + 1.1 * len(exps), 4))
    xs = np.arange(len(exps))
    for i, (mdl, g) in enumerate(grids.items()):
        mus = [np.nanmean(g[e].get(f"Mean {metric}", [np.nan]))
               if e in g else np.nan for e in exps]
        sds = [np.nanmean(g[e].get(f"StdDev {metric}", [0.0]))
               if e in g else 0.0 for e in exps]
        ax.bar(xs + i * width, mus, width=width, yerr=sds, capsize=2,
               label=mdl)
    ax.set_xticks(xs + width * (len(grids) - 1) / 2)
    ax.set_xticklabels(exps, rotation=30, ha="right")
    ax.set_ylabel(metric)
    ax.legend()
    ax.grid(axis="y", alpha=0.3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
