"""Dataset statistics: physical size of fissure labels per case
(counterpart of compute_fraction_of_fissures.py; host code):

    python -m fissure_segmentation_tpu_torch.compute_fraction_of_fissures \
        [--data_dir DIR] [--n_synthetic 8] [--output CSV]

Per case, the physical volume (mm^3) and voxel count of each
(regularized) fissure label, plus totals and the fissure fraction of the
image, written to one CSV. Operates on the port's image cases (synthetic,
or a folder of ``*_img.npz`` cases with ``image``/``labels``/``spacing``
arrays).
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np


def fissure_size_stats(labels: np.ndarray, spacing) -> dict:
    """Voxel counts and mm^3 per fissure label of one (D, H, W) labelmap."""
    labels = np.asarray(labels)
    voxel_mm3 = float(np.prod(spacing))
    row = {}
    total_mm3 = 0.0
    total_vox = 0
    for lbl in sorted(int(l) for l in np.unique(labels) if l != 0):
        n = int((labels == lbl).sum())
        row[f"fissure_{lbl}_n_vox"] = n
        row[f"fissure_{lbl}_mm3"] = n * voxel_mm3
        total_vox += n
        total_mm3 += n * voxel_mm3
    row["all_n_vox"] = total_vox
    row["all_mm3"] = total_mm3
    row["total_size_n_vox"] = int(labels.size)
    row["total_size_mm3"] = labels.size * voxel_mm3
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description="fissure size statistics")
    parser.add_argument("--data_dir", default=None,
                        help="folder of *_img.npz cases; default: synthetic")
    parser.add_argument("--n_synthetic", type=int, default=8)
    parser.add_argument("--output", default="results/fissure_sizes.csv")
    args = parser.parse_args(argv)

    rows = []
    if args.data_dir:
        from glob import glob
        for path in sorted(glob(os.path.join(args.data_dir, "*_img.npz"))):
            with np.load(path) as z:
                row = fissure_size_stats(z["labels"], z.get("spacing", (1, 1, 1)))
            row["case"] = os.path.basename(path)
            rows.append(row)
    else:
        from .data.synthetic import make_synthetic_image_case
        for i in range(args.n_synthetic):
            case = make_synthetic_image_case(i)
            row = fissure_size_stats(case["labels"], case["spacing"])
            row["case"] = case["case_id"]
            rows.append(row)

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    keys = ["case"] + sorted({k for r in rows for k in r} - {"case"})
    with open(args.output, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        writer.writeheader()
        writer.writerows(rows)
        mean_row = {"case": "mean"}
        for k in keys[1:]:
            vals = [r[k] for r in rows if k in r]
            mean_row[k] = float(np.mean(vals)) if vals else ""
        writer.writerow(mean_row)
    frac = np.mean([r["all_n_vox"] / r["total_size_n_vox"] for r in rows])
    print(f"wrote {args.output}: {len(rows)} cases, "
          f"mean fissure fraction {frac:.2e}")


if __name__ == "__main__":
    main()
