"""Dataset preprocessing entry point (counterpart of the JAX package's
preprocess_dataset.py):

    python -m fissure_segmentation_tpu_torch.preprocess_dataset \\
        --synthetic 2 --output OUT [--kp_mode foerstner|noisy|cnn|enhancement]
        [--feature mind|mind_ssc|image|enhancement] [--cnn_model M.fst]

Per case: crop, flip and clamp the CT, derive the GT (fissures, lung mask,
the left/right lung halves), then the four label steps (Poisson
regularization, masking, lobes, keypoints and features), writing the same
files and npz keys as the JAX entry (``{case}_img_{seq}.npz``,
``{case}_mesh_{seq}/``, ``{case}_points_{seq}.npz``), so either package's
trainer reads the other's output. Input: a folder of ``{case}_raw.npz``
(``image`` (D, H, W) HU, ``lobes`` (D, H, W), optional ``spacing``), or
``--synthetic N`` demo cases. `--evaluate_enhancement` scores the Hessian
enhancement filter over the processed ``*_img_*.npz`` cases.

Everything runs on the CUDA card; without one it raises, unless the caller
of `main` or `process_case` passes ``device="cpu"`` (as the tests do).
"""
from __future__ import annotations

import argparse
import csv
import os
import sys
from glob import glob

import numpy as np
import torch

from .data.dataset import save_case_npz
from .preprocess.labels import binary_lung_mask_to_left_right
from .preprocess.pipeline import (EXCLUDE_LIST_V1, label_pipeline_case,
                                  preprocess_totalsegmentator_case)
from .utils.device import resolve_device
from .utils.profiling import stage


def process_case(img, lobes, spacing, out_dir: str, case: str,
                 sequence: str = "fixed", kp_mode: str = "foerstner",
                 cnn_model_path: str | None = None,
                 feature_mode: str | None = None, legacy_v1: bool = False,
                 device=None, stages: dict | None = None,
                 generator: torch.Generator | None = None,
                 draws: dict | None = None) -> dict:
    """One raw case -> ``{case}_img_{seq}.npz`` (image, lobes, fissures,
    lung_mask, mask_lr, spacing), the meshes and ``{case}_points_{seq}.npz``.

    :param device: the card unless asked for the CPU
    :param stages: optional dict of synced stage seconds ("crop_gt",
        "mask_lr", "write", and label_pipeline_case's)
    :param generator, draws: the keypoints' random draws
    :return: label_pipeline_case's dict
    """
    dev = resolve_device(device, "process_case")
    with stage(stages, "crop_gt", dev):
        pre = preprocess_totalsegmentator_case(img, lobes,
                                               legacy_v1=legacy_v1,
                                               device=dev)
    with stage(stages, "mask_lr", dev):
        mask_lr = binary_lung_mask_to_left_right(pre["lung_mask"],
                                                 device=dev)
    with stage(stages, "write", dev):
        np.savez_compressed(
            os.path.join(out_dir, f"{case}_img_{sequence}.npz"),
            image=pre["image"], lobes=pre["lobes"], fissures=pre["fissures"],
            lung_mask=pre["lung_mask"], mask_lr=mask_lr,
            spacing=np.asarray(spacing, np.float32))
    out = label_pipeline_case(pre["image"], pre["fissures"],
                              pre["lung_mask"], out_dir, case, sequence,
                              kp_mode=kp_mode, spacing=spacing,
                              cnn_model_path=cnn_model_path,
                              feature_mode=feature_mode, device=dev,
                              stages=stages, generator=generator, draws=draws)
    if out.get("points") is not None:
        with stage(stages, "write", dev):
            save_case_npz(out["points"], out_dir)
    return out


def evaluate_enhancement(folder: str, device=None) -> None:
    """The Hessian enhancement's quality over the processed cases: per case
    ROC-AUC, AP and the Dice threshold sweep (plots where matplotlib is
    installed), and ``enhancement_eval/enhancement_eval.csv``."""
    from .keypoints.enhancement_eval import fissure_candidates
    from .keypoints.hessian import hessian_fissure_enhancement

    dev = resolve_device(device, "evaluate_enhancement")
    files = sorted(glob(os.path.join(folder, "*_img_*.npz")))
    if not files:
        raise FileNotFoundError(f"no *_img_*.npz cases in {folder}")
    eval_dir = os.path.join(folder, "enhancement_eval")
    os.makedirs(eval_dir, exist_ok=True)
    rows = [["case", "roc_auc_all", "avg_prec_all", "best_threshold",
             "best_dice"]]
    for path in files:
        case = os.path.basename(path).split("_img_")[0]
        with np.load(path) as z:
            img, fissures = z["image"], z["fissures"]
        enhanced = hessian_fissure_enhancement(
            torch.as_tensor(img, device=dev), fissure_mu=-313.5,
            fissure_sigma=62.6).cpu().numpy()
        roc_auc, avg_prec, th, dice, _, _ = fissure_candidates(
            enhanced, fissures, img_dir=eval_dir, img_prefix=f"{case}_")
        auc, ap = roc_auc.get("all"), avg_prec.get("all")
        if auc is None:
            # no fissure voxel, or only fissure voxels: NaN, go on
            print(f"{case}: degenerate fissure GT, skipped")
            rows.append([case, float("nan"), float("nan"), float("nan"),
                         float("nan")])
            continue
        rows.append([case, auc, ap, float(th[int(np.argmax(dice))]),
                     float(dice.max())])
        print(f"{case}: AUC={auc:.4f} AP={ap:.4f} "
              f"best dice={dice.max():.4f}")
    with open(os.path.join(eval_dir, "enhancement_eval.csv"), "w") as f:
        csv.writer(f).writerows(rows)
    print(f"wrote {eval_dir}/enhancement_eval.csv")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="preprocess a CT dataset")
    parser.add_argument("--data_dir", default=None,
                        help="folder of {case}_raw.npz inputs")
    parser.add_argument("--output", default="results/preprocessed")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="generate N synthetic demo cases instead")
    parser.add_argument("--kp_mode", default="foerstner")
    parser.add_argument("--feature", default=None,
                        choices=["mind", "mind_ssc", "image", "enhancement"],
                        help="per-point features to attach to the point "
                             "files; default: none (cnn kp_mode keeps its "
                             "softmax-patch features)")
    parser.add_argument("--cnn_model", default=None,
                        help="trained seg-CNN checkpoint (.fst) for "
                             "kp_mode=cnn (e.g. seg_cnn_out/fold0/model.fst)")
    parser.add_argument("--sequence", default="fixed")
    parser.add_argument("--v1", action="store_true",
                        help="legacy TotalSegmentator-v1 crop semantics "
                             "(z_pad 20, raw z-range, unclamped HU) and the "
                             "v1 exclusion list of incomplete-lobe cases")
    parser.add_argument("--evaluate_enhancement", action="store_true",
                        help="evaluate the Hessian fissure-enhancement "
                             "filter (ROC/AP + Dice-vs-threshold sweep) over "
                             "the processed *_img_*.npz cases in --output")
    return parser


def main(argv=None, device=None) -> int:
    parser = get_parser()
    args = parser.parse_args(argv)
    dev = resolve_device(device, "preprocess_dataset")
    os.makedirs(args.output, exist_ok=True)
    if args.evaluate_enhancement:
        evaluate_enhancement(args.output, device=dev)
        return 0
    kw = dict(kp_mode=args.kp_mode, cnn_model_path=args.cnn_model,
              feature_mode=args.feature, legacy_v1=args.v1, device=dev)
    if args.synthetic:
        from .data.synthetic import make_synthetic_image_case
        for i in range(args.synthetic):
            case = make_synthetic_image_case(i)
            # synthetic cases carry intensities in [-1, 1); rescale to HU
            img = case["image"] * 1000.0
            process_case(img, case["lobes"], case["spacing"], args.output,
                         case["case_id"], args.sequence, **kw)
            print(f"processed {case['case_id']}")
        return 0
    if not args.data_dir:
        parser.error("--data_dir or --synthetic required")
    excluded = {f"s{i:04d}" for i in EXCLUDE_LIST_V1}
    for path in sorted(glob(os.path.join(args.data_dir, "*_raw.npz"))):
        case = os.path.basename(path).replace("_raw.npz", "")
        if args.v1 and case in excluded:
            print(f"skipping {case} (v1 exclusion list: incomplete lobes)")
            continue
        with np.load(path) as z:
            img = z["image"]
            lobes = z["lobes"]
            spacing = z["spacing"] if "spacing" in z else (1.0, 1.0, 1.0)
        process_case(img, lobes, spacing, args.output, case, args.sequence,
                     **kw)
        print(f"processed {case}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
