"""Deformable CT pair registration by Adam instance optimization
(counterpart of register_images.py):

    python -m fissure_segmentation_tpu_torch.register_images -F FIX -M MOV \
        -f FIX_MASK -m MOV_MASK [-w WARPED] [-d DISP.npz] [-l LMS.npz]

registers a moving (inspiration) scan onto a fixed (exhale) scan with
MIND-SSC and label features, writes the warped image and the displacement
fields (`disp`, `disp_lo`) and reports landmark TRE when landmarks are
given. It runs on the first CUDA card, and raises without one unless
`main(argv, device="cpu")` asks for the CPU.

Label volumes are found next to the images by swapping "img" for
"fissures_poisson" and "lobes" in the file's basename and are optional;
the masks are required. Landmarks come as an .npz with lm_fix and lm_mov
((N, 3) normalized xyz) and optionally spacing (3,).
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from .shape_model.adam_registration import landmark_tre_mm, register_images
from .utils.device import resolve_device
from .utils.nifti import load_nifti, save_nifti
from .utils.profiling import stage


def _load(path, device):
    return torch.as_tensor(np.array(load_nifti(path).array), device=device)


def _maybe(path, device=None):
    """Load an *optional* companion volume; None when absent."""
    if path and os.path.exists(path):
        return _load(path, device)
    return None


def _require(path, what, device=None):
    """Load a required volume; a missing file is an error, not a silent
    unmasked/label-free registration."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"{what} not found: {path}")
    return _load(path, device)


def _companion(img_path, tag):
    """Swap 'img' for `tag` in the *basename* only (a full-path replace
    corrupts paths whose directories contain 'img')."""
    d, b = os.path.split(img_path)
    return os.path.join(d, b.replace("img", tag))


def get_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("-F", "--fixed_file", required=True,
                        help="fixed scan (exhale) nii.gz")
    parser.add_argument("-M", "--moving_file", required=True,
                        help="moving scan (inspiration) nii.gz")
    parser.add_argument("-f", "--fixed_mask_file", required=True)
    parser.add_argument("-m", "--moving_mask_file", required=True)
    parser.add_argument("-w", "--warped_file", default=None,
                        help="output warped image nii.gz")
    parser.add_argument("-d", "--disp_file", default=None,
                        help="output displacement-field .npz")
    parser.add_argument("-l", "--landmarks", default=None,
                        help=".npz with lm_fix, lm_mov (N,3 normalized xyz) "
                             "and spacing (3,) for TRE evaluation")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--lambda_weight", type=float, default=0.65)
    return parser


def main(argv=None, device=None, stages: dict | None = None) -> dict:
    """Run the entry; returns register_images' result dict (on `device`),
    with "tre" = (before, after) mean mm where landmarks were given.

    :param stages: optional dict of synced stage seconds (register_images'
        stages and "io", the reading and writing of files)
    """
    args = get_parser().parse_args(argv)
    dev = resolve_device(device, "register_images")
    with stage(stages, "io", dev):
        fix = load_nifti(args.fixed_file)
        mov = load_nifti(args.moving_file)
        inputs = dict(
            mask_fix=_require(args.fixed_mask_file, "fixed mask", dev),
            mask_mov=_require(args.moving_mask_file, "moving mask", dev),
            fissures_fix=_maybe(_companion(args.fixed_file,
                                           "fissures_poisson"), dev),
            fissures_mov=_maybe(_companion(args.moving_file,
                                           "fissures_poisson"), dev),
            lobes_fix=_maybe(_companion(args.fixed_file, "lobes"), dev),
            lobes_mov=_maybe(_companion(args.moving_file, "lobes"), dev))
        img_fix = torch.as_tensor(np.array(fix.array, np.float32), device=dev)
        img_mov = torch.as_tensor(np.array(mov.array, np.float32), device=dev)
    res = register_images(img_fix, img_mov, **inputs, iters=args.iters,
                          lambda_weight=args.lambda_weight, stages=stages)
    losses = res["losses"].cpu().numpy()
    print(f"final cost {float(losses[-1]):.5f} "
          f"(initial {float(losses[0]):.5f})")

    with stage(stages, "io", dev):
        if args.warped_file:
            save_nifti(args.warped_file, res["warped"].cpu().numpy(),
                       spacing=fix.spacing)
        if args.disp_file:
            np.savez_compressed(args.disp_file,
                                disp=res["disp"].cpu().numpy(),
                                disp_lo=res["disp_lo"].cpu().numpy())
    if args.landmarks:
        with np.load(args.landmarks) as lm:
            spacing = lm["spacing"] if "spacing" in lm.files else np.ones(3)
            before, after = landmark_tre_mm(
                torch.as_tensor(lm["lm_fix"], dtype=torch.float32,
                                device=dev),
                torch.as_tensor(lm["lm_mov"], dtype=torch.float32,
                                device=dev),
                res["disp"], spacing)
        res["tre"] = (float(before.mean()), float(after.mean()))
        print(f"TRE before {res['tre'][0]:.3f} mm -> "
              f"after {res['tre'][1]:.3f} mm")
    return res


if __name__ == "__main__":
    main()
