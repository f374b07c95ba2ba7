"""K1 (kNN) and K5 (farthest-point sampling) of one checkout of this
repository, timed on the card at their path shapes, so that two commits
can be compared in one call on one card. Run it with the checkout's root:

    python fissure_segmentation_tpu_torch/prof/kernel_ab.py ROOT [--tag NAME]

The script imports the kernels and `prof.probes.median_ms` from ROOT, not
from its own location, so one copy times any checkout whose kernels/knn.py
and kernels/fps.py have `knn_cuda`/`knn_plain` and `fps_cuda`/`fps_plain`;
run it on the two roots in turns (A, B, B, A). Every input is drawn from
one seeded generator in a fixed order, so both sides time the same inputs;
each kernel is checked bit-equal to its plain version first. Prints one
JSON line (per shape the median ms of CUDA-event runs), then the card's
name and power limit. Raises without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

# The path shapes of chip_smoke.py phases 3 and 9, listed here because an
# older checkout's chip_smoke.py may not time all of them.
# (name, shape, k, self_loop): the DGCNN serving graph, the training
# step's graph, the PSR normals
KNN_SHAPES = (("graph_5x2048x3_k40", (5, 2048, 3), 40, False),
              ("train_32x2048x3_k40", (32, 2048, 3), 40, False),
              ("normals_3x8192x3_k30", (3, 8192, 3), 30, True))
# (name, shape, m, valid share): the PointTransformer step's first two
# TransitionDowns, a served ensemble group, DSEG-AE's masked cloud
FPS_SHAPES = (("pt_step_32x2048x3_m512", (32, 2048, 3), 512, 1.0),
              ("pt_step_32x512x3_m128", (32, 512, 3), 128, 1.0),
              ("pt_serve_5x2048x3_m512", (5, 2048, 3), 512, 1.0),
              ("dseg_masked_1x20000x3_m1024", (1, 20000, 3), 1024, 0.35))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab runs only on an NVIDIA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from fissure_segmentation_tpu_torch.kernels import fps, knn
    from fissure_segmentation_tpu_torch.prof.probes import median_ms
    for mod in (fps, knn):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} imported from "
                               f"{mod.__file__}, not from {root}")
    gen = torch.Generator().manual_seed(0)
    out = {"root": root, "tag": args.tag, "knn": {}, "fps": {}}
    for name, shape, k, self_loop in KNN_SHAPES:
        x = (torch.rand(shape, generator=gen) * 2 - 1).cuda()
        i_k, d_k = knn.knn_cuda(x, k, self_loop)
        i_p, d_p = knn.knn_plain(x, k, self_loop)
        if not (torch.equal(i_k, i_p) and torch.equal(d_k, d_p)):
            raise AssertionError(f"K1 {name}: kernel differs from plain")
        out["knn"][name] = median_ms(lambda: knn.knn_cuda(x, k, self_loop))
    for name, shape, m, share in FPS_SHAPES:
        x = (torch.rand(shape, generator=gen) * 2 - 1).cuda()
        valid = None
        if share < 1.0:
            valid = (torch.rand(shape[:2], generator=gen) < share).cuda()
        if not torch.equal(fps.fps_cuda(x, m, valid),
                           fps.fps_plain(x, m, valid)):
            raise AssertionError(f"K5 {name}: kernel differs from plain")
        out["fps"][name] = median_ms(lambda: fps.fps_cuda(x, m, valid))
    print(json.dumps(out), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
