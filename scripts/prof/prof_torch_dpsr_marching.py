"""Where DPSR-Net's marching + sampling stage spends its time, on one NVIDIA
card.

Run from the repository root on the card's machine:

    python scripts/prof/prof_torch_dpsr_marching.py [--reps 7]

The stage's input is the 96 PSR fields of 128^3 of one forward of a seeded
DPSRNet2 at train_dpsr_net's defaults (32 clouds of 1024 points, 4
classes, the triangle budget 8 * 128^2, 2048 samples a field). Prints:
  * a torch.profiler table of 3 warm forwards and backwards of the stage
    (models/dpsr_net.py:_extract: marching_tetrahedra_batched and
    sample_points_on_triangles), device time per kernel;
  * the stage's three scans timed with CUDA events, median of --reps
    runs: the cell counts' (int32 (96, 127^3) along the rows), the
    slot flags' (int32 (96, 8 * 128^2, 12), along their short last axis
    as `torch.cumsum(dim=-1)` runs it, and along the leading axis of the
    transposed flags, what ops/marching.py:_rank_to_slot runs; equal
    integers), the sampler's areas' (float32 (96, 8 * 128^2) along the
    rows).
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

from fissure_segmentation_tpu_torch.models import dpsr_net  # noqa: E402
from fissure_segmentation_tpu_torch.ops import marching  # noqa: E402
from fissure_segmentation_tpu_torch.prof.timing import median_ms  # noqa: E402
from fissure_segmentation_tpu_torch.train.profile_step import \
    card_line  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    res, max_tris, s = 128, 8 * 128 * 128, 2048
    model = dpsr_net.DPSRNet2(
        "DGCNN", k=20, in_features=4, num_classes=4, max_tris=max_tris,
        n_surface_samples=s,
        generator=torch.Generator().manual_seed(0)).cuda().train()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((32, 1024, 4), generator=g, device="cuda") * 1.6 - 0.8
    with torch.no_grad():
        psr = model(x, return_psr=True)[3]
    psr = psr.reshape(-1, res, res, res).contiguous().requires_grad_()
    draws = dpsr_net._surface_draws(psr.shape[0], s, g, None, "cuda")

    def stage():
        pts, _ = dpsr_net._extract(psr, max_tris, s, draws)
        pts.sum().backward()
    for _ in range(2):
        stage()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            stage()
        torch.cuda.synchronize()
    print(f"marching + sampling, 96 x 128^3, forward and backward, 3 "
          f"times, on {card}", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=20, max_name_column_width=70),
          flush=True)

    with torch.no_grad():
        b = psr.shape[0]
        counts = marching._cell_tri_counts(psr.detach(), 0.0,
                                           (res - 1,) * 3).reshape(b, -1)
        t_counts = median_ms(lambda: torch.cumsum(counts, dim=1),
                             reps=args.reps, inner=3)
        flags = torch.randint(0, 2, (b, max_tris, 12), generator=g,
                              device="cuda", dtype=torch.int32)

        def leading():
            return torch.cumsum(flags.movedim(-1, 0).contiguous(),
                                dim=0).movedim(0, -1)
        if not torch.equal(torch.cumsum(flags, dim=-1), leading()):
            raise AssertionError("the two flag scans differ")
        t_last = median_ms(lambda: torch.cumsum(flags, dim=-1),
                           reps=args.reps, inner=3)
        t_lead = median_ms(leading, reps=args.reps, inner=3)
        area = torch.rand((b, max_tris), generator=g, device="cuda")
        t_area = median_ms(lambda: torch.cumsum(area, dim=-1),
                           reps=args.reps, inner=3)
    print(f"scans: cell counts int32 {tuple(counts.shape)} along the rows "
          f"{t_counts:.3f} ms; slot flags int32 {tuple(flags.shape)} along "
          f"the last axis {t_last:.3f} ms, along the leading axis of the "
          f"transpose {t_lead:.3f} ms (equal integers); areas float32 "
          f"{tuple(area.shape)} along the rows {t_area:.3f} ms, on {card}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
