"""Train step (train/trainer.py): the model FLOPs of the window's steps
over the window times the bf16 tensor-core peak, in %.

Model FLOPs a step: 3 x the forward's (forward and backward) x batch;
the forward's from the published layer shapes (portbench/flops.py). The
optimiser is not counted."""
from portbench.flops import dgcnn_forward_flops
from portbench.peaks import BF16_FLOPS


def step_flops(cfg) -> int:
    return 3 * cfg["batch"] * dgcnn_forward_flops(cfg, cfg["sample_points"])


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return 100.0 * step_flops(run.config) * run.steps / (run.window_s
                                                         * BF16_FLOPS)
