"""Models (the CNN forward and the DGCNN ensemble): the FLOPs of the
window's cases over the window times the float32 peak (TF32 off), in %.

FLOPs a case (portbench/flops.py): the CNN's whole-volume forward, plus
the ensemble's forwards of the point model (the subsets, padded to whole
groups, of `sample_points` points)."""
from portbench.flops import cnn_flops, dgcnn_forward_flops
from portbench.peaks import F32_FLOPS


def case_flops(config) -> int:
    s = config["serving"]
    runs = max(s["n_runs_min"], -(-s["max_kpts"] // s["sample_points"]))
    runs = -(-runs // s["subset_batch"]) * s["subset_batch"]
    return cnn_flops(config) + runs * dgcnn_forward_flops(
        config["point_model"], s["sample_points"])


def read(run):
    if not run.cases or run.window_s <= 0:
        return None
    return 100.0 * case_flops(run.config) * run.cases / (run.window_s
                                                         * F32_FLOPS)
