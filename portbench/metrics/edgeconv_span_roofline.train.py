"""Kernels of the EdgeConvs in the train step, read by span:
edgeconv_roofline.train's least time a step of the kernels that ran over
the device time of the operations launched inside the spans
"edgeconv.kernels" (K1 and the transpose, the gather-reduce forward, K3
and K4 in the fused backward, K2 in the gather's backward, and what those
calls launch beside them), in %. The spans hold those kernels, so this
reads at most edgeconv_roofline.train where attribution lost none
(portbench/spans.py; a stock run keeps no spans and reads nothing)."""
import os

from portbench.common import HERE, load_file_module

_EDGE = load_file_module(
    os.path.join(HERE, "metrics", "edgeconv_roofline.train.py"),
    "portbench_metric_edgeconv_roofline_train")


def read(run):
    program = getattr(run.trace, "program", None)
    if program is None or not run.trace_steps:
        return None
    least = sum(one * calls for pattern, (one, calls)
                in _EDGE.least_by_kernel(run.config).items()
                if run.trace.device_time(pattern) > 0)
    t = program.device_s("edgeconv.kernels")
    return 100.0 * least * run.trace_steps / t if t > 0 else None
