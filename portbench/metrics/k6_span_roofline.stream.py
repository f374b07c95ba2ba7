"""Kernels: K6 (depthwise.cu) in the CNN's whole-volume forward, read by
span: k6_roofline.stream's least time of the served cases' depthwise
layers over the device time of the operations launched inside the span
"cnn.depthwise" (the layers' forwards: K6 and what they launch beside
it), in %. The span holds K6's kernels, so this reads at most
k6_roofline.stream where attribution lost none (portbench/spans.py; a
stock run keeps no spans and reads nothing)."""
import os

from portbench.common import HERE, load_file_module

_K6 = load_file_module(os.path.join(HERE, "metrics", "k6_roofline.stream.py"),
                       "portbench_metric_k6_roofline_stream")


def read(run):
    program = getattr(run.trace, "program", None)
    if program is None or not run.trace_cases:
        return None
    t = program.device_s("cnn.depthwise")
    if t <= 0:
        return None
    return 100.0 * _K6.case_least_s(run.config) * run.trace_cases / t
