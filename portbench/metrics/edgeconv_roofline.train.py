"""Kernels of the EdgeConvs (K1 knn.cu; the graph transpose, K2-K4
scatter.cu; gather_reduce.cu) in the train step: the least time of their
work, summed over the kernels that ran, over those kernels' device time,
in %.

The work is counted from the step's shapes (batch B, points N, k
neighbours, 64 channels, the compute dtype's bytes), whatever implements
it, each input byte read once and each output byte written once; the
least time is max(bytes / 3.35 TB/s, operations / 67 TFLOP/s):
  K1          reads the (B, N, 3) float32 coordinates, writes the
              (B, N, k + 1) int32 graph; 8 operations a pair of points
              (3 differences, 3 squares, 2 additions)
  transpose   reads the (B, N, k) int32 graph, writes the transposed
              (B, N, k) int32 lists and (B, N + 1) int32 offsets
  gather_reduce (a single-layer EdgeConv's forward, one a layer) reads
              the (B, N, C) activations and the graph, writes (B, N, C)
  K3          (its backward) reads the (B, N, C) gradient and the graph,
              writes the (B, N, C) gradient of the activations
  K4          reads the (B, N + 1) int32 offsets, writes (B, N) counts
  K2          (EdgeConv_0's gather backward) reads the (B, N k, C)
              edge gradients, writes (B, N, C)
A kernel that does not appear in the trace adds neither its work nor its
time. Kernel names go stale where a later change renames a kernel; spans
inside the program are to replace them."""
from portbench.peaks import least_s

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def least_by_kernel(cfg) -> dict:
    """{name pattern: (least seconds of one call, calls a step)}."""
    b, n, k = cfg["batch"], cfg["sample_points"], cfg["k"]
    c = cfg["edge_widths"][0][-1]
    e = DTYPE_BYTES[cfg["compute_dtype"]]
    single = sum(1 for w in cfg["edge_widths"] if len(w) == 1)
    multi = len(cfg["edge_widths"]) - single
    graph = b * n * k * 4
    act = b * n * c * e
    return {
        "knn_kernel": (least_s(b * n * 3 * 4 + b * n * (k + 1) * 4,
                               8 * b * n * n), 1),
        "transpose_": (least_s(2 * graph + b * (n + 1) * 4, 0), 1),
        "gather_reduce_": (least_s(act + graph + act, 0), single),
        "scatter_routed_": (least_s(act + graph + act, 0), single),
        "count_": (least_s(b * (n + 1) * 4 + b * n * 4, 0), single),
        "scatter_rows_kernel": (least_s(b * n * k * c * e + act, 0), multi),
    }


def read(run):
    if run.trace is None or not run.trace_steps:
        return None
    least = spent = 0.0
    for pattern, (one, calls) in least_by_kernel(run.config).items():
        t = run.trace.device_time(pattern)
        if t > 0:
            least += one * calls * run.trace_steps
            spent += t
    return 100.0 * least / spent if spent > 0 else None
