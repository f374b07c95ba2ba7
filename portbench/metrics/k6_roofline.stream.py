"""Kernels: K6 (depthwise.cu) in the CNN's whole-volume forward, the
served cases' depthwise layers: their least time over the device time of
the `depthwise_tiled` / `depthwise_simple` kernels, in %.

Each depthwise layer of the configuration's blocks (stride 1 or 2,
3x3x3, padding 1) on the volume the CNN sees (the CT edge-padded to
multiples of 4, halved by the stem) reads its float32 input and its 27
taps a channel and writes its output, once; 2 x 27 operations an output
value; least time max(bytes / 3.35 TB/s, operations / 67 TFLOP/s)."""
from portbench.peaks import least_s


def depthwise_layers(config) -> list:
    """(input voxels, output voxels, channels) of each depthwise layer."""
    shape = [-(-s // 4) * 4 // 2 for s in config["ct_shape"]]
    out = []
    for mid, _, stride, _ in config["blocks"]:
        vin = shape[0] * shape[1] * shape[2]
        if stride == 2:
            shape = [-(-s // 2) for s in shape]
        vout = shape[0] * shape[1] * shape[2]
        out.append((vin, vout, mid))
    return out


def case_least_s(config) -> float:
    return sum(least_s((vin + vout) * c * 4 + 27 * c * 4, 2 * 27 * vout * c)
               for vin, vout, c in depthwise_layers(config))


def read(run):
    if run.trace is None or not run.trace_cases:
        return None
    t = run.trace.device_time("depthwise_tiled", "depthwise_simple")
    if t <= 0:
        return None
    return 100.0 * case_least_s(run.config) * run.trace_cases / t
