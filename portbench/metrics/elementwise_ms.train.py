"""Models' elementwise passes (models/dgcnn.py, models/blocks.py:
BatchNorm, LeakyReLU, casts, concatenations, Adam's foreach updates): the
device milliseconds a step of PyTorch's elementwise, reduction and copy
kernels, matched by name in the trace."""

PATTERNS = ("elementwise_kernel", "reduce_kernel", "CatArrayBatchedCopy",
            "multi_tensor_apply_kernel", "Memcpy DtoD", "Memset")


def read(run):
    if run.trace is None or not run.trace_steps:
        return None
    t = run.trace.device_time(*PATTERNS)
    return 1e3 * t / run.trace_steps if t > 0 else None
