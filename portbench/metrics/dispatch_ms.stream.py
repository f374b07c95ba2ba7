"""Serving, main thread (serving.segment_cases): the mean of the
program's per-case `timings` "dispatch_s" (enqueueing a case's device
half), in ms, over every case of the window."""


def read(run):
    v = [t["dispatch_s"] for t in run.timings if "dispatch_s" in t]
    return 1e3 * sum(v) / len(v) if v else None
