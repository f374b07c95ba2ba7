"""Serving's host half (native/: the component filter and the labelmap):
the mean of the program's per-case `timings` "host_s", in ms, over every
case of the window."""


def read(run):
    v = [t["host_s"] for t in run.timings if "host_s" in t]
    return 1e3 * sum(v) / len(v) if v else None
