"""Serving, main thread (serving.segment_cases): the span
"serving.surface" of a case's enqueue, the per-class spectral PSR and
marching tetrahedra (batched_psr_mc): the mean of the program's per-case
`timings` "surface_s" (the span's seconds), in ms, over every case of
the window."""


def read(run):
    v = [t["surface_s"] for t in run.timings if "surface_s" in t]
    return 1e3 * sum(v) / len(v) if v else None
