"""Serving, main thread (serving.segment_cases): the span
"serving.ensemble" of a case's enqueue, the point model's subset ensemble
and its argmax: the mean of the program's per-case `timings`
"ensemble_s" (the span's seconds), in ms, over every case of the
window."""


def read(run):
    v = [t["ensemble_s"] for t in run.timings if "ensemble_s" in t]
    return 1e3 * sum(v) / len(v) if v else None
