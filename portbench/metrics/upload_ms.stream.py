"""Serving, main thread (serving.segment_cases): the span "serving.upload"
of a case's enqueue, the copies of the CT and its lung mask from host
memory to the card (utils/device.py:host_to): the mean of the program's
per-case `timings` "upload_s" (the span's seconds), in ms, over every
case of the window."""


def read(run):
    v = [t["upload_s"] for t in run.timings if "upload_s" in t]
    return 1e3 * sum(v) / len(v) if v else None
