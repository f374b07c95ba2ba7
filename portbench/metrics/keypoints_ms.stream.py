"""Serving, main thread (serving.segment_cases): the span
"serving.keypoints" of a case's enqueue, the CNN forward ("serving.cnn")
and the keypoint selection: the mean of the program's per-case `timings`
"keypoints_s" (the span's seconds), in ms, over every case of the
window."""


def read(run):
    v = [t["keypoints_s"] for t in run.timings if "keypoints_s" in t]
    return 1e3 * sum(v) / len(v) if v else None
