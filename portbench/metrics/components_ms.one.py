"""Serving's host half (native/): the span "serving.components", the
native component filter of each class's mesh (postprocess/
surface_fitting.py:_class_meshes): its mean host ms a case over the
untraced window (the records portbench/spans.py keeps; a stock run keeps
none and reads nothing)."""


def read(run):
    records = getattr(run, "records", None)
    v = [r[3] - r[2] for r in records or () if r[0] == "serving.components"]
    return 1e-6 * sum(v) / len(v) if v else None
