"""Serving's host half (native/): the span "serving.labelmap", the
labelmap rasterized from the meshes (postprocess/surface_fitting.py:
mesh_to_labelmap): its mean host ms a case over the untraced window (the
records portbench/spans.py keeps; a stock run keeps none and reads
nothing)."""


def read(run):
    records = getattr(run, "records", None)
    v = [r[3] - r[2] for r in records or () if r[0] == "serving.labelmap"]
    return 1e-6 * sum(v) / len(v) if v else None
