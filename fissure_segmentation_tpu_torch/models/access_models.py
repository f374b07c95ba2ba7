"""Model registry for the point-segmentation entry point (counterpart of
models/access_models.py)."""
from __future__ import annotations

from .dgcnn import DGCNNSeg
from .point_transformer import PointTransformerSeg


def get_point_seg_model_class(name: str):
    if name == "DGCNN":
        return DGCNNSeg
    if name == "PointTransformer":
        return PointTransformerSeg
    if name == "PointNet":
        raise NotImplementedError("PointNet is not ported yet")
    raise ValueError(f"unknown point segmentation model {name!r}; known: "
                     "['DGCNN', 'PointNet', 'PointTransformer']")
