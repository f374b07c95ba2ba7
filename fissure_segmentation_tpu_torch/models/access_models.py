"""Model registries for the entry points (counterpart of
models/access_models.py)."""
from __future__ import annotations

from .dgcnn import DGCNNSeg
from .point_transformer import PointTransformerSeg
from .seg_cnn import MobileNetASPP


def get_point_seg_model_class(name: str):
    if name == "DGCNN":
        return DGCNNSeg
    if name == "PointTransformer":
        return PointTransformerSeg
    if name == "PointNet":
        raise NotImplementedError("PointNet is not ported yet")
    raise ValueError(f"unknown point segmentation model {name!r}; known: "
                     "['DGCNN', 'PointNet', 'PointTransformer']")


def get_seg_cnn_model_class(version: str):
    """The pre-segmentation CNN: "v1" MobileNetASPP; "v3" (LR-ASPP,
    models/lraspp_3d.py) is not ported yet (ROADMAP Queue 1)."""
    if version == "v1":
        return MobileNetASPP
    if version == "v3":
        raise NotImplementedError("the LR-ASPP CNN (v3) is not ported yet; "
                                  "see ROADMAP.md Queue 1")
    raise ValueError(f"unknown seg CNN version {version!r}; known: "
                     "['v1', 'v3']")
