"""Intensity normalization of the CT (the part of keypoints/features.py the
CNN's data path needs; the MIND/SSC descriptors are not ported yet)."""
from __future__ import annotations

IMG_MIN = -1000.0  # reference data.py:30
IMG_MAX = 1500.0   # reference data.py:31


def normalize_img(img, min_val: float = IMG_MIN, max_val: float = IMG_MAX):
    """HU normalization into [-1, 1] (reference data.py:365-366)."""
    return (img - min_val) / (max_val - min_val) * 2 - 1
