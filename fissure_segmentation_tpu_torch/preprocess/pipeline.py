"""Dataset preparation (counterpart of preprocess/pipeline.py):

  `preprocess_totalsegmentator_case` — z-crop around the lobe labels,
      flip into the canonical orientation, clamp HU, derive fissures and
      the lung mask from the lobe GT;
  `create_case_meshes` — GT surface meshes of fissures (Poisson fit) and
      lobes (marching);
  `label_pipeline_case` — the four steps of a case: Poisson
      regularization of the fissure labels, lung masking, lobes from the
      fissures, keypoints and features;
  `save_meshes` — `{case}_mesh_{seq}/{case}_{name}{i}_{seq}.obj`.

The device work runs on `device`: the card unless the caller asks for the
CPU.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..postprocess.surface_fitting import poisson_reconstruction
from ..utils.device import resolve_device
from ..utils.objio import save_obj
from ..utils.profiling import stage
from .labels import (find_fissures, find_lobes, find_non_zero_range,
                     generate_lung_mask, label_to_mesh)

IMG_MIN, IMG_MAX = -1000.0, 1500.0  # HU clamp range (constants.py:8-9)

# Cases whose 5 lobes are present but cut off somewhere: the v1 script's
# curated exclusion set (preprocess_totalsegmentator_dataset_v1.py:28)
EXCLUDE_LIST_V1 = (57, 58, 67, 135, 165, 199, 212, 215, 256, 264, 266, 294,
                   321, 428, 509, 542, 555, 566, 607, 651, 682, 705, 743,
                   762, 806, 864, 965, 1179, 1257, 1261, 1268, 1307, 1367,
                   1386)


def preprocess_totalsegmentator_case(img: np.ndarray, lobes: np.ndarray,
                                     z_pad: int = 15, flip_xy: bool = True,
                                     legacy_v1: bool = False, device=None):
    """One TotalSegmentator case -> cropped, canonical image and GT labels.

    :param img: (D, H, W) CT volume in HU
    :param lobes: (D, H, W) lobe labelmap (1 RLL, 2 RUL, 3 LLL, 4 LUL,
        5 RML)
    :param legacy_v1: the v1 crops (z_pad 20, no opening of the lobe
        z-range, no HU clamp); fissures and lung mask are derived alike
    :return: dict of numpy image, lobes, fissures, lung_mask
    """
    dev = resolve_device(device, "preprocess_totalsegmentator_case")
    img = np.asarray(img)
    lobes = np.asarray(lobes)
    if legacy_v1:
        z_pad = 20
    lo, hi = find_non_zero_range(lobes, axis=0,
                                 open_radius=0 if legacy_v1 else 2,
                                 device=dev)
    lo = max(lo - z_pad, 0)
    hi = min(hi + z_pad, lobes.shape[0])
    img, lobes = img[lo:hi], lobes[lo:hi]

    if flip_xy:  # direction (-1, 0, 0, 0, -1, 0, 0, 0, 1) -> canonical
        img = img[:, ::-1, ::-1].copy()
        lobes = lobes[:, ::-1, ::-1].copy()

    if not legacy_v1:  # the v1 script wrote unclamped HU volumes
        img = np.clip(img, IMG_MIN - 1, IMG_MAX)
    lobes_t = torch.as_tensor(lobes, device=dev)
    fissures = find_fissures(lobes_t).cpu().numpy()
    lung_mask = generate_lung_mask(lobes_t).cpu().numpy()
    return {"image": img.astype(np.float32), "lobes": lobes.astype(np.int32),
            "fissures": fissures.astype(np.uint8), "lung_mask": lung_mask}


def save_meshes(meshes, folder: str, case: str, sequence: str,
                obj_name: str = "fissure") -> list[str]:
    """Write (tris, valid) triangle soups as OBJ files in the
    `{case}_mesh_{seq}/` layout."""
    mesh_dir = os.path.join(folder, f"{case}_mesh_{sequence}")
    os.makedirs(mesh_dir, exist_ok=True)
    paths = []
    for i, (tris, valid) in enumerate(meshes):
        t = np.asarray(tris)[np.asarray(valid)]
        verts = t.reshape(-1, 3)
        faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
        p = os.path.join(mesh_dir, f"{case}_{obj_name}{i + 1}_{sequence}.obj")
        save_obj(p, verts, faces)
        paths.append(p)
    return paths


def _lobe_meshes(lobes: np.ndarray, device) -> list:
    lab = torch.as_tensor(lobes, device=device)
    return [label_to_mesh(lab, lbl)
            for lbl in sorted(int(v) for v in np.unique(lobes) if v != 0)]


def create_case_meshes(fissures: np.ndarray, lobes: np.ndarray,
                       lung_mask: np.ndarray, spacing=(1.0, 1.0, 1.0),
                       device=None, **fit_kwargs):
    """GT meshes: fissures by Poisson surface fitting, lobes by marching
    their labelmap. Returns (fissure_meshes, lobe_meshes), (tris, valid)
    numpy lists."""
    dev = resolve_device(device, "create_case_meshes")
    _, fissure_meshes = poisson_reconstruction(fissures, lung_mask,
                                               spacing=spacing, device=dev,
                                               **fit_kwargs)
    return fissure_meshes, _lobe_meshes(lobes, dev)


def label_pipeline_case(img: np.ndarray, fissures: np.ndarray,
                        lung_mask: np.ndarray, out_dir: str, case: str,
                        sequence: str, exclude_rhf: bool = True,
                        kp_mode: str = "foerstner",
                        compute_points: bool = True,
                        spacing=(1.0, 1.0, 1.0),
                        cnn_model_path: str | None = None,
                        feature_mode: str | None = None, device=None,
                        stages: dict | None = None,
                        generator: torch.Generator | None = None,
                        draws: dict | None = None, **fit_kwargs) -> dict:
    """The four label steps of a case on `device`:
      1. Poisson regularization of the fissure labels (+ GT meshes),
      2. lung masking of the regularized labels,
      3. lobes from the fissures (morphology, components, random walk),
      4. keypoints and features.
    Writes the meshes under `out_dir` and returns the artifacts.

    :param cnn_model_path: for kp_mode='cnn': a trained seg-CNN (.fst of
        either package) whose whole-volume softmax in bfloat16 gives the
        candidates
    :param stages: optional dict; the synced seconds of each stage are
        added to it ("poisson:label{f}", "poisson:labelmap", "masking",
        "find_lobes:*", "lobe_meshes", "cnn", "keypoints", "features",
        "write" for the meshes)
    :param generator, draws: the keypoints' random draws
        (keypoints/extraction.py:compute_keypoints); default: a CPU
        generator seeded 0, the JAX package's PRNGKey(0)
    """
    dev = resolve_device(device, "label_pipeline_case")
    # 1. surface fitting
    regularized, fissure_meshes = poisson_reconstruction(
        fissures, lung_mask, spacing=spacing, device=dev, stages=stages,
        **fit_kwargs)
    with stage(stages, "write", dev):
        save_meshes(fissure_meshes, out_dir, case, sequence,
                    obj_name="fissure")

    # 2. lung masking
    with stage(stages, "masking", dev):
        regularized = np.where(np.asarray(lung_mask, bool), regularized,
                               np.zeros((), regularized.dtype))

    # 3. lobe generation
    lobes, success = find_lobes(regularized, lung_mask,
                                exclude_rhf=exclude_rhf, device=dev,
                                stages=stages)
    out = {"fissures_regularized": regularized,
           "fissure_meshes": fissure_meshes, "lobes": lobes,
           "lobes_success": success}
    if not success:
        return out
    with stage(stages, "lobe_meshes", dev):
        lobe_meshes = _lobe_meshes(lobes, dev)
    with stage(stages, "write", dev):
        save_meshes(lobe_meshes, out_dir, case, sequence, obj_name="lobe")
    out["lobe_meshes"] = lobe_meshes

    # 4. keypoints + features
    if compute_points:
        from ..keypoints.extraction import compute_keypoints
        cnn_softmax = None
        if kp_mode == "cnn":
            if cnn_model_path is None:
                raise ValueError(
                    "kp_mode='cnn' needs cnn_model_path (a trained seg-CNN "
                    ".fst checkpoint, e.g. <seg_cnn_dir>/fold0/model.fst)")
            with stage(stages, "cnn", dev):
                cnn_softmax = predict_cnn_softmax(cnn_model_path, img, dev)
        out["points"] = compute_keypoints(
            img, regularized, lung_mask, kp_mode=kp_mode, lobes=lobes,
            case_id=case, sequence=sequence, cnn_softmax=cnn_softmax,
            feature_mode=feature_mode, device=dev, generator=generator,
            draws=draws, stages=stages)
    return out


def predict_cnn_softmax(cnn_model_path: str, img: np.ndarray,
                        device) -> torch.Tensor:
    """The seg-CNN of a `.fst` (either package's, models/io.py) run on the
    whole CT in bfloat16 on `device`.

    :return: (D, H, W, C) float32 softmax on `device`
    """
    from ..models.io import load_fst
    from ..models.seg_cnn import predict_full_volume
    model = load_fst(cnn_model_path).to(device).eval()
    vol = torch.as_tensor(np.asarray(img, np.float32), device=device)
    return predict_full_volume(model, vol, dtype=torch.bfloat16)
