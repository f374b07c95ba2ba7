"""Point-cloud dataset, splits and class weights (jax-free copy of
data/dataset.py).

A copy, not an import: `fissure_segmentation_tpu.data` imports jax in its
package __init__. The functions keep the JAX package's semantics and file
formats (one ``*_points_*.npz`` per case, json or nnU-Net pickle split
files), so both packages read each other's files; `to_store` builds the
device store of data/store.py.
"""
from __future__ import annotations

import copy
import json
import os
from glob import glob

import numpy as np

from .store import build_store


def compute_class_weights(class_frequency: np.ndarray) -> np.ndarray:
    """(1 - normalized frequency) * num_classes."""
    f = class_frequency / class_frequency.sum()
    return ((1 - f) * len(f)).astype(np.float32)


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not jsonable: {type(o)}")


def save_case_npz(case: dict, folder: str) -> str:
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder,
                        f"{case['case_id']}_points_{case['sequence']}.npz")
    arrays = {k: case[k] for k in ("coords", "labels")}
    for opt in ("features", "lobes"):
        if case.get(opt) is not None:
            arrays[opt] = case[opt]
    for lbl, pts in (case.get("gt_surfaces") or {}).items():
        arrays[f"gt_surface_{lbl}"] = pts
    meta = {k: v for k, v in case.items()
            if k not in arrays and k != "gt_surfaces"}
    np.savez_compressed(path, __meta__=json.dumps(meta, default=_json_default),
                        **arrays)
    return path


def load_case_npz(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        case = {k: z[k] for k in z.files
                if k != "__meta__" and not k.startswith("gt_surface_")}
        gt = {int(k.split("_")[-1]): z[k] for k in z.files
              if k.startswith("gt_surface_")}
        if gt:
            case["gt_surfaces"] = gt
        meta = json.loads(str(z["__meta__"]))
    if "surface_params" in meta and isinstance(meta["surface_params"], dict):
        meta["surface_params"] = {int(k): v
                                  for k, v in meta["surface_params"].items()}
    case.update(meta)
    return case


class PointDataset:
    """Host-side dataset of point-cloud cases: label handling (binary,
    exclude_rhf, lobes), augmentation toggle, class weights and splits;
    per-step sampling runs on the device (data/store.py:sample_batch)."""

    def __init__(self, cases: list[dict], sample_points: int = 2048,
                 exclude_rhf: bool = False, lobes: bool = False,
                 binary: bool = False, do_augmentation: bool = True,
                 copd: bool = False):
        if lobes and binary:
            raise NotImplementedError("binary + lobes not supported")
        self.cases = cases
        self.sample_points = sample_points
        self.exclude_rhf = exclude_rhf
        self.lobes = lobes
        self.binary = binary
        self.do_augmentation = do_augmentation
        self.copd = copd
        for c in self.cases:
            if lobes:
                if "lobes" not in c:
                    raise ValueError(
                        f"case {c.get('case_id')} has no lobe labels")
                c["labels"] = np.asarray(c["lobes"], np.int32)
            elif exclude_rhf:
                lbl = np.asarray(c["labels"]).copy()
                lbl[lbl == 3] = 0
                c["labels"] = lbl

    @classmethod
    def from_folder(cls, folder: str, **kwargs) -> "PointDataset":
        files = sorted(glob(os.path.join(folder, "*_points_*.npz")))
        if not files:
            raise FileNotFoundError(f"no *_points_*.npz cases in {folder}")
        cases = [load_case_npz(f) for f in files]
        if kwargs.get("copd"):
            # the COPD transfer-validation set: the cases whose id says so
            cases = [c for c in cases if "COPD" in str(c["case_id"])]
            if not cases:
                raise FileNotFoundError(f"no COPD cases in {folder}")
        return cls(cases, **kwargs)

    def __len__(self):
        return len(self.cases)

    def __getitem__(self, i):
        return self.cases[i]

    @property
    def ids(self):
        return [(c["case_id"], c["sequence"]) for c in self.cases]

    @property
    def num_classes(self) -> int:
        if self.binary:
            return 2
        return int(max(np.max(c["labels"]) for c in self.cases)) + 1

    @property
    def n_features(self) -> int:
        f = self.cases[0].get("features")
        return 3 + (0 if f is None else f.shape[1])

    def get_class_weights(self) -> np.ndarray:
        freq = np.zeros(self.num_classes)
        for c in self.cases:
            lbl = np.asarray(c["labels"])
            if self.binary:
                lbl = (lbl != 0).astype(np.int32)
            freq += np.bincount(lbl, minlength=self.num_classes)[
                :self.num_classes]
        return compute_class_weights(freq)

    def get_full_pointcloud(self, i: int):
        """(N, 3+F) inputs and (N,) labels of case i."""
        c = self.cases[i]
        x = c["coords"]
        if c.get("features") is not None:
            x = np.concatenate([x, c["features"]], axis=1)
        lbl = np.asarray(c["labels"])
        if self.binary:
            lbl = (lbl != 0).astype(np.int32)
        return x, lbl

    def to_store(self, device=None):
        return build_store(self.cases, device=device)

    def split_data_set(self, split: dict, fold_nr: int | None = None):
        """(train_ds, val_ds) by case id lists. A COPD dataset is the
        validation set of every fold: (None, self)."""
        if self.copd:
            return None, self
        tr_ids = {tuple(x) if isinstance(x, (list, tuple)) else (x, None)
                  for x in split["train"]}
        vl_ids = {tuple(x) if isinstance(x, (list, tuple)) else (x, None)
                  for x in split["val"]}

        def _match(c, idset):
            return ((c["case_id"], c["sequence"]) in idset
                    or (c["case_id"], None) in idset)

        train = copy.deepcopy([c for c in self.cases if _match(c, tr_ids)])
        val = copy.deepcopy([c for c in self.cases if _match(c, vl_ids)])

        def mk(cs, aug):
            # labels were remapped in __init__; don't remap again
            return PointDataset(cs, self.sample_points, exclude_rhf=False,
                                lobes=False, binary=self.binary,
                                do_augmentation=aug)
        return mk(train, self.do_augmentation), mk(val, False)


def create_split(ids: list, k: int = 5, seed: int = 42) -> list[dict]:
    """k-fold split over case ids: random permutation, k folds, val = fold,
    train = the rest."""
    rng = np.random.default_rng(seed)
    ids = list(ids)
    perm = rng.permutation(len(ids))
    folds = np.array_split(perm, k)
    split = []
    for f in range(k):
        val = sorted(folds[f].tolist())
        train = sorted([i for g in range(k) if g != f
                        for i in folds[g].tolist()])
        split.append({"train": [ids[i] for i in train],
                      "val": [ids[i] for i in val]})
    return split


def save_split_file(split: list[dict], path: str) -> None:
    if path.endswith(".pkl"):  # nnU-Net pickle compatibility
        import pickle
        with open(path, "wb") as f:
            pickle.dump(split, f)
    else:
        with open(path, "w") as f:
            json.dump(split, f, indent=1, default=_json_default)


def load_split_file(path: str) -> list[dict]:
    """Load a split file (json, or the nnU-Net pickle format)."""
    if path.endswith(".pkl"):
        import pickle
        with open(path, "rb") as f:
            split = pickle.load(f)
        return [{"train": list(np.asarray(s["train"]).tolist()),
                 "val": list(np.asarray(s["val"]).tolist())} for s in split]
    with open(path) as f:
        return json.load(f)
