"""Mesh-backed datasets (counterpart of data/mesh_dataset.py: `MeshStore`,
`build_mesh_store`, `sample_mesh_batch`, `SampleFromMeshDS` for the PC-AE,
`PointToMeshDS` for DPSR-Net, `CorrespondingPointDataset` for DG-SSM).

The (case, object) meshes are padded triangle soups stacked once into
tensors on the training device (`MeshStore`, the triangle axis padded to a
multiple of 128 like the JAX store); each step then samples, augments and
jitters there from an explicit `torch.Generator`. jax.random cannot be
replayed in torch, so every draw can be injected instead (`draws=`, a
dict; the parity tests pass the JAX package's):

  * "input": (u (B, S), uv (B, S, 2)), the surface uniforms of the inputs
    (ops/marching.py:sample_points_on_triangles, one draw per cloud);
  * "transform": the augmentation's SimilarityTransform;
  * "jitter": (B, S, 3) standard normals, times 0.005;
  * "target": (u (B, St), uv (B, St, 2)), the mesh target's uniforms.

A generator draws them in that order, on its own device.
`CorrespondingPointDataset.sample_batch` takes {"noise": (B, N_max)
subset uniforms, "transform": the augmentation's SimilarityTransform}.
"""
from __future__ import annotations

import copy
import os
from glob import glob
from typing import NamedTuple

import numpy as np
import torch

from ..ops.marching import sample_points_on_triangles
from ..utils.coords import kpts_to_grid
from ..utils.objio import load_obj, mesh_to_triangle_soup
from .augmentation import (SimilarityTransform, chain_transforms,
                           compose_transform, decompose_similarity_transform,
                           point_augmentation, so3_log_map, transform_points)
from .dataset import PointDataset
from .store import sample_batch as sample_points_batch


def load_meshes(folder: str, case: str, sequence: str,
                obj_name: str = "fissure") -> list[np.ndarray]:
    """All `{case}_{obj_name}{i}_{sequence}.obj` meshes of one case as
    triangle soups."""
    mesh_dir = os.path.join(folder, f"{case}_mesh_{sequence}")
    files = sorted(glob(os.path.join(mesh_dir,
                                     f"{case}_{obj_name}*_{sequence}.obj")))
    return [mesh_to_triangle_soup(*load_obj(f)) for f in files]


class MeshStore(NamedTuple):
    """Padded stack of triangle-soup meshes (tensors on one device)."""
    tris: torch.Tensor    # (n_items, T_max, 3, 3)
    valid: torch.Tensor   # (n_items, T_max) bool

    @property
    def n_items(self) -> int:
        return self.tris.shape[0]


def build_mesh_store(soups: list[np.ndarray], pad_to: int | None = None,
                     device=None) -> MeshStore:
    t_max = max(max(len(s) for s in soups), pad_to or 1)
    t_max = -(-t_max // 128) * 128
    tris = np.zeros((len(soups), t_max, 3, 3), np.float32)
    valid = np.zeros((len(soups), t_max), bool)
    for i, s in enumerate(soups):
        tris[i, :len(s)] = s
        valid[i, :len(s)] = True
    return MeshStore(torch.from_numpy(tris).to(device),
                     torch.from_numpy(valid).to(device))


def _surface(store: MeshStore, item_idx: torch.Tensor, n: int, generator,
             draws):
    return sample_points_on_triangles(store.tris[item_idx],
                                      store.valid[item_idx], n, generator,
                                      draws)


def sample_mesh_batch(store: MeshStore, item_idx: torch.Tensor,
                      sample_points: int,
                      generator: torch.Generator | None = None,
                      augment: bool = True, jitter: float = 0.005,
                      draws: dict | None = None):
    """Area-weighted uniform surface samples of a batch of store items,
    then (with `augment`) a random similarity transform and gaussian
    jitter. Returns (samples (B, S, 3), transform or None)."""
    draws = draws or {}
    samples = _surface(store, item_idx, sample_points, generator,
                       draws.get("input"))
    transform = None
    if augment:
        samples, transform = point_augmentation(
            samples, generator, transform=draws.get("transform"))
        noise = draws.get("jitter")
        if noise is None:
            noise = torch.randn(samples.shape, generator=generator,
                                device=samples.device)
        samples = samples + noise.to(samples.device) * jitter
    return samples, transform


class SampleFromMeshDS:
    """(case, object) mesh items for PC-AE training.

    Vertices are normalized to [-1, 1] grid coordinates with respect to
    the case's world extent (size x spacing) at construction; the train
    step then only samples and augments.
    """

    def __init__(self, cases_meshes: list[list[np.ndarray]], ids: list,
                 img_sizes_world: list, sample_points: int = 1024,
                 fixed_object: int | None = None, exclude_rhf: bool = False,
                 mesh_as_target: bool = True, do_augmentation: bool = True):
        assert all(len(m) == len(cases_meshes[0]) for m in cases_meshes), \
            "all cases must have the same number of objects"
        if exclude_rhf:
            cases_meshes = [m[:2] for m in cases_meshes]
        self.num_objects = len(cases_meshes[0])
        self.sample_points = sample_points
        self.fixed_object = fixed_object
        self.mesh_as_target = mesh_as_target
        self.do_augmentation = do_augmentation
        self.ids = list(ids)
        self.img_sizes_world = [np.asarray(s, np.float32)
                                for s in img_sizes_world]
        # grid coords w.r.t. the world extent (zyx order for kpts_to_grid)
        self._soups = []
        for meshes, size_w in zip(cases_meshes, self.img_sizes_world):
            shape_zyx = size_w[::-1]
            self._soups.append([
                kpts_to_grid(m.reshape(-1, 3), shape_zyx).reshape(-1, 3, 3)
                for m in meshes])

    @classmethod
    def from_folder(cls, folder: str, sample_points: int = 1024,
                    lobes: bool = False, **kwargs) -> "SampleFromMeshDS":
        from ..utils.nifti import load_image_metadata
        mesh_dirs = sorted(glob(os.path.join(folder, "*_mesh_*")))
        if not mesh_dirs:
            raise FileNotFoundError(f"no *_mesh_* directories in {folder}")
        cases_meshes, ids, sizes = [], [], []
        for md in mesh_dirs:
            case, sequence = os.path.basename(md).split("_mesh_")
            meshes = load_meshes(folder, case, sequence,
                                 "lobe" if lobes else "fissure")
            if not meshes:
                continue
            cases_meshes.append(meshes)
            ids.append((case, sequence))
            size, spacing = load_image_metadata(
                os.path.join(folder, f"{case}_img_{sequence}.nii.gz"))
            sizes.append([sz * sp for sz, sp in zip(size, spacing)])
        return cls(cases_meshes, ids, sizes, sample_points, **kwargs)

    def __len__(self):
        return (len(self.ids) * self.num_objects
                if self.fixed_object is None else len(self.ids))

    def continuous_to_pat_index(self, item: int) -> int:
        return item // self.num_objects if self.fixed_object is None \
            else item

    def continuous_to_obj_index(self, item: int) -> int:
        return item % self.num_objects if self.fixed_object is None \
            else self.fixed_object

    def get_id(self, item):
        return self.ids[self.continuous_to_pat_index(item)]

    def get_obj_mesh(self, item) -> np.ndarray:
        """Normalized triangle soup of one (case, object) item."""
        return self._soups[self.continuous_to_pat_index(item)][
            self.continuous_to_obj_index(item)]

    def to_store(self, items=None, pad_to: int | None = None,
                 device=None) -> MeshStore:
        items = range(len(self)) if items is None else items
        return build_mesh_store([self.get_obj_mesh(i) for i in items],
                                pad_to, device)

    def sample_batch(self, store: MeshStore, item_idx: torch.Tensor,
                     generator: torch.Generator | None = None,
                     n_target_samples: int | None = None,
                     draws: dict | None = None):
        """(inputs (B, S, 3), target (B, St, 3)).

        With mesh_as_target the target is an independent dense sample
        (4 S points by default) of the same meshes, moved by the inputs'
        augmentation transform (not jittered); otherwise the target is
        the inputs."""
        samples, transform = sample_mesh_batch(
            store, item_idx, self.sample_points, generator,
            self.do_augmentation, draws=draws)
        if not self.mesh_as_target:
            return samples, samples
        n_trg = n_target_samples or 4 * self.sample_points
        target = _surface(store, item_idx, n_trg, generator,
                          (draws or {}).get("target"))
        if transform is not None:
            target = transform_points(target, transform)
        return samples, target

    def split_data_set(self, split: dict):
        def _subset(idset):
            sel = [i for i, cid in enumerate(self.ids)
                   if list(cid) in idset or cid[0] in idset]
            ds = SampleFromMeshDS.__new__(SampleFromMeshDS)
            ds.__dict__.update(self.__dict__)
            ds.ids = [self.ids[i] for i in sel]
            ds.img_sizes_world = [self.img_sizes_world[i] for i in sel]
            ds._soups = [self._soups[i] for i in sel]
            return ds
        tr = _subset([list(x) if isinstance(x, (list, tuple)) else x
                      for x in split["train"]])
        vl = _subset([list(x) if isinstance(x, (list, tuple)) else x
                      for x in split["val"]])
        vl.do_augmentation = False
        return tr, vl


def _id_set(xs) -> set:
    return {tuple(x) if isinstance(x, (list, tuple)) else (x, None)
            for x in xs}


def _select(cases: list[dict], idset: set) -> list[int]:
    return [i for i, c in enumerate(cases)
            if (c["case_id"], c["sequence"]) in idset
            or (c["case_id"], None) in idset]


class PointToMeshDS(PointDataset):
    """PointDataset plus each case's ground-truth meshes, the supervision
    of DPSR-Net's Chamfer term. Mesh vertices are normalized to grid
    coordinates with respect to the world extent."""

    def __init__(self, cases: list[dict], meshes: list[list[np.ndarray]],
                 img_sizes_world: list, **kwargs):
        super().__init__(cases, **kwargs)
        self.img_sizes_world = [np.asarray(s, np.float32)
                                for s in img_sizes_world]
        self.meshes = [[kpts_to_grid(m.reshape(-1, 3),
                                     size_w[::-1]).reshape(-1, 3, 3)
                        for m in ms]
                       for ms, size_w in zip(meshes, self.img_sizes_world)]

    def mesh_store(self, indices=None, pad_to: int | None = None,
                   device=None) -> MeshStore:
        """One item per case: all its objects merged."""
        idx = range(len(self.cases)) if indices is None else indices
        return build_mesh_store([np.concatenate(self.meshes[i], axis=0)
                                 for i in idx], pad_to, device)

    def class_mesh_store(self, label: int, indices=None,
                         pad_to: int | None = None, device=None) -> MeshStore:
        """One item per case: its mesh of class `label` (1-based)."""
        idx = range(len(self.cases)) if indices is None else indices
        return build_mesh_store([self.meshes[i][label - 1] for i in idx],
                                pad_to, device)

    def split_data_set(self, split: dict, fold_nr=None):
        """(train, val) keeping each case's meshes with it."""
        def subset(idset, aug):
            sel = _select(self.cases, idset)
            ds = PointToMeshDS.__new__(PointToMeshDS)
            PointDataset.__init__(
                ds, copy.deepcopy([self.cases[i] for i in sel]),
                sample_points=self.sample_points, binary=self.binary,
                do_augmentation=aug)
            ds.img_sizes_world = [self.img_sizes_world[i] for i in sel]
            ds.meshes = [self.meshes[i] for i in sel]
            return ds
        return (subset(_id_set(split["train"]), self.do_augmentation),
                subset(_id_set(split["val"]), False))


class CorrespondingPointDataset(PointDataset):
    """Keypoint clouds plus corresponding point sets and the similarity
    transform the network regresses.

    `corr_points`: (n_cases, P, 3) pre-registered corresponding points in
    world coordinates; `prereg_transforms`: per case {"rotation",
    "translation", "scale"}, the similarity that registered it to the mean
    shape. Case i's target is norm^-1 o prereg_i^-1 o norm (o the
    augmentation), as the 7-dof [so3 log | translation | scale] vector
    (scale repeated to 3, the model's head width).
    """

    def __init__(self, cases: list[dict], corr_points: np.ndarray,
                 prereg_transforms: list[dict],
                 corr_labels: np.ndarray | None = None,
                 do_augmentation: bool = True, **kwargs):
        kwargs.setdefault("exclude_rhf", True)
        super().__init__(cases, do_augmentation=False, **kwargs)
        assert len(cases) == len(corr_points) == len(prereg_transforms)
        self.corr_points = np.asarray(corr_points, np.float32)
        self.corr_labels = (np.zeros(self.corr_points.shape[1], np.int32)
                            if corr_labels is None
                            else np.asarray(corr_labels))
        self.prereg_transforms = prereg_transforms
        self.augment_correspondingly = do_augmentation

        def extent_zyx(c):
            if "size_world" in c:    # xyz, like sitk GetSize() * spacing
                return np.asarray(c["size_world"], np.float32)[::-1]
            return (np.asarray(c["shape"], np.float32)
                    * np.asarray(c.get("spacing", (1.0, 1.0, 1.0)),
                                 np.float32))
        self._sizes = np.stack([extent_zyx(c) for c in cases])

    @property
    def num_classes(self) -> int:
        return int(len(np.unique(self.corr_labels)))

    def normalize_pc(self, pc: np.ndarray, index: int,
                     return_transform: bool = False):
        """World -> grid coords with respect to case `index`'s world
        extent; optionally also that map as a SimilarityTransform (an
        anisotropic scale and a shift)."""
        shape_zyx = self._sizes[index]
        out = kpts_to_grid(pc, shape_zyx)
        if not return_transform:
            return out
        whd = shape_zyx[::-1].astype(np.float32)
        scale = (2.0 / whd).astype(np.float32)
        shift = (-(whd - 1.0) / whd).astype(np.float32)
        return out, SimilarityTransform(torch.eye(3),
                                        torch.from_numpy(scale),
                                        torch.from_numpy(shift))

    def target_for_case(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        """(normalized corresponding points (P, 3), 7-dof params (9,)):
        norm^-1 o prereg^-1 o norm composed as 4 x 4 row-vector matrices
        in float64, its linear part split by SVD into the closest rotation
        and the mean singular value as isotropic scale."""
        corr_norm, norm_t = self.normalize_pc(self.corr_points[index], index,
                                              return_transform=True)
        tr = self.prereg_transforms[index]

        def mat(rot, scale, trans):      # [p 1] @ M
            m = np.eye(4, dtype=np.float64)
            m[:3, :3] = np.asarray(rot, np.float64) * np.asarray(scale)
            m[3, :3] = np.asarray(trans, np.float64)
            return m

        m_norm = mat(norm_t.rotation.numpy(), norm_t.scaling.numpy(),
                     norm_t.translation.numpy())
        m_prereg = mat(tr["rotation"], tr["scale"], tr["translation"])
        m = np.linalg.inv(m_norm) @ np.linalg.inv(m_prereg) @ m_norm
        a, trans = m[:3, :3], m[3, :3]
        u, s, vt = np.linalg.svd(a)
        rot = u @ vt
        if np.linalg.det(rot) < 0:       # keep a proper rotation
            u[:, -1] *= -1
            rot = u @ vt
        scale = np.full(3, s.mean())
        log_r = so3_log_map(torch.tensor(rot, dtype=torch.float32)).numpy()
        params = np.concatenate([log_r, trans.astype(np.float32),
                                 scale.astype(np.float32)])
        return np.asarray(corr_norm, np.float32), params.astype(np.float32)

    def corr_targets(self) -> tuple[np.ndarray, np.ndarray]:
        """Stacked (n_cases, P, 3) normalized corresponding points and
        (n_cases, 9) transform params."""
        pts, params = zip(*(self.target_for_case(i)
                            for i in range(len(self))))
        return np.stack(pts), np.stack(params)

    def get_normalized_corr_datamatrix_with_affine_reg(self) -> np.ndarray:
        """(n_cases, P, 3) normalized corresponding points: the SSM's
        data matrix."""
        return np.stack([self.normalize_pc(self.corr_points[i], i)
                         for i in range(len(self))])

    def sample_batch(self, store, case_idx: torch.Tensor,
                     corr_pts: torch.Tensor, corr_params: torch.Tensor,
                     generator: torch.Generator | None = None,
                     draws: dict | None = None):
        """(x (B, S, C), (corresponding points (B, P, 3), params (B, 9))):
        sampled input clouds, with `augment_correspondingly` augmented and
        the augmentation chained after the target transform (it acts in
        the moving space)."""
        draws = draws or {}
        x, _ = sample_points_batch(store, case_idx, self.sample_points,
                                   generator, augment=False,
                                   noise=draws.get("noise"))
        t_corr = corr_pts[case_idx]
        t_params = corr_params[case_idx]
        if self.augment_correspondingly:
            coords, aug_t = point_augmentation(
                x[..., :3], generator, transform=draws.get("transform"))
            x = torch.cat([coords, x[..., 3:]], dim=-1)
            base_t = compose_transform(t_params[:, :3], t_params[:, 3:6],
                                       t_params[:, 6:7])
            log_r, trans, scale = decompose_similarity_transform(
                chain_transforms(base_t, aug_t))
            t_params = torch.cat([log_r, trans,
                                  scale.expand(*scale.shape[:-1], 3)], dim=-1)
        return x, (t_corr, t_params)

    def split_data_set(self, split: dict, fold_nr=None):
        def subset(idset, aug):
            sel = _select(self.cases, idset)
            return CorrespondingPointDataset(
                [self.cases[i] for i in sel], self.corr_points[sel],
                [self.prereg_transforms[i] for i in sel], self.corr_labels,
                do_augmentation=aug, sample_points=self.sample_points,
                exclude_rhf=False, binary=self.binary)
        return (subset(_id_set(split["train"]),
                       self.augment_correspondingly),
                subset(_id_set(split["val"]), False))
