"""Mesh-backed dataset of the PC-AE (counterpart of data/mesh_dataset.py:
`MeshStore`, `build_mesh_store`, `sample_mesh_batch`, `SampleFromMeshDS`).

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

Not ported yet: `PointToMeshDS` and `CorrespondingPointDataset` (DPSR-Net
and DG-SSM).
"""
from __future__ import annotations

import os
from glob import glob
from typing import NamedTuple

import numpy as np
import torch

from ..ops.marching import sample_points_on_triangles
from ..utils.coords import kpts_to_grid
from ..utils.objio import load_obj, mesh_to_triangle_soup
from .augmentation import point_augmentation, transform_points


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
