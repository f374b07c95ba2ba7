"""DPSR-Net: point segmentation trained end to end through a differentiable
surface (counterpart of models/dpsr_net.py: `soft_mesh_surface_samples`,
`per_class_surface_samples`, `DPSRNet`, `DPSRNet2`).

v2, SoftMesh (`DPSRNet2`, the paper's main variant): the per-class softmax
scores are splatted to a grid (ops/splat.py:splat_grid_sample), a normal
field is taken as Gaussian derivatives of that grid (real space, constant
padding: utils/filters.py), the spectral Poisson solver gives an indicator
field (ops/dpsr.py), marching tetrahedra extracts its zero level set and
area-weighted samples of that surface come out (ops/marching.py). The
gradient reaches the logits through every stage; the triangle selection
and the sampler's CDF are integer or detached work, as in JAX.
v1 (`DPSRNet`): each class's points by hard argmax, their normals by kNN
PCA (ops/normals.py, K1 on B * C' masked clouds), rasterized and solved
the same way; the argmax cuts the gradient, so only the segmentation loss
trains the net (the JAX package's and the reference's behaviour).

The port follows the JAX package, not the reference, on two points that
package documents: the normal field's channel d is the derivative along
grid dim d (the reference swaps x and z), and the spectral solver gets
zyx coordinates in [0, 1] (the reference passes raw [-1, 1] ones).

Extraction: the JAX package maps over the B * C' fields one at a time
(`lax.map`); here `marching_tetrahedra_batched` takes all of them at once,
each truncated to `max_tris` in z-order (at the entry's defaults, 96 fields
of 128^3, the step's peak stays under a quarter of the card's memory:
PERF.md, PR 14). Random draws: `generator` (on the logits' device), or
`draws` = (u (B * C', S), uv (B * C', S, 2)) injected, the JAX package's
per-field uniforms of `sample_points_on_triangles` (tests pass them). A
forward given neither uses a generator seeded 0 on every call, as the JAX
module falls back to PRNGKey(0) when no "surface" rng is given, which its
trainer never gives. The forward's stages run in the spans (utils/
profiling.py) "dpsr:seg_net", "dpsr:splat_normals", "dpsr:psr" and
"dpsr:marching_sampling", profiler ranges of the same names under a
profiler (the card's step breakdown reads them).

Output: (seg_logits (B, N, C), surface samples (B, C', S, 3) xyz grid
coords, valid (B, C', S)[, psr (B, C', *res)]).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.dpsr import spectral_psr
from ..ops.marching import (marching_tetrahedra_batched,
                            sample_points_on_triangles)
from ..ops.normals import estimate_pointcloud_normals
from ..ops.splat import point_rasterize, splat_grid_sample
from ..utils.filters import gaussian_differentiation
from ..utils.profiling import span
from .access_models import get_point_seg_model_class


def _surface_draws(n_fields: int, n_samples: int, generator, draws,
                   device):
    if draws is not None:
        return tuple(d.to(device) for d in draws)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dev = generator.device
    return (torch.rand((n_fields, n_samples), generator=generator,
                       device=dev).to(device),
            torch.rand((n_fields, n_samples, 2), generator=generator,
                       device=dev).to(device))


def _extract(psr: torch.Tensor, max_tris: int, n_samples: int, draws):
    """Marching tetrahedra and surface samples of each (B', D, H, W)
    field: (samples (B', S, 3) zyx voxel coords, surface found (B',))."""
    with span("dpsr:marching_sampling"):
        tris, tvalid, _ = marching_tetrahedra_batched(psr, max_tris)
        return (sample_points_on_triangles(tris, tvalid, n_samples,
                                           draws=draws), tvalid.any(-1))


def _to_grid_xyz(pts: torch.Tensor, res) -> torch.Tensor:
    """zyx voxel coords -> xyz grid coords in [-1, 1]."""
    sz = torch.tensor(res, dtype=pts.dtype, device=pts.device) - 1
    return ((pts / sz) * 2.0 - 1.0).flip(-1)


def soft_mesh_surface_samples(seg_logits: torch.Tensor, coords: torch.Tensor,
                              res=(128, 128, 128),
                              normals_smoothing_sigma: float = 10.0,
                              dpsr_sigma: float = 10.0,
                              dpsr_scale: bool = True,
                              dpsr_shift: bool = True,
                              max_tris: int = 100_000,
                              n_surface_samples: int = 2048,
                              exclude_background: bool = True,
                              generator: torch.Generator | None = None,
                              draws=None):
    """SoftMesh: surface samples per (batch, class).

    :param seg_logits: (B, N, C) raw logits
    :param coords: (B, N, 3) xyz grid coords in [-1, 1]
    :return: (samples (B, C', S, 3) xyz grid coords, valid (B, C', S),
        psr grids (B, C', *res))
    """
    res = tuple(res)
    b, n, c = seg_logits.shape
    with span("dpsr:splat_normals"):
        probs = torch.softmax(seg_logits, dim=-1)
        if exclude_background:
            probs = probs[..., 1:]
            c -= 1
        coords = coords.clamp(-1.0, 1.0)
        seg_grid = splat_grid_sample(probs, coords, res)      # (B, C', *res)
        # normal field: channel d = d/d(grid dim d); truncate 1.5, constant
        # padding (the reference's)
        normals = torch.stack([
            gaussian_differentiation(seg_grid, normals_smoothing_sigma,
                                     order=1, dim=d, padding_mode="constant",
                                     truncate=1.5)
            for d in range(3)], dim=2).reshape(b * c, 3, *res)
    v_rep = ((coords.flip(-1) + 1.0) / 2.0).repeat_interleave(c, dim=0)
    with span("dpsr:psr"):
        psr = spectral_psr(v_rep, normals, res, dpsr_sigma, scale=dpsr_scale,
                           shift=dpsr_shift)                  # (B*C', *res)
    pts, found = _extract(psr, max_tris, n_surface_samples,
                          _surface_draws(b * c, n_surface_samples, generator,
                                         draws, seg_logits.device))
    valid = found[:, None].expand(b * c, n_surface_samples)
    return (_to_grid_xyz(pts, res).reshape(b, c, n_surface_samples, 3),
            valid.reshape(b, c, n_surface_samples),
            psr.reshape(b, c, *res))


def per_class_surface_samples(seg_logits: torch.Tensor, coords: torch.Tensor,
                              res=(128, 128, 128), dpsr_sigma: float = 10.0,
                              dpsr_scale: bool = True,
                              dpsr_shift: bool = True, k_normals: int = 30,
                              max_tris: int = 100_000,
                              n_surface_samples: int = 2048,
                              min_points: int = 4,
                              generator: torch.Generator | None = None,
                              draws=None):
    """DPSR-Net v1: hard-argmax per-class points -> kNN-PCA normals ->
    spectral DPSR -> surface samples. Every class keeps the full cloud
    with a mask: masked points get zero normals and weight 0 in the
    solver's shift; a class of fewer than `min_points` points gives a
    constant field and no valid samples.

    :return: as `soft_mesh_surface_samples`, for the C - 1 fissure classes
    """
    res = tuple(res)
    b, n, cc = seg_logits.shape
    c = cc - 1
    with span("dpsr:splat_normals"):
        pred = seg_logits.argmax(-1)                          # (B, N)
        coords = coords.clamp(-1.0, 1.0)
        v_zyx = (coords.flip(-1) + 1.0) / 2.0
        class_ids = torch.arange(1, cc, device=pred.device)
        masks = (pred[:, None, :] == class_ids[None, :, None]).reshape(
            b * c, n)
        v_rep = v_zyx.repeat_interleave(c, dim=0)             # (B*C', N, 3)
        normals = estimate_pointcloud_normals(v_rep, k=min(k_normals, n - 1),
                                              mask=masks)
        normals = torch.where(masks[..., None], normals, 0.0)
        ras = point_rasterize(v_rep, normals, res)            # (B*C', 3, *res)
    with span("dpsr:psr"):
        psr = spectral_psr(v_rep, ras, res, dpsr_sigma, scale=dpsr_scale,
                           shift=dpsr_shift, point_weights=masks.float())
    class_ok = masks.sum(-1) >= min_points
    psr = torch.where(class_ok[:, None, None, None],
                      torch.nan_to_num(psr, nan=1.0, posinf=1.0, neginf=1.0),
                      1.0)
    pts, found = _extract(psr, max_tris, n_surface_samples,
                          _surface_draws(b * c, n_surface_samples, generator,
                                         draws, seg_logits.device))
    valid = (found & class_ok)[:, None].expand(b * c, n_surface_samples)
    return (_to_grid_xyz(pts, res).reshape(b, c, n_surface_samples, 3),
            valid.reshape(b, c, n_surface_samples),
            psr.reshape(b, c, *res))


class _DPSRBase(nn.Module):
    """The segmentation net (submodule `{class}_0`, the JAX tree's name)
    and the constructor config; subclasses add the surface path."""

    def __init__(self, seg_net_class: str, k: int, in_features: int,
                 num_classes: int, spatial_transformer: bool, dynamic: bool,
                 image_feat_module: bool, generator, **surface):
        super().__init__()
        seg_cls = get_point_seg_model_class(seg_net_class)
        self.seg_name = f"{seg_cls.__name__}_0"
        setattr(self, self.seg_name, seg_cls(
            k=k, in_features=in_features, num_classes=num_classes,
            spatial_transformer=spatial_transformer, dynamic=dynamic,
            image_feat_module=image_feat_module, generator=generator))
        surface["dpsr_res"] = tuple(surface["dpsr_res"])
        self.surface = surface
        self.config = dict(seg_net_class=seg_net_class, k=k,
                           in_features=in_features, num_classes=num_classes,
                           spatial_transformer=spatial_transformer,
                           dynamic=dynamic,
                           image_feat_module=image_feat_module,
                           **{k_: list(v) if isinstance(v, tuple) else v
                              for k_, v in surface.items()})

    @property
    def seg_net(self) -> nn.Module:
        return getattr(self, self.seg_name)

    @property
    def n_surface_samples(self) -> int:
        return self.surface["n_surface_samples"]

    def forward(self, x: torch.Tensor, generator=None, draws=None,
                return_psr: bool = False):
        with span("dpsr:seg_net"):
            seg_logits = self.seg_net(x)
        samples, valid, psr = self.surface_samples(
            seg_logits, x[..., :3], generator=generator, draws=draws)
        if return_psr:
            return seg_logits, samples, valid, psr
        return seg_logits, samples, valid


class DPSRNet(_DPSRBase):
    """DPSR-Net v1: seg net + per-class hard extraction with estimated
    normals."""

    def __init__(self, seg_net_class: str, k: int, in_features: int,
                 num_classes: int, spatial_transformer: bool = False,
                 dynamic: bool = True, image_feat_module: bool = False,
                 dpsr_res: Sequence[int] = (128, 128, 128),
                 dpsr_sigma: float = 10.0, dpsr_scale: bool = True,
                 dpsr_shift: bool = True, k_normals: int = 30,
                 max_tris: int = 100_000, n_surface_samples: int = 2048,
                 generator: torch.Generator | None = None):
        super().__init__(seg_net_class, k, in_features, num_classes,
                         spatial_transformer, dynamic, image_feat_module,
                         generator, dpsr_res=dpsr_res, dpsr_sigma=dpsr_sigma,
                         dpsr_scale=dpsr_scale, dpsr_shift=dpsr_shift,
                         k_normals=k_normals, max_tris=max_tris,
                         n_surface_samples=n_surface_samples)

    def surface_samples(self, seg_logits, coords, **kw):
        s = self.surface
        return per_class_surface_samples(
            seg_logits, coords, res=s["dpsr_res"], dpsr_sigma=s["dpsr_sigma"],
            dpsr_scale=s["dpsr_scale"], dpsr_shift=s["dpsr_shift"],
            k_normals=s["k_normals"], max_tris=s["max_tris"],
            n_surface_samples=s["n_surface_samples"], **kw)


class DPSRNet2(_DPSRBase):
    """DPSR-Net v2: seg net + SoftMesh."""

    def __init__(self, seg_net_class: str, k: int, in_features: int,
                 num_classes: int, spatial_transformer: bool = False,
                 dynamic: bool = True, image_feat_module: bool = False,
                 normals_smoothing_sigma: float = 10.0,
                 dpsr_res: Sequence[int] = (128, 128, 128),
                 dpsr_sigma: float = 10.0, dpsr_scale: bool = True,
                 dpsr_shift: bool = True, max_tris: int = 100_000,
                 n_surface_samples: int = 2048,
                 generator: torch.Generator | None = None):
        super().__init__(seg_net_class, k, in_features, num_classes,
                         spatial_transformer, dynamic, image_feat_module,
                         generator,
                         normals_smoothing_sigma=normals_smoothing_sigma,
                         dpsr_res=dpsr_res, dpsr_sigma=dpsr_sigma,
                         dpsr_scale=dpsr_scale, dpsr_shift=dpsr_shift,
                         max_tris=max_tris,
                         n_surface_samples=n_surface_samples)

    def surface_samples(self, seg_logits, coords, **kw):
        s = self.surface
        return soft_mesh_surface_samples(
            seg_logits, coords, res=s["dpsr_res"],
            normals_smoothing_sigma=s["normals_smoothing_sigma"],
            dpsr_sigma=s["dpsr_sigma"], dpsr_scale=s["dpsr_scale"],
            dpsr_shift=s["dpsr_shift"], max_tris=s["max_tris"],
            n_surface_samples=s["n_surface_samples"], **kw)
