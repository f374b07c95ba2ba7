"""DSEG-AE: a trained segmentation model regularized by a trained PC-AE, at
test time (counterpart of models/dseg_ae.py).

The full cloud is segmented by subset ensembling (models/ensemble.py);
the points of each fissure class are selected with a mask, optionally
padded with jittered copies (`random_extend_points`), sampled to the AE's
input size — farthest-point sampling with the mask (K5, ops/fps.py) or
the mean of 10 decodings of random subsets ("accumulate") — and decoded to
a regularized mesh.

Draws come from one CPU `torch.Generator` (the subsets, then per class
the padding's and the accumulation's uniforms and normals, moved to the
cloud's device); each can be injected instead through `draws` (the parity
tests pass the JAX package's):

  * "subsets": (R, S) ensemble subsets;
  * "classes": one dict per fissure class with "extend": (u (1, N),
    direction (1, N, 3), magnitude (1, N, 1)) — uniforms and standard
    normals — and "accumulate": 10 uniform (1, N) score arrays.
"""
from __future__ import annotations

import torch

from ..ops.fps import farthest_point_sampling
from ..ops.knn import knn
from .ensemble import ensemble_predict
from .folding_net import folding_points_for

N_ACCUMULATE = 10


def random_extend_points(points: torch.Tensor, valid: torch.Tensor,
                         desired_n: int,
                         generator: torch.Generator | None = None,
                         draws=None):
    """Pad a masked (B, N, 3) cloud with jittered copies of valid points:
    every invalid slot below `desired_n` takes a random valid point moved
    in a random direction by a normal distance with the mean and std of
    the nearest-neighbour distances among the valid points.

    The neighbour distances are K1's (`knn(·, 1, self_loop=False)`) on the
    cloud with invalid points moved to 1e6 (their distances to valid
    points are about 3e12 in float32; ties to the lower index).

    :param draws: (u (B, N), direction (B, N, 3), magnitude (B, N, 1)) to
        use instead of the generator's
    :return: (points (B, N, 3), valid (B, N))
    """
    b, n, _ = points.shape
    n_valid = valid.sum(-1, keepdim=True)                       # (B, 1)
    far = torch.where(valid[..., None], points,
                      torch.tensor(1e6, dtype=points.dtype,
                                   device=points.device))
    _, dist = knn(far.contiguous(), 1, self_loop=False, return_dist=True)
    d = torch.sqrt(torch.clamp(dist[..., 0], min=0.0))
    d = torch.where(valid, d, torch.nan)
    avg = torch.nanmean(d, -1, keepdim=True)
    std = torch.where(n_valid > 1, torch.sqrt(torch.nanmean(
        (d - avg) ** 2, -1, keepdim=True)), 0.0)

    if draws is None:
        draws = (torch.rand((b, n), generator=generator),
                 torch.randn((b, n, 3), generator=generator),
                 torch.randn((b, n, 1), generator=generator))
    u, direction, mag = (t.to(device=points.device, dtype=points.dtype)
                         for t in draws)
    # a random valid source point per slot, by its rank among the valid
    src_rank = torch.floor(u * n_valid).long()
    order = torch.sort(torch.where(valid, 0, 1), dim=-1, stable=True).indices
    src_idx = torch.gather(order, -1, src_rank.clamp(0, n - 1))
    src = torch.gather(points, 1, src_idx[..., None].expand(b, n, 3))
    direction = direction / torch.clamp(
        torch.linalg.norm(direction, dim=-1, keepdim=True), min=1e-12)
    magnitude = mag * std[..., None] + avg[..., None]
    jittered = src + direction * magnitude

    slot = torch.arange(n, device=points.device)[None]
    need = (~valid) & (slot < desired_n)
    return torch.where(need[..., None], jittered, points), valid | need


class RegularizedSegDGCNN:
    """The composition model (test time only, like the reference)."""

    def __init__(self, seg_model, ae_model, n_points_seg: int = 2048,
                 n_points_ae: int = 1024, sample_mode: str = "farthest",
                 random_extend: bool = False):
        """
        :param seg_model: (B, S, C) -> (B, S, num_classes) logits, in eval
            mode, with `config["num_classes"]`
        :param ae_model: a DGCNNFoldingNet in eval mode
        """
        if sample_mode not in ("farthest", "accumulate"):
            raise NotImplementedError(
                f"Sampling mode {sample_mode} not implemented.")
        self.seg_model, self.ae = seg_model, ae_model
        self.n_points_seg = n_points_seg
        self.n_points_ae = n_points_ae
        self.sample_mode = sample_mode
        self.random_extend = random_extend

    def segment(self, pc: torch.Tensor,
                generator: torch.Generator | None = None,
                subsets: torch.Tensor | None = None) -> torch.Tensor:
        """(N, C_in) full cloud -> (N,) argmax labels (the subset
        ensemble, 50 runs)."""
        probs = ensemble_predict(self.seg_model, pc,
                                 sample_points=self.n_points_seg,
                                 generator=generator, subsets=subsets)
        return probs.argmax(-1)

    @torch.no_grad()
    def reconstruct(self, pc: torch.Tensor, seg: torch.Tensor,
                    generator: torch.Generator | None = None,
                    return_hidden: bool = False, draws: list | None = None):
        """Per fissure class: masked sampling -> PC-AE decode.

        :param draws: one dict per class (module docstring)
        :return: a list over classes 1.. of (verts (1, m, 3), faces) (or
            verts, with `return_hidden` (out, code)), or None where fewer
            than the AE's k points were segmented
        """
        coords = pc[None, :, :3].contiguous()
        outputs = []
        for obj in range(1, self.seg_model.config["num_classes"]):
            d = draws[obj - 1] if draws is not None else {}
            m = (seg == obj)[None]
            n_pts = int(m.sum())
            if n_pts < self.ae.k:
                outputs.append(None)
                continue
            pts, valid = coords, m
            if self.random_extend and n_pts < self.n_points_ae:
                pts, valid = random_extend_points(coords, m,
                                                  self.n_points_ae,
                                                  generator, d.get("extend"))
            if self.sample_mode == "farthest":
                idx = farthest_point_sampling(pts, self.n_points_ae,
                                              mask=valid).long()
                sampled = torch.gather(pts, 1, idx[..., None].expand(
                    *idx.shape, 3))
                out = self.ae(sampled, return_hidden=return_hidden)
            else:
                # the mean decoding of random subsets (folding_net.py:66-80)
                outs = []
                scores = d.get("accumulate") or [None] * N_ACCUMULATE
                for score in scores:
                    if score is None:
                        score = torch.rand(valid.shape, generator=generator)
                    score = torch.where(valid, score.to(pts.device),
                                        -torch.inf)
                    # lax.top_k's order: descending, ties to the lower index
                    sidx = torch.sort(score, dim=-1, descending=True,
                                      stable=True).indices[
                        :, :self.n_points_ae]
                    sub = torch.gather(pts, 1, sidx[..., None].expand(
                        *sidx.shape, 3))
                    o = self.ae(sub)
                    outs.append(o[0] if isinstance(o, tuple) else o)
                verts = sum(outs) / len(outs)
                if self.ae.decode_mesh:
                    _, faces = folding_points_for(self.ae.shape_type,
                                                  self.ae.m, True)
                    out = (verts, torch.from_numpy(faces).to(verts.device))
                else:
                    out = verts
            outputs.append(out)
        return outputs

    def __call__(self, pc: torch.Tensor,
                 generator: torch.Generator | None = None,
                 return_hidden: bool = False, draws: dict | None = None):
        draws = draws or {}
        seg = self.segment(pc, generator, draws.get("subsets"))
        return self.reconstruct(pc, seg, generator, return_hidden,
                                draws.get("classes")), seg
