"""The serving cells' reference: for a served case, its keypoints and
labels worked out again from the benchmark's inputs (the CT, its lung
mask, the weights, the case's generator seed), and the numbers that judge
the program's answer by them.

The draws are a frozen copy of the port's protocol for a CPU generator
`g` and a case served on `device` (keypoints/extraction.py:device_generator
and uniform_scores, models/ensemble.py:build_subsets): on a card, a 62-bit
integer from `g` seeds a generator there that draws the D*H*W uniform
keypoint scores (on the CPU, `g` draws them); then from `g` on the CPU, a
permutation of the keypoint slots whose first ceil(n/S) rows of S cover
every slot (the tail wrapped), then one permutation a further subset,
its first S.

Keypoints: the foreground (argmax over classes not 0) inside the lung
mask; of it the `max_kpts` voxels of largest score (ties to the lower
flat index), zyx. Labels: the point model on grid coordinates of the
keypoints (xyz voxel / (size - 1) * 2 - 1, times (size - 1) / size;
empty slots at -1), summed softmax over the subsets (groups of
`subset_batch`), a final softmax, its argmax.
"""
from __future__ import annotations

import torch

from . import dgcnn, mobilenet_aspp
from ..gen.weights import class_bias


def score_draw(gen: torch.Generator, n: int, device) -> torch.Tensor:
    device = torch.device(device)
    if gen.device.type != device.type:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=gen.device))
        gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(n, generator=gen, device=device)


def subset_draw(gen: torch.Generator, n: int, s: int, runs_min: int):
    n_cover = -(-n // s)
    perm = torch.randperm(n, generator=gen)
    pad = n_cover * s - n
    covered = torch.cat([perm, perm[:pad]]) if pad else perm
    rows = [covered.reshape(n_cover, s)]
    rows += [torch.randperm(n, generator=gen)[None, :s]
             for _ in range(max(runs_min, n_cover) - n_cover)]
    return torch.cat(rows)


def select(soft: torch.Tensor, mask: torch.Tensor, scores: torch.Tensor,
           max_kpts: int):
    """(kpts (n, 3) int64 zyx, flat indices (n,)) of the selection."""
    d, h, w, _ = soft.shape
    fg = ((soft.argmax(-1) != 0) & mask).reshape(-1)
    score = torch.where(fg, scores, -torch.inf)
    vals, idx = torch.sort(score, descending=True, stable=True)
    idx = idx[:max_kpts][torch.isfinite(vals[:max_kpts])]
    kp = torch.stack([idx // (h * w), (idx // w) % h, idx % w], -1)
    return kp, idx


def grid_points(kpts: torch.Tensor, shape, n_slots: int) -> torch.Tensor:
    """(n_slots, 3) grid coordinates xyz of zyx keypoints, empty slots -1."""
    d, h, w = shape
    size = torch.tensor([w, h, d], dtype=torch.float32, device=kpts.device)
    world = kpts.flip(-1).to(torch.float32)
    g = (world / (size - 1) * 2 - 1) * ((size - 1) / size)
    out = torch.full((n_slots, 3), -1.0, device=kpts.device)
    out[:len(g)] = g
    return out


@torch.no_grad()
def ensemble(p: dict, pc: torch.Tensor, subsets: torch.Tensor, cfg: dict,
             serving: dict, band_list: list, quant=None) -> torch.Tensor:
    """(N, C) final softmax of the subset ensemble."""
    sb = serving["subset_batch"]
    subsets = subsets.to(pc.device)
    r, s = subsets.shape
    if r % sb:
        subsets = torch.cat([subsets, subsets[:sb - r % sb]])
    acc = torch.zeros(pc.shape[0], cfg["num_classes"], device=pc.device)
    for group in subsets.reshape(-1, sb, s):
        x = pc[group]
        out = class_bias(x, dgcnn.forward(p, x, cfg, train=False,
                                          quant=quant),
                         band_list, cfg["class_bias"])
        probs = torch.softmax(out, dim=-1)
        for rows, pr in zip(group, probs):
            acc.index_add_(0, rows, pr)
    return torch.softmax(acc, dim=-1)


@torch.no_grad()
def answer(cnn_p, point_p, vol, mask, gen, config: dict, band_list: list,
           soft=None, labels: bool = True):
    """The reference's own (kpts (n, 3) zyx, labels (n,) or None) of a case;
    `soft`: the case's CNN softmax if already computed; `labels` False
    skips the ensemble."""
    serving, pcfg = config["serving"], config["point_model"]
    if soft is None:
        soft = mobilenet_aspp.softmax_volume(cnn_p, vol, config)
    scores = score_draw(gen, vol.numel(), vol.device)
    kp, _ = select(soft, mask, scores, serving["max_kpts"])
    if not labels:
        return kp, None
    subsets = subset_draw(gen, serving["max_kpts"], serving["sample_points"],
                          serving["n_runs_min"])
    pc = grid_points(kp, vol.shape, serving["max_kpts"])
    probs = ensemble(point_p, pc, subsets, pcfg, serving, band_list)
    return kp, probs[:len(kp)].argmax(-1)


@torch.no_grad()
def judge(kpts, labels, vol, mask, soft, gen, config: dict, point_p,
          band_list: list, labels_too: bool = True) -> dict:
    """The numbers that judge an answer (kpts (n, 3) zyx, labels (n,)):
      outside_mask  keypoints outside the lung mask
      kp_gap        the widest gap by which the class the answer decided a
                    voxel for lies below the reference CNN's best class:
                    every keypoint was decided foreground (its gap: the
                    best class's probability less the best foreground
                    class's), and every voxel of the mask whose score is
                    above the lowest keypoint's (draws tie: a voxel that
                    ties it may lose to a lower index) and that is no
                    keypoint was decided background (its gap: the best class's
                    probability less the background's); with fewer than
                    `max_kpts` keypoints every other voxel of the mask was
                    decided background
      label_gap     (`labels_too`) the widest, over the keypoints, of the
                    reference's best final probability less that of the
                    answer's label, the ensemble run on the answer's
                    keypoints with the case's subsets
      kp_missed     keypoints of the reference's selection that the answer
                    lacks (not compared: TF32 flips too few voxels in some
                    cases' selections to read above float32's flips)
    `soft`: the reference's CNN softmax of the case; `gen`: the case's
    generator, fresh."""
    serving, pcfg = config["serving"], config["point_model"]
    d, h, w = vol.shape
    kpts = kpts.to(vol.device).long()
    flat = (kpts[:, 0] * h + kpts[:, 1]) * w + kpts[:, 2]
    mflat = mask.reshape(-1)
    sflat = soft.reshape(-1, soft.shape[-1])
    outside = int((~mflat[flat]).sum())
    scores = score_draw(gen, vol.numel(), vol.device)
    best = sflat[flat].amax(-1)
    kp_gap = float((best - sflat[flat, 1:].amax(-1)).max()) if len(flat) \
        else 0.0
    lowest = scores[flat].min() if len(flat) >= serving["max_kpts"] \
        else -torch.inf
    bg = mflat & (scores > lowest)
    bg[flat] = False
    bg = bg.nonzero()[:, 0]
    if len(bg):
        kp_gap = max(kp_gap, float((sflat[bg].amax(-1) - sflat[bg, 0]).max()))
    _, ref_flat = select(soft, mask, scores, serving["max_kpts"])
    out = {"outside_mask": outside, "kp_gap": kp_gap,
           "kp_missed": int((~torch.isin(ref_flat, flat)).sum())}
    if labels_too:
        labels = labels.to(vol.device).long()
        subsets = subset_draw(gen, serving["max_kpts"],
                              serving["sample_points"],
                              serving["n_runs_min"])
        pc = grid_points(kpts, vol.shape, serving["max_kpts"])
        probs = ensemble(point_p, pc, subsets, pcfg, serving,
                         band_list)[:len(kpts)]
        out["label_gap"] = float((probs.amax(-1) - probs.gather(
            1, labels[:, None])[:, 0]).max()) if len(kpts) else 0.0
    return out
