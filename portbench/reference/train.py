"""The training cell's reference: the first steps of DGCNN training,
worked out again from the benchmark's inputs (the store, the initial
weights, the generator's seed), and the numbers that compare the
program's steps with them.

The batch draw is a frozen copy of the port's sampler's protocol
(data/store.py:sample_batch, data/augmentation.py:random_transform), so
the reference draws the same numbers from a generator seeded alike: per
step the case indices (a permutation of the store's cases, the first
`batch`), uniform noise (B, N_pad) whose `sample_points` smallest valid
entries pick the points (ties to the lower index), and a similarity
transform per row (axis from 3 uniforms, rotation 0.1 pi, translation
from 3, scale from 1); p' = (p @ R) * s + t. Loss: the nnU-Net loss,
class-weighted cross entropy plus the negative batch Dice (smoothing 1,
classes weighted by 1 / volume). Optimiser: Adam with the L2 decay added
to the gradient (torch.optim.Adam(weight_decay=...)).
"""
from __future__ import annotations

import math

import torch

from . import dgcnn


def so3_exp_map(log_rot: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (..., 3) axis-angle -> (..., 3, 3)."""
    norm = torch.linalg.norm(log_rot, dim=-1, keepdim=True)
    theta = norm[..., None]
    safe = torch.clamp(theta, min=1e-8)
    axis = log_rot / torch.clamp(norm, min=1e-8)
    zeros = torch.zeros_like(axis[..., 0])
    k = torch.stack([
        torch.stack([zeros, -axis[..., 2], axis[..., 1]], dim=-1),
        torch.stack([axis[..., 2], zeros, -axis[..., 0]], dim=-1),
        torch.stack([-axis[..., 1], axis[..., 0], zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=log_rot.dtype,
                    device=log_rot.device).expand(k.shape)
    r = eye + torch.sin(safe) * k + (1 - torch.cos(safe)) * (k @ k)
    return torch.where(theta > 1e-8, r, eye)


def draw_batch(gen, store, cfg):
    """One step's batch (x (B, S, 3), y (B, S)) from the store tensors
    (coords, labels, valid) and the generator, in the sampler's order."""
    coords, labels, valid = store
    dev = coords.device
    b, s = cfg["batch"], cfg["sample_points"]
    aug = cfg["augmentation"]
    idx = torch.randperm(coords.shape[0], generator=gen, device=dev)[:b]
    noise = torch.rand((b, coords.shape[1]), generator=gen, device=dev)
    noise = torch.where(valid[idx], noise, 2.0)
    sel = torch.sort(noise, dim=1, stable=True).indices[:, :s]
    x = torch.gather(coords[idx], 1, sel[..., None].expand(b, s, 3))
    y = torch.gather(labels[idx], 1, sel)
    v = torch.rand((b, 3), generator=gen, device=dev) * 2 - 1
    axis = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-8)
    rot = so3_exp_map(axis * (math.pi * aug["rotation"]))
    trans = (torch.rand((b, 3), generator=gen, device=dev) * 2 - 1) \
        * aug["translation"]
    scale = 1.0 - torch.rand((b, 1), generator=gen, device=dev) \
        * aug["scale"]
    x = (x @ rot) * scale[:, None, :] + trans[:, None, :]
    return x, y


def nnu_loss(logits, y, weights):
    """Class-weighted cross entropy + negative batch Dice."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, y[..., None])[..., 0]
    w = weights[y]
    ce = (w * nll).sum() / torch.clamp(w.sum(), min=1e-12)
    probs = torch.softmax(logits, dim=-1)
    y1 = torch.nn.functional.one_hot(y, logits.shape[-1]).to(probs.dtype)
    axes = tuple(range(probs.ndim - 1))
    vol = y1.sum(axes) + 1e-6
    tp = ((probs * y1).sum(axes) / vol).sum()
    fp = ((probs * (1 - y1)).sum(axes) / vol).sum()
    fn = (((1 - probs) * y1).sum(axes) / vol).sum()
    dc = (2 * tp + 1.0) / (2 * tp + fp + fn + 1.0)
    return ce - dc


def train_steps(state: dict, names: list, batches: list, weights, cfg,
                quant=None) -> dict:
    """Adam steps from `state` on `batches`: {"loss": [...], "grad1":
    {name: the first step's gradient with the decay}, "change": {name:
    parameters after the last step - before the first}}."""
    b1, b2 = cfg["betas"]
    lr, wd, eps = cfg["lr"], cfg["weight_decay"], cfg["adam_eps"]
    p = {k: v.detach().clone() for k, v in state.items()}
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    losses, grad1 = [], None
    for t, (x, y) in enumerate(batches, start=1):
        leaves = {k: p[k].clone().requires_grad_(True) for k in names}
        full = {**p, **leaves}
        logits = dgcnn.forward(full, x, cfg, train=True, quant=quant)
        loss = nnu_loss(logits, y, weights)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: gk + wd * p[k] for k, gk in zip(names, grads)}
            if grad1 is None:
                grad1 = g
            for k in names:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v[k] = b2 * v[k] + (1 - b2) * g[k] * g[k]
                mhat = m[k] / (1 - b1 ** t)
                vhat = v[k] / (1 - b2 ** t)
                p[k] = p[k] - lr * mhat / (torch.sqrt(vhat) + eps)
        del leaves, full, logits, loss, grads
    change = {k: p[k] - state[k] for k in names}
    return {"loss": losses, "grad1": grad1, "change": change}


def _norms(d: dict, names: list) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(d[k].double())
                        for k in names])


def leaf_gaps(got: dict, ref: dict, names: list) -> torch.Tensor:
    """Per leaf, |norm(got) - norm(ref)| / max(norm(ref), the median
    leaf's norm(ref))."""
    gn, rn = _norms(got, names), _norms(ref, names)
    return (gn - rn).abs() / torch.maximum(rn, rn.median())


def worst_leaf(got: dict, ref: dict, names: list) -> float:
    return float(leaf_gaps(got, ref, names).max())


def compare(got: dict, ref: dict, names: list) -> dict:
    """The numbers that compare a run's first steps with the reference's:
    the relative loss gap of the first step and the worst of the steps;
    the first gradient's gap, worst leaf and median leaf; the change's
    gap, worst and median leaf, over the leaves whose reference gradient
    is at least a thousandth of the median leaf's (leaves under it move by
    round-off alone)."""
    loss = [abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])]
    rg = _norms(ref["grad1"], names)
    moved = [k for k, n in zip(names, rg) if n >= 1e-3 * rg.median()]
    grad = leaf_gaps(got["grad1"], ref["grad1"], names)
    change = leaf_gaps(got["change"], ref["change"], moved)
    return {"loss_gap": max(loss), "loss1_gap": loss[0],
            "grad_gap": float(grad.max()),
            "grad_gap_median": float(grad.median()),
            "change_gap": float(change.max()),
            "change_gap_median": float(change.median())}
