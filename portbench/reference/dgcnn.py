"""Plain DGCNN point segmentation (Wang et al., "Dynamic Graph CNN for
Learning on Point Clouds", the reference's models/dgcnn.py): float32
PyTorch operations only, no kernel, no fusion. It reads the weights the
benchmark made, by the names the program's state uses.

Static graph: the k nearest neighbours of each point by squared euclidean
distance of the coordinates, self excluded (the k + 1 nearest, ties to the
lower index, then the first dropped). EdgeConv: edge features
concat(x_j - x_i, x_i) -> Dense -> BatchNorm -> LeakyReLU(0.2) (-> Dense ->
BatchNorm -> LeakyReLU) -> max over the k edges. Head: the three EdgeConv
outputs concatenated (192) -> Dense(1024) + BatchNorm + LeakyReLU -> max
over points -> concatenated to every point -> Dense 256, 256, 128 (+
BatchNorm + LeakyReLU) -> Dense(num_classes) with bias. BatchNorm over
every axis but the last: in training the batch's mean and biased
variance, in eval the running statistics; y = (x - mean) / sqrt(var +
eps) * scale + offset.

`quant` computes at a lower precision (reference/precision.py), as the
program computes in a compute dtype: every activation (each EdgeConv's
input and edge features, each product's operands and output, each
BatchNorm's and LeakyReLU's output) and each weight is rounded to it;
BatchNorm's statistics stay float32. None computes in float32.
"""
from __future__ import annotations

import torch

from .precision import rounded


def knn_graph(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, 3) coordinates -> (B, N, k) int64 neighbours, self excluded;
    distances summed channel by channel in channel order, a stable sort."""
    d = None
    for ch in range(x.shape[-1]):
        diff = x[..., :, None, ch] - x[..., None, :, ch]
        sq = diff * diff
        d = sq if d is None else d + sq
    idx = torch.sort(d, dim=-1, stable=True).indices
    return idx[..., 1:k + 1]


def _bn(x, p, name, train, eps, quant=None):
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = x.mean(axes)
        var = ((x - mean) ** 2).mean(axes)
    else:
        mean, var = p[name + ".mean"], p[name + ".var"]
    return rounded((x - mean) * torch.rsqrt(var + eps) * p[name + ".scale"]
                   + p[name + ".bias"], quant)


def _lrelu(x, slope, quant=None):
    return rounded(torch.where(x >= 0, x, slope * x), quant)


def _mm(x, w, quant):
    """x @ w with both operands and the product rounded by `quant`."""
    return rounded(rounded(x, quant) @ rounded(w, quant), quant)


def _dense(x, p, name, quant):
    """A torch Linear weight (out, in) applied to the last axis."""
    y = _mm(x, p[name + ".weight"].t(), quant)
    if name + ".bias" in p:
        y = y + p[name + ".bias"]
    return y


def _edge_features(x, idx):
    b, n, c = x.shape
    nb = x[torch.arange(b, device=x.device)[:, None, None], idx]
    ctr = x[:, :, None, :].expand_as(nb)
    return torch.cat([nb - ctr, ctr], -1)


def forward(p: dict, x: torch.Tensor, cfg: dict, train: bool,
            quant=None, idx: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, 3) grid coordinates -> (B, N, num_classes) float32 logits.

    :param p: {name: tensor}, the program's state names
    :param cfg: the configuration (k, edge_widths, negative_slope, eps)
    :param idx: the static graph, if already built
    """
    slope, eps = cfg["negative_slope"], cfg["batchnorm_epsilon"]
    if idx is None:
        idx = knn_graph(x[..., :3], cfg["k"])
    feats, h = [], x
    for i, widths in enumerate(cfg["edge_widths"]):
        pre = f"EdgeConv_{i}."
        e = rounded(_edge_features(rounded(h, quant), idx), quant)
        e = _mm(e, p[pre + "EdgeMLP_0.kernel"], quant)
        e = _lrelu(_bn(e, p, pre + "EdgeMLP_0.BatchNorm_0", train, eps,
                       quant), slope, quant)
        for j in range(len(widths) - 1):
            sub = pre + f"SharedMLP_{j}."
            e = _dense(e, p, sub + "Dense_0", quant)
            e = _lrelu(_bn(e, p, sub + "BatchNorm_0", train, eps, quant),
                       slope, quant)
        h = e.amax(dim=-2)
        feats.append(h)
    multi = torch.cat(feats, -1)

    def shared(t, j):
        t = _dense(t, p, f"SharedMLP_{j}.Dense_0", quant)
        return _lrelu(_bn(t, p, f"SharedMLP_{j}.BatchNorm_0", train, eps,
                          quant), slope, quant)
    g = shared(multi, 0).amax(dim=-2, keepdim=True)
    h = torch.cat([multi, g.expand(*multi.shape[:-1], g.shape[-1])], -1)
    for j in range(1, 1 + len(cfg["head_widths"])):
        h = shared(h, j)
    return _dense(h, p, f"SharedMLP_{1 + len(cfg['head_widths'])}.Dense_0",
                  quant)
