"""Weights from the seed, and the serving cells' class bias.

`seeded_state` fills a model's state (names and shapes as the program's
`state_dict` lists them) from one normal draw on the device, scaled leaf
by leaf by the leaf's shape, as the program's own initialisers would:
  * 5-d convolution weights (out, in / groups, k, k, k): kaiming-normal
    over fan-out, std sqrt(2 / (out k^3)) (models/seg_cnn.py);
  * 4-d depthwise kernels (3, 3, 3, C), K6's layout: the same with
    fan-out C * 27;
  * 2-d weights (Dense (out, in), the EdgeMLP kernel (2C, F)):
    xavier-normal, std sqrt(2 / (rows + cols));
  * BatchNorm: scale 1, offset drawn from +-[0.05, 0.1] (chip_smoke.py's
    `_draw_bn_offsets`: eval-mode BatchNorm is then no identity), running
    mean 0 and variance 1; other biases 0.
The benchmark hands the same tensors to the program (`load_state_dict`)
and to the plain reference.

`ClassBias` is chip_smoke.py's `biased_model`, frozen here: random weights
label points at random, so the served point model's logits get +`bias` on
a fissure's class for grid points within two standard deviations (+0.02)
of that fissure's mean height and on its lung's side; every class then
has points, and the surface fit has work. The bands come from one case's
fissure parameters (`bands`); the reference adds the same bias.
"""
from __future__ import annotations

import math

import torch

from .points import FISSURES, LUNGS, in_lung, surface_z


def _is_batchnorm(name: str, names: set) -> bool:
    prefix = name.rsplit(".", 1)[0]
    return f"{prefix}.scale" in names and f"{prefix}.var" in names


def seeded_state(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor on `device`} for {name: shape} (a state dict's
    names and shapes, in its order)."""
    names = set(shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for s in shapes.values()]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    sign = torch.randint(0, 2, (sum(sizes),), generator=gen,
                         device=device) * 2 - 1
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        sl = slice(at, at + size)
        at += size
        leaf = name.rsplit(".", 1)[-1]
        if _is_batchnorm(name, names):
            if leaf == "scale" or leaf == "var":
                t = torch.ones(size, device=device)
            elif leaf == "bias":
                t = sign[sl] * (0.05 + 0.05 * uniform[sl])
            else:
                t = torch.zeros(size, device=device)
        elif len(shape) == 5:
            std = math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
            t = normal[sl] * std
        elif len(shape) == 4:
            std = math.sqrt(2.0 / (shape[-1] * math.prod(shape[:3])))
            t = normal[sl] * std
        elif len(shape) == 2:
            t = normal[sl] * math.sqrt(2.0 / (shape[0] + shape[1]))
        else:
            t = torch.zeros(size, device=device)
        out[name] = t.reshape(shape).to(torch.float32).contiguous()
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    """{name: shape} of a module's floating-point state."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()
            if v.is_floating_point()}


def bands(params: dict, shape, seed: int = 11) -> list:
    """(mean height, half width, side) in grid coordinates of each fissure
    class, from 2000 points on each sheet of the case with parameters
    `params` {label: (5,)} in a `shape` (D, H, W) volume."""
    d, h, w = shape
    scale = torch.tensor([w, h, d], dtype=torch.float32) - 1
    gen = torch.Generator().manual_seed(seed)
    out = []
    for lbl, (lung, _, _) in FISSURES.items():
        c, ax = LUNGS[lung]
        p = params[lbl].detach().cpu().to(torch.float32)
        pts = []
        while sum(len(q) for q in pts) < 2000:
            u = torch.rand((8000, 2), generator=gen)
            x = c[0] - ax[0] + u[:, 0] * 2 * ax[0]
            y = c[1] - ax[1] + u[:, 1] * 2 * ax[1]
            z = surface_z(p, x[:, None], y[:, None], c[0])[:, 0]
            q = torch.stack([x, y, z], -1)
            pts.append(q[in_lung(q, lung, 0.85)])
        s = torch.cat(pts)[:2000] * scale
        g = (s / scale * 2 - 1) * (scale / (scale + 1))   # kpts_to_grid
        out.append((float(g[:, 2].mean()), float(2 * g[:, 2].std() + 0.02),
                    float(torch.sign(g[:, 0].mean()))))
    return out


def class_bias(x: torch.Tensor, logits: torch.Tensor, band_list: list,
               bias: float) -> torch.Tensor:
    """`logits` plus the bias of `bands` at the grid points `x`."""
    z, xg = x[..., 2], x[..., 0]
    add = torch.zeros_like(logits)
    for c, (mu, width, side) in enumerate(band_list, start=1):
        add[..., c] = bias * (((z - mu).abs() < width) & (xg * side > 0))
    return logits + add


class ClassBias(torch.nn.Module):
    """A point model whose logits get the class bias."""

    def __init__(self, model, band_list: list, bias: float):
        super().__init__()
        self.model, self.band_list, self.bias = model, band_list, bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return class_bias(x, self.model(x), self.band_list, self.bias)
