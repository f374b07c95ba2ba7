"""Plain MobileNetASPP whole-volume inference (the reference's
models/seg_cnn.py): PyTorch convolutions in NCDHW, float32, no kernel of
the port. It reads the weights the benchmark made, by the names the
program's state uses.

Backbone: eight inverted residuals (1x1 expand, or a 3x3x3 stride-2 conv in
the first; BatchNorm; ReLU6; 3x3x3 depthwise, stride 1 or 2, padding 1;
BatchNorm; ReLU6; 1x1 project; BatchNorm; the input added where shapes
allow). ASPP on the 1/4 features: a 1x1 branch, a dilated 3x3x3 branch
per rate, a global-mean branch, each Conv + BatchNorm + ReLU, then a 1x1
projection + BatchNorm + ReLU. Decoder: nearest x2 upsampling, the 1/2
features concatenated, 1x1 + BatchNorm + ReLU, 3x3x3 + BatchNorm + ReLU,
1x1 with bias, trilinear x2 (half-pixel centres), softmax over classes.
Eval-mode BatchNorm: (x - mean) / sqrt(var + eps) * scale + offset.
Inputs whose sides are not multiples of 4 are edge-padded to them and the
output cropped (low side takes the odd voxel), as whole-volume inference
does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _bn(x, p, name, eps):
    sh = (1, -1, 1, 1, 1)
    return ((x - p[name + ".mean"].view(sh))
            * torch.rsqrt(p[name + ".var"].view(sh) + eps)
            * p[name + ".scale"].view(sh) + p[name + ".bias"].view(sh))


def _conv(x, w, stride=1, padding=0, dilation=1, groups=1, bias=None):
    return F.conv3d(x, w, bias, stride, padding, dilation, groups)


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def _block(x, p, pre, cin, mid, out, stride, first, eps):
    if first:
        h = _conv(x, p[pre + "Conv_0.weight"], stride=2, padding=1)
    else:
        h = _conv(x, p[pre + "Conv_0.weight"])
    h = _relu6(_bn(h, p, pre + "BatchNorm_0", eps))
    if stride == 1:
        w = p[pre + "Conv_1.kernel"].permute(3, 0, 1, 2)[:, None]
        h = _conv(h, w.contiguous(), padding=1, groups=mid)
    else:
        h = _conv(h, p[pre + "Conv_1.weight"], stride=2, padding=1,
                  groups=mid)
    h = _relu6(_bn(h, p, pre + "BatchNorm_1", eps))
    h = _bn(_conv(h, p[pre + "Conv_2.weight"]), p, pre + "BatchNorm_2", eps)
    if cin == out and stride == 1 and not first:
        h = h + x
    return h


def logits(p: dict, vol: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(D, H, W) volume, sides multiples of 4 -> (C, D, H, W) logits."""
    eps = cfg["batchnorm_epsilon"]
    x = vol[None, None]
    cin = cfg["in_channels"]
    x1 = None
    for i, (mid, out, stride, first) in enumerate(cfg["blocks"]):
        x = _block(x, p, f"MobileNet3D_0.Checkpoint_InvertedResidual_{i}.",
                   cin, mid, out, stride, first, eps)
        cin = out
        if i == 0:
            x1 = x
    pre = "CheckpointASPP_0."
    rates = cfg["aspp_rates"]

    def branch(i, t, **kw):
        t = _conv(t, p[f"{pre}Conv_{i}.weight"], **kw)
        return torch.relu(_bn(t, p, f"{pre}BatchNorm_{i}", eps))
    res = [branch(0, x)]
    res += [branch(1 + j, x, padding=r, dilation=r)
            for j, r in enumerate(rates)]
    g = branch(len(rates) + 1, x.mean((2, 3, 4), keepdim=True))
    res.append(g.expand_as(res[0]))
    y = branch(len(rates) + 2, torch.cat(res, 1))
    y = F.interpolate(y, scale_factor=2, mode="nearest-exact")
    y = torch.cat([x1, y], 1)
    y = torch.relu(_bn(_conv(y, p["Conv_0.weight"]), p, "BatchNorm_0", eps))
    y = torch.relu(_bn(_conv(y, p["Conv_1.weight"], padding=1), p,
                       "BatchNorm_1", eps))
    y = _conv(y, p["Conv_2.weight"], bias=p["Conv_2.bias"])
    return F.interpolate(y, scale_factor=2, mode="trilinear",
                         align_corners=False)[0]


def logits_volume(p: dict, vol: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(D, H, W) volume -> (C, D, H, W) logits, edge-padding the sides to
    multiples of 4 and cropping back."""
    pad = [(-s) % 4 for s in vol.shape]
    lo = [q // 2 + q % 2 for q in pad]
    d, h, w = vol.shape
    if any(pad):
        spec = []
        for q, l in zip(reversed(pad), reversed(lo)):
            spec += [l, q - l]
        vol = F.pad(vol[None, None], spec, mode="replicate")[0, 0]
    out = logits(p, vol, cfg)
    return out[:, lo[0]:lo[0] + d, lo[1]:lo[1] + h, lo[2]:lo[2] + w]


def softmax_volume(p: dict, vol: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(D, H, W) volume -> (D, H, W, C) softmax (whole-volume inference)."""
    return torch.softmax(logits_volume(p, vol, cfg), dim=0).permute(
        1, 2, 3, 0)
