"""Load a JAX variable tree into a port module and export it back (no JAX
library needed); save and load trained models as `model.pt`.

The port's submodules carry the JAX package's module names, so a JAX tree
``{"params": ..., "batch_stats": ...}`` maps onto them one to one:

  * a Dense ``kernel`` (in, out) becomes the ``nn.Linear`` weight (out, in);
    a Dense ``bias`` the Linear bias;
  * a Conv ``kernel`` (kd, kh, kw, in / groups, out) becomes the
    ``nn.Conv3d`` weight (out, in / groups, kd, kh, kw) (so the stride-2
    depthwise kernel (3, 3, 3, 1, C) becomes (C, 1, 3, 3, 3)); a stride-1
    depthwise kernel (3, 3, 3, 1, C) becomes K6's (3, 3, 3, C)
    (`seg_cnn.DepthwiseConv3`);
  * any other params leaf (an EdgeMLP ``kernel``, BatchNorm ``scale`` and
    ``bias``, a Conv ``bias``) is copied into the parameter of the same
    name;
  * ``batch_stats`` leaves (BatchNorm ``mean``/``var``) into the buffers of
    the same name.

Strict both ways: a leaf that finds no target, a shape that differs, or a
port parameter or buffer left unset raises. `export_jax_variables` is the
exact inverse. Leaves may be numpy arrays or torch tensors (a `.fst`
file's bfloat16 arrays are read as tensors, models/io.py).

`save_model` writes `model.pt`: the flattened tree, the constructor config
and the class name (`model_class`), so `load_model(path)` rebuilds a
DGCNNSeg, DGCNNReg, PointNetSeg, PointTransformerSeg, DGCNNFoldingNet,
MobileNetASPP, LRASPPMobileNetV33D, DPSRNet, DPSRNet2, DGSSM or an affine
model without being told which
(DPSR-Net's seg net and DG-SSM's heads sit under the JAX tree's scopes,
`DGCNNSeg_0` and `MultiHeadDGCNN_0/...`, so the same walk maps them);
a `model.pt` written before the class was recorded loads when the class is
passed in. `load_fold_model` reads a fold directory written by either
package: its `model.pt`, or the JAX package's `model.fst` where only that
exists.
"""
from __future__ import annotations

import json
import os
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .seg_cnn import DepthwiseConv3

_COLLECTIONS = ("params", "batch_stats")


def _to_port(kind: str | None, arr: np.ndarray) -> np.ndarray:
    """A JAX leaf in the port's layout."""
    if kind == "dense":
        return arr.T
    if kind == "conv":
        return arr.transpose(4, 3, 0, 1, 2)
    if kind == "depthwise":
        return arr.reshape(3, 3, 3, arr.shape[-1])
    return arr


def _to_jax(kind: str | None, arr: np.ndarray) -> np.ndarray:
    """The inverse of `_to_port`."""
    if kind == "dense":
        return arr.T.copy()
    if kind == "conv":
        return arr.transpose(2, 3, 4, 1, 0).copy()
    if kind == "depthwise":
        return arr.reshape(3, 3, 3, 1, arr.shape[-1])
    return arr


def _kind(mod: nn.Module, name: str) -> str | None:
    """How the port's parameter `name` of `mod` is laid out against the
    JAX leaf (None: the same)."""
    if isinstance(mod, nn.Linear) and name == "weight":
        return "dense"
    if isinstance(mod, nn.Conv3d) and name == "weight":
        return "conv"
    if isinstance(mod, DepthwiseConv3) and name == "kernel":
        return "depthwise"
    return None


def _target(mod: nn.Module, collection: str, name: str):
    if collection == "params":
        if isinstance(mod, (nn.Linear, nn.Conv3d)) and name == "kernel":
            return mod.weight, _kind(mod, "weight")
        return mod._parameters.get(name), _kind(mod, name)
    return mod._buffers.get(name), None


def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Fill `module`'s parameters and buffers from a JAX variable tree.

    :param variables: nested mappings of array-likes, as returned by the JAX
        model's ``init`` (leaves are converted with ``np.asarray``)
    :return: `module`, for chaining
    """
    extra = set(variables) - set(_COLLECTIONS)
    if extra:
        raise KeyError(f"unknown variable collections {sorted(extra)}")
    assigned: set[int] = set()

    def walk(tree: Mapping, mod: nn.Module, collection: str, path: str):
        for name, val in tree.items():
            where = f"{collection}/{path}{name}"
            if isinstance(val, Mapping):
                sub = mod._modules.get(name)
                if sub is None:
                    raise KeyError(f"{where}: no submodule {name!r} in "
                                   f"{type(mod).__name__}")
                walk(val, sub, collection, f"{path}{name}/")
                continue
            target, kind = _target(mod, collection, name)
            if target is None:
                raise KeyError(f"{where}: no {collection} target {name!r} in "
                               f"{type(mod).__name__}")
            arr = (val.detach().to("cpu", torch.float32).numpy()
                   if isinstance(val, torch.Tensor)
                   else np.asarray(val, np.float32))
            if (kind in ("conv", "depthwise") and arr.ndim != 5) or \
                    (kind == "depthwise" and arr.shape[3] != 1):
                raise ValueError(f"{where}: shape {arr.shape} is no flax "
                                 f"{kind} kernel")
            arr = _to_port(kind, arr)
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(f"{where}: shape {arr.shape} != port "
                                 f"{tuple(target.shape)}")
            with torch.no_grad():
                target.copy_(torch.tensor(arr))
            assigned.add(id(target))

    for collection in _COLLECTIONS:
        walk(variables.get(collection, {}), module, collection, "")
    unset = [n for n, t in [*module.named_parameters(),
                            *module.named_buffers()] if id(t) not in assigned]
    if unset:
        raise KeyError(f"port tensors not set by the JAX tree: {unset}")
    return module


def export_jax_variables(module: nn.Module, grad: bool = False) -> dict:
    """The JAX variable tree of `module`: ``{"params", "batch_stats"}`` as
    nested dicts of numpy float32 arrays, Dense kernels as (in, out) and
    Conv kernels as (kd, kh, kw, in / groups, out) — the strict inverse of
    `load_jax_variables`.

    :param grad: export each parameter's ``.grad`` instead of its value (the
        ``params`` collection only); a parameter without a gradient raises
    """
    def walk(mod: nn.Module, path: str):
        params, stats = {}, {}
        for name, p in mod._parameters.items():
            if p is None:
                continue
            t = p.grad if grad else p
            if t is None:
                raise ValueError(f"params/{path}{name}: no gradient")
            arr = t.detach().to("cpu", torch.float32).numpy().copy()
            kind = _kind(mod, name)
            params["kernel" if name == "weight" and kind else name] = \
                _to_jax(kind, arr)
        if not grad:
            for name, b in mod._buffers.items():
                if b is not None:
                    stats[name] = b.detach().to("cpu",
                                                torch.float32).numpy().copy()
        for name, sub in mod._modules.items():
            sp, ss = walk(sub, f"{path}{name}/")
            if sp:
                params[name] = sp
            if ss:
                stats[name] = ss
        return params, stats

    params, stats = walk(module, "")
    return {"params": params} if grad else {"params": params,
                                             "batch_stats": stats}


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(flat: Mapping) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def model_class(name: str):
    """The port's model class of that name (a `model.pt`'s or a `.fst`
    header's `model_class`)."""
    from .affine import AffineDGCNN, AffineOpenDGCNN, AffinePointNet
    from .dg_ssm import DGSSM
    from .dgcnn import DGCNNReg, DGCNNSeg
    from .dpsr_net import DPSRNet, DPSRNet2
    from .folding_net import DGCNNFoldingNet
    from .lraspp_3d import LRASPPMobileNetV33D
    from .point_transformer import PointTransformerSeg
    from .pointnet import PointNetSeg
    from .seg_cnn import MobileNetASPP
    classes = {c.__name__: c for c in (DGCNNSeg, PointTransformerSeg,
                                       DGCNNFoldingNet, MobileNetASPP,
                                       LRASPPMobileNetV33D, DPSRNet,
                                       DPSRNet2, DGSSM, PointNetSeg,
                                       DGCNNReg, AffineDGCNN,
                                       AffineOpenDGCNN, AffinePointNet)}
    if name not in classes:
        raise KeyError(f"model class {name!r} is not ported; known: "
                       f"{sorted(classes)}")
    return classes[name]


def resolve_model_class(name: str | None, model_cls, path: str):
    """The class a file records, checked against the caller's; a file that
    records none takes the caller's."""
    if name is None:
        if model_cls is None:
            raise KeyError(f"{path} records no model class; pass one")
        return model_cls
    if model_cls is not None and model_cls.__name__ != name:
        raise ValueError(f"{path} holds a {name}, not a "
                         f"{model_cls.__name__}")
    return model_class(name)


def save_model(module: nn.Module, path: str) -> None:
    """Write `module` as ``model.pt``: its JAX variable tree flattened to
    ``"collection/Module_0/.../leaf"`` tensors, the constructor config
    (``module.config``) as JSON and the class name."""
    flat = _flatten(export_jax_variables(module))
    torch.save({"config": json.dumps(module.config),
                "model_class": type(module).__name__,
                "variables": {k: torch.from_numpy(v) for k, v in flat.items()}},
               path)


def load_model(path: str, model_cls=None) -> nn.Module:
    """Rebuild a module written by `save_model`: ``model_cls(**config)``
    with its variables loaded (eval mode, on the CPU), `model_cls` being
    the class the file records (a given one must match it) or, for a file
    that records none, the given one."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model_cls = resolve_model_class(state.get("model_class"), model_cls,
                                    path)
    module = model_cls(**json.loads(state["config"]))
    tree = _unflatten({k: v.numpy() for k, v in state["variables"].items()})
    return load_jax_variables(module, tree).eval()


def load_fold_model(fold_dir: str, model_cls=None) -> nn.Module:
    """The model of a fold directory: its `model.pt`, or the JAX package's
    `model.fst` where only that exists (models/io.py)."""
    pt = os.path.join(fold_dir, "model.pt")
    if os.path.exists(pt):
        return load_model(pt, model_cls)
    fst = os.path.join(fold_dir, "model.fst")
    if os.path.exists(fst):
        from .io import load_fst
        return load_fst(fst, model_cls)
    raise FileNotFoundError(f"neither model.pt nor model.fst in {fold_dir}")
