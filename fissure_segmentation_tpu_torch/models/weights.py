"""Load a JAX variable tree into a port module and export it back (no JAX
library needed); save and load trained models as `model.pt`.

The port's submodules carry the JAX package's module names, so a JAX tree
``{"params": ..., "batch_stats": ...}`` maps onto them one to one:

  * a Dense ``kernel`` (in, out) becomes the ``nn.Linear`` weight (out, in);
    a Dense ``bias`` the Linear bias;
  * any other params leaf (an EdgeMLP ``kernel``, BatchNorm ``scale`` and
    ``bias``) is copied into the parameter of the same name;
  * ``batch_stats`` leaves (BatchNorm ``mean``/``var``) into the buffers of
    the same name.

Strict both ways: a leaf that finds no target, a shape that differs, or a
port parameter or buffer left unset raises. `export_jax_variables` is the
exact inverse. Reading and writing `.fst` msgpack files is not ported yet
(it needs flax's serializer); `save_model` writes `model.pt` instead.
"""
from __future__ import annotations

import json
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_COLLECTIONS = ("params", "batch_stats")


def _target(mod: nn.Module, collection: str, name: str):
    if collection == "params":
        if isinstance(mod, nn.Linear) and name == "kernel":
            return mod.weight, True
        if isinstance(mod, nn.Linear) and name == "bias":
            return mod.bias, False
        return mod._parameters.get(name), False
    return mod._buffers.get(name), False


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
            target, transpose = _target(mod, collection, name)
            if target is None:
                raise KeyError(f"{where}: no {collection} target {name!r} in "
                               f"{type(mod).__name__}")
            arr = np.asarray(val, np.float32)
            if transpose:
                arr = arr.T
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
    nested dicts of numpy float32 arrays, Dense kernels as (in, out) — the
    strict inverse of `load_jax_variables`.

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
            if isinstance(mod, nn.Linear) and name == "weight":
                params["kernel"] = arr.T.copy()
            else:
                params[name] = arr
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


def save_model(module: nn.Module, path: str) -> None:
    """Write `module` as ``model.pt``: its JAX variable tree flattened to
    ``"collection/Module_0/.../leaf"`` tensors, plus the constructor config
    (``module.config``) as JSON."""
    flat = _flatten(export_jax_variables(module))
    torch.save({"config": json.dumps(module.config),
                "variables": {k: torch.from_numpy(v) for k, v in flat.items()}},
               path)


def load_model(path: str, model_cls) -> nn.Module:
    """Rebuild a module written by `save_model`: ``model_cls(**config)``
    with its variables loaded (eval mode, on the CPU)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    module = model_cls(**json.loads(state["config"]))
    tree = _unflatten({k: v.numpy() for k, v in state["variables"].items()})
    return load_jax_variables(module, tree).eval()
