"""Load a JAX variable tree into a port module (no JAX library needed).

The port's submodules carry the JAX package's module names, so a JAX tree
``{"params": ..., "batch_stats": ...}`` maps onto them one to one:

  * a Dense ``kernel`` (in, out) becomes the ``nn.Linear`` weight (out, in);
    a Dense ``bias`` the Linear bias;
  * any other params leaf (an EdgeMLP ``kernel``, BatchNorm ``scale`` and
    ``bias``) is copied into the parameter of the same name;
  * ``batch_stats`` leaves (BatchNorm ``mean``/``var``) into the buffers of
    the same name.

Strict both ways: a leaf that finds no target, a shape that differs, or a
port parameter or buffer left unset raises. Reading `.fst` msgpack files is
not ported yet.
"""
from __future__ import annotations

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
