"""The JAX package's `.fst` checkpoints, read and written without flax or
msgpack (counterpart of models/io.py).

A `.fst` file is a JSON header ``{"format": 2, "model_class", "config"}``,
the separator ``b"\\x00fst\\x00"`` and the variable tree as flax writes it
(`flax.serialization.to_bytes`): msgpack maps in the tree's order, arrays as
ext type 1 holding the msgpack triple (shape, dtype name, C-order bytes),
and arrays above 2**30 bytes split into flax's `__msgpack_chunked_array__`
maps. This module carries its own msgpack reader and writer for that
subset: maps, arrays, strings, binaries, ints, floats, bool, nil and ext
types. Arrays are read into torch tensors (`torch.frombuffer`; bfloat16
arrays too, where numpy has no type) and written from numpy arrays or
torch tensors.

`save_fst` / `load_fst` map the header's config between the JAX module's
fields and the port's constructor (`JAX_FIELDS`); the tree goes through
`export_jax_variables` / `load_jax_variables` (models/weights.py).
"""
from __future__ import annotations

import json
import os
import struct
from collections.abc import Mapping

import numpy as np
import torch

SEP = b"\x00fst\x00"
MAX_CHUNK_SIZE = 2 ** 30      # flax.serialization's
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3

# the JAX modules' dataclass fields, in declaration order, with defaults
JAX_FIELDS = {
    "DGCNNSeg": [("k", None), ("in_features", None), ("num_classes", None),
                 ("spatial_transformer", False), ("dynamic", True),
                 ("image_feat_module", False), ("dtype", None),
                 ("knn_recall", None)],
    "PointTransformerSeg": [("in_features", None), ("num_classes", None),
                            ("blocks", [2, 3, 4, 6, 3]),
                            ("planes", [32, 64, 128, 256, 512]),
                            ("strides", [1, 4, 4, 4, 4]),
                            ("nsamples", [8, 16, 16, 16, 16]),
                            ("share_planes", 8), ("dtype", None)],
    "DGCNNFoldingNet": [("k", None), ("n_embedding", None),
                        ("shape_type", None), ("n_input_points", 1024),
                        ("decode_mesh", True), ("deform", False),
                        ("static", False), ("dec_depth", 2)],
    "MobileNetASPP": [("num_classes", None), ("patch_size", [128, 128, 128])],
    "LRASPPMobileNetV33D": [("num_classes", None),
                            ("patch_size", [128, 128, 128])],
}

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}


# ---- msgpack ------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes) -> None:
    """A length header: the fix form below fix_max, else 8/16/32 bits."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 2 ** 8:
        out += bytes([codes[0], n])
    elif n < 2 ** 16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                               (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
            if v < top:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, bot in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                               (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if v >= bot:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _array_payload(arr) -> bytes:
    """flax's ndarray encoding: msgpack (shape, dtype name, bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t
               ).numpy().tobytes()
        shape = tuple(t.shape)
    else:
        arr = np.asarray(arr)
        name, raw, shape = arr.dtype.name, arr.tobytes("C"), arr.shape
    return packb((list(shape), name, raw))


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.generic):     # before float: np.float64 is one
        _pack_ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode()
        _pack_len(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, Mapping):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _EXT_NDARRAY, _array_payload(obj))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of `obj` as msgpack-python packs it with
    use_bin_type=True (and flax's ext types for arrays)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode()

    def read(self):
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.mapping(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.string(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            return self.unpack(ints[c])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in lens:
            return self.string(self.unpack(lens[c]))
        bins = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in bins:
            return bytes(self.take(self.unpack(bins[c])))
        if c in (0xDC, 0xDD):
            n = self.unpack(">H" if c == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self.mapping(self.unpack(">H" if c == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            n = fixext[c]
        elif c in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
        else:
            raise ValueError(f"msgpack: unsupported type byte {c:#x}")
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _array_from_payload(data: bytes) -> torch.Tensor:
    shape, name, raw = _Reader(data, raw=True).read()
    name = name.decode() if isinstance(name, bytes) else name
    if name not in _DTYPES:
        raise ValueError(f".fst: unsupported dtype {name!r}")
    dtype = _DTYPES[name]
    if not raw:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=dtype).reshape(
        tuple(shape))


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_payload(data)
    if code == _EXT_NPSCALAR:
        return _array_from_payload(data).reshape(())
    raise ValueError(f"msgpack: unsupported ext type {code}")


def unpackb(data: bytes):
    """The object msgpack-python's unpackb(raw=False) gives, with flax's
    arrays as torch tensors."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: extra bytes after the object")
    return obj


# ---- flax's tree encoding ------------------------------------------------------

def _chunk(arr) -> dict:
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    flat = t.reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / flat.element_size()))
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): s for i, s in enumerate(t.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.numel(), size))}}


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _state(tree):
    """flax's state dict of a variable tree: string keys in the tree's
    order, oversized arrays chunked."""
    if isinstance(tree, Mapping):
        return {str(k): _state(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and \
            _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return torch.cat(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def to_bytes(tree) -> bytes:
    """The bytes `flax.serialization.to_bytes` writes for a tree of nested
    dicts with numpy-array or tensor leaves."""
    return packb(_state(tree))


def msgpack_restore(data: bytes):
    """The tree `flax.serialization.msgpack_restore` reads, with torch
    tensor leaves."""
    return _unchunk(unpackb(data))


# ---- .fst ----------------------------------------------------------------------

def _sorted(tree):
    if isinstance(tree, Mapping):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def jax_config(module) -> tuple[str, dict]:
    """(class name, config) as the JAX package's header holds them."""
    name = type(module).__name__
    if name not in JAX_FIELDS:
        raise KeyError(f".fst: no JAX fields known for {name}; known: "
                       f"{sorted(JAX_FIELDS)}")
    cfg = {}
    for field, default in JAX_FIELDS[name]:
        v = module.config.get(field, default)
        if field == "dtype" and v not in (None, "float32"):
            v = {"__dtype__": v}
        elif field == "dtype":
            v = None
        cfg[field] = list(v) if isinstance(v, tuple) else v
    return name, cfg


def port_config(name: str, cfg: Mapping) -> dict:
    """The port constructor's kwargs for a JAX header's config."""
    out = {}
    for k, v in cfg.items():
        if isinstance(v, Mapping) and "__dtype__" in v:
            v = v["__dtype__"]
        out[k] = v
    if name == "PointTransformerSeg" and out.get("dtype") is None:
        out.pop("dtype", None)
    return out


def save_fst(module, path: str) -> None:
    """Write `module` as a JAX `.fst` checkpoint."""
    from .weights import export_jax_variables
    name, cfg = jax_config(module)
    header = json.dumps({"format": 2, "model_class": name,
                         "config": cfg}).encode()
    # the JAX trainer's order: params, then batch_stats, each sorted as
    # jax.tree_util leaves a dict
    tree = export_jax_variables(module)
    payload = to_bytes({"params": _sorted(tree["params"]),
                        "batch_stats": _sorted(tree["batch_stats"])})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header + SEP + payload)


def read_fst(path: str) -> tuple[dict, dict]:
    """(header, variable tree with tensor leaves) of a `.fst` file."""
    with open(path, "rb") as f:
        blob = f.read()
    header_bytes, payload = blob.split(SEP, 1)
    header = json.loads(header_bytes)
    if header.get("format", 1) < 2:
        raise ValueError(f"{path}: .fst format {header.get('format', 1)} "
                         "(before the EdgeMLP parameter tree) is not read")
    return header, msgpack_restore(payload)


def load_fst(path: str, model_cls=None):
    """Rebuild the module a `.fst` file holds, its variables loaded (eval
    mode, on the CPU); a given `model_cls` must be the header's."""
    from .weights import load_jax_variables, resolve_model_class
    header, tree = read_fst(path)
    cls = resolve_model_class(header["model_class"], model_cls, path)
    module = cls(**port_config(header["model_class"], header["config"]))
    return load_jax_variables(module, tree).eval()
