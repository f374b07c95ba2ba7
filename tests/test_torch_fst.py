"""The port's `.fst` reader and writer (models/io.py) against flax and
msgpack, and model.pt's recorded class (models/weights.py).

Tolerances: none for bytes and trees (the writer gives the bytes
`flax.serialization.to_bytes` gives, plus the JAX header; the reader gives
equal arrays, bf16 ones too); models loaded from a JAX `.fst` give JAX's
outputs within 2e-4 (float32; the bf16 DGCNNSeg within BF16_TOL of its max
logit, tests/test_torch_dynamic.py says why bf16 graphs differ).
"""
import os
import subprocess
import sys
import textwrap

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu.models import io as jio
from fissure_segmentation_tpu.models.folding_net import \
    DGCNNFoldingNet as JFoldingNet
from fissure_segmentation_tpu_torch.models import (DGCNNFoldingNet, DGCNNSeg,
                                                   PointTransformerSeg,
                                                   export_jax_variables,
                                                   io, load_fold_model,
                                                   load_jax_variables,
                                                   load_model, save_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = 0.15


def _t(a):
    return torch.from_numpy(np.array(a))


def _trees():
    rng = np.random.default_rng(0)
    return {
        "f32": {"params": {"Dense_0": {"kernel": rng.normal(size=(5, 7))
                                       .astype(np.float32),
                                       "bias": np.zeros(7, np.float32)}}},
        "nested_mixed": {"b": {"z": np.arange(6, dtype=np.int32)
                               .reshape(2, 3),
                               "a": {"deep": rng.random((4,)) < 0.5}},
                         "a": rng.normal(size=(3, 3, 3)).astype(np.float64),
                         "c": np.ones((0, 4), np.float32),
                         "d": np.float32(2.5)},
        "scalars": {"int_small": 3, "int_neg": -7, "int_u8": 200,
                    "int_u16": 60000, "int_u32": 3_000_000_000,
                    "int_i8": -100, "int_i16": -30000, "int_i64": -2 ** 40,
                    "f": 0.1, "t": True, "n": None, "s": "fst" * 20,
                    "long": "x" * 300},
        "wide": {f"leaf_{i:02d}": np.full((i % 5 + 1,), i, np.int64)
                 for i in range(40)},
        "big": {"w": rng.normal(size=(300, 300)).astype(np.float32),
                "v": rng.normal(size=(70000,)).astype(np.float32)},
    }


@pytest.mark.parametrize("name", sorted(_trees()))
def test_writer_gives_flax_bytes(name):
    tree = _trees()[name]
    assert io.to_bytes(tree) == flax.serialization.to_bytes(tree)


def test_writer_gives_flax_bytes_for_bf16():
    """A bf16 JAX array and the same bits as a torch.bfloat16 tensor."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(6, 5)).astype(np.float32)).astype(
        jnp.bfloat16)
    tree_j = {"p": {"w": x, "n": jnp.arange(4, dtype=jnp.int32)}}
    tree_t = {"p": {"w": _t(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16), "n": torch.arange(4, dtype=torch.int32)}}
    assert io.to_bytes(tree_t) == flax.serialization.to_bytes(tree_j)


def test_chunked_arrays(monkeypatch):
    """flax's `__msgpack_chunked_array__` maps, both ways (the threshold
    lowered from 2**30 bytes so a small array is chunked)."""
    import flax.serialization as fs
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(io, "MAX_CHUNK_SIZE", 64)
    tree = {"a": np.arange(50, dtype=np.float32).reshape(5, 10),
            "b": {"c": np.arange(3, dtype=np.int32)}}
    data = fs.to_bytes(tree)
    assert io.to_bytes(tree) == data
    assert b"__msgpack_chunked_array__" in data
    back = io.msgpack_restore(data)
    np.testing.assert_array_equal(back["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(back["b"]["c"].numpy(), tree["b"]["c"])


def _equal_trees(got, want):
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal_trees(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic, jax.Array)):
        w = np.asarray(want)
        assert got.dtype == getattr(torch, w.dtype.name), (got.dtype, w.dtype)
        np.testing.assert_array_equal(got.float().numpy()
                                      if got.dtype == torch.bfloat16
                                      else got.numpy(),
                                      w.astype(np.float32)
                                      if w.dtype.name == "bfloat16" else w)
    else:
        assert got == want and type(got) is type(want)


@pytest.mark.parametrize("name", sorted(_trees()))
def test_reader_reads_flax_bytes(name):
    tree = _trees()[name]
    data = flax.serialization.to_bytes(tree)
    _equal_trees(io.msgpack_restore(data),
                 flax.serialization.msgpack_restore(data))


def test_reader_reads_bf16():
    x = jnp.linspace(-3, 3, 24, dtype=jnp.float32).reshape(4, 6).astype(
        jnp.bfloat16)
    data = flax.serialization.to_bytes({"w": x})
    got = io.msgpack_restore(data)["w"]
    assert got.dtype == torch.bfloat16 and got.shape == (4, 6)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def test_msgpack_matches_the_library():
    """packb/unpackb against msgpack-python on every length and integer
    form the subset uses."""
    objs = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0, float("inf"),
            True, False, None, "", "a" * 31, "a" * 32, "a" * 255, "a" * 256,
            "ä" * 40000, b"", b"x" * 255, b"x" * 256, b"x" * 70000,
            list(range(15)), list(range(16)), list(range(70000)),
            {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
            {"nested": {"list": [1, "two", None, [3.0]]}}]
    for obj in objs:
        data = msgpack.packb(obj, use_bin_type=True)
        assert io.packb(obj) == data, repr(obj)[:40]
        assert io.unpackb(data) == msgpack.unpackb(data, raw=False)
    for n in (0, 1, 2, 3, 4, 8, 16, 17, 255, 256, 70000):
        ext = msgpack.ExtType(5, b"e" * n)
        out = bytearray()
        io._pack_ext(out, 5, b"e" * n)
        assert bytes(out) == msgpack.packb(ext)


def _trainer_order(variables):
    """The tree as the JAX trainer saves it: params, then batch_stats."""
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"]}


def _jax_seg(dtype=None, dynamic=False):
    jm = JDGCNNSeg(k=6, in_features=4, num_classes=4, dynamic=dynamic,
                   dtype=dtype)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 4)))
    return jm, _trainer_order(jax.tree_util.tree_map(np.asarray, variables))


def _cloud(seed, b=2, n=96, c=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(-16, 17, (b, n, c)) / 16.0).astype(np.float32)


@pytest.mark.parametrize("dtype,dynamic", [(None, False), (None, True),
                                           (jnp.bfloat16, True)])
def test_jax_fst_gives_dgcnn_seg(tmp_path, dtype, dynamic):
    """A DGCNNSeg saved by the JAX package loads into the port (its config
    from the header) and gives JAX's logits; the port's save_fst of the
    loaded model writes the JAX file byte for byte."""
    jm, variables = _jax_seg(dtype, dynamic)
    path = str(tmp_path / "model.fst")
    jio.save_model(jm, variables, path)
    model = io.load_fst(path)
    assert isinstance(model, DGCNNSeg) and model.dynamic == dynamic
    assert model.dtype == (None if dtype is None else torch.bfloat16)
    x = _cloud(1)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jm.apply(variables, x, train=False))
    with torch.no_grad():
        got = model(_t(x)).numpy()
    if dtype is None:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
    again = str(tmp_path / "again.fst")
    io.save_fst(model, again)
    assert open(again, "rb").read() == open(path, "rb").read()
    assert load_fold_model(str(tmp_path)).config == model.config


@pytest.mark.parametrize("cfg", [dict(), dict(decode_mesh=False,
                                              static=True),
                                 dict(deform=True, dec_depth=1)])
def test_jax_fst_gives_folding_net(tmp_path, cfg):
    kw = dict(k=8, n_embedding=32, shape_type="plane", n_input_points=256,
              **cfg)
    jm = JFoldingNet(**kw)
    variables = _trainer_order(jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 256, 3)))))
    path = str(tmp_path / "model.fst")
    jio.save_model(jm, variables, path)
    model = io.load_fst(path, DGCNNFoldingNet)
    assert model.config == {**dict(decode_mesh=True, deform=False,
                                   static=False, dec_depth=2), **kw}
    x = _cloud(2, n=256, c=3)
    with jax.default_matmul_precision("float32"):
        want = jm.apply(variables, x, train=False)
    with torch.no_grad():
        got = model(_t(x))
    if isinstance(want, tuple):
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    again = str(tmp_path / "again.fst")
    io.save_fst(model, again)
    assert open(again, "rb").read() == open(path, "rb").read()
    header, tree = io.read_fst(path)
    assert header["model_class"] == "DGCNNFoldingNet"
    _equal_trees(tree, flax.serialization.msgpack_restore(
        open(path, "rb").read().split(io.SEP, 1)[1]))


def test_point_transformer_header(tmp_path):
    """PointTransformerSeg's config maps to JAX's fields and back: written
    by the port, read by the JAX package (the same modules and leaves) and
    by the port."""
    pt = PointTransformerSeg(in_features=4, num_classes=3, blocks=(1, 2, 1,
                                                                   1, 1),
                             generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "pt.fst")
    io.save_fst(pt, path)
    module, variables = jio.load_model(path)
    assert type(module).__name__ == "PointTransformerSeg"
    assert tuple(module.blocks) == (1, 2, 1, 1, 1) and module.dtype is None
    back = io.load_fst(path)
    assert back.config == pt.config
    want = export_jax_variables(pt)
    for coll in ("params", "batch_stats"):
        _equal_trees(io.msgpack_restore(io.to_bytes(io._sorted(want[coll]))),
                     io._sorted(jax.tree_util.tree_map(
                         np.asarray, dict(variables[coll]))))


def test_model_pt_records_its_class(tmp_path):
    """model.pt records model_class: load_model needs no class; a wrong
    class raises; a model.pt without the key (written before it was
    recorded) still loads when the class is passed; a fold directory with
    both files prefers model.pt."""
    seg = DGCNNSeg(k=4, in_features=3, num_classes=4,
                   generator=torch.Generator().manual_seed(0))
    ae = DGCNNFoldingNet(k=4, n_embedding=16, shape_type="plane",
                         n_input_points=64)
    for m in (seg, ae):
        path = str(tmp_path / f"{type(m).__name__}.pt")
        save_model(m, path)
        back = load_model(path)
        assert type(back) is type(m) and back.config == m.config
    with pytest.raises(ValueError, match="holds a DGCNNSeg"):
        load_model(str(tmp_path / "DGCNNSeg.pt"), DGCNNFoldingNet)
    state = torch.load(str(tmp_path / "DGCNNSeg.pt"), weights_only=True)
    del state["model_class"]
    torch.save(state, str(tmp_path / "old.pt"))
    assert load_model(str(tmp_path / "old.pt"), DGCNNSeg).config == \
        seg.config
    with pytest.raises(KeyError, match="records no model class"):
        load_model(str(tmp_path / "old.pt"))
    fold = tmp_path / "fold0"
    fold.mkdir()
    io.save_fst(seg, str(fold / "model.fst"))
    assert isinstance(load_fold_model(str(fold)), DGCNNSeg)
    save_model(ae, str(fold / "model.pt"))
    assert isinstance(load_fold_model(str(fold)), DGCNNFoldingNet)
    with pytest.raises(FileNotFoundError):
        load_fold_model(str(tmp_path / "nowhere"))


def test_load_jax_variables_takes_tensor_leaves():
    jm, variables = _jax_seg()
    tensors = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                     variables)
    a = load_jax_variables(DGCNNSeg(k=6, in_features=4, num_classes=4,
                                    dynamic=False), variables)
    b = load_jax_variables(DGCNNSeg(k=6, in_features=4, num_classes=4,
                                    dynamic=False), tensors)
    for (_, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y)


def test_reader_imports_neither_msgpack_nor_flax(tmp_path):
    jm, variables = _jax_seg()
    path = str(tmp_path / "model.fst")
    jio.save_model(jm, variables, path)
    code = textwrap.dedent(f"""
        import sys
        from fissure_segmentation_tpu_torch.models.io import load_fst
        model = load_fst({path!r})
        assert type(model).__name__ == "DGCNNSeg"
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("msgpack", "flax", "jax", "fissure_segmentation_tpu")]
        assert not bad, bad
    """)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env={**os.environ, "PYTHONPATH": REPO})


def _jax_family(name):
    """A JAX DPSRNet, DPSRNet2 or DGSSM and its trainer-ordered tree."""
    x0 = jnp.zeros((1, 64, 3))
    if name == "DGSSM":
        from fissure_segmentation_tpu.models.dg_ssm import DGSSM as J
        from fissure_segmentation_tpu.shape_model.ssm import fit_ssm
        ssm = fit_ssm(np.random.default_rng(0).normal(size=(6, 20, 3)))
        jm = J(k=6, in_features=3, ssm_modes=ssm.num_modes, dynamic=False,
               active_heads=("main", "translation"))
        variables = jm.init(jax.random.PRNGKey(0), x0, ssm, train=False)
    else:
        from fissure_segmentation_tpu.models import dpsr_net
        jm = getattr(dpsr_net, name)(seg_net_class="DGCNN", k=6,
                                     in_features=3, num_classes=3,
                                     dynamic=False, dpsr_res=(16, 16, 16),
                                     dpsr_sigma=3.0, max_tris=2048,
                                     n_surface_samples=64)
        key = jax.random.PRNGKey(0)
        variables = jm.init(key, x0, train=False, rng=key)
    return jm, _trainer_order(jax.tree_util.tree_map(np.asarray, variables))


@pytest.mark.parametrize("name", ["DPSRNet", "DPSRNet2", "DGSSM"])
def test_jax_fst_gives_dpsr_net_and_dgssm(tmp_path, name):
    """DPSR-Net's and DG-SSM's `.fst` headers: a JAX-written file loads as
    the port's class with the JAX module's config (the seg net and the
    heads under their flax scopes), the port writes it back byte for byte,
    and load_fold_model reads a fold that holds only it."""
    from fissure_segmentation_tpu_torch.models import load_fold_model
    jm, variables = _jax_family(name)
    path = str(tmp_path / "model.fst")
    jio.save_model(jm, variables, path)
    model = io.load_fst(path)
    assert type(model).__name__ == name
    header, _ = io.read_fst(path)
    assert io.jax_config(model) == (name, header["config"])
    again = str(tmp_path / "again.fst")
    io.save_fst(model, again)
    assert open(again, "rb").read() == open(path, "rb").read()
    back = load_fold_model(str(tmp_path))
    assert type(back).__name__ == name and back.config == model.config
    module, restored = jio.load_model(again)
    assert type(module).__name__ == name
    _equal_trees(io.msgpack_restore(io.to_bytes(io._sorted(
        export_jax_variables(back)["params"]))),
        io._sorted(jax.tree_util.tree_map(np.asarray,
                                          dict(restored["params"]))))
