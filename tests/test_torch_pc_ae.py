"""Port parity for the PC-AE slice: the shape generators, MeshTopology, the
Chamfer distance, the mesh loss terms, SampleFromMeshDS, DGCNNFoldingNet
(eval, train forward, one step's gradient) and the train_pc_ae entry,
against the JAX package on the CPU (matmuls at float32 precision), at
B = 2, N = 256 (so m = 256), k = 8, latent 32.

Tolerances:
  * the generators, the topology, the splits and the store: equal arrays;
  * the Chamfer distance, the mesh terms and the surface samples (JAX's
    draws injected): rtol = 1e-5, atol = 1e-6 (float32 rounding of the same
    operations in other orders);
  * DGCNNFoldingNet, float32, dyadic inputs (every coordinate graph exact
    on both sides): outputs within AE_TOL = 2e-4 in eval and train mode,
    every gradient of a point decoder within AE_TOL of JAX's. The dynamic
    graphs of layers 1-3 are built from generic float features, where a
    near-tie could swap a neighbour between the packages' roundings; on
    these inputs none does (held by the gradients agreeing). Under the
    mesh loss each gradient leaf within MESH_GRAD_TOL = 1e-3 of its
    largest entry (readings up to 3.5e-4: its Chamfer minima meet
    near-ties that float32 breaks either way), and the decoders with
    their losses in float64 within 1e-9
    (test_decoder_and_loss_match_jax_f64 says why float32 is too coarse
    there). The Laplacian stays out of the step (JAX's gradient is NaN
    where a vertex's Laplacian is exactly 0; test_laplacian_gradient_at_
    zero);
  * the entry: a model trained by the JAX entry and tested by the port's
    --test_only (reading its model.fst) with JAX's evaluation draws
    injected gives JAX's reconstruction_chamfer.csv within ENTRY_RTOL =
    1e-4 relative.
"""
import csv
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.data import mesh_dataset as jmesh_dataset
from fissure_segmentation_tpu.data.augmentation import \
    random_transform as jrandom_transform
from fissure_segmentation_tpu.losses import chamfer as jchamfer
from fissure_segmentation_tpu.losses import mesh as jmesh
from fissure_segmentation_tpu.models import folding_net as jfolding
from fissure_segmentation_tpu_torch import train_pc_ae
from fissure_segmentation_tpu_torch.data import mesh_dataset
from fissure_segmentation_tpu_torch.data.augmentation import \
    SimilarityTransform
from fissure_segmentation_tpu_torch.data.synthetic import \
    make_synthetic_mesh_dataset
from fissure_segmentation_tpu_torch.losses import chamfer, mesh
from fissure_segmentation_tpu_torch.models import (export_jax_variables,
                                                   folding_net,
                                                   load_jax_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
AE_TOL = dict(rtol=2e-4, atol=2e-4)
MESH_GRAD_TOL = 1e-3
ENTRY_RTOL = 1e-4
SMALL = ["--ds", "synthetic", "--epochs", "2", "--batch", "4", "--pts",
         "64", "--k", "8", "--latent", "32", "--fold", "0", "--static",
         "--scheduler", "none"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _surface_draws(key, n):
    """JAX's two uniform draws of sample_points_on_triangles(key, ...)."""
    r_idx, r_uv = jax.random.split(key)
    return (_t(jax.random.uniform(r_idx, (n,))),
            _t(jax.random.uniform(r_uv, (n, 2))))


def _batch_draws(key, b, n):
    """Those of a vmap over split(key, b): (u (b, n), uv (b, n, 2))."""
    draws = [_surface_draws(r, n) for r in jax.random.split(key, b)]
    return torch.stack([d[0] for d in draws]), torch.stack([d[1]
                                                            for d in draws])


# ---- shape generators and topology -------------------------------------------

@pytest.mark.parametrize("shape,m,decode_mesh", [
    ("plane", 256, True), ("plane", 256, False), ("plane", 1024, True),
    ("sphere", 256, False), ("gaussian", 100, False)])
def test_shape_generators_equal(shape, m, decode_mesh):
    got = folding_net.folding_points_for(shape, m, decode_mesh)
    want = jfolding.folding_points_for(shape, m, decode_mesh)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_shape_generators_raise_as_jax():
    for args, err in ((("sphere", 64, True), NotImplementedError),
                      (("gaussian", 64, True), ValueError),
                      (("cube", 64, False), ValueError)):
        with pytest.raises(err):
            folding_net.folding_points_for(*args)
        with pytest.raises(err):
            jfolding.folding_points_for(*args)
    np.testing.assert_array_equal(folding_net.get_plane_mesh(49)[1],
                                  jfolding.get_plane_mesh(49)[1])


def test_mesh_topology_equal():
    rng = np.random.default_rng(0)
    _, plane = jfolding.get_plane_mesh(256)
    soup = rng.integers(0, 30, (40, 3))
    soup = soup[(soup[:, 0] != soup[:, 1]) & (soup[:, 1] != soup[:, 2])
                & (soup[:, 0] != soup[:, 2])]
    for faces, nv in ((plane, 256), (soup, 30)):
        got = mesh.MeshTopology.from_faces(faces, nv)
        want = jmesh.MeshTopology.from_faces(faces, nv)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---- losses ------------------------------------------------------------------

@pytest.mark.parametrize("masks", ["none", "x", "y", "both"])
def test_chamfer_matches_jax(masks):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 50, 3)).astype(np.float32)
    y = rng.normal(size=(2, 70, 3)).astype(np.float32)
    xm = rng.random((2, 50)) < 0.7 if masks in ("x", "both") else None
    ym = rng.random((2, 70)) < 0.6 if masks in ("y", "both") else None

    def jfn(a, b):
        return jchamfer.chamfer_distance(
            a, b, None if xm is None else jnp.asarray(xm),
            None if ym is None else jnp.asarray(ym))
    with jax.default_matmul_precision("float32"):
        want, (gxj, gyj) = jax.value_and_grad(jfn, (0, 1))(x, y)
    xt, yt = _t(x).requires_grad_(), _t(y).requires_grad_()
    got = chamfer.chamfer_distance(xt, yt, None if xm is None else _t(xm),
                                   None if ym is None else _t(ym))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), gxj, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), gyj, rtol=1e-4, atol=1e-6)
    loss, comps = chamfer.chamfer_loss(_t(x), _t(y))
    assert set(comps) == {"Chamfer"}


def _plane_verts(rng, b=2, m=64):
    pts, faces = jfolding.get_plane_mesh(m, (-0.3, 0.3), (-0.3, 0.3))
    verts = np.concatenate([pts, np.zeros((m, 1), np.float32)], 1)
    verts = verts[None] + rng.normal(0, 0.05, (b, m, 3)).astype(np.float32)
    return verts.astype(np.float32), faces


@pytest.mark.parametrize("term", ["edge", "normal", "laplacian"])
def test_mesh_terms_match_jax(term):
    rng = np.random.default_rng(2)
    verts, faces = _plane_verts(rng)
    topo = jmesh.MeshTopology.from_faces(faces, 64)
    ptopo = mesh.MeshTopology.from_faces(faces, 64)
    fns = {"edge": (lambda v: jmesh.mesh_edge_loss(v, topo),
                    lambda v: mesh.mesh_edge_loss(v, ptopo)),
           "normal": (lambda v: jmesh.mesh_normal_consistency(v, faces, topo),
                      lambda v: mesh.mesh_normal_consistency(v, faces,
                                                             ptopo)),
           "laplacian": (lambda v: jmesh.mesh_laplacian_smoothing(v, topo),
                         lambda v: mesh.mesh_laplacian_smoothing(v, ptopo))}
    jfn, tfn = fns[term]
    want, gj = jax.value_and_grad(jfn)(jnp.asarray(verts))
    vt = _t(verts).requires_grad_()
    got = tfn(vt)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), gj, rtol=1e-4, atol=1e-6)


def test_laplacian_gradient_at_zero():
    """A vertex whose uniform Laplacian is exactly 0 (an affine map of the
    regular plane grid, what a ReLU decoder gives wherever its activation
    pattern is fixed): jnp.linalg.norm's gradient there is NaN, so JAX's
    mesh-loss gradient is NaN as a whole; the port's norm takes the 0
    subgradient there, as torch and the reference's pytorch3d do, and
    elsewhere equals JAX's."""
    pts, faces = jfolding.get_plane_mesh(64, (-0.3, 0.3), (-0.3, 0.3))
    a = np.asarray([[1.0, 0.5], [-0.25, 2.0], [0.5, 0.0]], np.float32)
    verts = (pts @ a.T)[None].astype(np.float32)
    verts[0, 0] += 0.125                 # one corner off the affine map
    topo = jmesh.MeshTopology.from_faces(faces, 64)
    gj = np.asarray(jax.grad(lambda v: jmesh.mesh_laplacian_smoothing(
        v, topo))(jnp.asarray(verts)))
    vt = _t(verts).requires_grad_()
    mesh.mesh_laplacian_smoothing(
        vt, mesh.MeshTopology.from_faces(faces, 64)).backward()
    g = vt.grad.numpy()
    assert np.isnan(gj).any() and np.isfinite(g).all()
    fin = np.isfinite(gj[0]).all(-1)
    np.testing.assert_allclose(g[0][fin], gj[0][fin], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("target", ["points", "mesh"])
def test_regularized_mesh_loss_with_jax_draws(target):
    """The JAX loss with its default PRNGKey(0): the port's loss with the
    same draws injected gives its total, every component and the gradient
    in the predicted vertices within TOL (gradient 1e-4 relative)."""
    rng = np.random.default_rng(3)
    verts, faces = _plane_verts(rng)
    tverts, _ = _plane_verts(rng)
    topo = jmesh.MeshTopology.from_faces(faces, 64)
    n = 300
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    jl = jmesh.make_regularized_mesh_loss(n_samples=n)
    tl = mesh.make_regularized_mesh_loss(
        n_samples=n, draws=_surface_draws(r1, n),
        target_draws=_surface_draws(r2, n))
    y = tverts if target == "mesh" else rng.normal(
        0, 0.2, (2, 500, 3)).astype(np.float32)
    kw = {"target_faces": faces} if target == "mesh" else {}

    def jfn(v):
        return jl(v, jnp.asarray(y), faces=faces, topo=topo, **kw)
    with jax.default_matmul_precision("float32"):
        (want, wcomps), gj = jax.value_and_grad(jfn, has_aux=True)(
            jnp.asarray(verts))
    vt = _t(verts).requires_grad_()
    got, comps = tl(vt, _t(y), faces=faces,
                    topo=mesh.MeshTopology.from_faces(faces, 64), **kw)
    got.backward()
    assert set(comps) == set(wcomps)
    for k in wcomps:
        np.testing.assert_allclose(float(comps[k]), float(wcomps[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), gj, rtol=1e-4, atol=1e-6)


def test_mesh_loss_draws_are_fixed():
    """The port keeps JAX's fixed key: two calls sample the same points."""
    rng = np.random.default_rng(4)
    verts, faces = _plane_verts(rng)
    topo = mesh.MeshTopology.from_faces(faces, 64)
    loss = mesh.make_regularized_mesh_loss(n_samples=200)
    y = _t(rng.normal(size=(2, 100, 3)).astype(np.float32))
    a = loss(_t(verts), y, faces=faces, topo=topo)[0]
    b = loss(_t(verts), y, faces=faces, topo=topo)[0]
    assert torch.equal(a, b)


# ---- the mesh dataset --------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_data():
    cases, meshes, sizes = make_synthetic_mesh_dataset(
        n_cases=4, grid_n=10, n_points=200, with_feature=False)
    ids = [(c["case_id"], c["sequence"]) for c in cases]
    return meshes, ids, sizes


def _datasets(mesh_data, **kw):
    meshes, ids, sizes = mesh_data
    return (mesh_dataset.SampleFromMeshDS(meshes, ids, sizes, 48, **kw),
            jmesh_dataset.SampleFromMeshDS(meshes, ids, sizes, 48, **kw))


def test_store_and_split_equal_jax(mesh_data):
    ours, theirs = _datasets(mesh_data)
    assert len(ours) == len(theirs) == 12
    store, jstore = ours.to_store(), theirs.to_store()
    assert store.tris.shape[1] % 128 == 0
    np.testing.assert_array_equal(store.tris.numpy(), np.asarray(jstore.tris))
    np.testing.assert_array_equal(store.valid.numpy(),
                                  np.asarray(jstore.valid))
    split = {"train": [list(ours.ids[0]), ours.ids[2][0]],
             "val": [list(ours.ids[1]), list(ours.ids[3])]}
    for a, b in zip(ours.split_data_set(split), theirs.split_data_set(split)):
        assert a.ids == b.ids and len(a) == len(b)
        assert a.do_augmentation == b.do_augmentation
        for i in range(len(a)):
            np.testing.assert_array_equal(a.get_obj_mesh(i),
                                          b.get_obj_mesh(i))
    fixed = _datasets(mesh_data, fixed_object=1, exclude_rhf=True)
    assert len(fixed[0]) == len(fixed[1]) == 4
    np.testing.assert_array_equal(fixed[0].get_obj_mesh(2),
                                  fixed[1].get_obj_mesh(2))


@pytest.mark.parametrize("augment,mesh_as_target", [
    (True, True), (True, False), (False, True)])
def test_sample_batch_with_jax_draws(mesh_data, augment, mesh_as_target):
    """The JAX draws (surface uniforms of inputs and target, the
    augmentation transform, the jitter) injected: inputs and target within
    TOL of JAX's."""
    ours, theirs = _datasets(mesh_data, mesh_as_target=mesh_as_target,
                             do_augmentation=augment)
    store, jstore = ours.to_store(), theirs.to_store()
    items = np.asarray([3, 0, 7])
    key = jax.random.PRNGKey(11)
    xj, yj = theirs.sample_batch(key, jstore, jnp.asarray(items))
    r_in, r_trg = jax.random.split(key)
    r_sample, r_aug, r_jit = jax.random.split(r_in, 3)
    draws = {"input": _batch_draws(r_sample, 3, 48),
             "target": _batch_draws(r_trg, 3, 4 * 48)}
    if augment:
        draws["transform"] = SimilarityTransform(
            *(_t(v) for v in jrandom_transform(r_aug, (3,))))
        draws["jitter"] = _t(jax.random.normal(r_jit, (3, 48, 3)))
    xt, yt = ours.sample_batch(store, _t(items), draws=draws)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)
    if not mesh_as_target:
        assert yt is xt
    g = torch.Generator().manual_seed(0)
    xg, yg = ours.sample_batch(store, _t(items), g)
    assert xg.shape == (3, 48, 3) and torch.isfinite(yg).all()


# ---- DGCNNFoldingNet ---------------------------------------------------------

CONFIGS = {
    "folding_points_dynamic": dict(decode_mesh=False),
    "folding_mesh_dynamic": dict(),
    "folding_mesh_static": dict(static=True),
    "deforming_mesh_dynamic": dict(deform=True),
    "deforming_points_static": dict(deform=True, decode_mesh=False,
                                    static=True),
}


def _ae(cfg, seed=0):
    kw = dict(k=8, n_embedding=32, shape_type="plane", n_input_points=256,
              **cfg)
    jm = jfolding.DGCNNFoldingNet(**kw)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 256, 3))))
    return jm, variables, load_jax_variables(folding_net.DGCNNFoldingNet(
        **kw), variables)


def _cloud(seed, b=2, n=256):
    rng = np.random.default_rng(seed)
    return (rng.integers(-16, 17, (b, n, 3)) / 16.0).astype(np.float32)


def _verts(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_folding_net_eval_matches_jax(name):
    jm, variables, tm = _ae(CONFIGS[name])
    x = _cloud(5)
    with jax.default_matmul_precision("float32"):
        want, hj = jm.apply(variables, x, train=False, return_hidden=True)
    with torch.no_grad():
        got, h = tm.eval()(_t(x), return_hidden=True)
    assert tm.m == jm.m == 256
    np.testing.assert_allclose(_verts(got).numpy(), _verts(want), **AE_TOL)
    np.testing.assert_allclose(h.numpy(), hj, **AE_TOL)
    if isinstance(want, tuple):
        np.testing.assert_array_equal(got[1].numpy(), want[1])


def _leaves(tree, path=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", np.asarray(tree[k], np.float32)


TRAIN_CONFIGS = [n for n in sorted(CONFIGS) if n.startswith("folding")]


@pytest.mark.parametrize("name", TRAIN_CONFIGS)
def test_folding_net_train_step_matches_jax(name):
    """Train mode: the loss (Chamfer to the input for a point decoder, the
    mesh loss with JAX's default draws for a mesh decoder) within 1e-5,
    every gradient and the running statistics within AE_TOL of JAX's. The
    deforming decoder's train mode is held in float64
    (test_deforming_decoder_train_matches_jax_f64 says why)."""
    cfg = CONFIGS[name]
    jm, variables, tm = _ae(cfg, seed=1)
    x = _cloud(6)
    mesh_dec = cfg.get("decode_mesh", True)
    n = 512
    if mesh_dec:
        _, faces = jfolding.folding_points_for("plane", 256, True)
        topo = jmesh.MeshTopology.from_faces(faces, 256)
        # no Laplacian: JAX's is NaN in the gradient wherever a vertex's
        # Laplacian is exactly 0 (test_laplacian_gradient_at_zero)
        jl = jmesh.make_regularized_mesh_loss(w_laplacian=0.0, n_samples=n)
        r1, r2 = jax.random.split(jax.random.PRNGKey(0))
        base = mesh.make_regularized_mesh_loss(
            w_laplacian=0.0, n_samples=n, draws=_surface_draws(r1, n))
        ptopo = mesh.MeshTopology.from_faces(faces, 256)

        def jloss_fn(out, y):
            return jl(out[0], y, faces=faces, topo=topo)

        def tloss_fn(out, y):
            return base(out[0], y, faces=faces, topo=ptopo)
    else:
        jloss_fn = jchamfer.chamfer_loss
        tloss_fn = chamfer.chamfer_loss

    def jfn(params):
        out, mut = jm.apply({**variables, "params": params}, x, train=True,
                            mutable=["batch_stats"])
        loss, comps = jloss_fn(out, jnp.asarray(x))
        return loss, (comps, mut["batch_stats"])
    with jax.default_matmul_precision("float32"):
        (lj, (_, stats_j)), gj = jax.value_and_grad(jfn, has_aux=True)(
            variables["params"])
    tm.train()
    loss, _ = tloss_fn(tm(_t(x)), _t(x))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-5)
    grads = dict(_leaves(export_jax_variables(tm, grad=True)["params"]))
    want = dict(_leaves(gj))
    assert set(grads) == set(want)
    for k in want:
        if mesh_dec:      # Chamfer near-ties (test_decoder_and_loss_...)
            gap = np.abs(grads[k] - want[k]).max() / np.abs(want[k]).max()
            assert gap <= MESH_GRAD_TOL, (k, gap)
        else:
            np.testing.assert_allclose(grads[k], want[k], err_msg=k,
                                       **AE_TOL)
    got_stats = dict(_leaves(export_jax_variables(tm)["batch_stats"]))
    for k, w in _leaves(stats_j):
        np.testing.assert_allclose(got_stats[k], w, err_msg=k, **AE_TOL)


@pytest.mark.parametrize("deform,decode_mesh,depth", [
    (False, True, 2), (True, True, 2), (True, False, 1)])
def test_decoder_and_loss_match_jax_f64(deform, decode_mesh, depth):
    """A decoder in train mode and its loss (the mesh loss without its
    Laplacian, with JAX's default draws, or the Chamfer distance), in
    float64 on both sides: the loss, the vertices and every gradient within
    F64_TOL. Two things make float32 too coarse here. The deforming
    decoder's BatchNorms normalize over B x m points whose code part takes
    B values only, which amplifies rounding: in float32 the whole model's
    train-mode vertices differ by 8e-4 (of 7.6) between the packages,
    where its eval-mode ones agree within 4e-7. And the Chamfer minima
    meet near-ties that float32 rounding breaks either way: in float32 the
    whole model's gradient leaves differ by up to 3.5e-4 of their largest
    entry (MESH_GRAD_TOL holds them there)."""
    from fissure_segmentation_tpu.models.folding_net import \
        DeformingDecoder as JDeforming
    from fissure_segmentation_tpu.models.folding_net import \
        FoldingDecoder as JFolding
    f64 = dict(rtol=1e-9, atol=1e-9)
    rng = np.random.default_rng(7)
    code = rng.normal(size=(2, 32))
    target = rng.normal(0, 0.3, (2, 100, 3))
    n = 300
    _, faces = jfolding.folding_points_for("plane", 64, True)
    with jax.enable_x64(True):
        jd = (JDeforming(32, "plane", 64, decode_mesh, depth) if deform
              else JFolding(32, "plane", 64, decode_mesh))
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            jd.init(jax.random.PRNGKey(3), jnp.asarray(code)))
        if decode_mesh:
            topo = jmesh.MeshTopology.from_faces(faces, 64)
            jl = jmesh.make_regularized_mesh_loss(w_laplacian=0.0,
                                                  n_samples=n)
            r1 = jax.random.split(jax.random.PRNGKey(0))[0]
            draws = _surface_draws(r1, n)

            def jloss(v, y):
                return jl(v, y, faces=faces, topo=topo)[0]
        else:
            def jloss(v, y):
                return jchamfer.chamfer_distance(v, y)

        def jfn(params, c):
            out, _ = jd.apply({**variables, "params": params}, c,
                              train=True, mutable=["batch_stats"])
            return jloss(_verts(out), jnp.asarray(target)), _verts(out)
        (lj, want), (gj, gcj) = jax.value_and_grad(
            jfn, (0, 1), has_aux=True)(variables["params"], code)
        lj, want, gcj = float(lj), np.asarray(want), np.asarray(gcj)
        gj = dict(_leaves(jax.tree_util.tree_map(np.asarray, gj)))
    if decode_mesh:
        base = mesh.make_regularized_mesh_loss(w_laplacian=0.0, n_samples=n,
                                               draws=draws)
        ptopo = mesh.MeshTopology.from_faces(faces, 64)

        def tloss(v, y):
            return base(v, y, faces=faces, topo=ptopo)[0]
    else:
        tloss = chamfer.chamfer_distance
    td = (folding_net.DeformingDecoder(32, "plane", 64, decode_mesh, depth)
          if deform else folding_net.FoldingDecoder(32, "plane", 64,
                                                    decode_mesh))
    td = load_jax_variables(td, variables).double().train()
    ct = torch.from_numpy(code).requires_grad_()
    out = _verts(td(ct))
    loss = tloss(out, torch.from_numpy(target))
    loss.backward()
    assert out.dtype == torch.float64
    np.testing.assert_allclose(float(loss), lj, **f64)
    np.testing.assert_allclose(out.detach().numpy(), want, **f64)
    np.testing.assert_allclose(ct.grad.numpy(), gcj, **f64)
    grads = export_jax_variables(td, grad=True)["params"]
    for k, g in _leaves(grads):
        # export casts to float32: within its rounding of the float64 value
        np.testing.assert_allclose(g, gj[k], err_msg=k, rtol=1e-6,
                                   atol=1e-9)


def test_folding_net_config_and_m():
    tm = folding_net.DGCNNFoldingNet(k=4, n_embedding=16, shape_type="plane",
                                     n_input_points=1000)
    assert tm.m == jfolding.DGCNNFoldingNet(
        k=4, n_embedding=16, shape_type="plane", n_input_points=1000).m
    assert tm.config == dict(k=4, n_embedding=16, shape_type="plane",
                             n_input_points=1000, decode_mesh=True,
                             deform=False, static=False, dec_depth=2)
    assert not [n for n, _ in tm.named_buffers() if "grid" in n]


# ---- the entry ---------------------------------------------------------------

def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_entry_trains_and_tests_on_cpu(tmp_path):
    """The port's entry at the JAX entry test's tiny config, point target
    and --mesh: model.pt (the class recorded), history.csv with the loss
    components, reconstruction_chamfer.csv and cv_results.csv in the JAX
    layout; --test_only rereads model.pt and writes the same numbers."""
    from fissure_segmentation_tpu_torch.models import load_model
    for extra in ([], ["--mesh", "--loss_weights", "1", "1", "0.1", "0.1"]):
        out = str(tmp_path / ("mesh" if extra else "points"))
        assert train_pc_ae.main(SMALL + ["--output", out] + extra,
                                device="cpu") == 0
        model = load_model(os.path.join(out, "fold0", "model.pt"))
        assert isinstance(model, folding_net.DGCNNFoldingNet)
        assert model.decode_mesh == bool(extra)
        hist = _read(os.path.join(out, "fold0", "history.csv"))
        assert len(hist) == 3
        if extra:
            assert "train_Laplacian" in hist[0]
        rec = _read(os.path.join(out, "fold0", "test",
                                 "reconstruction_chamfer.csv"))
        assert rec[0] == ["mean_chamfer", "std_chamfer"]
        assert np.isfinite(np.asarray(rec[1], float)).all()
        cv = _read(os.path.join(out, "cv_results.csv"))
        assert cv[0] == ["fold", "chamfer"] and cv[-1][0] == "mean"
        assert train_pc_ae.main(["--output", out, "--test_only", "--fold",
                                 "0"], device="cpu") == 0
        assert _read(os.path.join(out, "fold0", "test",
                                  "reconstruction_chamfer.csv")) == rec


def _jax_eval_draws(ds, n_eval=4096):
    """evaluate_reconstruction's draws in the JAX entry: PRNGKey(7), split
    per item; the inputs from sample_batch's first key, the GT samples
    from the item's key itself."""
    rng = jax.random.PRNGKey(7)
    draws = []
    for _ in range(len(ds)):
        rng, r = jax.random.split(rng)
        r_in, _ = jax.random.split(r)
        r_sample = jax.random.split(r_in, 3)[0]
        draws.append({"input": _batch_draws(r_sample, 1, ds.sample_points),
                      "eval": _surface_draws(r, n_eval)})
    return draws


def test_jax_trained_model_tested_by_port(tmp_path, monkeypatch):
    """The JAX entry trains fold 0 and tests it (model.fst); the port's
    --test_only reads that model.fst (no model.pt exists) and, with JAX's
    evaluation draws injected, writes JAX's reconstruction_chamfer.csv and
    cv_results.csv within ENTRY_RTOL."""
    sys.path.insert(0, REPO)
    import train_pc_ae as jentry
    out = str(tmp_path / "run")
    with jax.default_matmul_precision("float32"):
        jentry.run(jentry.get_pc_ae_train_parser().parse_args(
            SMALL + ["--output", out]))
    test_dir = os.path.join(out, "fold0", "test")
    want = _read(os.path.join(test_dir, "reconstruction_chamfer.csv"))
    want_cv = _read(os.path.join(out, "cv_results.csv"))
    assert not os.path.exists(os.path.join(out, "fold0", "model.pt"))
    real = train_pc_ae.evaluate_reconstruction

    def with_jax_draws(ds, model, out_dir, **kw):
        return real(ds, model, out_dir, draws=_jax_eval_draws(ds), **kw)
    monkeypatch.setattr(train_pc_ae, "evaluate_reconstruction",
                        with_jax_draws)
    assert train_pc_ae.main(["--output", out, "--test_only", "--fold", "0"],
                            device="cpu") == 0
    got = _read(os.path.join(test_dir, "reconstruction_chamfer.csv"))
    assert got[0] == want[0]
    np.testing.assert_allclose(np.asarray(got[1], float),
                               np.asarray(want[1], float), rtol=ENTRY_RTOL)
    got_cv = _read(os.path.join(out, "cv_results.csv"))
    assert [r[0] for r in got_cv] == [r[0] for r in want_cv]
    np.testing.assert_allclose(float(got_cv[-1][1]), float(want_cv[-1][1]),
                               rtol=ENTRY_RTOL)
