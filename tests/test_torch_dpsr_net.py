"""Port parity for DPSR-Net: the splatting, the spectral PSR and marching
tetrahedra with their gradients, the SoftMesh (v2) and per-class (v1)
surface paths, DPSRNet and DPSRNet2 from a JAX `init`, the DPSR loss,
PointToMeshDS and the train_dpsr_net entry, against the JAX package on the
CPU (matmuls at float32 precision), at grids of 12-24 cells an axis.
JAX's uniforms of `sample_points_on_triangles` (one key a field, split
from the call's key) are injected (`draws=`).

Tolerances:
  * splatting, rasterizing, the PSR grid and its gradient, marching's
    triangles and their gradient, the surface samples: TOL = rtol 1e-5,
    atol 1e-5 (float32 rounding of the same operations in other orders:
    index_add_ against XLA's scatter, torch.fft against XLA's FFT);
  * v1's PSR grid: PSR_V1_TOL = 1e-4 (its normals come from closed-form
    3x3 eigenvectors that round differently in the two packages; reading
    2.3e-5);
  * triangle counts and valid flags: equal;
  * the gradient of a scalar of the surface samples with respect to the
    logits (v2; v1's argmax cuts it, zero in both), through splat,
    normals, PSR, marching and sampling: GRAD_TOL = rtol 1e-4 of the
    largest entry (readings up to 2e-6 relative);
  * the models' forward and one train step (the DPSR loss with its Chamfer
    term on): logits and samples within MODEL_TOL = 2e-4, the loss within
    rtol 2e-5 and every gradient leaf within MODEL_GRAD_TOL = 5e-4 of its
    largest entry (readings up to 2.1e-4, v2's SharedMLP_1 kernel: the
    Chamfer minima and the PSR path carry the seg net's rounding
    further; the SharedMLP_0 BatchNorm bias, whose true gradient is 0, at
    the whole gradient's largest entry) (dyadic inputs: the static
    coordinate graph is exact; an input on which both packages take the
    same LeakyReLU branches);
  * the stores and the loss's switch: equal arrays, and the loss within
    TOL;
  * the entries: each writes the files the JAX entry writes (model.pt
    where JAX writes model.fst), and `--test_only` reads them back.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.data import mesh_dataset as jmesh_dataset
from fissure_segmentation_tpu.losses.dpsr import make_dpsr_loss as \
    jmake_dpsr_loss
from fissure_segmentation_tpu.models import dpsr_net as jdpsr_net
from fissure_segmentation_tpu.ops import dpsr as jdpsr
from fissure_segmentation_tpu.ops import marching as jmarching
from fissure_segmentation_tpu.ops import splat as jsplat
from fissure_segmentation_tpu_torch import train_dpsr_net
from fissure_segmentation_tpu_torch.data import mesh_dataset
from fissure_segmentation_tpu_torch.data.synthetic import \
    make_synthetic_mesh_dataset
from fissure_segmentation_tpu_torch.losses import get_loss_fn
from fissure_segmentation_tpu_torch.models import (export_jax_variables,
                                                   load_jax_variables)
from fissure_segmentation_tpu_torch.models import dpsr_net
from fissure_segmentation_tpu_torch.ops import dpsr, marching, splat

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-4
MODEL_TOL = 2e-4
MODEL_GRAD_TOL = 5e-4
PSR_V1_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_to_max(got, want, rel, what=""):
    """|got - want| <= rel * max|want| (a gradient leaf's scale)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _jax_draws(key, n_fields, n_samples):
    """The per-field uniforms of the JAX surface path: split(key, n);
    per field split into the triangle and the barycentric draws."""
    def one(k):
        r_idx, r_uv = jax.random.split(k)
        return (jax.random.uniform(r_idx, (n_samples,)),
                jax.random.uniform(r_uv, (n_samples, 2)))
    u, uv = jax.vmap(one)(jax.random.split(key, n_fields))
    return _t(u), _t(uv)


# ---- splatting and rasterizing ----------------------------------------------

@pytest.mark.parametrize("mode", ["drop", "clamp"])
def test_splat_grid_sample_matches_jax(mode):
    """Coordinates up to 1.3 put corners beyond the grid's far faces (JAX
    drops or clamps them as the port does); corners below index 0 are
    test_splat_drops_corners_below_the_grid's."""
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(2, 60, 3)).astype(np.float32)
    coords = rng.uniform(-0.8, 1.3, (2, 60, 3)).astype(np.float32)
    w = rng.normal(size=(2, 3, 6, 7, 8)).astype(np.float32)
    grid = (6, 7, 8)

    def f(v):
        return jnp.sum(jsplat.splat_grid_sample(v, jnp.asarray(coords),
                                                grid, mode) * w)
    want = np.asarray(jsplat.splat_grid_sample(jnp.asarray(vals),
                                               jnp.asarray(coords), grid,
                                               mode))
    gj = np.asarray(jax.grad(f)(jnp.asarray(vals)))
    vt = _t(vals).requires_grad_()
    got = splat.splat_grid_sample(vt, _t(coords), grid, mode)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), gj, **TOL)
    # one cloud without the batch axis
    np.testing.assert_allclose(
        splat.splat_grid_sample(_t(vals[0]), _t(coords[0]), grid,
                                mode).numpy(), want[0], **TOL)


def _np_splat(vals, idx, shape, wrap):
    """Trilinear splat in float64 numpy: corners outside the grid dropped,
    or with `wrap` those at -n..-1 wrapped to the far side (numpy's
    negative indices, which JAX's `.at[].add(mode="drop")` applies)."""
    out = np.zeros((vals.shape[-1], *shape))
    lo = np.floor(idx).astype(int)
    frac = idx - lo
    for corner in np.ndindex(2, 2, 2):
        c = lo + np.asarray(corner)
        w = np.prod(np.where(np.asarray(corner), frac, 1 - frac), -1)
        for p in range(len(idx)):
            ok = all(-(n if wrap else 0) <= ci < n
                     for ci, n in zip(c[p], shape))
            if ok:
                out[(slice(None), *c[p])] += w[p] * vals[p]
    return out


def test_splat_drops_corners_below_the_grid():
    """A corner at index -1 (a coordinate within half a voxel of -1)
    contributes nothing in the port, the transpose of grid_sample's zeros
    padding that the JAX package documents; JAX's scatter wraps it to the
    far face instead (ROADMAP Queue 3, F9). Both are held to a float64
    numpy splat, with and without the wrap."""
    rng = np.random.default_rng(13)
    grid = (6, 7, 8)
    vals = rng.normal(size=(40, 2)).astype(np.float32)
    coords = rng.uniform(-1.0, 1.0, (40, 3)).astype(np.float32)
    coords[:10, 0] = -0.99                       # x corner at -1
    whd = np.asarray(grid[::-1], np.float32)
    idx = ((coords * whd / (whd - 1) + 1) / 2 * (whd - 1))[:, ::-1]
    got = splat.splat_grid_sample(_t(vals), _t(coords), grid).numpy()
    jax_out = np.asarray(jsplat.splat_grid_sample(
        jnp.asarray(vals), jnp.asarray(coords), grid))
    np.testing.assert_allclose(got, _np_splat(vals, idx, grid, False),
                               **TOL)
    np.testing.assert_allclose(jax_out, _np_splat(vals, idx, grid, True),
                               **TOL)
    assert np.abs(got - jax_out)[..., -1].max() > 0.1   # the far x face


def test_point_rasterize_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0.0, 1.2, (2, 80, 3)).astype(np.float32)
    vals = rng.normal(size=(2, 80, 3)).astype(np.float32)
    size = (9, 10, 11)
    w = rng.normal(size=(2, 3, *size)).astype(np.float32)

    def f(p, v):
        return jnp.sum(jsplat.point_rasterize(p, v, size) * w)
    want = np.asarray(jsplat.point_rasterize(jnp.asarray(pts),
                                             jnp.asarray(vals), size))
    gp, gv = jax.grad(f, argnums=(0, 1))(jnp.asarray(pts), jnp.asarray(vals))
    pt, vt = _t(pts).requires_grad_(), _t(vals).requires_grad_()
    got = splat.point_rasterize(pt, vt, size)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gv), **TOL)
    _close_to_max(pt.grad.numpy(), gp, GRAD_TOL)


# ---- spectral PSR, marching, sampling ---------------------------------------

@pytest.mark.parametrize("weights", [False, True])
def test_spectral_psr_gradient_matches_jax(weights):
    rng = np.random.default_rng(2)
    res = (12, 14, 16)
    v = rng.uniform(0.1, 0.9, (2, 50, 3)).astype(np.float32)
    nf = rng.normal(size=(2, 3, *res)).astype(np.float32)
    pw = (rng.uniform(size=(2, 50)) > 0.3).astype(np.float32) if weights \
        else None
    w = rng.normal(size=(2, *res)).astype(np.float32)

    def f(v_, n_):
        phi = jdpsr.spectral_psr(v_, n_, res, 3.0,
                                 point_weights=None if pw is None
                                 else jnp.asarray(pw))
        return jnp.sum(phi * w), phi
    (_, phi_j), (gv, gn) = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(v), jnp.asarray(nf))
    vt, nt = _t(v).requires_grad_(), _t(nf).requires_grad_()
    phi = dpsr.spectral_psr(vt, nt, res, 3.0,
                            point_weights=None if pw is None else _t(pw))
    (phi * _t(w)).sum().backward()
    np.testing.assert_allclose(phi.detach().numpy(), np.asarray(phi_j),
                               **TOL)
    _close_to_max(nt.grad.numpy(), gn, GRAD_TOL)
    _close_to_max(vt.grad.numpy(), gv, GRAD_TOL)


def _sphere_fields(rng, n, shape):
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape],
                             indexing="ij")
    out = []
    for _ in range(n):
        c = rng.uniform(-0.2, 0.2, 3)
        r = np.sqrt((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
        out.append(r - rng.uniform(0.4, 0.6)
                   + rng.normal(0, 0.02, shape))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("max_tris", [4000, 300])
def test_marching_gradient_matches_jax(max_tris):
    """Triangles, valid flags and counts equal JAX's (max_tris 300
    truncates in z-order), the gradient of a scalar of the triangles
    within GRAD_TOL; the batched extraction equals one field at a time."""
    rng = np.random.default_rng(3)
    phis = _sphere_fields(rng, 2, (12, 13, 14))
    w = rng.normal(size=(max_tris, 3, 3)).astype(np.float32)

    def f(phi):
        tris, valid, n = jmarching.marching_tetrahedra(phi, max_tris=max_tris)
        return jnp.sum(tris * w), (tris, valid, n)
    pt = _t(phis).requires_grad_()
    tris, valid, n = marching.marching_tetrahedra_batched(pt, max_tris)
    (tris * _t(w)).sum().backward()
    for i in range(2):
        (_, (tj, vj, nj)), gj = jax.value_and_grad(f, has_aux=True)(
            jnp.asarray(phis[i]))
        assert int(n[i]) == int(nj)
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(vj))
        np.testing.assert_allclose(tris[i].detach().numpy(), np.asarray(tj),
                                   **TOL)
        _close_to_max(pt.grad[i].numpy(), gj, GRAD_TOL)
        one = marching.marching_tetrahedra(_t(phis[i]), max_tris)
        assert torch.equal(one[0], tris[i].detach())
        assert torch.equal(one[1], valid[i]) and int(one[2]) == int(n[i])
    assert int(n[0]) > 300       # the small budget does truncate


def test_sample_points_gradient_matches_jax():
    """The sampler's CDF is detached in both packages: the gradient
    reaches the triangles through the barycentric combination only."""
    rng = np.random.default_rng(4)
    tris = rng.normal(size=(50, 3, 3)).astype(np.float32)
    valid = np.arange(50) < 41
    key = jax.random.PRNGKey(5)
    w = rng.normal(size=(40, 3)).astype(np.float32)

    def f(t):
        return jnp.sum(jmarching.sample_points_on_triangles(
            key, t, jnp.asarray(valid), 40) * w)
    gj = jax.grad(f)(jnp.asarray(tris))
    r_idx, r_uv = jax.random.split(key)
    draws = (_t(jax.random.uniform(r_idx, (40,))),
             _t(jax.random.uniform(r_uv, (40, 2))))
    tt = _t(tris).requires_grad_()
    pts = marching.sample_points_on_triangles(tt, _t(valid), 40,
                                              draws=draws)
    (pts * _t(w)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gj), **TOL)


# ---- the surface paths ------------------------------------------------------

def _logits_and_coords(rng, b=2, n=300, c=3):
    """Classes by region (x < -0.2: 1, x > 0.2: 2, else 0) plus noise, so
    every class keeps well over k_normals points."""
    coords = rng.uniform(-0.9, 0.9, (b, n, 3)).astype(np.float32)
    lbl = np.where(coords[..., 0] < -0.2, 1,
                   np.where(coords[..., 0] > 0.2, 2, 0))
    logits = rng.normal(0, 1, (b, n, c)).astype(np.float32) \
        + 4 * np.eye(c, dtype=np.float32)[lbl]
    return logits, coords


@pytest.mark.parametrize("res", [(16, 16, 16), (16, 20, 24)])
def test_soft_mesh_surface_samples_match_jax(res):
    rng = np.random.default_rng(6)
    logits, coords = _logits_and_coords(rng)
    key = jax.random.PRNGKey(7)
    kw = dict(res=res, normals_smoothing_sigma=2.0, dpsr_sigma=3.0,
              max_tris=3000, n_surface_samples=64)
    w = rng.normal(size=(2, 2, 64, 3)).astype(np.float32)

    def f(lg):
        p, v, psr = jdpsr_net.soft_mesh_surface_samples(
            lg, jnp.asarray(coords), key, **kw)
        return jnp.sum(jnp.where(v[..., None], p, 0.0) * w), (p, v, psr)
    with jax.default_matmul_precision("float32"):
        (_, (pj, vj, psrj)), gj = jax.jit(jax.value_and_grad(
            f, has_aux=True))(
            jnp.asarray(logits))
    lt = _t(logits).requires_grad_()
    pt, vt, psrt = dpsr_net.soft_mesh_surface_samples(
        lt, _t(coords), draws=_jax_draws(key, 4, 64), **kw)
    (torch.where(vt[..., None], pt, 0.0) * _t(w)).sum().backward()
    np.testing.assert_allclose(psrt.detach().numpy(), np.asarray(psrj),
                               **TOL)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt.all()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), **TOL)
    _close_to_max(lt.grad.numpy(), gj, GRAD_TOL)
    # the same triangle counts from the same grids
    flat = psrt.detach().reshape(4, *res)
    n_t = marching.marching_tetrahedra_batched(flat, 3000)[2]
    n_j = [int(jmarching.marching_tetrahedra(p, max_tris=3000)[2])
           for p in np.asarray(psrj).reshape(4, *res)]
    assert n_t.tolist() == n_j


def test_per_class_surface_samples_match_jax():
    """v1: argmax classes, kNN-PCA normals, masked rasterizing and shift.
    The argmax cuts the gradient: a scalar of the samples has a zero
    gradient with respect to the logits in both packages (JAX's with
    respect to the coordinates is NaN, from the masked points it pushes
    to 1e6, and nothing trains through it). An empty class gives no valid
    samples and a constant field."""
    rng = np.random.default_rng(8)
    logits, coords = _logits_and_coords(rng, c=4)   # class 3 never wins
    logits[..., 3] = -10.0
    key = jax.random.PRNGKey(9)
    kw = dict(res=(16, 16, 16), dpsr_sigma=3.0, max_tris=3000,
              n_surface_samples=64, k_normals=10)
    w = rng.normal(size=(2, 3, 64, 3)).astype(np.float32)

    def f(lg):
        p, v, psr = jdpsr_net.per_class_surface_samples(
            lg, jnp.asarray(coords), key, **kw)
        return jnp.sum(jnp.where(v[..., None], p, 0.0) * w), (p, v, psr)
    with jax.default_matmul_precision("float32"):
        (_, (pj, vj, psrj)), gj = jax.jit(jax.value_and_grad(
            f, has_aux=True))(
            jnp.asarray(logits))
    lt = _t(logits).requires_grad_()
    pt, vt, psrt = dpsr_net.per_class_surface_samples(
        lt, _t(coords), draws=_jax_draws(key, 6, 64), **kw)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt[:, :2].all() and not vt[:, 2].any()
    assert (psrt[:, 2] == 1.0).all()
    np.testing.assert_allclose(psrt.detach().numpy(), np.asarray(psrj),
                               **PSR_V1_TOL)
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), **TOL)
    assert not pt.requires_grad and not np.asarray(gj).any()


# ---- the models -------------------------------------------------------------

def _jax_dpsr_model(cls, rng, **kw):
    jm = cls(seg_net_class="DGCNN", k=6, in_features=3, num_classes=3,
             dynamic=False, dpsr_res=(16, 16, 16), dpsr_sigma=3.0,
             max_tris=3000, n_surface_samples=64, **kw)
    x0 = jnp.zeros((1, 64, 3), jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), x0, train=False,
                            rng=jax.random.PRNGKey(0)))

    def randomize(path, leaf):
        name = jax.tree_util.keystr(path)
        if "BatchNorm" not in name:
            return leaf
        if "var" in name:
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.3, leaf.shape).astype(np.float32) + \
            (1.0 if "scale" in name else 0.0)
    return jm, jax.tree_util.tree_map_with_path(randomize, variables)


def _flatten_loss(base, out, y):
    """The entry's flattening of the class axis."""
    seg, pts, valid = out
    b, c1, s, _ = pts.shape
    return base((seg, pts.reshape(b * c1, s, 3), valid.reshape(b * c1, s)),
                (y[0], y[1].reshape(b * c1, -1, 3),
                 y[2].reshape(b * c1, -1)))


def _same_branches(jm, variables, tm, x, key) -> bool:
    """Whether every BatchNorm output of the train-mode forward (each
    feeds a LeakyReLU) has the same sign in both packages."""
    import flax.linen as fnn
    _, state = jax.jit(lambda v, x_: jm.apply(
        v, x_, train=True, rng=key, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda m, _: isinstance(m, fnn.BatchNorm)))(
        variables, jnp.asarray(x))
    want = {"/".join(str(p.key) for p in path[1:-2]): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                state["intermediates"])[0]}
    got = {}
    hooks = [m.register_forward_hook(
        lambda m_, i, o, n=n: got.__setitem__(n, o.detach().numpy()))
        for n, m in tm.seg_net.named_modules() if n.endswith("BatchNorm_0")]
    with torch.no_grad():
        tm.seg_net.train()(_t(x))
    for h in hooks:
        h.remove()
    got = {n.replace(".", "/"): v for n, v in got.items()}
    assert len(got.keys() & want.keys()) >= 5
    return all(np.array_equal(got[n] >= 0, want[n] >= 0)
               for n in got.keys() & want.keys())


@pytest.mark.parametrize("version", [1, 2])
def test_dpsr_net_forward_and_step_match_jax(version):
    """The input is the first of up to 10 draws on which both packages
    take the same LeakyReLU branches (every BatchNorm output with the same
    sign): the seg net's inputs lie within 1e-5 of 0 on most draws, where
    float32 rounding in another order may take the other branch (one at
    4e-6 moved a leaf's gradient by 4.5 %), no fault of either package."""
    rng = np.random.default_rng(10 + version)
    jcls = jdpsr_net.DPSRNet if version == 1 else jdpsr_net.DPSRNet2
    tcls = dpsr_net.DPSRNet if version == 1 else dpsr_net.DPSRNet2
    extra = dict(k_normals=10) if version == 1 else \
        dict(normals_smoothing_sigma=2.0)
    jm, variables = _jax_dpsr_model(jcls, rng, **extra)
    tm = load_jax_variables(
        tcls("DGCNN", k=6, in_features=3, num_classes=3, dynamic=False,
             dpsr_res=(16, 16, 16), dpsr_sigma=3.0, max_tris=3000,
             n_surface_samples=64, **extra), variables)
    assert list(variables["params"]) == ["DGCNNSeg_0"]
    key = jax.random.PRNGKey(11)
    with jax.default_matmul_precision("float32"):
        for _ in range(10):
            x = (rng.integers(-14, 15, (2, 64, 3)) / 16.0).astype(np.float32)
            if _same_branches(jm, variables, tm, x, key):
                break
        else:
            pytest.fail("no input on which both take the same branches")
    tm = load_jax_variables(tm, variables)    # undo the running update
    y = rng.integers(0, 3, (2, 64))
    surf = rng.uniform(-0.8, 0.8, (2, 2, 80, 3)).astype(np.float32)
    draws = _jax_draws(key, 4, 64)
    cw = np.asarray([0.5, 1.5, 1.0], np.float32)

    with jax.default_matmul_precision("float32"):
        ej = jax.jit(lambda v, x_: jm.apply(v, x_, train=False, rng=key))(
            variables, jnp.asarray(x))
    with torch.no_grad():
        et = tm.eval()(_t(x), draws=draws)
    np.testing.assert_allclose(et[0].numpy(), np.asarray(ej[0]),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_array_equal(et[2].numpy(), np.asarray(ej[2]))
    np.testing.assert_allclose(et[1].numpy(), np.asarray(ej[1]),
                               rtol=MODEL_TOL, atol=MODEL_TOL)

    jbase = jmake_dpsr_loss(jnp.asarray(cw))
    yj = (jnp.asarray(y), jnp.asarray(surf), jnp.ones(surf.shape[:-1], bool))

    def jloss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), train=True, rng=key,
                          mutable=["batch_stats"])
        return _flatten_loss(jbase, out, yj)[0]
    with jax.default_matmul_precision("float32"):
        lj, gj = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    tbase = get_loss_fn("dpsr", _t(cw))
    yt = (_t(y), _t(surf), torch.ones(surf.shape[:-1], dtype=torch.bool))
    lt = _flatten_loss(tbase, tm.train()(_t(x), draws=draws), yt)[0]
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5)
    got = export_jax_variables(tm, grad=True)["params"]
    leaves_j = dict(jax.tree_util.tree_flatten_with_path(gj)[0])
    leaves_t = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert leaves_j.keys() == leaves_t.keys()
    whole = max(float(np.abs(np.asarray(g)).max())
                for g in leaves_j.values())
    for k, g in leaves_j.items():
        name = jax.tree_util.keystr(k)
        if "['SharedMLP_0']['BatchNorm_0']['bias']" in name:
            # its true gradient is 0 (the next BatchNorm removes a shift):
            # float32 noise, held at the whole gradient's scale
            err = float(np.abs(leaves_t[k] - np.asarray(g)).max())
            assert err <= MODEL_GRAD_TOL * whole, (name, err, whole)
            continue
        _close_to_max(leaves_t[k], g, MODEL_GRAD_TOL, name)


@pytest.mark.parametrize("frac", [0.05, 0.1, 0.5])
def test_make_dpsr_loss_matches_jax(frac):
    """The Chamfer term joins at epoch fraction 0.1, masks included."""
    rng = np.random.default_rng(12)
    logits = rng.normal(size=(2, 40, 3)).astype(np.float32)
    y = rng.integers(0, 3, (2, 40))
    p = rng.normal(size=(2, 30, 3)).astype(np.float32)
    pv = rng.uniform(size=(2, 30)) > 0.2
    t = rng.normal(size=(2, 25, 3)).astype(np.float32)
    cw = np.asarray([0.5, 1.5, 1.0], np.float32)
    lj, cj = jmake_dpsr_loss(jnp.asarray(cw))(
        (jnp.asarray(logits), jnp.asarray(p), jnp.asarray(pv)),
        (jnp.asarray(y), jnp.asarray(t)), current_epoch_fraction=frac)
    lt, ct = get_loss_fn("dpsr", _t(cw))(
        (_t(logits), _t(p), _t(pv)), (_t(y), _t(t)),
        current_epoch_fraction=frac)
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
    assert set(ct) == set(cj) == {"Segmentation", "Chamfer"}
    for k in cj:
        np.testing.assert_allclose(float(ct[k]), float(cj[k]), **TOL)
    assert (float(ct["Chamfer"]) == 0.0) == (frac < 0.1)


# ---- data -------------------------------------------------------------------

def test_point_to_mesh_ds_matches_jax():
    cases, meshes, sizes = make_synthetic_mesh_dataset(
        n_cases=4, grid_n=8, n_points=300, gt_surfaces=True)
    ours = mesh_dataset.PointToMeshDS(cases, meshes, sizes, sample_points=64)
    theirs = jmesh_dataset.PointToMeshDS(cases, meshes, sizes,
                                         sample_points=64)
    for a, b in ((ours.mesh_store(), theirs.mesh_store()),
                 (ours.class_mesh_store(2), theirs.class_mesh_store(2)),
                 (ours.class_mesh_store(1, [3, 0]),
                  theirs.class_mesh_store(1, [3, 0]))):
        np.testing.assert_array_equal(a.tris.numpy(), np.asarray(b.tris))
        np.testing.assert_array_equal(a.valid.numpy(), np.asarray(b.valid))
    split = {"train": [list(ours.ids[0]), ours.ids[2][0]],
             "val": [list(ours.ids[1]), list(ours.ids[3])]}
    for a, b in zip(ours.split_data_set(split),
                    theirs.split_data_set(split)):
        assert a.ids == b.ids and a.do_augmentation == b.do_augmentation
        for ma, mb in zip(a.meshes, b.meshes):
            for sa, sb in zip(ma, mb):
                np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(a.class_mesh_store(1).tris.numpy(),
                                      np.asarray(b.class_mesh_store(1).tris))


# ---- the entry --------------------------------------------------------------

SMALL = ["--ds", "synthetic", "--epochs", "2", "--batch", "2", "--pts", "64",
         "--k", "8", "--fold", "0", "--static", "--scheduler", "none",
         "--res", "16", "16", "16"]
# what the JAX entry writes, with model.pt for its model.fst
ENTRY_FILES = {"commandline_args.json", "cross_val_split.json",
               "cv_results.csv", "op_count.csv", "fold0/history.csv",
               "fold0/model.pt", "fold0/train_time.csv",
               "fold0/test/test_results.csv",
               "fold0/test/dice_per_instance.csv",
               "fold0/test/assd_per_instance.csv",
               "fold0/test/inference_time.csv"}


@pytest.fixture(scope="module")
def small_mesh_dataset():
    """The entry's synthetic dataset at 600 points a case, made once."""
    import copy
    made = train_dpsr_net.make_synthetic_mesh_dataset(
        n_cases=10, grid_n=8, n_points=600, gt_surfaces=True)

    def small(**kw):
        return copy.deepcopy(made)
    return small


@pytest.mark.parametrize("version", ["1", "2"])
def test_entry_trains_and_tests_on_cpu(tmp_path, monkeypatch, version,
                                       small_mesh_dataset):
    monkeypatch.setattr(train_dpsr_net, "make_synthetic_mesh_dataset",
                        small_mesh_dataset)
    out = str(tmp_path / "run")
    assert train_dpsr_net.main(SMALL + ["--dpsr_version", version,
                                        "--output", out],
                               device="cpu") == 0
    have = {os.path.relpath(os.path.join(d, f), out)
            for d, _, fs in os.walk(out) for f in fs}
    assert ENTRY_FILES <= have, ENTRY_FILES - have
    from fissure_segmentation_tpu_torch.models import load_model
    model = load_model(os.path.join(out, "fold0", "model.pt"))
    assert type(model).__name__ == ("DPSRNet" if version == "1"
                                    else "DPSRNet2")
    assert model.config["max_tris"] == 8 * 16 * 16
    assert model.n_surface_samples == 128
    with open(os.path.join(out, "fold0", "history.csv")) as f:
        header = f.readline().strip().split(",")
    assert "train_Chamfer" in header
    os.remove(os.path.join(out, "cv_results.csv"))
    assert train_dpsr_net.main(["--output", out, "--test_only", "--fold",
                                "0"], device="cpu") == 0
    assert os.path.exists(os.path.join(out, "cv_results.csv"))


def test_entry_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_dpsr_net.main(SMALL + ["--output", str(tmp_path)])
