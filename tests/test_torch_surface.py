"""Port parity for the surface fit: closed-form eigen-solve, kNN-PCA
normals, splatting, spectral PSR, marching tetrahedra and the host mesh
filter, each against the JAX package on the same numpy-seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.keypoints.hessian import eigvalsh3 as jeig
from fissure_segmentation_tpu.ops.dpsr import dpsr_forward as jdpsr
from fissure_segmentation_tpu.ops.marching import \
    marching_tetrahedra as jmarching
from fissure_segmentation_tpu.ops.normals import \
    estimate_pointcloud_normals as jnormals
from fissure_segmentation_tpu.ops.splat import grid_interp as jinterp
from fissure_segmentation_tpu.ops.splat import point_rasterize as jraster
from fissure_segmentation_tpu.postprocess import surface_fitting as jsf
from fissure_segmentation_tpu_torch.keypoints.hessian import eigvalsh3
from fissure_segmentation_tpu_torch.ops.dpsr import dpsr_forward
from fissure_segmentation_tpu_torch.ops.marching import marching_tetrahedra
from fissure_segmentation_tpu_torch.ops.normals import \
    estimate_pointcloud_normals
from fissure_segmentation_tpu_torch.ops.splat import (grid_interp,
                                                      point_rasterize)
from fissure_segmentation_tpu_torch.postprocess import surface_fitting as tsf

RES = (16, 16, 16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sheet(rng, b=2, n=300):
    """Noisy tilted sheets in [-0.9, 0.9]^3 (zyx), generic floats (no
    distance ties), plus a validity mask with a few invalid rows."""
    yx = rng.uniform(-0.8, 0.8, (b, n, 2))
    z = 0.3 * yx[..., :1] - 0.2 * yx[..., 1:] + rng.normal(0, 0.02, (b, n, 1))
    pts = np.concatenate([z, yx], -1).astype(np.float32)
    valid = rng.random((b, n)) > 0.1
    return pts, valid


def test_eigvalsh3_matches():
    """rtol/atol 1e-5 of the spectrum scale: arccos/cos round differently
    in the two libraries."""
    rng = np.random.default_rng(0)
    a = [rng.normal(0, 1, 500).astype(np.float32) for _ in range(6)]
    e_j = np.stack([np.asarray(e) for e in jeig(*map(jnp.asarray, a))])
    e_t = np.stack([e.numpy() for e in eigvalsh3(*map(_t, a))])
    np.testing.assert_allclose(e_t, e_j, rtol=1e-5, atol=1e-5)


def test_normals_match_on_valid_rows():
    """Masked kNN-PCA normals, k=12: within 1e-4 on valid rows (invalid
    rows are arbitrary by contract)."""
    pts, valid = _sheet(np.random.default_rng(1))
    with jax.default_matmul_precision("float32"):
        n_j = np.asarray(jnormals(jnp.asarray(pts), 12, jnp.asarray(valid)))
    n_t = estimate_pointcloud_normals(_t(pts), 12, _t(valid)).numpy()
    np.testing.assert_allclose(n_t[valid], n_j[valid], atol=1e-4)


def test_rasterize_and_interp_match():
    """Trilinear splat (drop mode: the upper corners of points at 1.0 fall
    outside) and clamped interpolation; float sums in the same order,
    tolerance 1e-6."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 1, (2, 200, 3)).astype(np.float32)
    pts[:, :5] = 1.0
    vals = rng.normal(0, 1, (2, 200, 3)).astype(np.float32)
    r_j = np.asarray(jraster(jnp.asarray(pts), jnp.asarray(vals), RES))
    r_t = point_rasterize(_t(pts), _t(vals), RES).numpy()
    np.testing.assert_allclose(r_t, r_j, rtol=1e-6, atol=1e-6)
    grid = rng.normal(0, 1, (2, *RES, 2)).astype(np.float32)
    i_j = np.asarray(jinterp(jnp.asarray(grid), jnp.asarray(pts)))
    i_t = grid_interp(_t(grid), _t(pts)).numpy()
    np.testing.assert_allclose(i_t, i_j, rtol=1e-6, atol=1e-6)


def _phi_pair():
    pts, valid = _sheet(np.random.default_rng(3))
    nrm = np.zeros_like(pts)
    nrm[..., 0] = 1.0
    nrm *= valid[..., None]
    phi_j = np.asarray(jdpsr(jnp.asarray(pts), jnp.asarray(nrm), RES, sig=2.0,
                             point_weights=jnp.asarray(valid)))
    phi_t = dpsr_forward(_t(pts), _t(nrm), RES, sig=2.0,
                         point_weights=_t(valid)).numpy()
    return phi_j, phi_t


def test_psr_phi_matches():
    """Spectral PSR: FFT libraries differ in summation order; phi within
    1e-4 of its own scale."""
    phi_j, phi_t = _phi_pair()
    np.testing.assert_allclose(phi_t, phi_j, rtol=0,
                               atol=1e-4 * np.abs(phi_j).max())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("max_tris", [20000, 300])
def test_marching_tetrahedra_on_same_phi(masked, max_tris):
    """Same phi into both: n_tris equal, the same z-order truncation when
    the budget overflows, triangles within 1e-5 voxel."""
    phi = _phi_pair()[0][0]
    mask = None
    if masked:
        mask = np.zeros(tuple(r - 1 for r in RES), bool)
        mask[2:12, 3:14, 1:9] = True
    t_j, v_j, n_j = jmarching(jnp.asarray(phi), max_tris=max_tris,
                              cell_mask=None if mask is None
                              else jnp.asarray(mask))
    t_t, v_t, n_t = marching_tetrahedra(_t(phi), max_tris=max_tris,
                                        cell_mask=None if mask is None
                                        else _t(mask))
    assert int(n_t) == int(n_j) > 0
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=0,
                               atol=1e-5)


def test_bbox_cell_mask_equal():
    pts, valid = _sheet(np.random.default_rng(4))
    m_t = tsf._bbox_cell_mask(_t(pts), _t(valid), RES).numpy()
    for i in range(pts.shape[0]):
        m_j = np.asarray(jsf._bbox_cell_mask(jnp.asarray(pts[i]),
                                             jnp.asarray(valid[i]), RES))
        np.testing.assert_array_equal(m_t[i], m_j)


def test_host_mesh_filter_and_labelmap_equal():
    """The host half is a numpy copy over the shared native runtime:
    bit-equal outputs."""
    phi = _phi_pair()[0][0]
    tris, tvalid, n = jmarching(jnp.asarray(phi), max_tris=20000)
    n = int(n)
    tris = np.asarray(tris)[:n]
    shape = (40, 36, 44)
    rng = np.random.default_rng(5)
    pts_world = rng.uniform(5, 30, (50, 3)).astype(np.float32)
    mask = np.ones(shape, bool)
    mask[:, :, :4] = False
    args = (phi < 0, tris, np.ones(n, bool), pts_world, shape, RES, mask, 1,
            True, 20.0, True)
    mj = jsf._host_mesh_filter(*args)
    mt = tsf._host_mesh_filter(*args)
    assert mj[1].any()
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsf.mesh_to_labelmap([mt, mt], shape),
                                  jsf.mesh_to_labelmap([mj, mj], shape))
