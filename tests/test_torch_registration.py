"""Port parity for point-cloud registration (shape_model/registration.py):
TPS and thin_plate_dense, CPD's E-step, a few CPD iterations and whole
rigid and deformable runs, against the JAX package on the CPU (matmuls at
float32 precision) on the same seeded numpy inputs.

Tolerances:
  * TPS.d/u/z and the dense field (float32 products; torch's and JAX's
    linspace round alike to 1 ulp): TOL = rtol 1e-5, atol 1e-5 of the
    field's scale; the TPS solve (LU of a (N+4)^2 system): rtol 1e-4;
  * the E-step (one exp of the same squared distances): rtol 1e-5;
  * rigid CPD after 3 and 60 iterations: registered clouds within 1e-4 of
    the cloud's scale, the similarity's scale, rotation and translation
    within 1e-4 (readings about 1e-6);
  * deformable CPD after 3 iterations: registered clouds within 1e-4 of
    the cloud's scale, the displacements within 1e-3; after 40,
    within twice JAX's own distance to a float64 run (the test says why);
  * the rigid M-step's SVD: u @ c @ vt does not depend on the SVD's sign
    convention, held on a cloud whose cross-covariance has distinct
    singular values, where both packages must give one rotation within
    1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.shape_model import registration as jreg
from fissure_segmentation_tpu_torch.shape_model import registration as reg

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _helix(rng, n=120):
    t = rng.uniform(0, 2 * np.pi, n)
    y = np.stack([np.cos(t), np.sin(t), t / 6], 1)
    return (y + rng.normal(0, 0.01, y.shape)).astype(np.float32)


def _rotation(angle, axis):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def _close_to_scale(got, want, rel, what):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def test_tps_matches_jax():
    rng = np.random.default_rng(30)
    c = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    f = rng.normal(size=(30, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (21, 3)).astype(np.float32)

    @jax.jit
    def jax_tps(c, f, x):
        theta = jreg.TPS.fit(c, f, 0.1)
        return jreg.TPS.d(x, c), theta, jreg.TPS.z(x, c, theta)
    with jax.default_matmul_precision("float32"):
        jd, jtheta, jz = (np.asarray(a) for a in jax_tps(c, f, x))
    np.testing.assert_allclose(reg.TPS.d(_t(x), _t(c)).numpy(), jd, **TOL)
    theta = reg.TPS.fit(_t(c), _t(f), 0.1)
    np.testing.assert_allclose(theta.numpy(), jtheta, rtol=1e-4, atol=1e-4)
    _close_to_scale(reg.TPS.z(_t(x), _t(c), theta).numpy(), jz, 1e-4, "z")
    # exact interpolation at the controls without smoothing
    theta0 = reg.TPS.fit(_t(c), _t(f))
    np.testing.assert_allclose(reg.TPS.z(_t(c), _t(c), theta0).numpy(), f,
                               atol=1e-2)


def test_thin_plate_dense_matches_jax():
    """On odd shapes: the dense field at (9, 13, 11), and the corner-aligned
    upsampling alone where an axis has one sample."""
    shape = (9, 13, 11)
    rng = np.random.default_rng(sum(shape))
    x1 = rng.uniform(-0.8, 0.8, (1, 20, 3)).astype(np.float32)
    y1 = rng.normal(0, 0.05, (1, 20, 3)).astype(np.float32)
    dense = jax.jit(jreg.thin_plate_dense, static_argnums=(2, 3))
    with jax.default_matmul_precision("float32"):
        want = np.asarray(dense(jnp.asarray(x1), jnp.asarray(y1), shape, 4))
    got = reg.thin_plate_dense(_t(x1), _t(y1), shape, step=4).numpy()
    assert got.shape == (1, *shape, 3)
    _close_to_scale(got, want, 1e-4, "dense field")
    vol = rng.normal(size=(1, 3, 2, 3)).astype(np.float32)
    up = jax.jit(jreg._upsample_linear_corners, static_argnums=1)
    np.testing.assert_allclose(
        reg._upsample_linear_corners(_t(vol), (4, 3, 5)).numpy(),
        np.asarray(up(jnp.asarray(vol), (4, 3, 5))), **TOL)


@pytest.mark.parametrize("w_outlier", [0.0, 0.1])
def test_estep_matches_jax(w_outlier):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    y = rng.normal(size=(37, 3)).astype(np.float32)
    want = np.asarray(jreg._cpd_estep(jnp.asarray(x), jnp.asarray(y),
                                      jnp.float32(0.7), w_outlier))
    got = reg._cpd_estep(_t(x), _t(y), torch.tensor(0.7), w_outlier).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # the (M, N) distances summed coordinate by coordinate equal the
    # (M, N, 3) sum's
    np.testing.assert_array_equal(
        reg._sqdist(_t(y), _t(x)).numpy(),
        ((y[:, None] - x[None]) ** 2).sum(-1))


def _rigid_case(seed):
    rng = np.random.default_rng(seed)
    y = _helix(rng)
    r_true = _rotation(0.1 * np.pi, [0.0, 0.0, 1.0])
    x = (1.1 * y @ r_true.T + np.array([0.3, -0.2, 0.1])).astype(np.float32)
    return x, y


@pytest.mark.parametrize("iters", [3, 60])
def test_cpd_rigid_matches_jax(iters):
    """JAX's own rigid test case (its rng seed, helix, similarity)."""
    x, y = _rigid_case(42)
    with jax.default_matmul_precision("float32"):
        jy, (js, jr, jt) = jreg.register_cpd_rigid(
            jnp.asarray(x), jnp.asarray(y), max_iter=iters)
    ty, (s, r, t) = reg.register_cpd_rigid(_t(x), _t(y), max_iter=iters)
    _close_to_scale(ty.numpy(), np.asarray(jy), 1e-4, "registered cloud")
    assert abs(float(s) - float(js)) <= 1e-4
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4)
    if iters == 60:
        assert np.linalg.norm(ty.numpy() - x, axis=1).mean() < 0.05
        assert abs(float(s) - 1.1) < 0.05


@pytest.mark.parametrize("w_outlier", [0.0, 0.2])
def test_cpd_rigid_with_outliers_matches_jax(w_outlier):
    x, y = _rigid_case(1)
    with jax.default_matmul_precision("float32"):
        jy, _ = jreg.register_cpd_rigid(jnp.asarray(x), jnp.asarray(y),
                                        w_outlier=w_outlier, max_iter=3)
    ty, _ = reg.register_cpd_rigid(_t(x), _t(y), w_outlier=w_outlier,
                                   max_iter=3)
    _close_to_scale(ty.numpy(), np.asarray(jy), 1e-4, "registered cloud")


def test_rigid_rotation_is_independent_of_svd_signs():
    """The M-step's rotation u @ c @ vt from torch's SVD equals the one from
    every sign choice of the singular-vector pairs, on a cross-covariance
    with distinct singular values."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 3))
    sv = np.linalg.svd(a, compute_uv=False)
    assert np.diff(sv).max() < -1e-3          # distinct
    at = torch.from_numpy(a.astype(np.float32))
    u, _, vt = torch.linalg.svd(at)

    def rotation(u, vt):
        c = torch.diag(torch.stack([torch.tensor(1.0), torch.tensor(1.0),
                                    torch.sign(reg._det3(u @ vt))]))
        return u @ c @ vt
    want = rotation(u, vt)
    for signs in ([1, -1, 1], [-1, -1, 1], [1, 1, -1], [-1, 1, -1]):
        s = torch.tensor(signs, dtype=torch.float32)
        torch.testing.assert_close(rotation(u * s, s[:, None] * vt), want,
                                   rtol=1e-5, atol=1e-5)
    ju, _, jvt = np.linalg.svd(a.astype(np.float32))
    jc = np.diag([1.0, 1.0, np.sign(np.linalg.det(ju @ jvt))])
    np.testing.assert_allclose(want.numpy(), ju @ jc @ jvt, atol=1e-5)


@pytest.mark.parametrize("iters", [3, 40])
def test_cpd_deformable_matches_jax(iters):
    """Held tightly while sigma^2 is large; once it nears its floor the
    M-step's system (G P + alpha sigma^2 I) is so ill-conditioned that
    float32 rounding alone moves the result by percents: there the port
    is held to within twice JAX's own distance to a float64 run of the
    port (readings at 40 iterations: JAX 0.020, the port 0.008)."""
    rng = np.random.default_rng(2)
    y = rng.uniform(-1, 1, (80, 3)).astype(np.float32)
    x = (y + 0.2 * np.sin(y[:, :1] * 2)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        jy, jd = jreg.register_cpd_deformable(jnp.asarray(x), jnp.asarray(y),
                                              beta=2.0, max_iter=iters)
    jy, jd = np.asarray(jy), np.asarray(jd)
    ty, td = reg.register_cpd_deformable(_t(x), _t(y), beta=2.0,
                                         max_iter=iters)
    if iters < 40:
        _close_to_scale(ty.numpy(), jy, 1e-4, "registered cloud")
        _close_to_scale(td.numpy(), jd, 1e-3, "displacements")
        return
    ref, _ = reg.register_cpd_deformable(_t(x).double(), _t(y).double(),
                                         beta=2.0, max_iter=iters)
    ref = ref.numpy()
    err_port = float(np.abs(ty.numpy() - ref).max())
    err_jax = float(np.abs(jy - ref).max())
    assert err_port <= 2 * err_jax, (err_port, err_jax)
    d_before = np.linalg.norm(x - y, axis=1).mean()
    d_after = np.linalg.norm(x - ty.numpy(), axis=1).mean()
    assert d_after < 0.3 * d_before


def test_cpd_deformable_raises_on_a_singular_solve():
    """A singular M-step system is reported once the loop ends (the info
    of every solve is kept on the device)."""
    y = torch.zeros((4, 3))
    with pytest.raises(RuntimeError, match="singular"):
        reg.register_cpd_deformable(torch.ones((5, 3)), y, alpha=0.0,
                                    max_iter=2)
