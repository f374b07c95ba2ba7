"""Port parity for plane fitting (postprocess/plane_fitting.py), the SSM's
qualitative helpers (shape_model/qualitative.py) and the shape sanity
probes (shape_sanity_checks.py) against the JAX package on the CPU
(matmuls at float32 precision), JAX's draws injected.

Tolerances:
  * the least-squares plane: (n, d) equal to JAX's up to one common sign
    (the smallest singular vector's sign is LAPACK's choice) within 1e-5;
    after 50 Adam steps within 1e-4 (Adam is odd in the gradient, so the
    mirrored start gives the mirrored path; optax's float32 bias
    correction, tests/test_torch_adam_registration.py); the mesh: equal;
  * the qualitative helpers' decoded shapes (float32 products): 1e-5;
    the sampled-shape files: equal arrays either way;
  * the weight probe (20 steps): error and baseline within rtol 1e-4
    (reading 5e-7); the eigenvector probe (30 steps from JAX's start
    matrix): rtol 1e-4;
  * the DG-SSM toy: JAX's rotation draws give JAX's batch (built here with
    the JAX package's transform algebra) within 1e-5.
    The model step itself is held against JAX's
    DGSSM in tests/test_torch_dgssm.py (JAX's whole toy takes 25 s to
    compile on one core); that the toy recovers the rotations (JAX's bound)
    is chip_smoke.py's phase 48, at the entry's widths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shape_sanity_checks as jsanity
from fissure_segmentation_tpu.data import augmentation as jaug
from fissure_segmentation_tpu.postprocess import plane_fitting as jplane
from fissure_segmentation_tpu.shape_model import qualitative as jqual
from fissure_segmentation_tpu.shape_model import ssm as jssm
from fissure_segmentation_tpu_torch import shape_sanity_checks as sanity
from fissure_segmentation_tpu_torch.postprocess import plane_fitting as plane
from fissure_segmentation_tpu_torch.shape_model import qualitative as qual
from fissure_segmentation_tpu_torch.shape_model import ssm


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _plane_points(seed=1):
    """The JAX test's noisy plane."""
    rng = np.random.default_rng(seed)
    n_true = np.asarray([0.2, -0.3, 0.93])
    n_true = n_true / np.linalg.norm(n_true)
    basis = np.linalg.svd(n_true[None])[2][1:]
    uv = rng.uniform(-10, 10, (500, 2))
    pts = 7.0 * n_true + uv @ basis + rng.normal(0, 0.05, (500, 3))
    return pts.astype(np.float32), n_true


def _same_plane(n, d, jn, jd, tol):
    n, jn = np.asarray(n), np.asarray(jn)
    sign = 1.0 if float(n @ jn) >= 0 else -1.0
    np.testing.assert_allclose(sign * n, jn, atol=tol)
    np.testing.assert_allclose(sign * float(d), float(jd), atol=tol * 10)


def test_plane_fitting_matches_jax():
    pts, n_true = _plane_points()
    valid = np.ones(len(pts), bool)
    valid[::7] = False
    lstsq = jax.jit(jplane.plane_from_points_lstsq)
    for v in (np.ones(len(pts), bool), valid):
        with jax.default_matmul_precision("float32"):
            jn0, jd0 = lstsq(jnp.asarray(pts), jnp.asarray(v))
        n0, d0 = plane.plane_from_points_lstsq(torch.from_numpy(pts),
                                               torch.from_numpy(v))
        _same_plane(n0, d0, jn0, jd0, 1e-5)
    # no mask is the all-valid mask
    torch.testing.assert_close(
        plane.plane_from_points_lstsq(torch.from_numpy(pts)),
        plane.plane_from_points_lstsq(torch.from_numpy(pts), torch.ones(
            len(pts), dtype=torch.bool)), rtol=0, atol=0)
    with jax.default_matmul_precision("float32"):
        jn, jd = jplane.fit_plane_to_fissure(jnp.asarray(pts), steps=50)
    n, d = plane.fit_plane_to_fissure(torch.from_numpy(pts), steps=50)
    _same_plane(n, d, jn, jd, 1e-4)
    assert abs(float(n @ torch.from_numpy(n_true).float())) > 0.999
    tris, valid = plane.plane_to_mesh(n.numpy(), float(d), (32, 32, 32))
    jtris, jvalid = jplane.plane_to_mesh(n.numpy(), float(d), (32, 32, 32))
    np.testing.assert_array_equal(tris, jtris)
    np.testing.assert_array_equal(valid, jvalid)


def _train_shapes(n=12, p=64, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.randn(p, 3).astype(np.float32)
    modes = rng.randn(3, p, 3).astype(np.float32)
    w = rng.randn(n, 3).astype(np.float32)
    return base[None] + np.einsum("nm,mpd->npd", w, modes) * 0.3


def test_qualitative_helpers_match_jax(tmp_path):
    shapes = _train_shapes()
    jparams = jssm.fit_ssm(shapes)
    params = ssm.fit_ssm(shapes)
    draws = np.asarray(jax.random.uniform(jax.random.PRNGKey(0),
                                          (3, params.num_modes)))
    with jax.default_matmul_precision("float32"):
        # JAX's default draws (PRNGKey(0)), as visualize_ssm_samples takes
        # them, read back from its sampled-shape files
        jpaths = jqual.sample_shapes_to_npz(jparams, 3, str(tmp_path / "jz"))
        jdecoded = jqual.latent_interpolation(shapes[0], shapes[1], jparams,
                                              steps=1)
    jsamples = np.stack([jqual.load_shape_npz(p)[0].reshape(-1, 3)
                         for p in jpaths])
    samples = qual.visualize_ssm_samples(params, 1, str(tmp_path / "port"),
                                         draws=torch.from_numpy(draws[:1]))
    np.testing.assert_allclose(samples, jsamples[:1], atol=1e-5)
    assert [p.name for p in (tmp_path / "port").iterdir()] == ["smpl_0.png"]
    decoded = qual.latent_interpolation(shapes[0], shapes[1], params, steps=1,
                                        savepath=str(tmp_path / "i.png"))
    np.testing.assert_allclose(decoded, jdecoded, atol=1e-5)
    assert (tmp_path / "i.png").exists()
    qual.visualize_reconstruction(shapes[0], shapes[1],
                                  savepath=str(tmp_path / "rec.png"))
    assert (tmp_path / "rec.png").stat().st_size > 0
    paths = qual.sample_shapes_to_npz(params, 3, str(tmp_path / "pz"),
                                      draws=torch.from_numpy(draws))
    for mine, theirs in zip(paths, jpaths):
        for read in (qual.load_shape_npz, jqual.load_shape_npz):
            a, ta = read(mine)
            b, tb = read(theirs)
            np.testing.assert_allclose(a, b, atol=1e-5)
            assert ta["scale"] == tb["scale"]
            np.testing.assert_array_equal(ta["rotation"], tb["rotation"])
            np.testing.assert_array_equal(ta["translation"],
                                          tb["translation"])


def test_weight_probe_matches_jax():
    np.testing.assert_array_equal(sanity.make_shapes(), jsanity.make_shapes())
    with jax.default_matmul_precision("float32"):
        want = jsanity.sanity_check_weights(n_iter=20, verbose=False)
    got = sanity.sanity_check_weights(n_iter=20, verbose=False, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_eigenvector_probe_matches_jax():
    shapes = jsanity.make_shapes()
    f, m = shapes[0].size, ssm.fit_ssm(shapes).num_modes
    m0 = 0.1 * np.asarray(jax.random.normal(jax.random.PRNGKey(0), (f, m)))
    with jax.default_matmul_precision("float32"):
        want = jsanity.sanity_check_eigenvectors(n_iter=30, verbose=False)
    got = sanity.sanity_check_eigenvectors(n_iter=30, verbose=False,
                                           device="cpu",
                                           m0=torch.from_numpy(m0))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _jax_toy_draws(n_steps):
    """The JAX toy's rotation uniforms: rng = PRNGKey(1), then each step
    rng, r = split(rng) and uniform(r, (8, 3))."""
    rng, out = jax.random.PRNGKey(1), []
    for _ in range(n_steps):
        rng, r = jax.random.split(rng)
        out.append(np.asarray(jax.random.uniform(r, (8, 3))))
    return np.stack(out)


def test_dgssm_toy_uses_jax_draws(monkeypatch):
    """The toy's batch from JAX's first draw is the batch JAX's toy builds
    (recorded at the port's transform_points)."""
    from fissure_segmentation_tpu_torch.data import augmentation
    draws = _jax_toy_draws(1)
    shapes = sanity.make_shapes(n=16, p=256)
    target = jnp.asarray(shapes[0])
    log_rot = (jnp.asarray(draws[0]) * 2 - 1) * 1.5
    t = jaug.compose_transform(log_rot, jnp.zeros((8, 3)), jnp.ones((8, 1)))
    center = target.mean(0)
    want_batch = np.asarray(jaug.transform_points(target[None] - center, t)
                            + center)
    seen = []
    transform = augmentation.transform_points

    def record(points, tr):
        seen.append(transform(points, tr))
        return seen[-1]
    monkeypatch.setattr(augmentation, "transform_points", record)
    errs = sanity.dgssm_rigid_toy_example(
        epochs=1, steps=1, verbose=False, device="cpu",
        draws=torch.from_numpy(draws))
    batch = seen[0] + torch.from_numpy(shapes[0]).mean(0)
    np.testing.assert_allclose(batch.numpy(), want_batch, rtol=1e-5,
                               atol=1e-6)
    assert len(errs) == 1 and np.isfinite(errs).all()
