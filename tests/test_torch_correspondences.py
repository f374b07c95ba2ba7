"""Port parity for corresponding-point generation
(shape_model/correspondences.py) against the JAX package on the CPU
(matmuls at float32 precision), on the JAX test's `_two_sheets` cases,
and the npz layout read and written by either package.

Tolerances:
  * on the JAX package's registrations (both modes): equal arrays. The
    locations are the same points (FPS is K5's plain version, bit-equal
    to JAX's; k-means is the same numpy code on the same draws), so
    everything after the registrations is exact;
  * on the port's own registrations: the similarity transforms within
    1e-4 (readings about 1e-6); the correspondences within 1e-4 at 5
    deformable iterations, and at 25 the JAX test's bound (the test says
    why). k-means is not compared on the port's own registrations: Lloyd's
    assignments flip on 1e-6 changes of the moved clouds (2.6 % of the
    points at 3 deformable iterations, 42 % at 25);
  * the npz files: equal arrays both ways.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.shape_model import correspondences as jcorr
from fissure_segmentation_tpu.shape_model import registration as jreg
from fissure_segmentation_tpu_torch.shape_model import correspondences as corr


def _two_sheets(rng, n=150, shift=(0, 0, 0), scale=1.0):
    u = rng.uniform(-1, 1, (n, 2))
    a = np.concatenate([u, 0.2 * u[:, :1]], 1) * scale + shift
    b = np.concatenate([u, 0.5 + 0.1 * u[:, 1:]], 1) * scale + shift
    return [a.astype(np.float32), b.astype(np.float32)]


def _cases():
    rng = np.random.default_rng(0)
    return [_two_sheets(rng), _two_sheets(rng, shift=(0.2, 0.1, 0.0)),
            _two_sheets(rng, scale=1.1)]


def _check_transforms(tr, jt, tol):
    for a, b in zip(tr, jt):
        np.testing.assert_allclose(a["rotation"], b["rotation"], atol=tol)
        np.testing.assert_allclose(a["translation"], b["translation"],
                                   atol=tol)
        assert abs(a["scale"] - b["scale"]) <= tol
    np.testing.assert_array_equal(tr[0]["rotation"], np.eye(3))


@pytest.mark.parametrize("mode", ["simple", "kmeans"])
def test_corresponding_points_on_jax_registrations_equal_jax(mode,
                                                             monkeypatch):
    """With the registrations routed through the JAX package's, the rest
    (locations by FPS or k-means, nearest moved points, pre-registered
    positions, labels, transforms) equals the JAX function's output."""
    def rigid(x, y, max_iter):
        out, (s, r, t) = jreg.register_cpd_rigid(
            jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), max_iter=max_iter)
        return (torch.from_numpy(np.array(out)),
                tuple(torch.from_numpy(np.array(v)) for v in (s, r, t)))

    def deformable(x, y, alpha, beta, max_iter):
        out, disp = jreg.register_cpd_deformable(
            jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), alpha=alpha,
            beta=beta, max_iter=max_iter)
        return torch.from_numpy(np.array(out)), \
            torch.from_numpy(np.array(disp))
    monkeypatch.setattr(corr, "register_cpd_rigid", rigid)
    monkeypatch.setattr(corr, "register_cpd_deformable", deformable)
    kw = dict(n_per_object=32, rigid_iters=25, deform_iters=25, mode=mode)
    with jax.default_matmul_precision("float32"):
        jc, jl, jt = jcorr.generate_corresponding_points(_cases(), **kw)
        c, lab, tr = corr.generate_corresponding_points(_cases(),
                                                        device="cpu", **kw)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(lab, jl)
    _check_transforms(tr, jt, 0.0)


@pytest.mark.parametrize("deform_iters", [5, 25])
def test_corresponding_points_match_jax(deform_iters):
    """The port's own registrations ('simple' mode). At 5 deformable
    iterations every point within 1e-4 of JAX's (readings 1.5e-6); at the
    JAX test's 25 the deformable M-step's ill-conditioning moves the
    registered clouds by 1e-2 in both packages
    (tests/test_torch_registration.py), which changes some nearest
    points: held there by the JAX test's own bound on the result."""
    kw = dict(n_per_object=32, rigid_iters=25, deform_iters=deform_iters)
    with jax.default_matmul_precision("float32"):
        jc, jl, jt = jcorr.generate_corresponding_points(_cases(), **kw)
    c, lab, tr = corr.generate_corresponding_points(_cases(), device="cpu",
                                                    **kw)
    assert c.shape == jc.shape == (3, 64, 3)
    np.testing.assert_array_equal(lab, jl)
    _check_transforms(tr, jt, 1e-4)
    if deform_iters == 5:
        np.testing.assert_allclose(c, jc, atol=1e-4)
    # the JAX test's property: cases agree in the registered frame
    assert np.linalg.norm(c[0] - c[1], axis=1).mean() < 0.25


def test_kmeans_and_nearest_are_the_jax_code():
    pts = np.random.default_rng(4).normal(size=(300, 3)).astype(np.float32)
    np.testing.assert_array_equal(corr._kmeans(pts, 7), jcorr._kmeans(pts, 7))
    np.testing.assert_array_equal(corr._nearest(pts[:20], pts[5:]),
                                  jcorr._nearest(pts[:20], pts[5:]))


def test_corresponding_points_files_either_way(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(2, 10, 3)).astype(np.float32)
    labels = np.repeat(np.arange(1, 3, dtype=np.int32), 5)
    trs = [{"rotation": np.eye(3, dtype=np.float32),
            "translation": np.zeros(3, np.float32), "scale": 1.0},
           {"rotation": rng.normal(size=(3, 3)).astype(np.float32),
            "translation": rng.normal(size=3).astype(np.float32),
            "scale": 1.25}]
    ids = [("a", "fixed"), ("b", "moving")]
    for writer, reader, d in ((jcorr, corr, "jax"), (corr, jcorr, "port")):
        writer.save_corresponding_points(str(tmp_path / d), ids, pts, labels,
                                         trs)
        got_ids, got, got_lab, got_tr = reader.load_corresponding_points(
            str(tmp_path / d))
        assert got_ids == ids
        np.testing.assert_array_equal(got, pts)
        np.testing.assert_array_equal(got_lab, labels)
        for a, b in zip(got_tr, trs):
            np.testing.assert_array_equal(a["rotation"], b["rotation"])
            np.testing.assert_array_equal(a["translation"], b["translation"])
            assert a["scale"] == b["scale"]


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown correspondence mode"):
        corr.generate_corresponding_points(_cases(), mode="grid",
                                           device="cpu")
