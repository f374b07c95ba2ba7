"""Port parity for dense Adam image registration
(shape_model/adam_registration.py and the register_images entry) against
the JAX package on the CPU, on the same seeded numpy inputs.

Tolerances:
  * the one-hot label features: equal; the MIND-SSC features: within 5e-4
    of their largest entry (the port's MIND against JAX's,
    tests/test_torch_keypoint_features.py says why);
  * the loss (a sum of float32 means): rtol 1e-5; its gradient: within
    1e-4 of its largest entry (the box filter and the mean sum in other
    orders);
  * 5 steps of the loop from a warm start off the voxel grid (lr 0.5):
    the field within 1e-4 of its largest entry and the losses within rtol
    1e-5 (torch.optim.Adam is optax.adam but for optax's bias correction
    1 - 0.999^t, taken in float32 and 1.3e-5 off at t = 1);
  * the trilinear upsampling (F.interpolate against jax.image.resize at odd
    shapes) and the warps: atol 1e-5 of unit-scale values (readings 1.5e-6);
    nearest warps of labels: equal;
  * TRE: rtol 1e-5;
  * the JAX test's 24^3 end-to-end registration (60 steps, lr 0.3), which
    starts at zero on the interpolation's kinks (the test says why): the
    first loss within rtol 1e-5, the last within rtol 1e-3, the warped
    image's squared error within 2 % of JAX's; the JAX test's bounds hold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.shape_model import adam_registration as jar
from fissure_segmentation_tpu_torch import register_images as entry
from fissure_segmentation_tpu_torch.shape_model import adam_registration as ar


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _smooth_image(shape, seed=0):
    """The JAX test's band-limited random volume (as numpy)."""
    rng = np.random.RandomState(seed)
    small = rng.randn(*[max(2, s // 4) for s in shape])
    img = jax.image.resize(jnp.asarray(small), shape, "trilinear")
    return np.asarray(img / (jnp.abs(img).max() + 1e-9), np.float32)


def _gt_disp_norm(shape, amp=0.08):
    idx = jar._identity_grid_xyz(shape)
    window = jnp.prod(jnp.cos(idx * jnp.pi / 2) ** 2, axis=-1, keepdims=True)
    return np.asarray(amp * jnp.sin(idx * jnp.pi * 1.5) * window)


def _close_to_max(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    scale = max(float(np.abs(want).max()), 1e-12)
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def test_registration_features_odd_dims_with_labels():
    shape = (17, 19, 21)
    img = _smooth_image(shape) * 300.0
    lobes = np.zeros(shape, np.int32)
    lobes[2:15, 2:17, 2:19] = 5
    lobes[2:8, 2:17, 2:19] = 2
    fissures = np.zeros(shape, np.int32)
    fissures[8, 5:15, 5:15] = 3           # combined = 5 + 3 + 5 = 13
    fissures[3, 4:9, 4:9] = 12            # beyond the one-hot width: zeros
    mask = np.ones(shape, bool)
    mask[:, :3] = False
    want = np.asarray(jar.registration_features(
        jnp.asarray(img), jnp.asarray(mask), jnp.asarray(fissures),
        jnp.asarray(lobes)))
    got = ar.registration_features(_t(img), torch.from_numpy(mask),
                                   torch.from_numpy(fissures),
                                   torch.from_numpy(lobes)).numpy()
    assert got.shape == want.shape == (12 + 16, 8, 9, 10)
    np.testing.assert_array_equal(got[12:], want[12:])
    assert got[12 + 13].sum() > 0
    _close_to_max(got[:12], want[:12], 5e-4, "MIND-SSC")


def _features(shape=(6, 7, 5), c=4, seed=0):
    rng = np.random.default_rng(seed)
    fix = rng.normal(size=(c, *shape)).astype(np.float32)
    mov = (fix + 0.3 * rng.normal(size=fix.shape)).astype(np.float32)
    return fix, mov


def test_loss_and_gradient_match_jax():
    fix, mov = _features()
    disp = np.random.default_rng(2).normal(0, 0.7, (6, 7, 5, 3)).astype(
        np.float32)
    jid = jar._identity_grid_xyz((6, 7, 5))
    jl, jg = jax.jit(jax.value_and_grad(jar._loss_fn))(
        jnp.asarray(disp), jnp.asarray(fix), jnp.asarray(mov), jid, 0.65)
    d = _t(disp).requires_grad_(True)
    loss = ar._loss_fn(d, _t(fix), _t(mov), ar._identity_grid_xyz((6, 7, 5)),
                       0.65)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    _close_to_max(d.grad.numpy(), jg, 1e-4, "gradient")


def test_adam_steps_match_jax():
    """Five steps from a warm start off the voxel grid (from zero every
    sampling position sits on a kink of the trilinear interpolation; see
    the end-to-end test)."""
    fix, mov = _features(shape=(8, 6, 7), seed=3)
    init = np.random.default_rng(5).normal(0, 0.3, (8, 6, 7, 3)).astype(
        np.float32)
    jd, jl = jar.dense_adam_registration(jnp.asarray(fix), jnp.asarray(mov),
                                         iters=5, lambda_weight=0.1, lr=0.5,
                                         init_disp=jnp.asarray(init))
    d, losses = ar.dense_adam_registration(_t(fix), _t(mov), iters=5,
                                           lambda_weight=0.1, lr=0.5,
                                           init_disp=_t(init))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5)
    _close_to_max(d.numpy(), jd, 1e-4, "field")


@pytest.mark.parametrize("lo,hi", [((7, 9, 5), (15, 19, 11)),
                                   ((6, 6, 6), (13, 12, 13))])
def test_upsample_displacement_matches_jax(lo, hi):
    disp = np.random.default_rng(4).normal(size=(*lo, 3)).astype(np.float32)
    want = np.asarray(jar.upsample_displacement(jnp.asarray(disp), hi))
    got = ar.upsample_displacement(_t(disp), hi).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_register_images_end_to_end_matches_jax():
    """The JAX test's 24^3 case: fixed = moving warped by a sinusoid. The
    field starts at zero, where every sampling position sits on a kink of
    the trilinear interpolation: the one-sided derivative there follows the
    last bit of the voxel coordinate, which XLA's fused arithmetic rounds
    otherwise than eager torch (and eager JAX, which equals the port) at
    242 of 336 positions of a 8x6x7 grid. Adam's first steps, of size lr
    whatever the gradient's size, then go different ways at those voxels,
    so the fields are held by their outcome: the final loss within rtol
    1e-3 (reading 1.4e-4) and the warped image's squared error within 2 %
    of JAX's (reading 0.5 %), both far below the start."""
    shape = (24, 24, 24)
    moving = _smooth_image(shape, seed=2) * 500.0
    disp_gt = _gt_disp_norm(shape, amp=0.05)
    fixed = np.asarray(jar.warp_volume(jnp.asarray(moving),
                                       jnp.asarray(disp_gt)))
    mask = np.ones(shape, bool)
    lobes = (moving > 0).astype(np.int32)
    lobes_fix = np.asarray(jar.warp_volume(jnp.asarray(lobes, jnp.float32),
                                           jnp.asarray(disp_gt), "nearest"))
    want = jar.register_images(jnp.asarray(fixed), jnp.asarray(moving),
                               mask_fix=jnp.asarray(mask),
                               mask_mov=jnp.asarray(mask),
                               lobes_fix=jnp.asarray(lobes_fix),
                               lobes_mov=jnp.asarray(lobes), iters=60, lr=0.3)
    m = torch.from_numpy(mask)
    got = ar.register_images(_t(fixed), _t(moving), mask_fix=m, mask_mov=m,
                             lobes_fix=_t(lobes_fix),
                             lobes_mov=torch.from_numpy(lobes), iters=60,
                             lr=0.3)
    assert got["disp"].shape == (*shape, 3)
    assert got["warped"].shape == shape
    losses, jlosses = got["losses"].numpy(), np.asarray(want["losses"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses[-1], jlosses[-1], rtol=1e-3)
    err = np.mean((got["warped"].numpy() - fixed) ** 2)
    jerr = np.mean((np.asarray(want["warped"]) - fixed) ** 2)
    assert abs(err - jerr) <= 0.02 * jerr, (err, jerr)
    assert err < 0.7 * np.mean((moving - fixed) ** 2)


def test_warps_and_tre_match_jax():
    """At the end-to-end case's 24^3 (JAX's warps compiled once)."""
    shape = (24, 24, 24)
    img = _smooth_image(shape, seed=5)
    disp = _gt_disp_norm(shape, amp=0.1)
    np.testing.assert_allclose(
        ar.warp_volume(_t(img), _t(disp)).numpy(),
        np.asarray(jar.warp_volume(jnp.asarray(img), jnp.asarray(disp))),
        atol=1e-5)
    labels = (img > 0).astype(np.float32) + (img > 0.5)
    np.testing.assert_array_equal(
        ar.warp_volume(_t(labels), _t(disp), "nearest").numpy(),
        np.asarray(jar.warp_volume(jnp.asarray(labels), jnp.asarray(disp),
                                   "nearest")))
    rng = np.random.default_rng(6)
    lm_fix = rng.uniform(-0.6, 0.6, (20, 3)).astype(np.float32)
    lm_mov = (lm_fix + rng.normal(0, 0.05, lm_fix.shape)).astype(np.float32)
    jb, ja = jax.jit(jar.landmark_tre_mm, static_argnums=3)(
        jnp.asarray(lm_fix), jnp.asarray(lm_mov), jnp.asarray(disp),
        (0.7, 0.8, 1.5))
    b, a = ar.landmark_tre_mm(_t(lm_fix), _t(lm_mov), _t(disp),
                              (0.7, 0.8, 1.5))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-5)


def test_entry_companion_and_missing_mask(tmp_path):
    assert entry._companion("/data/imgs/case_img_fixed.nii.gz", "lobes") == \
        "/data/imgs/case_lobes_fixed.nii.gz"
    with pytest.raises(FileNotFoundError):
        entry._require(str(tmp_path / "nope.nii.gz"), "fixed mask")
    assert entry._maybe(str(tmp_path / "nope.nii.gz")) is None


def test_entry_writes_its_outputs(tmp_path):
    """main() on the CPU: the warped NIfTI, the disp/disp_lo npz and TRE,
    with the label companions found by name."""
    from fissure_segmentation_tpu_torch.utils.nifti import (load_nifti,
                                                            save_nifti)
    shape = (16, 16, 16)
    moving = torch.nn.functional.interpolate(
        torch.randn((1, 1, 4, 4, 4), generator=torch.Generator().manual_seed(
            7)), size=shape, mode="trilinear")[0, 0] * 500.0
    grid = ar._identity_grid_xyz(shape)
    fixed = ar.warp_volume(moving, 0.05 * torch.sin(grid * 4.7)).numpy()
    moving = moving.numpy()
    lobes = (moving > 0).astype(np.uint8)
    for name, arr in (("case_img_fix.nii.gz", fixed),
                      ("case_img_mov.nii.gz", moving),
                      ("case_lobes_fix.nii.gz", lobes),
                      ("case_lobes_mov.nii.gz", lobes),
                      ("mask.nii.gz", np.ones(shape, np.uint8))):
        save_nifti(str(tmp_path / name), arr)
    lm = np.random.default_rng(8).uniform(-0.5, 0.5, (10, 3))
    np.savez(tmp_path / "lms.npz", lm_fix=lm, lm_mov=lm + 0.01)
    argv = ["-F", str(tmp_path / "case_img_fix.nii.gz"),
            "-M", str(tmp_path / "case_img_mov.nii.gz"),
            "-f", str(tmp_path / "mask.nii.gz"),
            "-m", str(tmp_path / "mask.nii.gz"),
            "-w", str(tmp_path / "warped.nii.gz"),
            "-d", str(tmp_path / "disp.npz"),
            "-l", str(tmp_path / "lms.npz"), "--iters", "3"]
    res = entry.main(argv, device="cpu")
    assert load_nifti(str(tmp_path / "warped.nii.gz")).array.shape == shape
    with np.load(tmp_path / "disp.npz") as z:
        assert z["disp"].shape == (*shape, 3)
        assert z["disp_lo"].shape == (8, 8, 8, 3)
        np.testing.assert_array_equal(z["disp"], res["disp"].numpy())
    assert len(res["tre"]) == 2 and all(np.isfinite(res["tre"]))
