"""The CNN's data path against the JAX package on the CPU: resampling
(antialiased downsampling, upsampling, JAX's nearest index), the
label morphology, `map_coordinates` with mode "nearest" (order 1 and
order 0 at half-integer coordinates), the elastic field, the whole
augmentation with JAX's draws injected, the preprocessing of
ImageDataset (dilation, remapping, normalization), its class weights,
split, folder index and crops.

Tolerances, each with its reading: images after a resample, an order-1
warp or the elastic upsampling within 1e-5 (read 4.8e-7 for the
resample, 6.9e-6 for the warp of unit-variance patches, 1.7e-6 for the
upsampling against F.interpolate, 1.4e-6 for the elastic field: float32
products and sums in another order, and XLA folding divisions by
constants into reciprocals); labels, indices, crops, class weights and
splits equal, but for labels warped from a coordinate within 1e-4 of a
half-integer (order 0 rounds there, and the two frameworks' coordinates
differ in the last bits: read 1 of 46 080 voxels).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fissure_segmentation_tpu.data import image_dataset as J
from fissure_segmentation_tpu.data.synthetic import make_synthetic_image_case
from fissure_segmentation_tpu.utils import image_ops as JO
from fissure_segmentation_tpu_torch.data import image_dataset as T
from fissure_segmentation_tpu_torch.utils import image_ops as TO
from fissure_segmentation_tpu_torch.utils.nifti import save_nifti

IMG_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's tests: the suite runs six
    workers on the machine's cores, where torch's default of a thread a
    core makes them spin against each other (this file's fixtures took
    minutes there instead of seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("spacing,target", [
    ((1.0, 1.0, 1.0), 1.5),       # the synthetic case's downsampling
    ((0.7, 0.8, 1.25), 1.0),      # mixed: two axes down, one up
    ((1.0, 1.0, 1.0), 0.6),       # upsampling
])
def test_resample_equal_spacing_matches_jax(spacing, target):
    rng = np.random.default_rng(0)
    img = rng.normal(0, 1, (20, 23, 17)).astype(np.float32)
    lbl = rng.integers(0, 4, img.shape).astype(np.int32)
    want = np.asarray(JO.resample_equal_spacing(jnp.asarray(img), spacing,
                                                target))
    got = TO.resample_equal_spacing(_t(img), spacing, target).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)
    want = np.asarray(JO.resample_equal_spacing(
        jnp.asarray(lbl), spacing, target, use_nearest_neighbor=True))
    got = TO.resample_equal_spacing(_t(lbl), spacing, target,
                                    use_nearest_neighbor=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_resize_nearest_index_and_linear_upsampling():
    """JAX's compiled nearest index (20 -> 25: XLA's folded 0.79999995
    sends output 2 to input 1) and the linear upsampling of the elastic
    field against F.interpolate(align_corners=False), edges included."""
    x = jnp.arange(20, dtype=jnp.int32)
    for n_out in (25, 7, 43, 64):
        np.testing.assert_array_equal(
            TO.nearest_indices(20, n_out),
            np.asarray(jax.image.resize(x, (n_out,), "nearest")))
    assert TO.nearest_indices(20, 25)[2] == 1
    noise = torch.randn((2, 3, 5, 4, 6), generator=torch.Generator()
                        .manual_seed(0))
    got = TO.resize(noise, (48, 40, 64), "linear")
    want = F.interpolate(noise, size=(48, 40, 64), mode="trilinear",
                         align_corners=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=IMG_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.image.resize(
        jnp.asarray(noise.numpy()), (2, 3, 48, 40, 64), "linear")),
        rtol=0, atol=IMG_ATOL)


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("mode", ["dilate", "erode"])
def test_multiple_objects_morphology_matches_jax(radius, mode):
    lbl = np.zeros((16, 18, 14), np.int32)
    lbl[3:9, 2:12, 2:10] = 1          # thick enough to survive erosion
    lbl[6:8, :, :] = 2                # sheets meeting object 1
    lbl[11:16, 10:17, 4:13] = 3
    want = np.asarray(JO.multiple_objects_morphology(jnp.asarray(lbl),
                                                     radius, mode))
    got = TO.multiple_objects_morphology(_t(lbl), radius, mode).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).any()


def test_map_coordinates_matches_jax_at_half_integers():
    """Order 0 rounds half away from zero (2.5 -> 3, -0.5 -> -1 -> clamped
    0), order 1 weights by the unclamped coordinate; both clamp indices
    (mode "nearest")."""
    rng = np.random.default_rng(1)
    vol = rng.normal(0, 1, (6, 7, 8)).astype(np.float32)
    halves = np.stack(np.meshgrid(np.arange(-1.5, 7.0, 0.5),
                                  np.arange(-0.5, 8.0, 1.0),
                                  np.arange(0.5, 9.0, 0.5), indexing="ij"),
                      -1).astype(np.float32)
    generic = rng.uniform(-2, 9, (5, 9, 11, 3)).astype(np.float32)
    for coords in (halves, generic):
        for order in (0, 1):
            want = np.asarray(jax.scipy.ndimage.map_coordinates(
                jnp.asarray(vol), list(jnp.moveaxis(jnp.asarray(coords), -1,
                                                    0)),
                order=order, mode="nearest"))
            got = T.map_coordinates(_t(vol)[None], _t(coords)[None],
                                    order)[0].numpy()
            if order == 0:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # torch.round would send these ties to even
    c = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 3.49999976])
    assert T._round_half_away(c).tolist() == [1, 2, 3, -1, -2, 3]


def jax_draws(key, b, shape):
    """`augment_image_batch`'s draws of the JAX package for key `key`,
    taken with its own splits (its vmapped `_warp_coords` draws the axis
    and the angle from one key)."""
    r_warp, r_gate, r_mirror, r_noise, r_alpha = jax.random.split(key, 5)
    per = [jax.random.split(k, 3) for k in jax.random.split(r_warp, b)]
    grid = T.elastic_grid(shape)
    d = {"alpha": jax.random.uniform(r_alpha, (b,)),
         "gate": jax.random.uniform(r_gate, (b,)),
         "rot_axis": jnp.stack([jax.random.uniform(p[0], (3,)) for p in per]),
         "rot_angle": jnp.stack([jax.random.uniform(p[0], ()) for p in per]),
         "scale": jnp.stack([jax.random.uniform(p[1], ()) for p in per]),
         "elastic": jnp.stack([jax.random.normal(p[2], (3, *grid))
                               for p in per]),
         "flip": jax.random.uniform(r_mirror, (b, 3)),
         "noise": jax.random.normal(r_noise, (b, *shape))}
    assert {k: v.shape for k, v in d.items()} == {
        k: v.shape for k, v in T.draw_augmentation(None, (b, *shape)).items()}
    return {k: _t(v) for k, v in d.items()}


@pytest.mark.parametrize("elastic", [(0.0, 1000.0), None])
def test_augment_image_batch_matches_jax_with_its_draws(elastic):
    rng = np.random.default_rng(2)
    b, shape = 6, (16, 20, 24)
    imgs = rng.normal(0, 1, (b, *shape)).astype(np.float32)
    lbls = rng.integers(0, 4, (b, *shape)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    with jax.default_matmul_precision("float32"):
        want_i, want_l = jax.jit(lambda k, x, y: J.augment_image_batch(
            k, x, y, p_rotscale=0.5, elastic_alpha=elastic))(
                key, jnp.asarray(imgs), jnp.asarray(lbls))
    draws = jax_draws(key, b, shape)
    assert 0 < (draws["gate"] < 0.5).sum() < b   # warped and kept samples
    got_i, got_l = T.augment_image_batch(None, _t(imgs), _t(lbls),
                                         p_rotscale=0.5,
                                         elastic_alpha=elastic, draws=draws)
    assert got_l.dtype == torch.int32
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0,
                               atol=IMG_ATOL)
    # labels equal but where a warped coordinate lies within float32
    # rounding of a half-integer (the frameworks' coordinates differ in
    # the last bits, and order 0 rounds there)
    differ = torch.from_numpy(got_l.numpy() != np.asarray(want_l))
    flips = draws["flip"] < 0.5
    for ax in range(3):            # back to the warped voxel (before flips)
        f = flips[:, ax, None, None, None]
        differ = torch.where(f, torch.flip(differ, (ax + 1,)), differ)
    alphas = draws["alpha"] * 1000.0 if elastic else None
    coords = T._warp_coords(draws, shape, elastic_alpha=alphas)
    tie = ((coords - torch.floor(coords) - 0.5).abs() < 1e-4).any(-1)
    assert not (differ & ~tie).any()
    assert differ.sum() <= 2


def test_elastic_field_matches_jax():
    shape, alpha = (24, 30, 36), 700.0
    key = jax.random.PRNGKey(5)
    want = np.asarray(J.elastic_displacement_field(key, shape, alpha))
    noise = _t(jax.random.normal(key, (3, *T.elastic_grid(shape))))[None]
    got = T.elastic_displacement_field(noise, shape, torch.tensor([alpha]))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=IMG_ATOL)


def test_augmentation_draws_from_a_generator():
    imgs = torch.zeros((2, 8, 8, 8))
    lbls = torch.zeros((2, 8, 8, 8), dtype=torch.int32)
    a = T.augment_image_batch(torch.Generator().manual_seed(0), imgs, lbls)
    b = T.augment_image_batch(torch.Generator().manual_seed(0), imgs, lbls)
    assert torch.equal(a[0], b[0]) and a[0].std() > 0


@pytest.mark.parametrize("kw", [dict(), dict(binary=True),
                                dict(exclude_rhf=True)])
def test_image_dataset_preprocessing_matches_jax(kw):
    """Spacing 0.5 mm to 1.0: labels dilated by radius 1, then both
    resampled; a 1.0 mm case downsampled to 1.5 (radius 0)."""
    cases = [make_synthetic_image_case(i, shape=(24, 26, 22))
             for i in range(3)]
    imgs = [c["image"] * 2000 - 800 for c in cases]   # about HU
    lbls = [c["labels"] for c in cases]
    ids = [(c["case_id"], c["sequence"]) for c in cases]
    spacings = [(0.5, 0.6, 0.5), (1.0, 1.0, 1.0), (0.7, 0.8, 0.9)]
    for target in (1.0, 1.5):
        args = dict(resample_spacing=target, patch_size=(8, 8, 8), **kw)
        want = J.ImageDataset(imgs, lbls, ids, spacings, **args)
        got = T.ImageDataset(imgs, lbls, ids, spacings, **args)
        assert got.num_classes == want.num_classes
        np.testing.assert_array_equal(got.get_class_weights(),
                                      want.get_class_weights())
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.dtype == np.float32 and gl.dtype == np.int32
            np.testing.assert_allclose(gi, wi, rtol=0, atol=IMG_ATOL)
            np.testing.assert_array_equal(gl, wl)


def test_split_and_crops_match_jax():
    cases = [make_synthetic_image_case(i, shape=(12, 14, 10))
             for i in range(5)]
    args = ([c["image"] for c in cases], [c["labels"] for c in cases],
            [(c["case_id"], c["sequence"]) for c in cases])
    want = J.ImageDataset(*args, patch_size=(8, 16, 8),
                          resample_spacing=1.0)
    got = T.ImageDataset(*args, patch_size=(8, 16, 8), resample_spacing=1.0)
    split = {"train": [list(i) for i in args[2][:3]],
             "val": [args[2][3][0], list(args[2][4])]}
    for g, w in zip(got.split_data_set(split), want.split_data_set(split)):
        assert g.ids == w.ids and g.do_augmentation == w.do_augmentation
        for (gi, gl), (wi, wl) in zip(g, w):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    # crops (H padded: 14 < 16) from the same numpy stream, no augmentation
    got.do_augmentation = want.do_augmentation = False
    gi, gl = got.sample_batch(np.random.default_rng(4), None, [0, 3, 3, 1])
    wi, wl = want.sample_batch(np.random.default_rng(4), None, [0, 3, 3, 1])
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


def test_lung_data_index_and_from_folder_match_jax(tmp_path):
    cases = [make_synthetic_image_case(i, shape=(16, 18, 14))
             for i in range(3)]
    for c in cases[:2]:
        cid, seq = c["case_id"], c["sequence"]
        save_nifti(str(tmp_path / f"{cid}_img_{seq}.nii.gz"),
                   c["image"] * 2000 - 800, spacing=(0.8, 0.9, 1.0))
        save_nifti(str(tmp_path / f"{cid}_fissures_{seq}.nii.gz"),
                   c["labels"], spacing=(0.8, 0.9, 1.0))
    c = cases[2]                   # no fissures: indexed, not loaded
    save_nifti(str(tmp_path / f"{c['case_id']}_img_{c['sequence']}.nii.gz"),
               c["image"])
    os.makedirs(tmp_path / f"{c['case_id']}_mesh_{c['sequence']}")
    got, want = T.LungDataIndex(str(tmp_path)), J.LungDataIndex(str(tmp_path))
    for field in ("images", "ids", "fissures", "lobes", "lung_masks",
                  "landmarks", "fissure_meshes"):
        assert getattr(got, field) == getattr(want, field), field
    kw = dict(resample_spacing=1.2, patch_size=(8, 8, 8))
    g = T.ImageDataset.from_folder(str(tmp_path), **kw)
    w = J.ImageDataset.from_folder(str(tmp_path), **kw)
    assert len(g) == len(w) == 2 and g.ids == w.ids
    for (gi, gl), (wi, wl) in zip(g, w):
        np.testing.assert_allclose(gi, wi, rtol=0, atol=IMG_ATOL)
        np.testing.assert_array_equal(gl, wl)
