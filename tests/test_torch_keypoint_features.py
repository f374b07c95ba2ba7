"""Port parity for the keypoint front end of preprocessing: utils/sampling.py,
keypoints/features.py (MIND, MIND-SSC, the patch features),
keypoints/foerstner.py's random subset, keypoints/extraction.py
(get_noisy_keypoints, the cnn mode's softmax patches, compute_keypoints in
all four modes), the cnn mode's bfloat16 CNN from weights converted by
models/weights.py, and keypoints/enhancement_eval.py, each against the JAX
package on the same numpy-seeded inputs at 32^3, with JAX's random draws
injected (jax.random cannot be replayed in torch).

Tolerances, each where it is used:
  * nearest sampling, the descriptor lookup, the keypoints, labels, lobes
    and the softmax patches: equal;
  * the patch offsets within 1e-7 and trilinear sampling within 1e-5
    (readings 3.0e-8 and 2.7e-6): XLA computes the same float32 formula
    with the last bit rounded otherwise here and there;
  * MIND and MIND-SSC: within FEAT_TOL of the largest entry. The
    smoothing and the variance are float32 sums that XLA and torch order
    differently (reading 1.6e-6). Besides, in a process that has loaded
    JAX, torch's CPU exp sometimes returns up to 1.5e-4 relative from the
    float64 exp on the last thread's share of a tensor (3 of 12 runs of
    one script here; never without JAX, and JAX's own stays within
    6e-8), so the limit is 5e-4;
  * the 'image' and 'enhancement' patch features: equal (a gather, then
    the same normalization);
  * the bfloat16 CNN's softmax: within CNN_BF16_TOL absolute of JAX's
    bfloat16 softmax and of the port's float32 one (readings 1.1e-4 and
    1.3e-4): XLA's CPU compiler computes bfloat16 elementwise chains in
    float32 and rounds at fusion ends, torch rounds every operation;
  * ROC-AUC and average precision: within 1e-12 of scikit-learn's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.keypoints import enhancement_eval as jenh
from fissure_segmentation_tpu.keypoints import extraction as jext
from fissure_segmentation_tpu.keypoints import features as jfeat
from fissure_segmentation_tpu.keypoints import foerstner as jfoer
from fissure_segmentation_tpu.keypoints import hessian as jhes
from fissure_segmentation_tpu.models import seg_cnn as jseg
from fissure_segmentation_tpu.utils import sampling as jsamp
from fissure_segmentation_tpu_torch.keypoints import (enhancement_eval,
                                                      extraction, features,
                                                      foerstner)
from fissure_segmentation_tpu_torch.models import (MobileNetASPP,
                                                   load_jax_variables)
from fissure_segmentation_tpu_torch.models.seg_cnn import predict_full_volume
from fissure_segmentation_tpu_torch.utils import sampling

SHAPE = (32, 32, 32)
FEAT_TOL = 5e-4
CNN_BF16_TOL = 1e-3
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ct():
    """A noisy CT with two bright tilted sheets, fissure labels on the
    sheets, lobes between them and a lung mask that leaves out a border."""
    rng = np.random.default_rng(0)
    img = rng.normal(-700, 80, SHAPE).astype(np.float32)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij")
    fis = np.zeros(SHAPE, np.int32)
    for lbl, z0 in ((1, 10), (2, 21)):
        on = np.abs(zz - (z0 + 0.2 * yy)) < 1.0
        img[on] = -300.0
        fis[on & (xx >= 4 * lbl)] = lbl
    lobes = 1 + (zz > 10 + 0.2 * yy) + (zz > 21 + 0.2 * yy)
    mask = np.ones(SHAPE, bool)
    mask[..., -3:] = False
    return {"img": img, "fis": fis, "lobes": lobes.astype(np.int32),
            "mask": mask}


# ---- sampling ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_grid_sample_volume_matches_jax(mode, padding):
    rng = np.random.default_rng(1)
    vol = rng.normal(size=(2, 9, 10, 11)).astype(np.float32)
    # random points (a point within an ulp of a half voxel is decided by
    # the last bit of the coordinate transform, which the jitted JAX
    # function may compute in another order: not compared)
    coords = rng.uniform(-1.2, 1.2, (40, 7, 3)).astype(np.float32)
    got = sampling.grid_sample_volume(_t(vol), _t(coords), mode, padding)
    want = jsamp.grid_sample_volume(jnp.asarray(vol), jnp.asarray(coords),
                                    mode=mode, padding_mode=padding)
    assert got.shape == (2, 40, 7)
    if mode == "nearest":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("patch", [4, 5])
def test_patch_sampling_matches_jax(patch):
    rng = np.random.default_rng(2)
    vol = rng.normal(size=(12, 13, 14)).astype(np.float32)
    kpts = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    np.testing.assert_allclose(
        sampling.patch_grid_offsets(patch, vol.shape).numpy(),
        np.asarray(jsamp.patch_grid_offsets(patch, vol.shape)), rtol=0,
        atol=1e-7)
    got = sampling.sample_patches_at_kpts(_t(vol), _t(kpts), patch)
    want = jsamp.sample_patches_at_kpts(jnp.asarray(vol), jnp.asarray(kpts),
                                        patch)
    assert got.shape == (30, patch, patch, patch)
    if patch % 2:        # nearest
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# ---- features ---------------------------------------------------------------

@pytest.mark.parametrize("ssc", [True, False])
def test_mind_matches_jax(ct, ssc):
    img = ct["img"]
    got = features.mind(_t(img), ssc=ssc).numpy()
    want = np.asarray(jfeat.mind(jnp.asarray(img), ssc=ssc))
    assert got.shape == want.shape == ((12 if ssc else 6), *SHAPE)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= FEAT_TOL, err
    i1, i2 = features._ssc_pairs()
    j1, j2 = jfeat._ssc_pairs()
    np.testing.assert_array_equal(i1, j1)
    np.testing.assert_array_equal(i2, j2)


@pytest.mark.parametrize("mode", ["mind", "mind_ssc", "image", "enhancement"])
def test_compute_point_features_matches_jax(ct, mode):
    rng = np.random.default_rng(3)
    kpts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    enh = np.asarray(jhes.hessian_fissure_enhancement(
        jnp.asarray(ct["img"]), fissure_mu=-313.5, fissure_sigma=62.6))
    got = features.compute_point_features(
        _t(ct["img"]), _t(kpts), mode, enhanced_img=_t(enh)).numpy()
    want = np.asarray(jfeat.compute_point_features(
        jnp.asarray(ct["img"]), jnp.asarray(kpts), mode,
        enhanced_img=jnp.asarray(enh)))
    assert got.shape == want.shape == (200, {"mind": 6, "mind_ssc": 12}.get(
        mode, 125))
    if mode.startswith("mind"):
        assert np.abs(got - want).max() <= FEAT_TOL * np.abs(want).max()
        desc = features.mind(_t(ct["img"]), ssc=mode == "mind_ssc")
        np.testing.assert_array_equal(
            features.descriptor_at_keypoints(desc, _t(kpts)).numpy(),
            np.asarray(jfeat.descriptor_at_keypoints(jnp.asarray(desc.numpy()),
                                                     jnp.asarray(kpts))))
    else:
        np.testing.assert_array_equal(got, want)


# ---- keypoints --------------------------------------------------------------

def test_foerstner_random_subset_matches_jax(ct):
    """More detections than max_kpts: with JAX's uniform draw injected the
    random subset is JAX's."""
    img, mask = ct["img"], ct["mask"]
    kw = dict(sigma=0.5, d=5, thresh=1e-8, max_kpts=150)
    kj, vj, nj = jfoer.foerstner_keypoints(jnp.asarray(img),
                                           jnp.asarray(mask), rng=KEY, **kw)
    draw = _t(jax.random.uniform(KEY, SHAPE)).reshape(-1)
    kt, vt, nt = foerstner.foerstner_keypoints(_t(img), _t(mask),
                                               scores=draw, **kw)
    assert int(nj) > 150 and int(nt) == int(nj)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(kt.numpy()[vt.numpy()],
                                  np.asarray(kj)[np.asarray(vj)])


@pytest.mark.parametrize("max_kpts", [300, 30000])
def test_noisy_keypoints_match_jax(ct, max_kpts):
    fis = ct["fis"]
    kj, vj = jext.get_noisy_keypoints(KEY, jnp.asarray(fis), max_kpts)
    r1, r2 = jax.random.split(KEY)
    kt, vt = extraction.get_noisy_keypoints(
        _t(fis), max_kpts,
        scores=_t(jax.random.uniform(r1, (fis.size,))),
        noise=_t(jax.random.normal(r2, (max_kpts, 3))))
    assert kt.dtype == torch.int32
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(kt.numpy()[vt.numpy()],
                                  np.asarray(kj)[np.asarray(vj)])
    assert int(vt.sum()) == min(int((fis != 0).sum()), max_kpts)


def _jax_draws(kp_mode, shape, max_kpts):
    """The draws of JAX's compute_keypoints with PRNGKey(0)."""
    n = int(np.prod(shape))
    if kp_mode == "noisy":
        r1, r2 = jax.random.split(KEY)
        return {"scores": _t(jax.random.uniform(r1, (n,))),
                "noise": _t(jax.random.normal(r2, (max_kpts, 3)))}
    if kp_mode == "foerstner":
        return {"scores": _t(jax.random.uniform(KEY, shape)).reshape(-1)}
    return {"scores": _t(jax.random.uniform(KEY, (n,)))}


def _softmax(shape, seed=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1, (*shape, 4)).astype(np.float32)
    logits[..., 0] += 1.5
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kp_mode", ["foerstner", "noisy", "enhancement",
                                     "cnn"])
def test_compute_keypoints_matches_jax(ct, kp_mode):
    """Every mode with its draws injected; the labels dilated per object
    (radius 2), lobes read at the keypoints, and the features: the cnn
    mode's softmax patches, or MIND-SSC in the other modes."""
    max_kpts = 400
    enh = np.asarray(jhes.hessian_fissure_enhancement(
        jnp.asarray(ct["img"]), fissure_mu=-313.5, fissure_sigma=62.6))
    soft = _softmax(SHAPE)
    feature = None if kp_mode == "cnn" else "mind_ssc"
    kw = dict(kp_mode=kp_mode, lobes=ct["lobes"], max_kpts=max_kpts,
              feature_mode=feature, case_id="c", sequence="s")
    with jax.default_matmul_precision("float32"):
        want = jext.compute_keypoints(
            KEY, ct["img"], ct["fis"], ct["mask"], enhanced_img=enh,
            cnn_softmax=soft, **kw)
    got = extraction.compute_keypoints(
        ct["img"], ct["fis"], ct["mask"], enhanced_img=enh,
        cnn_softmax=soft, device="cpu",
        draws=_jax_draws(kp_mode, SHAPE, max_kpts), **kw)
    assert set(got) == set(want)
    assert len(got["coords"]) >= 100
    for key in ("coords", "labels", "lobes"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), key)
    assert got["labels"].dtype == np.int32
    assert got["coords"].dtype == np.float32
    assert {1, 2} <= set(np.unique(got["labels"]))
    for key in ("shape", "spacing", "case_id", "sequence", "kp_mode",
                "feature_mode"):
        assert got[key] == want[key], key
    f_t, f_j = got["features"], np.asarray(want["features"])
    assert f_t.dtype == np.float32 and f_t.shape == f_j.shape
    if kp_mode == "cnn":
        assert f_t.shape[1] == 125 * 4
        np.testing.assert_array_equal(f_t, f_j)
    else:
        assert np.abs(f_t - f_j).max() <= FEAT_TOL * np.abs(f_j).max()


def test_label_dilation_ties_go_to_the_lower_label(ct):
    """compute_keypoints' per-object dilation (utils/image_ops.py:
    multiple_objects_morphology) where two objects' dilations meet: the
    lower label, as JAX's argmax over the dilated channels gives."""
    from fissure_segmentation_tpu_torch.utils.image_ops import \
        multiple_objects_morphology
    fis = np.zeros(SHAPE, np.int32)
    fis[4, 4, 2], fis[4, 4, 6] = 2, 1      # dilations meet at x = 4
    kw = dict(kp_mode="noisy", max_kpts=125, dilate_labels=2)
    got = extraction.compute_keypoints(
        None, fis, ct["mask"], device="cpu",
        draws=_jax_draws("noisy", SHAPE, 125), **kw)
    want = jext.compute_keypoints(KEY, None, fis, ct["mask"], **kw)
    np.testing.assert_array_equal(got["labels"], np.asarray(want["labels"]))
    dil = multiple_objects_morphology(_t(fis), 2).numpy()
    assert dil[4, 4, 4] == 1 and dil[4, 4, 0] == 2 and dil[0, 0, 0] == 0


def test_cnn_mode_bf16_from_converted_weights(ct):
    """The cnn mode's CNN: a JAX MobileNetASPP tree converted by
    models/weights.py, run by both packages' predict_full_volume in
    bfloat16; its softmax within CNN_BF16_TOL of JAX's and in float32
    close to the bfloat16 one, and the keypoints of compute_keypoints
    equal from the same softmax."""
    cm = jseg.MobileNetASPP(num_classes=4)
    cvars = jax.jit(lambda k, x: cm.init(k, x, train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 16, 1), jnp.float32))
    cvars = jax.tree_util.tree_map(np.asarray, dict(cvars))
    tcnn = load_jax_variables(MobileNetASPP(num_classes=4), cvars)
    vol = (ct["img"] + 700.0) / 200.0

    def capply(v, x, train=False):
        return cm.apply(v, x, train=train)
    want = np.asarray(jseg.predict_full_volume(capply, cvars,
                                               jnp.asarray(vol),
                                               dtype=jnp.bfloat16))
    got = predict_full_volume(tcnn, _t(vol), dtype=torch.bfloat16).numpy()
    f32 = predict_full_volume(tcnn, _t(vol)).numpy()
    assert got.shape == want.shape == (*SHAPE, 4) and got.dtype == np.float32
    assert np.abs(got - want).max() <= CNN_BF16_TOL
    assert np.abs(got - f32).max() <= CNN_BF16_TOL
    assert next(tcnn.parameters()).dtype == torch.float32   # not cast
    kw = dict(kp_mode="cnn", max_kpts=500)
    kj = jext.compute_keypoints(KEY, None, ct["fis"], ct["mask"],
                                cnn_softmax=want, **kw)
    kt = extraction.compute_keypoints(None, ct["fis"], ct["mask"],
                                      cnn_softmax=want, device="cpu",
                                      draws=_jax_draws("cnn", SHAPE, 500),
                                      **kw)
    np.testing.assert_array_equal(kt["coords"], np.asarray(kj["coords"]))
    np.testing.assert_array_equal(kt["features"], np.asarray(kj["features"]))


# ---- the enhancement's evaluation -------------------------------------------

def test_enhancement_scores_match_sklearn_and_jax(ct, tmp_path):
    from sklearn.metrics import average_precision_score, roc_auc_score
    enh = np.asarray(jhes.hessian_fissure_enhancement(
        jnp.asarray(ct["img"]), fissure_mu=-313.5, fissure_sigma=62.6))
    rng = np.random.default_rng(5)
    # ties in the scores: a quantized copy
    for scores in (enh.ravel(), np.round(enh.ravel(), 2)):
        gt = ct["fis"].ravel() != 0
        assert abs(enhancement_eval.roc_auc(gt, scores)
                   - roc_auc_score(gt, scores)) <= 1e-12
        assert abs(enhancement_eval.average_precision(gt, scores)
                   - average_precision_score(gt, scores)) <= 1e-12
    noise = rng.random(SHAPE).astype(np.float32)
    got = enhancement_eval.fissure_candidates(enh + 0.01 * noise, ct["fis"],
                                              img_dir=str(tmp_path / "t"))
    want = jenh.fissure_candidates(enh + 0.01 * noise, ct["fis"],
                                   img_dir=str(tmp_path / "j"))
    for g, w in zip(got[:2], want[:2]):
        assert g.keys() == w.keys() == {1, 2, "all", "all_but_RHF"}
        for k in g:
            assert abs(g[k] - w[k]) <= 1e-12, k
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())
