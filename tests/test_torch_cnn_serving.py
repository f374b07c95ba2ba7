"""Port parity for the CNN and enhancement keypoint modes of serving: the
keypoint functions and the Hessian detector, then segment_case in
kp_mode="cnn" (on a softmax volume and with the pre-segmentation CNN) and
kp_mode="enhancement", each against the JAX package on the same numpy
inputs on the CPU.

jax.random cannot be replayed in torch, so the JAX draws are injected into
the port: the cnn mode's uniform scores (`jax.random.uniform(fold_in(key,
1), (D * H * W,))`, as the JAX serving draws them) through `kp_scores`, the
ensemble subsets through `subsets`. The point model and its coordinate-keyed
class bias are tests/test_torch_serving.py's; meshes are compared
functionally, within max(8, 5 %) triangles, as that file says why.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.keypoints import extraction as jext
from fissure_segmentation_tpu.keypoints import hessian as jhes
from fissure_segmentation_tpu.models import DGCNNSeg as JDGCNNSeg
from fissure_segmentation_tpu.models import seg_cnn as jseg
from fissure_segmentation_tpu.models.ensemble import build_subsets
from fissure_segmentation_tpu.serving import segment_case as jsegment_case
from fissure_segmentation_tpu.utils import filters as jfilt
from fissure_segmentation_tpu_torch.keypoints import extraction, hessian
from fissure_segmentation_tpu_torch.models import (DGCNNSeg, MobileNetASPP,
                                                   load_jax_variables)
from fissure_segmentation_tpu_torch.serving import segment_case
from fissure_segmentation_tpu_torch.utils import filters

SHAPE = (48, 48, 48)
CFG = dict(max_kpts=2000, sample_points=128, n_runs_min=4, subset_batch=2,
           grid_res=(24, 24, 24), max_tris=24000)
KEY = jax.random.PRNGKey(7)


def _case():
    """tests/test_torch_serving.py's CT: a bright tilted sheet in noise; the
    lung mask leaves out the last 4 x slices."""
    rng = np.random.default_rng(0)
    img = rng.normal(-700, 80, SHAPE).astype(np.float32)
    zz, yy, _ = np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij")
    img[np.abs(zz - (20 + 0.2 * yy)) < 1.0] = -300.0
    mask = np.ones(SHAPE, bool)
    mask[..., -4:] = False
    return img, mask


def _band_class(g, lib):
    """Class of grid-coord points (..., 3) xyz: 1/2/3 by x third inside the
    band |z - (20 + 0.2 y)| < 3.1 voxels, else 0."""
    w = (g / (47 / 48) + 1) / 2 * 47                    # voxel xyz
    band = lib.abs(w[..., 2] - (20 + 0.2 * w[..., 1])) < 3.1
    third = 1 + 1 * (w[..., 0] >= 15.5) + 1 * (w[..., 0] >= 31.5)
    return lib.where(band, third, 0)


@pytest.fixture(scope="module")
def point_models():
    jm = JDGCNNSeg(k=8, in_features=3, num_classes=4, dynamic=False)
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 128, 3), jnp.float32), train=False)

    def japply(v, x, train=False):
        return jm.apply(v, x, train=train) + 50.0 * jax.nn.one_hot(
            _band_class(x, jnp), 4)

    tm = load_jax_variables(DGCNNSeg(k=8, in_features=3, num_classes=4,
                                     dynamic=False),
                            jax.tree_util.tree_map(np.asarray, variables))
    tm.eval()

    def tapply(x):
        return tm(x) + 50.0 * torch.nn.functional.one_hot(
            _band_class(x, torch), 4)
    subsets = torch.from_numpy(np.array(build_subsets(
        KEY, CFG["max_kpts"], CFG["sample_points"], CFG["n_runs_min"])))
    return japply, variables, tapply, subsets


def _cnn_draw(shape):
    return np.array(jax.random.uniform(jax.random.fold_in(KEY, 1),
                                       (int(np.prod(shape)),)))


def _assert_same_case(rj, rt, *, exact=True):
    """Keypoints and labels equal (`exact`), meshes and labelmaps within
    the functional tolerance."""
    if exact:
        np.testing.assert_array_equal(rt.kpts, rj.kpts)
        np.testing.assert_array_equal(rt.labels, rj.labels)
    assert {1, 2, 3} <= set(np.unique(rj.labels))
    for c, ((t1, v1), (t2, v2)) in enumerate(zip(rj.meshes, rt.meshes), 1):
        n1, n2 = int(v1.sum()), int(v2.sum())
        assert n1 > 0 and abs(n1 - n2) <= max(8, 0.05 * max(n1, n2)), (c, n1, n2)
        c1, c2 = t1[v1].mean(1), t2[v2].mean(1)
        d = np.linalg.norm(c1[:, None] - c2[None], axis=-1)
        assert max(np.median(d.min(1)), np.median(d.min(0))) < 0.3, c
        a, b = rj.labelmap == c, rt.labelmap == c
        assert 2 * (a & b).sum() / (a.sum() + b.sum()) >= 0.9, c


# ---- keypoint functions -----------------------------------------------------

def _softmax_volume(shape, seed):
    """A (D, H, W, 4) softmax whose foreground is the band around the sheet
    (by x third) plus scattered noise voxels."""
    rng = np.random.default_rng(seed)
    d, h, w = shape
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    band = np.abs(zz - (20 + 0.2 * yy)) < 1.5
    cls = np.where(band, 1 + (xx >= w / 3) + (xx >= 2 * w / 3), 0)
    logits = rng.normal(0, 1, (d, h, w, 4)).astype(np.float32)
    logits += 4.0 * np.eye(4, dtype=np.float32)[cls]
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("max_kpts", [500, 30000])
def test_cnn_keypoints_match_jax(max_kpts):
    """With the JAX draw injected the keypoints and validity are equal, both
    when the foreground exceeds max_kpts (a random subset) and when it does
    not (every foreground voxel, the rest invalid)."""
    shape = (32, 36, 40)
    soft = _softmax_volume(shape, 1)
    mask = np.ones(shape, bool)
    mask[:, :4] = False
    key = jax.random.PRNGKey(3)
    kj, vj, _ = jext.get_cnn_keypoints(jnp.asarray(soft), jnp.asarray(mask),
                                       max_kpts=max_kpts, rng=key,
                                       want_features=False)
    draw = torch.from_numpy(np.array(jax.random.uniform(
        key, (int(np.prod(shape)),))))
    kt, vt, feats = extraction.get_cnn_keypoints(
        torch.from_numpy(soft), torch.from_numpy(mask), max_kpts=max_kpts,
        scores=draw)
    assert feats is None and kt.dtype == torch.int32
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(kt.numpy()[vt.numpy()],
                                  np.asarray(kj)[np.asarray(vj)])
    fg = int(((soft.argmax(-1) != 0) & mask).sum())
    assert int(vt.sum()) == min(fg, max_kpts)
    # the 5^3 softmax patches, equal to JAX's (a gather, no arithmetic
    # but the grid coordinates, which round alike)
    _, _, fj = jext.get_cnn_keypoints(jnp.asarray(soft), jnp.asarray(mask),
                                      max_kpts=max_kpts, rng=key)
    _, _, ft = extraction.get_cnn_keypoints(
        torch.from_numpy(soft), torch.from_numpy(mask), max_kpts=max_kpts,
        scores=draw, want_features=True)
    assert ft.shape == (max_kpts, 125 * soft.shape[-1])
    np.testing.assert_array_equal(ft.numpy()[vt.numpy()],
                                  np.asarray(fj)[np.asarray(vj)])


def test_random_cap_matches_jax():
    rng = np.random.default_rng(5)
    kp = rng.integers(0, 50, (900, 3)).astype(np.int32)
    valid = rng.random(900) < 0.7
    key = jax.random.PRNGKey(11)
    kj, vj = jext._random_cap(key, jnp.asarray(kp), jnp.asarray(valid), 400)
    draw = torch.from_numpy(np.array(jax.random.uniform(key, (900,))))
    kt, vt = extraction._random_cap(torch.from_numpy(kp),
                                    torch.from_numpy(valid), 400, scores=draw)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    # a generator's draw gives a subset of the valid rows of the same size
    kg, vg = extraction._random_cap(torch.from_numpy(kp),
                                    torch.from_numpy(valid), 400,
                                    generator=torch.Generator().manual_seed(0))
    assert int(vg.sum()) == 400
    rows = {tuple(r) for r in kp[valid]}
    assert {tuple(r) for r in kg.numpy()} <= rows


@pytest.mark.parametrize("sigma", [0.5, 1.0, 1.7])
def test_gaussian_kernels_equal(sigma):
    """The host-side kernels are copies: equal bit for bit, every order."""
    for order in (0, 1, 2):
        np.testing.assert_array_equal(
            filters.gaussian_kernel_1d(sigma, order),
            np.asarray(jfilt.gaussian_kernel_1d(sigma, order)))
    x = np.random.default_rng(6).normal(0, 1, (9, 10, 11)).astype(np.float32)
    for dim in range(3):
        np.testing.assert_allclose(
            filters.gaussian_differentiation(torch.from_numpy(x), sigma, 2,
                                             dim).numpy(),
            np.asarray(jfilt.gaussian_differentiation(jnp.asarray(x), sigma,
                                                      2, dim)),
            rtol=0, atol=1e-6)


def test_hessian_enhancement_matches_jax():
    """Tolerance: the filters sum in the same tap order (float32 rounding,
    about 1e-7 relative on HU-scale sums), but arccos near r = +-1 and the
    plateness ratio where |l1| + |l2| is small amplify that; the enhanced
    values lie in [0, 1] and agree to 1e-4 absolute, the components of the
    Hessian to 1e-6 of their scale."""
    img, _ = _case()
    img = img[:24, :28, :32]
    hj = jhes.hessian_components(jnp.asarray(img))
    ht = hessian.hessian_components(torch.from_numpy(img))
    for a, b in zip(ht, hj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())
    want = np.asarray(jhes.hessian_fissure_enhancement(
        jnp.asarray(img), fissure_mu=-313.5, fissure_sigma=62.6))
    got = hessian.hessian_fissure_enhancement(torch.from_numpy(img),
                                              fissure_mu=-313.5,
                                              fissure_sigma=62.6).numpy()
    assert got.shape == img.shape and want.max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # _top2_by_abs on ties and signs
    e = [torch.tensor([3.0, -2.0, 1.0, -1.0]), torch.tensor([-3.0, 2.0, -5.0, 1.0]),
         torch.tensor([1.0, -4.0, 5.0, 0.5])]
    for a, b in zip(hessian._top2_by_abs(*e),
                    jhes._top2_by_abs(*[jnp.asarray(v.numpy()) for v in e])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("max_kpts", [300, 20000])
def test_enhancement_keypoints_match_jax(max_kpts):
    """The same enhancement volume (JAX's) through both: thresholded before
    the top-k, equal keypoints and validity."""
    img, _ = _case()
    enh = np.array(jhes.hessian_fissure_enhancement(
        jnp.asarray(img), fissure_mu=-313.5, fissure_sigma=62.6))
    kj, vj = jext.get_enhancement_keypoints(jnp.asarray(enh),
                                            max_kpts=max_kpts)
    kt, vt = extraction.get_enhancement_keypoints(torch.from_numpy(enh),
                                                  max_kpts=max_kpts)
    vj = np.asarray(vj)
    assert 0 < vj.sum() and (max_kpts > vj.sum()) == (max_kpts == 20000)
    np.testing.assert_array_equal(vt.numpy(), vj)
    np.testing.assert_array_equal(kt.numpy()[vj], np.asarray(kj)[vj])


# ---- segment_case ------------------------------------------------------------

def test_segment_case_cnn_softmax_matches_jax(point_models):
    """kp_mode="cnn" on a given (D, H, W, C) softmax volume: the case's
    shape is the volume's first three axes."""
    japply, variables, tapply, subsets = point_models
    soft = _softmax_volume(SHAPE, 2)
    _, mask = _case()
    with jax.default_matmul_precision("float32"):
        rj = jsegment_case(soft, mask, japply, variables, KEY,
                           kp_mode="cnn", center_x=SHAPE[2] / 2, **CFG)
    rt = segment_case(soft, mask, tapply, subsets=subsets, kp_mode="cnn",
                      kp_scores=torch.from_numpy(_cnn_draw(SHAPE)),
                      center_x=SHAPE[2] / 2, device="cpu", **CFG)
    assert rt.labelmap.shape == SHAPE
    _assert_same_case(rj, rt)


def test_segment_case_cnn_model_matches_jax(point_models):
    """kp_mode="cnn" with the pre-segmentation CNN run on the CT inside the
    case: the port's MobileNetASPP loaded from the JAX tree."""
    japply, variables, tapply, subsets = point_models
    img, mask = _case()
    vol = (img + 700.0) / 200.0     # the CNN's input scale
    cm = jseg.MobileNetASPP(num_classes=4)
    cvars = jax.jit(lambda k, x: cm.init(k, x, train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 16, 1), jnp.float32))
    cvars = jax.tree_util.tree_map(np.asarray, dict(cvars))
    tcnn = load_jax_variables(MobileNetASPP(num_classes=4), cvars)

    def capply(v, x, train=False):
        return cm.apply(v, x, train=train)

    with jax.default_matmul_precision("float32"):
        rj = jsegment_case(vol, mask, japply, variables, KEY, kp_mode="cnn",
                           cnn_apply_fn=capply, cnn_variables=cvars,
                           center_x=SHAPE[2] / 2, **CFG)
    rt = segment_case(vol, mask, tapply, subsets=subsets, kp_mode="cnn",
                      cnn_model=tcnn,
                      kp_scores=torch.from_numpy(_cnn_draw(SHAPE)),
                      center_x=SHAPE[2] / 2, device="cpu", **CFG)
    _assert_same_case(rj, rt)
    with pytest.raises(NotImplementedError, match="float32 only"):
        segment_case(vol, mask, tapply, subsets=subsets, kp_mode="cnn",
                     cnn_model=tcnn, cnn_dtype=torch.bfloat16, device="cpu",
                     **CFG)


def test_segment_case_enhancement_matches_jax(point_models):
    """kp_mode="enhancement": the detector's values differ from JAX's in
    float32 rounding only (test_hessian_enhancement_matches_jax), which
    can reorder near-equal scores at the top-k cut, so at least 99 % of the
    keypoints are shared; the meshes agree functionally."""
    japply, variables, tapply, subsets = point_models
    img, mask = _case()
    with jax.default_matmul_precision("float32"):
        rj = jsegment_case(img, mask, japply, variables, KEY,
                           kp_mode="enhancement", center_x=SHAPE[2] / 2,
                           **CFG)
    rt = segment_case(img, mask, tapply, subsets=subsets,
                      kp_mode="enhancement", center_x=SHAPE[2] / 2,
                      device="cpu", **CFG)
    a = dict(zip(map(tuple, rj.kpts), rj.labels))
    b = dict(zip(map(tuple, rt.kpts), rt.labels))
    shared = a.keys() & b.keys()
    assert len(a) > 100 and len(shared) >= 0.99 * max(len(a), len(b))
    assert all(a[k] == b[k] for k in shared)
    _assert_same_case(rj, rt, exact=False)
