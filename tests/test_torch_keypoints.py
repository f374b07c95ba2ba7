"""Port parity for the keypoint front end: separable filters, exact top-k,
the Förstner detector and the synthetic CT case, each against the JAX
package on the same numpy-seeded inputs on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.data.synthetic import \
    make_synthetic_image_case as jmake_case
from fissure_segmentation_tpu.keypoints.foerstner import \
    foerstner_keypoints as jfoerstner
from fissure_segmentation_tpu.ops.topk import masked_top_k as jmasked_top_k
from fissure_segmentation_tpu.utils import filters as jfilters
from fissure_segmentation_tpu_torch.data.synthetic import \
    make_synthetic_image_case
from fissure_segmentation_tpu_torch.keypoints.foerstner import \
    foerstner_keypoints
from fissure_segmentation_tpu_torch.ops.topk import masked_top_k
from fissure_segmentation_tpu_torch.utils import filters


def _vol(rng, shape=(12, 10, 14)):
    return rng.normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("dim", [0, 1, 2])
@pytest.mark.parametrize("mode", ["replicate", "constant"])
def test_filter_1d_bit_equal(dim, mode):
    """Same shifted-slice sum in tap order: tolerance 0."""
    x = _vol(np.random.default_rng(dim))
    w = np.array([0.1, -0.3, 0.5, 0.25, -0.05], np.float32)
    out_j = jfilters.filter_1d(jnp.asarray(x), jnp.asarray(w), dim, mode)
    out_t = filters.filter_1d(torch.from_numpy(x), w, dim, mode)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("sigma", [0.5, 1.4])
def test_smooth_bit_equal(sigma):
    x = _vol(np.random.default_rng(4))
    np.testing.assert_array_equal(
        filters.smooth(torch.from_numpy(x), sigma).numpy(),
        np.asarray(jfilters.smooth(jnp.asarray(x), sigma)))


@pytest.mark.parametrize("k", [4, 5, 9])
def test_max_pool_same_equal(k):
    x = _vol(np.random.default_rng(5))
    np.testing.assert_array_equal(
        filters.max_pool_same(torch.from_numpy(x), k).numpy(),
        np.asarray(jfilters.max_pool_same(jnp.asarray(x), k)))


def test_masked_top_k_planted_ties():
    """Finite slots equal lax.top_k's order: descending, lowest index first
    on ties — including ties that straddle the k-th slot."""
    rng = np.random.default_rng(6)
    s = rng.integers(0, 20, 50000).astype(np.float32)
    s[rng.random(50000) < 0.7] = -np.inf
    for k in (100, 3000, 20000):
        v_j, i_j = jmasked_top_k(jnp.asarray(s), k)
        v_t, i_t = masked_top_k(torch.from_numpy(s), k)
        fin = np.isfinite(np.asarray(v_j))
        assert fin.sum() == min(k, np.isfinite(s).sum())
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
        np.testing.assert_array_equal(i_t.numpy()[fin], np.asarray(i_j)[fin])
        _, r_i = jax.lax.top_k(jnp.asarray(s), k)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(r_i))


def _sheet_case():
    shape = (32, 32, 32)
    rng = np.random.default_rng(0)
    img = rng.normal(-700, 80, shape).astype(np.float32)
    zz, yy, _ = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    img[np.abs(zz - (12 + 0.2 * yy)) < 1.0] = -300.0
    mask = np.ones(shape, bool)
    mask[:, :, :3] = False
    return img, mask


def test_foerstner_keypoints_equal():
    """Serving's arguments (sigma 0.5, d 5, thresh 1e-8): keypoint indices
    and the valid mask equal (tolerance 0), candidate count equal."""
    img, mask = _sheet_case()
    k_j, v_j, n_j = jfoerstner(jnp.asarray(img), jnp.asarray(mask), sigma=0.5,
                               d=5, thresh=1e-8, max_kpts=600)
    k_t, v_t, n_t = foerstner_keypoints(torch.from_numpy(img),
                                        torch.from_numpy(mask), sigma=0.5,
                                        d=5, thresh=1e-8, max_kpts=600)
    v_j = np.asarray(v_j)
    assert 0 < v_j.sum() < 600 and int(n_t) == int(n_j)
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    np.testing.assert_array_equal(k_t.numpy()[v_j], np.asarray(k_j)[v_j])


def test_synthetic_image_case_bit_equal():
    a = jmake_case(3, shape=(24, 20, 28))
    b = make_synthetic_image_case(3, shape=(24, 20, 28))
    for key in ("image", "labels", "lobes", "lung_mask", "lung_lr"):
        np.testing.assert_array_equal(b[key], a[key])
    assert b["surface_params"] == a["surface_params"]
