"""Port parity for the pre-segmentation CNN (models/seg_cnn.py): the port's
MobileNetASPP loaded from a JAX `init` tree, whole-volume and sliding-window
inference, and the resize helper, each against the JAX package on the same
numpy inputs on the CPU.

JAX runs under `jax.default_matmul_precision("float32")`: this JAX build's
default convolution precision is low even on the CPU. The tree's BatchNorm
statistics, scales and offsets are redrawn with numpy so that eval-mode
BatchNorm is no identity. Tolerances: the two frameworks sum each
convolution in another order (float32 rounding, about 1e-7 relative per
layer and term); at these sizes logits of unit scale differed by 2.3e-6 and
softmax volumes by 5.4e-7, so the tolerances are 2e-5 and 5e-6 (about ten
times that).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.models import seg_cnn as jseg
from fissure_segmentation_tpu_torch.models import (LRASPPMobileNetV33D,
                                                   MobileNetASPP,
                                                   export_jax_variables,
                                                   get_seg_cnn_model_class,
                                                   load_jax_variables,
                                                   predict_all_patches,
                                                   predict_full_volume)
from fissure_segmentation_tpu_torch.models import seg_cnn

LOGIT_TOL = dict(rtol=0, atol=2e-5)
SOFT_TOL = dict(rtol=0, atol=5e-6)


def _leaves(tree, path=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", np.asarray(tree[k])


def _redraw_bn(tree, rng):
    """BatchNorm scale/bias/mean/var redrawn (other leaves kept)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw_bn(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("mean",) or (k == "bias" and np.ndim(v) == 1):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def models():
    jm = jseg.MobileNetASPP(num_classes=3)
    variables = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1), jnp.float32))
    variables = _redraw_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                           np.random.default_rng(0))
    tm = load_jax_variables(MobileNetASPP(num_classes=3), variables)
    return jm, variables, tm


def _jax_apply(jm):
    def apply(v, x, train=False):
        return jm.apply(v, x, train=train)
    return apply


def test_load_is_strict_and_export_inverts(models):
    _, variables, tm = models
    back = dict(_leaves(export_jax_variables(tm)))
    want = dict(_leaves(variables))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    # flax's names, including the stride-1 depthwise kernel in K6's layout
    blk = tm.MobileNet3D_0.Checkpoint_InvertedResidual_7
    assert tuple(blk.Conv_1.kernel.shape) == (3, 3, 3, 384)
    assert tuple(tm.MobileNet3D_0.Checkpoint_InvertedResidual_5.Conv_1
                 .weight.shape) == (192, 1, 3, 3, 3)
    bad = jax.tree_util.tree_map(np.asarray, variables)
    bad["params"]["Conv_1"]["kernel"] = np.zeros((3, 3, 3, 64, 32),
                                                 np.float32)
    with pytest.raises(ValueError, match="Conv_1/kernel"):
        load_jax_variables(MobileNetASPP(num_classes=3), bad)
    del bad["params"]["Conv_1"]
    with pytest.raises(KeyError, match="not set"):
        load_jax_variables(MobileNetASPP(num_classes=3), bad)


def test_forward_matches_jax(models):
    jm, variables, tm = models
    x = np.random.default_rng(1).normal(0, 1, (1, 16, 20, 24, 1)).astype(
        np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 16, 20, 24, 3)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_predict_full_volume_matches_jax(models):
    """Dimensions that are no multiple of 4 exercise the edge pad and crop."""
    jm, variables, tm = models
    img = np.random.default_rng(2).normal(0, 1, (18, 21, 23)).astype(
        np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jseg.predict_full_volume(_jax_apply(jm), variables,
                                                   jnp.asarray(img)))
    got = predict_full_volume(tm, torch.from_numpy(img)).numpy()
    assert got.shape == (18, 21, 23, 3)
    np.testing.assert_allclose(got, want, **SOFT_TOL)


def test_predict_all_patches_matches_jax(models):
    """Sliding window with 50 % overlap, Gaussian blending, edge padding of
    a dimension shorter than the patch, and the second softmax."""
    jm, variables, tm = models
    img = np.random.default_rng(3).normal(0, 1, (24, 20, 12)).astype(
        np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jseg.predict_all_patches(
            _jax_apply(jm), variables, jnp.asarray(img), 3,
            patch_size=(16, 16, 16)))
    got = predict_all_patches(tm, torch.from_numpy(img), 3,
                              patch_size=(16, 16, 16)).numpy()
    assert got.shape == (24, 20, 12, 3)
    np.testing.assert_allclose(got, want, **SOFT_TOL)


@pytest.mark.parametrize("method", ["nearest", "trilinear"])
def test_resize_matches_jax_image_resize(method):
    """F.interpolate's sample positions and edge clamping against
    jax.image.resize at an integer upscale (tolerance: two float32
    roundings of a convex combination, 1e-6 on unit-scale inputs)."""
    x = np.random.default_rng(4).normal(0, 1, (2, 5, 6, 7, 3)).astype(
        np.float32)
    want = np.asarray(jseg._resize(jnp.asarray(x), 2, method))
    got = seg_cnn._resize(torch.from_numpy(x), 2, method).numpy()
    assert got.shape == (2, 10, 12, 14, 3)
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_patch_helpers_equal():
    for img_size, patch in (((100, 90, 80), (64, 64, 64)),
                            ((31, 31, 31), (64, 64, 64)),
                            ((24, 20, 12), (16, 16, 16))):
        for overlap in (0.25, 0.5):
            assert seg_cnn.get_patch_starts(img_size, overlap, patch) == \
                jseg.get_patch_starts(img_size, overlap, patch)
    np.testing.assert_array_equal(seg_cnn.gaussian_importance_map((8, 10, 6)),
                                  jseg.gaussian_importance_map((8, 10, 6)))


def test_eval_only_float32_only_and_registry():
    """Built in eval mode; `.train()` switches every BatchNorm to batch
    statistics (the training half, tests/test_torch_cnn_train.py); the
    whole-volume forward takes float32 or bfloat16 (preprocessing's cnn
    mode; the model itself is not cast), the sliding window float32 only,
    other dtypes raise; "v3" resolves to LR-ASPP."""
    m = MobileNetASPP(num_classes=2, generator=torch.Generator().manual_seed(0))
    assert not m.training and not m.CheckpointASPP_0.BatchNorm_0.training
    assert m.train() is m
    assert all(mod.training for mod in m.modules())
    m.eval()
    soft = predict_full_volume(m, torch.zeros(8, 8, 8), dtype=torch.bfloat16)
    assert soft.shape == (8, 8, 8, 2) and soft.dtype == torch.float32
    assert next(m.parameters()).dtype == torch.float32
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        predict_full_volume(m, torch.zeros(8, 8, 8), dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="float32 only"):
        predict_all_patches(m, torch.zeros(8, 8, 8), 2, patch_size=(8, 8, 8),
                            dtype=torch.bfloat16)
    assert get_seg_cnn_model_class("v1") is MobileNetASPP
    assert get_seg_cnn_model_class("v3") is LRASPPMobileNetV33D
    with pytest.raises(ValueError):
        get_seg_cnn_model_class("v2")
