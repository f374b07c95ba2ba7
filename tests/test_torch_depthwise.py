"""K6 parity on the CPU: the plain version of the 3x3x3 depthwise
convolution against both JAX Pallas formulations (interpret mode, as
tests/test_pallas_kernels.py runs them) and against XLA's grouped
convolution, on numpy-seeded inputs; and the wrapper's checks.

Tolerance, per output element: the Pallas kernels sum the same 27
products in the same (dz, dy, dx) order, but XLA's CPU fuses each
`acc + tap * w` into an FMA (one rounding instead of two), and
`lax.conv_general_dilated` sums in another order. Each of the 27 products
and 27 sums rounds by at most 2^-24 of the magnitudes involved, so two
float32 evaluations differ by at most 54 * 2^-24 * sum |x * w| (`_bound`).
In bfloat16 the one final rounding to bfloat16 may then differ by one
bfloat16 ulp (2^-8 relative) on top of that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from fissure_segmentation_tpu.ops.pallas.depthwise import (
    depthwise_conv3, depthwise_conv3_ring)
from fissure_segmentation_tpu_torch.kernels.depthwise import (
    depthwise_conv3_cuda, depthwise_conv3_plain)

SHAPES = [
    # (B, D, H, W, C, ring th): the path's channel widths at small volume, a
    # ragged shape (odd D, H, W; C = 5), D = 1 (every dz != 1 tap is padding)
    ((1, 6, 16, 16, 8), 8),
    ((2, 5, 16, 7, 5), 8),
    ((1, 4, 8, 6, 96), 4),
    ((1, 1, 8, 10, 5), None),
]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, shape[-1])).astype(np.float32)
    return x, w


EPS32 = 2.0 ** -24


def _bound(x, w):
    """54 * 2^-24 * sum |x * w| per output element (see the module doc)."""
    return 54 * EPS32 * depthwise_conv3_plain(
        torch.from_numpy(np.abs(x)), torch.from_numpy(np.abs(w))).numpy()


def _within(got, want, bound):
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.parametrize("shape,th", SHAPES)
def test_plain_matches_pallas_f32(shape, th):
    x, w = _inputs(shape, sum(shape))
    got = depthwise_conv3_plain(torch.from_numpy(x), torch.from_numpy(w))
    bound = _bound(x, w)
    _within(got.numpy(), np.asarray(depthwise_conv3(jnp.asarray(x),
                                                    jnp.asarray(w))), bound)
    if th is not None:           # the ring needs H % th == 0 and D >= 2
        _within(got.numpy(), np.asarray(depthwise_conv3_ring(
            jnp.asarray(x), jnp.asarray(w), th=th)), bound)


@pytest.mark.parametrize("shape,th", SHAPES)
def test_plain_matches_xla_grouped_conv(shape, th):
    x, w = _inputs(shape, 1 + sum(shape))
    c = shape[-1]
    ref = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w).reshape(3, 3, 3, 1, c), (1, 1, 1),
        "SAME", feature_group_count=c,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=lax.Precision.HIGHEST)
    got = depthwise_conv3_plain(torch.from_numpy(x), torch.from_numpy(w))
    _within(got.numpy(), np.asarray(ref), _bound(x, w))


@pytest.mark.parametrize("shape,th", SHAPES[:2])
def test_plain_matches_pallas_bf16(shape, th):
    x, w = _inputs(shape, 2 + sum(shape))
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    x32 = np.array(xb.astype(jnp.float32))
    w32 = np.array(wb.astype(jnp.float32))
    got = depthwise_conv3_plain(torch.from_numpy(x32).bfloat16(),
                                torch.from_numpy(w32).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    got = got.float().numpy()
    bound = _bound(x32, w32) + 2.0 ** -8 * np.abs(got)
    _within(got, np.asarray(depthwise_conv3(xb, wb).astype(jnp.float32)),
            bound)
    _within(got, np.asarray(depthwise_conv3_ring(xb, wb, th=th).astype(
        jnp.float32)), bound)


def test_wrapper_runs_plain_on_cpu_and_checks_inputs():
    x, w = _inputs((1, 3, 4, 5, 6), 0)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = depthwise_conv3_cuda.launches
    assert torch.equal(depthwise_conv3_cuda(xt, wt),
                       depthwise_conv3_plain(xt, wt))
    assert depthwise_conv3_cuda.launches == before   # no kernel on the CPU
    with pytest.raises(ValueError, match="w must be"):
        depthwise_conv3_cuda(xt, wt[..., :5].contiguous())
    with pytest.raises(ValueError, match=r"\(B, D, H, W, C\)"):
        depthwise_conv3_cuda(xt[0], wt)
    with pytest.raises(ValueError, match="contiguous"):
        depthwise_conv3_cuda(xt.transpose(1, 2), wt)
    with pytest.raises(TypeError, match="float32"):
        depthwise_conv3_cuda(xt, wt.bfloat16())
    with pytest.raises(TypeError, match="float32"):
        depthwise_conv3_cuda(xt.double(), wt.double())


def test_wrapper_raises_when_autograd_would_record():
    """K6 has no backward: a grad-requiring input raises unless autograd is
    off, so no caller silently gets a detached output."""
    x, w = _inputs((1, 3, 4, 5, 6), 1)
    wt = torch.from_numpy(w).requires_grad_()
    xt = torch.from_numpy(x)
    with pytest.raises(RuntimeError, match="no gradient"):
        depthwise_conv3_cuda(xt, wt)
    with pytest.raises(RuntimeError, match="no gradient"):
        depthwise_conv3_cuda(xt.clone().requires_grad_(), wt.detach())
    with torch.no_grad():
        out = depthwise_conv3_cuda(xt, wt)
    assert not out.requires_grad
