"""Port parity for farthest-point sampling (K5).

The same numpy-seeded clouds go through both JAX versions — the XLA scan
(ops/fps.py, use_pallas=False) and the Pallas kernel fps_pallas, in
interpret mode on the CPU as tests/test_pallas_kernels.py runs it — and
through the port's ops/fps.py on the CPU, which runs K5's plain version
fps_plain. Tolerance: none. The indices must be equal, ties included:
every side rounds d = sum_c (p_c - p_last,c)^2 the same way and takes the
first index of the maximal score.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fissure_segmentation_tpu.ops.fps import \
    farthest_point_sampling as jfarthest_point_sampling
from fissure_segmentation_tpu.ops.pallas.fps import fps_pallas
from fissure_segmentation_tpu_torch.kernels.fps import fps_cuda, fps_plain
from fissure_segmentation_tpu_torch.ops.fps import farthest_point_sampling


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _lattice(rng, shape):
    """Integer points in [0, 4)^C: exact distances, ties everywhere."""
    return rng.integers(0, 4, shape).astype(np.float32)


def _mask(rng, shape, keep=0.6):
    return rng.random(shape) < keep


def _line(rng, shape):
    """Dyadic points on a line, descending with the index: every step's
    farthest point is at an end, every distance exact."""
    n = shape[-2]
    line = ((n - 1 - np.arange(n)) / 16.0).astype(np.float32)
    return np.broadcast_to(line[:, None], shape).copy()


def _equal(rng, shape):
    """Every point the same: every distance 0, only ties."""
    return np.full(shape, 0.25, np.float32)


def _far_masked(rng, shape):
    """The PSR normals' masking: every third point pushed to 1e6 (and
    invalid, `_every_third_invalid`), the rest dyadic."""
    pts = (rng.integers(-16, 17, shape) / 16.0).astype(np.float32)
    pts[..., ::3, :] = 1e6
    return pts


def _every_third_invalid(rng, shape):
    mask = np.ones(shape, bool)
    mask[..., ::3] = False
    return mask


def _few_valid(rng, shape):
    """Row 0 holds 3 valid points (fewer than m), row 1 none."""
    mask = np.zeros(shape, bool)
    mask[0, [17, 40, 101]] = True
    return mask


CASES = {
    # name: (points maker, shape, m, mask maker or None)
    "random_2x140x3": (_normal, (2, 140, 3), 9, None),
    "masked_2x140x3": (_normal, (2, 140, 3), 9, _mask),
    "two_d_70x3": (_normal, (70, 3), 5, None),
    "c4_2x100x4": (_normal, (2, 100, 4), 12, None),
    "ragged_3x300x3": (_normal, (3, 300, 3), 20, _mask),
    "lattice_ties_2x150x3": (_lattice, (2, 150, 3), 16, None),
    "lattice_ties_masked_2x150x3": (_lattice, (2, 150, 3), 16, _mask),
    "few_and_no_valid_2x140x3": (_normal, (2, 140, 3), 9, _few_valid),
    "m1_2x140x3": (_normal, (2, 140, 3), 1, _mask),
    # the card's hard cases at small size: distances falling with the
    # index, only ties, points pushed to 1e6 and masked
    "descending_line_2x150x3": (_line, (2, 150, 3), 16, None),
    "all_equal_2x130x3": (_equal, (2, 130, 3), 12, None),
    "far_masked_2x150x3": (_far_masked, (2, 150, 3), 16,
                           _every_third_invalid),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fps_plain_equals_both_jax_versions(name):
    make, shape, m, make_mask = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    pts = make(rng, shape)
    mask = None if make_mask is None else make_mask(rng, shape[:-1])
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jfarthest_point_sampling(jnp.asarray(pts), m, jmask,
                                               use_pallas=False))
    pallas = np.asarray(fps_pallas(jnp.asarray(pts), m, jmask))
    np.testing.assert_array_equal(pallas, want)
    got = farthest_point_sampling(
        torch.from_numpy(pts), m,
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if mask is not None:
        picked = np.take_along_axis(mask.reshape(-1, shape[-2]),
                                    got.numpy().reshape(-1, m), axis=1)
        has_valid = mask.reshape(-1, shape[-2]).any(-1)
        assert picked[has_valid].all()    # invalid points are never chosen


def test_fps_repeats_and_first_valid():
    """Fewer valid points than m: the valid ones first, then repeats; no
    valid point: index 0 throughout."""
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(_normal(rng, (2, 140, 3)))
    mask = torch.from_numpy(_few_valid(rng, (2, 140)))
    got = farthest_point_sampling(pts, 9, mask)
    assert got[0, 0] == 17
    assert set(got[0].tolist()) == {17, 40, 101}
    assert not got[1].any()


def test_fps_wrapper_checks_input_and_counts_only_kernel_launches():
    """On the CPU the wrapper runs fps_plain and counts no launch; it
    refuses what the kernel does not take."""
    pts = torch.zeros((1, 20, 3))
    before = fps_cuda.launches
    assert torch.equal(fps_cuda(pts, 4), fps_plain(pts, 4))
    assert fps_cuda.launches == before
    with pytest.raises(ValueError, match="C=9"):
        fps_cuda(torch.zeros((1, 20, 9)), 4)
    with pytest.raises(TypeError, match="float32"):
        fps_cuda(pts.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        fps_cuda(torch.zeros((1, 3, 20)).transpose(1, 2), 4)
    with pytest.raises(ValueError, match="valid"):
        fps_cuda(pts, 4, torch.ones((1, 19), dtype=torch.bool))
