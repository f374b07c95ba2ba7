"""The kernels on the card (K1 kNN, K2-K4 scatter, K5 farthest-point
sampling, K6 depthwise convolution, the fused EdgeConv gather-reduce, the
streaming column sums) against their plain PyTorch versions.

These tests need an NVIDIA card and skip elsewhere. The repository's
tests/conftest.py imports jax, which the card's machine does not have, so
run them there without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports no jax.
"""
import pytest
import torch

from fissure_segmentation_tpu_torch.kernels import scatter as ks
from fissure_segmentation_tpu_torch.kernels.depthwise import (
    depthwise_conv3_cuda, depthwise_conv3_plain)
from fissure_segmentation_tpu_torch.kernels.fps import fps_cuda, fps_plain
from fissure_segmentation_tpu_torch.kernels.gather_reduce import (
    gather_reduce, gather_reduce_plain)
from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda, knn_plain
from fissure_segmentation_tpu_torch.kernels.stream import (
    exact_payload, rounding_bound, stream_sum, stream_sum_async,
    stream_sum_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _uniform(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * 2 - 1


def _lattice(shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 6, shape, generator=g).float()
    x[:, : shape[1] // 5] = -1.0            # a block of exact duplicates
    return x


CASES = [
    # (B, N, C, k, self_loop, maker): the two path shapes, ragged N, ties,
    # the widest C and kk the kernel takes
    (5, 2048, 3, 40, False, _uniform),
    (3, 8192, 3, 30, True, _uniform),
    (2, 1000, 3, 17, False, _uniform),
    (3, 4096, 3, 30, True, _lattice),
    (1, 700, 8, 127, False, _uniform),
]


@pytest.mark.parametrize("b,n,c,k,self_loop,make", CASES)
def test_kernel_equals_plain(cuda, b, n, c, k, self_loop, make):
    """Bit-equal indices and distances (tolerance 0, ties included)."""
    x = make((b, n, c), b * n + k).to(cuda)
    i_k, d_k = knn_cuda(x, k, self_loop)
    torch.cuda.synchronize()
    i_p, d_p = knn_plain(x, k, self_loop)
    torch.cuda.synchronize()
    assert i_k.shape == (b, n, k) and i_k.dtype == torch.int32
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k, d_p)


def test_kernel_counts_launches_and_checks_input(cuda):
    x = _uniform((1, 64, 3), 0).to(cuda)
    before = knn_cuda.launches
    knn_cuda(x, 4)
    assert knn_cuda.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        knn_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), 4)
    with pytest.raises(ValueError, match="kk="):
        knn_cuda(_uniform((1, 300, 3), 1).to(cuda), 128)
    assert knn_cuda.launches == before + 1


# ---- K2-K4 ------------------------------------------------------------------
#
# The kernels sum each output row's incoming edges in ascending edge order;
# the plain versions (index_add_) sum the same float32 values in the order
# the card's atomics land. Each is a sequential float32 sum, off the exact
# sum by at most (deg - 1) * 2^-24 * sum|x|, so the stated tolerance per
# output element is twice that bound (`_bound`). K4 counts are equal.

EPS32 = 2.0 ** -24


def _targets(b, e, n_rows, seed, hub=True):
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, n_rows, (b, e), generator=g, dtype=torch.int32)
    if hub:                                 # a hub row, rows nobody reaches
        idx[torch.rand((b, e), generator=g) < 0.25] = 0
        idx[idx >= n_rows - 5] = 1
    return idx


def _bound(idx, absg, n_rows):
    deg = ks.scatter_count_plain(idx, n_rows)[..., None]
    return 2 * deg * EPS32 * ks.scatter_rows_plain(idx, absg, n_rows)


SCATTER_SHAPES = [
    # (B, N, K, C): the DGCNN train step (E = N * K), and a ragged shape
    (32, 2048, 40, 64),
    (3, 1000, 13, 40),
]


@pytest.mark.parametrize("b,n,k,c", SCATTER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_rows_kernel_matches_plain(cuda, b, n, k, c, dtype):
    idx = _targets(b, n * k, n, b + c).to(cuda)
    g = torch.randn((b, n * k, c), generator=torch.Generator().manual_seed(1)
                    ).to(dtype).to(cuda)
    before = ks.scatter_rows.launches
    got = ks.scatter_rows(idx, g, n)
    again = ks.scatter_rows(idx, g, n)
    torch.cuda.synchronize()
    assert ks.scatter_rows.launches == before + 2
    want = ks.scatter_rows_plain(idx, g, n)
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    assert torch.equal(got, again)                   # deterministic
    assert ((got - want).abs() <= _bound(idx, g.float().abs(), n)).all()
    assert not got[:, n - 5:].any()


@pytest.mark.parametrize("b,n,k,c", SCATTER_SHAPES)
def test_scatter_routed_kernel_matches_plain(cuda, b, n, k, c):
    gen = torch.Generator().manual_seed(2)
    idx = _targets(b, n * k, n, b + k).reshape(b, n, k).to(cuda)
    kstar = torch.randint(0, k, (b, n, c), generator=gen,
                          dtype=torch.int32).to(cuda)
    s = torch.randn((b, n, c), generator=gen).to(cuda)
    p = torch.randn((b, n, c), generator=gen).to(cuda)
    before = ks.scatter_routed.launches
    got = ks.scatter_routed(idx, kstar, s, p, n)
    again = ks.scatter_routed(idx, kstar, s, p, n)
    torch.cuda.synchronize()
    assert ks.scatter_routed.launches == before + 2
    want = ks.scatter_routed_plain(idx, kstar, s, p, n)
    assert torch.equal(got, again)
    deg = ks.scatter_count_plain(idx.reshape(b, n * k), n)[..., None]
    bound = 2 * deg * EPS32 * ks.scatter_routed_plain(idx, kstar, s.abs(),
                                                      p.abs(), n)
    assert ((got - want).abs() <= bound).all()


@pytest.mark.parametrize("b,e,n", [(32, 2048 * 40, 2048), (3, 12345, 1000)])
def test_scatter_count_kernel_equals_plain(cuda, b, e, n):
    idx = _targets(b, e, n, e).to(cuda)
    idx[:, ::97] = n + 7                     # dropped, like JAX's scatter
    idx[:, 5::101] = -3
    before = ks.scatter_count.launches
    got = ks.scatter_count(idx, n)
    torch.cuda.synchronize()
    assert ks.scatter_count.launches == before + 1
    assert torch.equal(got, ks.scatter_count_plain(idx, n))


def test_scatter_kernels_drop_out_of_range_and_check_inputs(cuda):
    idx = _targets(2, 500, 64, 9).to(cuda)
    idx[:, ::7] = 64
    idx[:, 3::11] = -1
    g = torch.randn((2, 500, 8), generator=torch.Generator().manual_seed(3)
                    ).to(cuda)
    got = ks.scatter_rows(idx, g, 64)
    want = ks.scatter_rows_plain(idx, g, 64)
    assert ((got - want).abs() <= _bound(idx, g.abs(), 64)).all()
    before = ks.scatter_rows.launches
    with pytest.raises(ValueError, match="contiguous"):
        ks.scatter_rows(idx, g.transpose(0, 1).contiguous().transpose(0, 1),
                        64)
    with pytest.raises(ValueError, match="different devices"):
        ks.scatter_rows(idx.cpu(), g, 64)
    assert ks.scatter_rows.launches == before


# ---- K5 ---------------------------------------------------------------------

FPS_CASES = [
    # (B, N, C, m, valid share, maker): the PointTransformer train step's
    # four TransitionDowns, a served ensemble group, DSEG-AE's masked shape,
    # ragged N, ties, C = 4
    (32, 2048, 3, 512, 1.0, _uniform),
    (32, 512, 3, 128, 1.0, _uniform),
    (32, 128, 3, 32, 1.0, _uniform),
    (32, 32, 3, 8, 1.0, _uniform),
    (5, 2048, 3, 512, 1.0, _uniform),
    (1, 20000, 3, 1024, 0.35, _uniform),
    (3, 1000, 3, 250, 0.8, _uniform),
    (2, 4096, 3, 300, 1.0, _lattice),
    (2, 700, 4, 100, 0.6, _uniform),
]


@pytest.mark.parametrize("b,n,c,m,share,make", FPS_CASES)
def test_fps_kernel_equals_plain(cuda, b, n, c, m, share, make):
    """Bit-equal indices (tolerance 0, ties included)."""
    x = make((b, n, c), b * n + m).to(cuda)
    valid = None
    if share < 1.0:
        g = torch.Generator().manual_seed(m)
        valid = (torch.rand((b, n), generator=g) < share).to(cuda)
    before = fps_cuda.launches
    got = fps_cuda(x, m, valid)
    torch.cuda.synchronize()
    assert fps_cuda.launches == before + 1
    want = fps_plain(x, m, valid)
    assert got.shape == (b, m) and got.dtype == torch.int32
    assert torch.equal(got, want)


def test_fps_kernel_few_and_no_valid_points(cuda):
    """Fewer valid points than m repeat; a row with none gives zeros."""
    x = _uniform((2, 300, 3), 5).to(cuda)
    valid = torch.zeros((2, 300), dtype=torch.bool, device=cuda)
    valid[0, [7, 99, 250]] = True
    got = fps_cuda(x, 10, valid)
    assert torch.equal(got, fps_plain(x, 10, valid))
    assert set(got[0].tolist()) == {7, 99, 250} and not got[1].any()


# ---- K6 ---------------------------------------------------------------------

DW_CASES = [
    # (B, D, H, W, C, dtype): the CNN path's channel widths at a smaller
    # volume, bfloat16, ragged (odd D, H, W; C = 5), D = 1, B > 1
    (1, 32, 32, 32, 32, torch.float32),
    (1, 24, 24, 24, 144, torch.float32),
    (1, 16, 16, 16, 384, torch.float32),
    (1, 24, 24, 24, 192, torch.bfloat16),
    (2, 7, 9, 11, 5, torch.float32),
    (1, 1, 6, 10, 5, torch.float32),
    (3, 5, 4, 3, 7, torch.bfloat16),
]


@pytest.mark.parametrize("b,d,h,w,c,dtype", DW_CASES)
def test_depthwise_kernel_equals_plain(cuda, b, d, h, w, c, dtype):
    """Bit-equal outputs (tolerance 0): both round every multiply and add
    in the same (dz, dy, dx) order, without FMA contraction."""
    g = torch.Generator().manual_seed(b * d * h * w + c)
    x = torch.randn((b, d, h, w, c), generator=g).to(cuda, dtype)
    wt = torch.randn((3, 3, 3, c), generator=g).to(cuda, dtype)
    before = depthwise_conv3_cuda.launches
    got = depthwise_conv3_cuda(x, wt)
    torch.cuda.synchronize()
    assert depthwise_conv3_cuda.launches == before + 1
    want = depthwise_conv3_plain(x, wt)
    assert got.shape == x.shape and got.dtype == dtype
    assert torch.equal(got, want)


def test_depthwise_kernel_checks_input(cuda):
    x = torch.randn((1, 4, 5, 6, 8), device=cuda)
    w = torch.randn((3, 3, 3, 8), device=cuda)
    before = depthwise_conv3_cuda.launches
    with pytest.raises(ValueError, match="w must be"):
        depthwise_conv3_cuda(x, w[..., :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        depthwise_conv3_cuda(x.transpose(2, 3), w)
    with pytest.raises(ValueError, match="different devices"):
        depthwise_conv3_cuda(x, w.cpu())
    with pytest.raises(TypeError, match="float32"):
        depthwise_conv3_cuda(x.half(), w.half())
    with pytest.raises(RuntimeError, match="no gradient"):
        depthwise_conv3_cuda(x, w.clone().requires_grad_())
    assert depthwise_conv3_cuda.launches == before


# ---- the fused EdgeConv gather-reduce ----------------------------------------

GR_CASES = [
    # (B, N, K, C): the DGCNN train step, the served ensemble group, more
    # than 32 slots with C = 8, ragged C (scalar loads), the widest C
    (32, 2048, 40, 64),
    (5, 2048, 40, 64),
    (2, 64, 70, 8),
    (2, 100, 37, 33),
    (3, 50, 5, 256),
]


@pytest.mark.parametrize("b,n,k,c", GR_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("want", ["max", "extrema", "all"])
def test_gather_reduce_kernel_equals_plain(cuda, b, n, k, c, dtype, want):
    """Every output bit-equal (tolerance 0), indices out of range included:
    the same comparisons, and float32 sums in k order without FMA."""
    g = torch.Generator().manual_seed(b * n + k + c)
    a = torch.randn((b, n, c), generator=g).to(cuda, dtype)
    idx = torch.randint(0, n, (b, n, k), generator=g, dtype=torch.int32)
    idx[0, 0, 0], idx[-1, -1, -1], idx[0, 1, k // 2] = -1, n + 5, -10 * n
    idx = idx.to(cuda)
    before = gather_reduce.launches
    got = gather_reduce(a, idx, want)
    torch.cuda.synchronize()
    assert gather_reduce.launches == before + 1
    want_ = gather_reduce_plain(a, idx, want)
    assert len(got) == len(want_)
    for x, y in zip(got, want_):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_gather_reduce_kernel_on_ties(cuda):
    """An integer lattice: every max and min ties between slots; the slots
    must be the first ones on both sides."""
    g = torch.Generator().manual_seed(3)
    a = torch.randint(0, 3, (4, 300, 64), generator=g).float().to(cuda)
    idx = torch.randint(0, 300, (4, 300, 40), generator=g,
                        dtype=torch.int32).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        got = gather_reduce(a.to(dtype), idx, "all")
        for x, y in zip(got, gather_reduce_plain(a.to(dtype), idx, "all")):
            assert torch.equal(x, y)


def test_gather_reduce_kernel_checks_input(cuda):
    a = torch.randn((2, 16, 8), device=cuda)
    idx = torch.zeros((2, 16, 4), dtype=torch.int32, device=cuda)
    before = gather_reduce.launches
    with pytest.raises(ValueError, match="contiguous"):
        gather_reduce(a.transpose(0, 1).contiguous().transpose(0, 1), idx)
    with pytest.raises(ValueError, match="different devices"):
        gather_reduce(a, idx.cpu())
    with pytest.raises(TypeError, match="int32"):
        gather_reduce(a, idx.long())
    with pytest.raises(RuntimeError, match="no gradient"):
        gather_reduce(a.clone().requires_grad_(), idx)
    assert gather_reduce.launches == before


# ---- the streaming column sums -----------------------------------------------

STREAM_CASES = [(81920, 64, torch.bfloat16), (10240, 1024, torch.bfloat16),
                (40000, 64, torch.float32), (1001, 8, torch.bfloat16),
                (7, 4, torch.float32)]


@pytest.mark.parametrize("rows,lanes,dtype", STREAM_CASES)
def test_stream_sums_match_plain(cuda, rows, lanes, dtype):
    """Both kernels within their rounding bound (the depth of their sums;
    about 1e-4 of a column sum here, the payload being drawn around 1) of
    the plain column sums, the exact sums rounded once; two launches
    bit-equal."""
    g = (torch.randn((rows, lanes), generator=torch.Generator().manual_seed(
        rows)) + 1).to(cuda, dtype)
    want = stream_sum_plain(g).double()
    before = (stream_sum.launches, stream_sum_async.launches)
    for got, again, bound in (
            (stream_sum(g), stream_sum(g), rounding_bound(g)),
            (stream_sum_async(g, 16, 3), stream_sum_async(g, 16, 3),
             rounding_bound(g, 16, 3))):
        torch.cuda.synchronize()
        assert got.shape == (lanes,) and got.dtype == torch.float32
        assert torch.equal(got, again)
        assert ((got.double() - want).abs() <= bound).all()
        if rows > 1000:
            assert (bound < 1e-3 * want.abs()).all()
    assert (stream_sum.launches, stream_sum_async.launches) == \
        (before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("rows,lanes,dtype", STREAM_CASES)
def test_stream_sums_exact_on_integers_and_see_a_zeroed_tile(cuda, rows,
                                                             lanes, dtype):
    """On integers 1..4 every partial sum is exact, so both kernels equal
    the plain version; with one tile of rows zeroed (a planted skipped
    tile) neither does."""
    ints = exact_payload(torch.empty((rows, lanes), dtype=dtype,
                                     device=cuda), seed=rows)
    want = stream_sum_plain(ints)
    bad = ints.clone()
    bad[rows // 2:rows // 2 + 16] = 0
    for fn in (stream_sum, lambda v: stream_sum_async(v, 16, 3)):
        assert torch.equal(fn(ints), want)
        assert not torch.equal(fn(bad), want)


def test_stream_sums_check_input(cuda):
    g = torch.randn((64, 64), device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        stream_sum(g[:, :6].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        stream_sum(g.t())
    with pytest.raises(ValueError, match="ring"):
        stream_sum_async(g, 1024, 8)
