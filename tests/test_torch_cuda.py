"""The kernels on the card (K1 kNN, the graph transpose, K2-K4 scatter, K5 farthest-point
sampling, K6 depthwise convolution at strides 1 and 2 and its backward (the
wgrad kernel, the dgrad through K6) with a CNN train step card against
CPU, the fused
EdgeConv gather-reduce, the
streaming column sums) against their plain PyTorch versions, the DGCNN
eval forward with grad enabled against the no_grad one, and the default
run's path: the feature graph card against CPU, the dynamic step with its
three transposes against the same step given none, test_pipeline card
against CPU; the fused EdgeConv tail card against CPU; knn(query_chunk=)
against the unchunked call on the card; the approximate top-k's fused row selection and bin pass
against their plain versions, the feature graph on the fused selection
against the stable sort it replaced, the approximate graph card against
CPU, the splat's sorted scatter and segment_cases against a loop of
segment_case.

These tests need an NVIDIA card and skip elsewhere. The repository's
tests/conftest.py imports jax, which the card's machine does not have, so
run them there without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports no jax.
"""
import copy

import numpy as np
import pytest
import torch

from fissure_segmentation_tpu_torch.kernels import scatter as ks
from fissure_segmentation_tpu_torch.kernels.depthwise import (
    depthwise_conv3_cuda, depthwise_conv3_plain)
from fissure_segmentation_tpu_torch.kernels.fps import fps_cuda, fps_plain
from fissure_segmentation_tpu_torch.kernels.gather_reduce import (
    STAGED_MAX_N, call_key, gather_reduce, gather_reduce_plain, staged_parts)
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


def _equal(shape, seed):
    """Every point the same: every distance 0, only ties."""
    return torch.full(shape, 0.25)


def _descending(shape, seed):
    """Points on a line, ordered so that for the last point every key's
    distance falls with its index (each key enters its list)."""
    b, n, c = shape
    line = torch.linspace(1.0, -1.0, n)[None, :, None]
    return (line * torch.ones(shape)).contiguous()


def _masked(shape, seed):
    """The PSR normals' input: a third of the points pushed to 1e6."""
    g = torch.Generator().manual_seed(seed)
    x = _uniform(shape, seed)
    x[torch.rand(shape[:2], generator=g) < 1 / 3] = 1e6
    return x


CASES = [
    # (B, N, C, k, self_loop, maker): the three path shapes, ragged N,
    # ties, the widest C and kk the kernel takes; the hard cases: every key
    # an insert, only ties, the masked normals' cloud, kk at the list's
    # row edges (1, 32, 33, 64, 128), N = kk, and a cloud larger than the
    # kernel stages whole in shared memory (tiles)
    (5, 2048, 3, 40, False, _uniform),
    (32, 2048, 3, 40, False, _uniform),
    (3, 8192, 3, 30, True, _uniform),
    (2, 1000, 3, 17, False, _uniform),
    (3, 4096, 3, 30, True, _lattice),
    (1, 700, 8, 127, False, _uniform),
    (2, 2048, 3, 40, False, _descending),
    (2, 2048, 3, 40, False, _equal),
    (3, 8192, 3, 30, True, _masked),
    (2, 300, 3, 1, True, _uniform),
    (2, 300, 3, 32, True, _uniform),
    (2, 300, 3, 33, True, _uniform),
    (2, 300, 3, 64, True, _uniform),
    (1, 700, 3, 128, True, _uniform),
    (2, 41, 3, 40, False, _uniform),
    (1, 128, 5, 128, True, _lattice),
    (1, 20000, 3, 16, False, _uniform),
    (1, 9000, 8, 20, True, _masked),
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


def _routed_check(cuda, idx, kstar, s, p, n_rows):
    """K3 twice with its own transpose and once with the caller's: equal
    to each other and within the rounding bound of plain."""
    b, n, k = idx.shape
    tr = ks.transpose(idx.reshape(b, n * k), n_rows)
    before = ks.scatter_routed.launches
    got = ks.scatter_routed(idx, kstar, s, p, n_rows)
    again = ks.scatter_routed(idx, kstar, s, p, n_rows)
    shared = ks.scatter_routed(idx, kstar, s, p, n_rows, tr)
    torch.cuda.synchronize()
    assert ks.scatter_routed.launches == before + 3
    assert torch.equal(got, again) and torch.equal(got, shared)
    want = ks.scatter_routed_plain(idx, kstar, s, p, n_rows)
    deg = ks.scatter_count_plain(idx.reshape(b, n * k), n_rows)[..., None]
    bound = 2 * deg * EPS32 * ks.scatter_routed_plain(
        idx, kstar, s.float().abs(), p.float().abs(), n_rows)
    assert ((got - want).abs() <= bound).all()


@pytest.mark.parametrize("b,n,k,c", SCATTER_SHAPES)
def test_scatter_routed_kernel_matches_plain_bf16(cuda, b, n, k, c):
    """K3 with bfloat16 payloads (the bf16 train step's)."""
    gen = torch.Generator().manual_seed(12)
    idx = _targets(b, n * k, n, b + k + 1).reshape(b, n, k).to(cuda)
    kstar = torch.randint(0, k, (b, n, c), generator=gen,
                          dtype=torch.int32).to(cuda)
    s = torch.randn((b, n, c), generator=gen).to(cuda, torch.bfloat16)
    p = torch.randn((b, n, c), generator=gen).to(cuda, torch.bfloat16)
    _routed_check(cuda, idx, kstar, s, p, n)


ROUTED_CASES = [
    # (name, B, N, K, C, dtype): C off the staged slice (8 float32 or 16
    # bfloat16 channels) and off 16-byte vectors; N where the staged slices
    # just fit in shared memory and just do not, and K above 255 (the
    # kernel that reads device memory); a hub row of in-degree 1250; kstar
    # only at 0 and K - 1
    ("c33", 2, 500, 40, 33, torch.float32),
    ("c40", 2, 500, 40, 40, torch.bfloat16),
    ("c36", 2, 500, 40, 36, torch.bfloat16),
    ("c200", 2, 500, 40, 200, torch.float32),
    ("c256", 2, 500, 40, 256, torch.bfloat16),
    ("fits", 1, ks.ROUTED_STAGED_MAX_N[torch.float32], 40, 64,
     torch.float32),
    ("spills", 1, ks.ROUTED_STAGED_MAX_N[torch.float32] + 1, 40, 64,
     torch.float32),
    ("fits", 1, ks.ROUTED_STAGED_MAX_N[torch.bfloat16], 40, 64,
     torch.bfloat16),
    ("spills", 1, ks.ROUTED_STAGED_MAX_N[torch.bfloat16] + 1, 40, 64,
     torch.bfloat16),
    ("k300", 2, 400, ks.ROUTED_STAGED_MAX_K + 45, 16, torch.float32),
    ("hub", 2, 2000, 40, 64, torch.float32),
    ("hub", 2, 2000, 40, 64, torch.bfloat16),
    ("kstar_0_and_last", 2, 700, 40, 64, torch.float32),
    ("kstar_0_and_last", 2, 700, 40, 64, torch.bfloat16),
]


@pytest.mark.parametrize("name,b,n,k,c,dtype", ROUTED_CASES)
def test_scatter_routed_kernel_hard_cases(cuda, name, b, n, k, c, dtype):
    gen = torch.Generator().manual_seed(n + k + c)
    idx = torch.randint(0, n, (b, n, k), generator=gen, dtype=torch.int32)
    if name == "hub":
        idx.view(b, -1)[:, ::64] = 7                 # in-degree 1250
    kstar = torch.randint(0, k, (b, n, c), generator=gen, dtype=torch.int32)
    if name == "kstar_0_and_last":
        kstar = torch.where(kstar % 2 == 0, 0, k - 1).to(torch.int32)
    s = torch.randn((b, n, c), generator=gen).to(dtype)
    p = torch.randn((b, n, c), generator=gen).to(dtype)
    _routed_check(cuda, idx.to(cuda), kstar.to(cuda), s.to(cuda),
                  p.to(cuda), n)


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


def _count_case(name):
    """(B, E) int32 targets and n_rows: K4's hard cases on the card."""
    g = torch.Generator().manual_seed(len(name))
    if name == "dropped":                  # above n_rows and negative
        return torch.randint(-40, 1040, (2, 7001), generator=g).int(), 1000
    if name == "hub":                      # row 7 takes 1250 of 5000 edges
        idx = torch.randint(0, 2000, (2, 5000), generator=g)
        idx[:, ::4] = 7
        return idx.int(), 2000
    if name == "n_rows_1":
        return torch.randint(-1, 2, (4, 999), generator=g).int(), 1
    if name == "b_1":                      # one cluster of 8 blocks
        return _targets(1, 2048 * 40, 2048, 3), 2048
    if name == "ragged_e":                 # E no multiple of 4
        return _targets(3, 12345, 1000, 4), 1000
    if name == "b_22":                     # clusters of 6 blocks
        return _targets(22, 4097, 700, 5), 700
    if name == "b_132":                    # clusters of one block
        return _targets(132, 4097, 700, 7), 700
    if name == "p1_rows_512":              # P1's k_onehot: in-degree 160
        return torch.randint(0, 2048, (32, 2048 * 40), generator=g
                             ).int() % 512, 512
    if name == "smem_rows":                # 8 blocks of 200 KB a cluster
        return torch.randint(-5, 51205, (2, 60000), generator=g).int(), 51200
    if name == "many_rows":                # counters in device memory
        return torch.randint(-5, 60005, (2, 5000), generator=g).int(), 60000
    return _targets(32, 2048 * 40, 2048, 6), 2048   # the train step's


COUNT_CASES = ["dropped", "hub", "n_rows_1", "b_1", "ragged_e", "b_22",
               "b_132", "p1_rows_512", "smem_rows", "many_rows",
               "train_step"]


@pytest.mark.parametrize("name", COUNT_CASES)
@pytest.mark.parametrize("from_ptr", [False, True], ids=["hist", "ptr"])
def test_scatter_count_kernels_on_hard_cases(cuda, name, from_ptr):
    """Both K4 kernels (the histogram of idx; the in-degrees from the
    transpose's row offsets) equal to plain on K4's hard cases, two
    launches bit-equal, each counted under its own call."""
    idx, n = _count_case(name)
    idx = idx.to(cuda)
    tr = ks.transpose(idx, n) if from_ptr else None
    b, e = idx.shape
    key = f"ptr_{b}x{n}" if from_ptr else f"hist_{b}x{e}_rows{n}"
    before, calls = ks.scatter_count.launches, ks.scatter_count.calls.get(
        key, 0)
    got = ks.scatter_count(idx, n, tr)
    again = ks.scatter_count(idx, n, tr)
    torch.cuda.synchronize()
    assert ks.scatter_count.launches == before + 2
    assert ks.scatter_count.calls[key] == calls + 2
    assert got.dtype == torch.float32 and got.shape == (b, n)
    assert torch.equal(got, again)
    assert torch.equal(got, ks.scatter_count_plain(idx, n))


def test_scatter_count_histogram_off_16_byte_boundaries(cuda):
    """idx starting 4 bytes past a 16-byte boundary, rows of E = 4k + 3
    targets: every row's head and tail outside the 16-byte loads."""
    g = torch.Generator().manual_seed(8)
    flat = torch.randint(-3, 703, (5 * 4003 + 1,), generator=g).int()
    idx = flat.to(cuda)[1:].view(5, 4003)
    assert idx.is_contiguous() and idx.data_ptr() % 16 == 4
    got = ks.scatter_count(idx, 700)
    assert torch.equal(got, ks.scatter_count_plain(idx, 700))


@pytest.mark.parametrize("shared", [False, True], ids=["own", "shared"])
def test_fused_backward_counts_from_one_transpose(cuda, shared):
    """The fused EdgeConv backward runs K3 once and K4 once from the
    transpose's row offsets, never the histogram; with transposed=None it
    builds exactly one transpose for both. Its gradients equal those given
    the caller's transpose."""
    from fissure_segmentation_tpu_torch.ops.fused_edge import \
        fused_edge_train
    gen = torch.Generator().manual_seed(9)
    b, n, kk, c = 4, 512, 20, 32
    idx = torch.randint(0, n, (b, n, kk), generator=gen,
                        dtype=torch.int32).to(cuda)
    ins = [torch.randn(shape, generator=gen).to(cuda)
           for shape in ((b, n, c), (b, n, c), (c,), (c,))]
    w = torch.randn((b, n, c), generator=gen).to(cuda)
    tr = ks.transpose(idx.reshape(b, n * kk), n)

    def grads(given):
        xs = [t.clone().requires_grad_(True) for t in ins]
        out, _, _ = fused_edge_train(*xs, idx, 1e-5, 0.2, given)
        before = (ks.transpose.launches, ks.scatter_routed.launches,
                  ks.scatter_count.launches, dict(ks.scatter_count.calls))
        (out * w).sum().backward()
        torch.cuda.synchronize()
        launched = (ks.transpose.launches - before[0],
                    ks.scatter_routed.launches - before[1],
                    ks.scatter_count.launches - before[2])
        new = {k: v - before[3].get(k, 0)
               for k, v in ks.scatter_count.calls.items()
               if v > before[3].get(k, 0)}
        return [x.grad for x in xs], launched, new

    got, launched, new = grads(tr if shared else None)
    assert launched == ((0, 1, 1) if shared else (1, 1, 1))
    assert new == {f"ptr_{b}x{n}": 1}
    want, _, _ = grads(tr)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _transpose_case(name, seed):
    """(B, E) int32 targets and n_rows: the transpose's hard cases."""
    g = torch.Generator().manual_seed(seed)
    if name == "hub":                      # row 7 takes 1250 of 5000 edges
        idx = torch.randint(0, 2000, (2, 5000), generator=g)
        idx[:, ::4] = 7
        return idx.int(), 2000
    if name == "one_row":                  # every edge into one row
        return torch.full((3, 9000), 5, dtype=torch.int32), 10
    if name == "empty_rows":
        return torch.randint(0, 50, (2, 3000), generator=g).int(), 4096
    if name == "dropped":                  # below 0 and past the last row
        return torch.randint(-40, 1040, (2, 7000), generator=g).int(), 1000
    if name == "n_rows_1":
        return torch.randint(-1, 2, (4, 999), generator=g).int(), 1
    if name == "no_edges":
        return torch.zeros((2, 0), dtype=torch.int32), 10
    if name == "many_rows":                # counters too many for shared
        return torch.randint(-5, 60005, (2, 5000), generator=g).int(), 60000
    return _targets(32, 2048 * 40, 2048, seed), 2048   # the train step's


@pytest.mark.parametrize("name", ["hub", "one_row", "empty_rows", "dropped",
                                  "n_rows_1", "no_edges", "many_rows",
                                  "train_step"])
def test_transpose_kernel_equals_plain(cuda, name):
    """(order, ptr) equal to the stable sort's, int32, one launch."""
    idx, n_rows = _transpose_case(name, 5)
    idx = idx.to(cuda)
    before = ks.transpose.launches
    order, ptr = ks.transpose(idx, n_rows)
    torch.cuda.synchronize()
    assert ks.transpose.launches == before + 1
    want_order, want_ptr = ks.transpose_plain(idx, n_rows)
    assert order.dtype == ptr.dtype == torch.int32
    assert torch.equal(order, want_order) and torch.equal(ptr, want_ptr)


@pytest.mark.parametrize("c", [1, 33, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True], ids=["own", "shared"])
def test_scatter_rows_kernel_by_width(cuda, c, dtype, shared):
    """K2 at channel widths off and on the 16-byte vectors, with its own
    transpose and with the caller's: two runs equal, within the rounding
    bound of plain, and a shared transpose changes nothing."""
    b, n, e = 3, 700, 9000
    idx = _targets(b, e, n, c).to(cuda)
    idx[:, ::13] = n + 2                     # dropped
    idx[:, :500] = 3                         # a hub row
    g = torch.randn((b, e, c), generator=torch.Generator().manual_seed(c)
                    ).to(dtype).to(cuda)
    tr = ks.transpose(idx, n) if shared else None
    before = ks.transpose.launches
    got = ks.scatter_rows(idx, g, n, tr)
    again = ks.scatter_rows(idx, g, n, tr)
    torch.cuda.synchronize()
    assert ks.transpose.launches == before + (0 if shared else 2)
    want = ks.scatter_rows_plain(idx, g, n)
    assert torch.equal(got, again)
    assert ((got - want).abs() <= _bound(idx, g.float().abs(), n)).all()
    if shared:
        assert torch.equal(got, ks.scatter_rows(idx, g, n))


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
    # the hard cases: only ties, N = 1, m above the valid count, N off
    # every block width, N = 32768 (a cluster of blocks), C = 1 and C = 8
    (2, 1000, 3, 100, 1.0, _equal),
    (3, 1, 3, 4, 1.0, _uniform),
    (2, 500, 3, 300, 0.3, _uniform),
    (2, 2047, 3, 64, 1.0, _uniform),
    (1, 1025, 3, 100, 0.9, _uniform),
    (2, 32768, 3, 256, 0.9, _uniform),
    (2, 3000, 1, 200, 1.0, _uniform),
    (2, 3000, 8, 200, 0.7, _uniform),
    (1, 32768, 8, 64, 1.0, _uniform),
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
    # the tiled kernel's hard cases: H and W off the tile, C off the
    # channel slice and off the 16-byte copies, D = 1 and 2, B = 2, bf16
    (1, 9, 13, 21, 32, torch.float32),
    (1, 6, 7, 9, 33, torch.float32),
    (2, 5, 10, 19, 96, torch.float32),
    (2, 3, 17, 9, 144, torch.float32),
    (1, 4, 9, 18, 384, torch.float32),
    (1, 1, 12, 20, 96, torch.float32),
    (1, 2, 8, 16, 144, torch.float32),
    (1, 5, 11, 18, 36, torch.float32),
    (2, 3, 10, 11, 64, torch.bfloat16),
    (1, 4, 9, 9, 144, torch.bfloat16),
    (1, 2, 7, 10, 40, torch.bfloat16),
    (1, 1, 9, 17, 384, torch.bfloat16),
    (2, 2, 5, 6, 12, torch.bfloat16),
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
    with pytest.raises(TypeError, match="float32 only"):
        depthwise_conv3_cuda(x.bfloat16(), w.bfloat16().requires_grad_())
    assert depthwise_conv3_cuda.launches == before


# ---- K6's backward -------------------------------------------------------------

WG_CASES = [
    # (B, D, H, W, C): C below, off and across the 32-channel groups, D = 1,
    # W = 1, rows off the thread rows, the step's narrowest layer small
    (2, 5, 6, 7, 8), (1, 3, 9, 11, 33), (2, 7, 5, 40, 144), (1, 1, 4, 4, 5),
    (3, 2, 3, 1, 64), (4, 12, 12, 12, 32), (2, 6, 6, 6, 384),
]


@pytest.mark.parametrize("b,d,h,w,c", WG_CASES)
def test_depthwise_backward_kernels(cuda, b, d, h, w, c):
    """wgrad within gamma_depth * sum |x dy| of the float64 plain version
    (a tap whose terms are all padding exactly 0) and the same from launch
    to launch; dgrad bit-equal to the plain version with flipped taps;
    autograd through the wrapper launches both, once each."""
    from fissure_segmentation_tpu_torch.kernels.depthwise import (
        depthwise_conv3_dgrad, depthwise_conv3_wgrad_cuda,
        depthwise_conv3_wgrad_plain, gamma, wgrad_plan)
    g = torch.Generator().manual_seed(b * d * h * w + c)
    x, gy = (torch.randn((b, d, h, w, c), generator=g).to(cuda)
             for _ in range(2))
    wt = torch.randn((3, 3, 3, c), generator=g).to(cuda)
    got = depthwise_conv3_wgrad_cuda(x, gy)
    torch.cuda.synchronize()
    want = depthwise_conv3_wgrad_plain(x.double(), gy.double())
    bound = gamma(wgrad_plan(x.shape).depth) * depthwise_conv3_wgrad_plain(
        x.double().abs(), gy.double().abs())
    assert ((got.double() - want).abs() <= bound).all()
    assert torch.equal(depthwise_conv3_wgrad_cuda(x, gy), got)
    assert torch.equal(depthwise_conv3_dgrad(gy, wt), depthwise_conv3_plain(
        gy, wt.flip((0, 1, 2)).contiguous()))
    roles = dict(depthwise_conv3_cuda.roles)
    wl = depthwise_conv3_wgrad_cuda.launches
    xr, wr = x.clone().requires_grad_(), wt.clone().requires_grad_()
    depthwise_conv3_cuda(xr, wr).backward(gy)
    assert depthwise_conv3_cuda.roles["forward"] == roles["forward"] + 1
    assert depthwise_conv3_cuda.roles["dgrad"] == roles["dgrad"] + 1
    assert depthwise_conv3_wgrad_cuda.launches == wl + 1
    assert torch.equal(wr.grad, got)


DW_STRIDE2_CASES = [
    # (B, D, H, W, C, dtype): block 5's serving width, the train step's
    # stride-2 widths at a smaller volume, odd D, H, W, D = 1 and 2, H and
    # W off the 4 x 8 output tile, C off the 16-byte rows, bf16
    (1, 32, 32, 32, 192, torch.float32),
    (2, 12, 12, 12, 64, torch.float32),
    (2, 6, 6, 6, 240, torch.float32),
    (1, 9, 13, 21, 32, torch.float32),
    (1, 1, 12, 20, 64, torch.float32),
    (1, 2, 8, 16, 144, torch.float32),
    (1, 6, 7, 9, 33, torch.float32),
    (2, 5, 4, 3, 5, torch.float32),
    (1, 16, 16, 16, 192, torch.bfloat16),
    (1, 5, 9, 9, 40, torch.bfloat16),
    (1, 3, 5, 6, 12, torch.bfloat16),
]


@pytest.mark.parametrize("b,d,h,w,c,dtype", DW_STRIDE2_CASES)
def test_depthwise_stride2_kernel_equals_plain(cuda, b, d, h, w, c, dtype):
    """K6's stride-2 mode bit-equal to its plain version (the stride-1
    plain result at every other output), ceil(n / 2) outputs an axis;
    counted as a "stride2" launch."""
    from fissure_segmentation_tpu_torch.kernels.depthwise import out_shape
    g = torch.Generator().manual_seed(b * d * h * w + c + 2)
    x = torch.randn((b, d, h, w, c), generator=g).to(cuda, dtype)
    wt = torch.randn((3, 3, 3, c), generator=g).to(cuda, dtype)
    roles = dict(depthwise_conv3_cuda.roles)
    got = depthwise_conv3_cuda(x, wt, stride=2)
    torch.cuda.synchronize()
    assert depthwise_conv3_cuda.roles == {**roles,
                                          "stride2": roles["stride2"] + 1}
    assert tuple(got.shape) == out_shape(x.shape, 2) and got.dtype == dtype
    assert torch.equal(got, depthwise_conv3_plain(x, wt, 2))


@pytest.mark.parametrize("b,d,h,w,c", WG_CASES + [(2, 9, 13, 21, 36),
                                                  (1, 7, 9, 11, 96)])
def test_depthwise_stride2_backward_kernels(cuda, b, d, h, w, c):
    """At stride 2: wgrad within gamma_depth * sum |x dy| of the float64
    plain version and the same from launch to launch; the dgrad (K6 on dy
    stuffed to x's shape, flipped taps) bit-equal to the plain version on
    the same stuffed input; autograd through the wrapper launches the
    stride-2 forward, one dgrad and one stride-2 wgrad."""
    from fissure_segmentation_tpu_torch.kernels.depthwise import (
        depthwise_conv3_dgrad, depthwise_conv3_wgrad_cuda,
        depthwise_conv3_wgrad_plain, gamma, out_shape, stuff, wgrad_plan)
    g = torch.Generator().manual_seed(b * d * h * w + c + 1)
    x = torch.randn((b, d, h, w, c), generator=g).to(cuda)
    gy = torch.randn(out_shape(x.shape, 2), generator=g).to(cuda)
    wt = torch.randn((3, 3, 3, c), generator=g).to(cuda)
    got = depthwise_conv3_wgrad_cuda(x, gy, 2)
    torch.cuda.synchronize()
    want = depthwise_conv3_wgrad_plain(x.double(), gy.double(), 2)
    bound = gamma(wgrad_plan(x.shape, 2).depth) * \
        depthwise_conv3_wgrad_plain(x.double().abs(), gy.double().abs(), 2)
    assert ((got.double() - want).abs() <= bound).all()
    assert torch.equal(depthwise_conv3_wgrad_cuda(x, gy, 2), got)
    dx = depthwise_conv3_dgrad(gy, wt, 2, x.shape)
    assert torch.equal(dx, depthwise_conv3_plain(
        stuff(gy, x.shape), wt.flip((0, 1, 2)).contiguous()))
    roles = dict(depthwise_conv3_cuda.roles)
    wl = dict(depthwise_conv3_wgrad_cuda.roles)
    xr, wr = x.clone().requires_grad_(), wt.clone().requires_grad_()
    depthwise_conv3_cuda(xr, wr, stride=2).backward(gy)
    assert depthwise_conv3_cuda.roles == {
        "forward": roles["forward"], "stride2": roles["stride2"] + 1,
        "dgrad": roles["dgrad"] + 1}
    assert depthwise_conv3_wgrad_cuda.roles == {
        "stride1": wl["stride1"], "stride2": wl["stride2"] + 1}
    assert torch.equal(wr.grad, got) and torch.equal(xr.grad, dx)


def test_depthwise_wgrad_checks_input(cuda):
    from fissure_segmentation_tpu_torch.kernels.depthwise import \
        depthwise_conv3_wgrad_cuda
    x = torch.randn((1, 4, 5, 6, 8), device=cuda)
    before = depthwise_conv3_wgrad_cuda.launches
    with pytest.raises(TypeError, match="float32 only"):
        depthwise_conv3_wgrad_cuda(x.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        depthwise_conv3_wgrad_cuda(x, x[..., :4].contiguous())
    with pytest.raises(ValueError, match="shape"):
        depthwise_conv3_wgrad_cuda(x, x, 2)
    with pytest.raises(ValueError, match="stride"):
        depthwise_conv3_wgrad_cuda(x, x, 3)
    with pytest.raises(ValueError, match="contiguous"):
        depthwise_conv3_wgrad_cuda(x.transpose(2, 3), x.transpose(2, 3))
    with pytest.raises(ValueError, match="different devices"):
        depthwise_conv3_wgrad_cuda(x, x.cpu())
    assert depthwise_conv3_wgrad_cuda.launches == before


@pytest.mark.parametrize("version", ["v1", "v3"])
def test_cnn_train_step_on_card_matches_cpu(cuda, version, tmp_path):
    """One ImageTrainer step of a full-width CNN on 2 augmented patches of
    32^3, card (K6, its backward, cuDNN with TF32 off) against CPU from the
    same weights, crops, draws and dropout mask: loss within 1e-4
    relative, the gradient within 3e-2 relative L2 (train-mode BatchNorm
    over few voxels amplifies the summation order; chip_smoke.py phase
    28)."""
    from fissure_segmentation_tpu_torch.data.image_dataset import (
        ImageDataset, draw_augmentation)
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.losses import get_loss_fn
    from fissure_segmentation_tpu_torch.models import (
        export_jax_variables, get_seg_cnn_model_class)
    from fissure_segmentation_tpu_torch.train.image_trainer import \
        ImageTrainer
    from fissure_segmentation_tpu_torch.train.trainer import TrainConfig
    torch.backends.cudnn.allow_tf32 = False
    cases = [make_synthetic_image_case(i, shape=(40, 40, 40))
             for i in range(2)]
    ds = ImageDataset([c["image"] * 3 for c in cases],
                      [c["labels"] for c in cases], [("a", "0"), ("b", "0")],
                      patch_size=(32, 32, 32), preprocessed=True)
    imgs, lbls = ds.crop_batch(np.random.default_rng(0), [0, 1])
    draws = draw_augmentation(torch.Generator().manual_seed(1), imgs.shape)
    keep = torch.rand((2, 8, 8, 8, 128),
                      generator=torch.Generator().manual_seed(3)) < 0.5
    cls = get_seg_cnn_model_class(version)
    model = cls(num_classes=ds.num_classes, patch_size=(32,) * 3,
                generator=torch.Generator().manual_seed(2))
    weights = torch.as_tensor(ds.get_class_weights(), dtype=torch.float32)
    out = {}
    for dev in ("cpu", cuda):
        trainer = ImageTrainer(
            copy.deepcopy(model), ds, get_loss_fn("nnunet", weights.to(dev)),
            str(tmp_path), TrainConfig(batch_size=2), device=dev)
        loss, _ = trainer.train_step(
            imgs.to(dev), lbls.to(dev),
            draws={k: v.to(dev) for k, v in draws.items()},
            keep=keep.to(dev) if version == "v1" else None)
        out[str(dev)] = (float(loss), export_jax_variables(trainer.model,
                                                           grad=True))
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-4 * abs(lc)

    def flat(t):
        return torch.cat([torch.as_tensor(v).reshape(-1) for v in
                          _flat_leaves(t)])
    a, b = flat(gg), flat(gc)
    assert float((a - b).norm() / b.norm()) <= 3e-2


def _flat_leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat_leaves(tree[k])
        else:
            yield tree[k]


# ---- the fused EdgeConv gather-reduce ----------------------------------------

GR_CASES = [
    # (B, N, K, C): the DGCNN train step, the served ensemble group, more
    # than 32 slots with C = 8, ragged C (scalar loads), the widest C; C
    # off the staged slice (16 float32 or 32 bfloat16 channels), one cloud
    # split among many blocks, N where the slice just fits in shared memory
    # and just does not (the kernel that reads device memory)
    (32, 2048, 40, 64),
    (5, 2048, 40, 64),
    (2, 64, 70, 8),
    (2, 100, 37, 33),
    (3, 50, 5, 256),
]

GR_PATH_CASES = [
    # (B, N, K, C, staged in f32, staged in bf16) on an H100 (132 SMs): the
    # train step; the served ensemble group (5 clouds x 4 slices, too few
    # for the SMs: the unstaged kernel); C off the staged slice (16 float32 or
    # 32 bfloat16 channels) and off 16-byte vectors; points split among
    # blocks; N where the slice just fits in shared memory and just does
    # not (the unstaged kernel)
    (32, 2048, 40, 64, True, True),
    (5, 2048, 40, 64, False, False),
    (17, 500, 40, 33, True, True),
    (17, 500, 40, 36, True, True),
    (17, 500, 40, 40, True, True),
    (12, 500, 40, 200, True, True),
    (11, 2048, 40, 64, True, False),
    (16, STAGED_MAX_N, 24, 64, True, True),
    (16, STAGED_MAX_N + 1, 24, 64, False, False),
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
    key = call_key(a, idx, want)
    calls = gather_reduce.calls.get(key, 0)
    got = gather_reduce(a, idx, want)
    torch.cuda.synchronize()
    assert gather_reduce.launches == before + 1
    assert gather_reduce.calls[key] == calls + 1
    want_ = gather_reduce_plain(a, idx, want)
    assert len(got) == len(want_)
    for x, y in zip(got, want_):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("b,n,k,c,f32_staged,bf16_staged", GR_PATH_CASES)
@pytest.mark.parametrize("want", ["max", "extrema", "all"])
def test_gather_reduce_kernel_paths(cuda, b, n, k, c, f32_staged,
                                    bf16_staged, want):
    """Both kernels bit-equal to plain where the shape sends the call, and
    on an H100 the shape sends it where the batch sweep found it faster."""
    g = torch.Generator().manual_seed(b * n + k + c)
    base = torch.randn((b, n, c), generator=g)
    idx = torch.randint(0, n, (b, n, k), generator=g, dtype=torch.int32)
    idx[0, 0, 0], idx[-1, -1, -1] = -1, n + 5
    idx = idx.to(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for dtype, staged in ((torch.float32, f32_staged),
                          (torch.bfloat16, bf16_staged)):
        if sms == 132:
            assert (staged_parts(b, n, c, dtype) > 0) == staged
        a = base.to(cuda, dtype)
        got = gather_reduce(a, idx, want)
        for x, y in zip(got, gather_reduce_plain(a, idx, want)):
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


# ---- the DGCNN eval forward with grad enabled -------------------------------

def test_dgcnn_eval_forward_with_grad_equals_no_grad(cuda, monkeypatch):
    """With grad enabled the fused eval core takes the standard path (flat
    gather, amax/amin) and autograd records it; under no_grad it launches
    the gather-reduce kernel. The two forwards are equal, and the gradient
    reaches the input."""
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    monkeypatch.setenv("FSEG_FUSED_EDGE", "1")
    torch.manual_seed(0)
    model = DGCNNSeg(k=8, in_features=3, num_classes=4,
                     dynamic=False).to(cuda).eval()
    x = _uniform((2, 256, 3), 3).to(cuda).requires_grad_(True)
    before = gather_reduce.launches
    out = model(x)
    assert gather_reduce.launches == before
    out.square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    with torch.no_grad():
        want = model(x)
    assert gather_reduce.launches > before
    assert torch.equal(out.detach(), want)


# ---- the dynamic graph and the test half --------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_feature_graph_on_card_equals_cpu(cuda, dtype):
    """The feature-space graph (matmul + stable sort, TF32 off): on dyadic
    features every distance is exact on both sides, so the indices, ties
    included, and the distances are equal; on generic float32 features the
    neighbour sets agree but for near-ties (at least 99 %)."""
    from fissure_segmentation_tpu_torch.ops.knn import feature_knn
    g = torch.Generator().manual_seed(11)
    x = (torch.randint(-16, 17, (3, 700, 64), generator=g) / 16.0).to(dtype)
    i_g, d_g = feature_knn(x.to(cuda), 41)
    i_c, d_c = feature_knn(x, 41)
    assert torch.equal(i_g.cpu(), i_c) and torch.equal(d_g.cpu(), d_c)
    if dtype == torch.float32:
        x = torch.randn((3, 700, 64), generator=g)
        i_g = feature_knn(x.to(cuda), 40)[0].cpu().sort(-1).values
        i_c = feature_knn(x, 40)[0].sort(-1).values
        assert (i_g == i_c).all(-1).float().mean() >= 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dynamic_step_with_transposes_equals_step_without(cuda, dtype,
                                                          monkeypatch):
    """The dynamic train step builds one transpose per graph (three) and
    hands each to the backward scatters of its EdgeConv; the same step
    given none (each scatter building its own) gives the same loss and
    bit-equal gradients, fused and unfused."""
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    from fissure_segmentation_tpu_torch.models import dgcnn
    x = _uniform((2, 256, 4), 5).to(cuda)
    shared = dgcnn.DGCNNSeg._transpose
    for fused in ("0", "1"):
        monkeypatch.setenv("FSEG_FUSED_EDGE", fused)
        grads, built = [], []
        for share in (True, False):
            monkeypatch.setattr(dgcnn.DGCNNSeg, "_transpose", shared if share
                                else lambda self, graph: None)
            model = DGCNNSeg(k=8, in_features=4, num_classes=4, dtype=dtype,
                             generator=torch.Generator().manual_seed(0)
                             ).to(cuda).train()
            before = ks.transpose.launches
            out = model(x)
            built.append(ks.transpose.launches - before)
            out.square().sum().backward()
            grads.append([p.grad.clone() for p in model.parameters()])
        assert built == [3, 0]
        for a, b in zip(*grads):
            assert torch.equal(a, b)


def test_test_pipeline_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """One small case through test_pipeline with a static f32 model (no
    near-tie in a feature graph can differ) and the same injected draws on
    the card and on the CPU, both on the fused tail's route: the same
    predictions and Dice; the ASSD family
    within 1e-2 relative: the surface fit's sums (PSR's FFT, the normals)
    round in other orders, and HD95 steps between samples (reading on an
    H100: 3.8e-3 at HD95, within 1e-4 elsewhere)."""
    monkeypatch.setenv("FSEG_FUSED_EDGE_TAIL", "1")
    import numpy as np
    from fissure_segmentation_tpu_torch.data.dataset import PointDataset
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_dataset
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    from fissure_segmentation_tpu_torch.models.ensemble import build_subsets
    from fissure_segmentation_tpu_torch.train import evaluation
    case = make_synthetic_dataset(1, n_points=1500, gt_surfaces=True)[0]
    ds = PointDataset([case], sample_points=256)
    g = torch.Generator().manual_seed(3)
    draws = [{"subsets": build_subsets(1500, 256, 6, g),
              "surface": {c: (torch.rand(4000, generator=g),
                              torch.rand((4000, 2), generator=g))
                          for c in (1, 2, 3)}}]
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(case["labels"]).long(), 4).float()
    pts = torch.as_tensor(case["coords"])
    res = {}
    for dev in ("cuda", "cpu"):
        model = DGCNNSeg(k=8, in_features=4, num_classes=4, dynamic=False,
                         generator=torch.Generator().manual_seed(1)
                         ).to(dev).eval()
        table, lab = pts.to(dev), onehot.to(dev)

        def biased(v, model=model, table=table, lab=lab):
            d = ((v[..., None, :3] - table) ** 2).sum(-1)
            return model(v) + lab[d.argmin(-1)]
        res[dev] = evaluation.test_pipeline(
            ds, biased, str(tmp_path / dev), sample_points=256,
            n_runs_min=6, grid_res=(32, 32, 32), device=dev, draws=draws)
    np.testing.assert_array_equal(res["cuda"]["dice"], res["cpu"]["dice"])
    for k in ("assd", "sdsd", "hd", "hd95"):
        assert np.isfinite(res["cpu"][k]).all(), k
        np.testing.assert_allclose(res["cuda"][k], res["cpu"][k], rtol=1e-2,
                                   err_msg=k)


# ---- the PC-AE and DSEG-AE ----------------------------------------------------

def test_knn_padding_graph_with_far_points(cuda):
    """DSEG-AE's padding graph: kk = 2 on a cloud whose invalid points all
    sit at 1e6 (distances about 3e12 to the valid ones, 0 among
    themselves, ties to the lower index), a class of 12 % and of 30
    points valid: indices and distances equal to plain."""
    for n_valid in (None, 30):
        x = _uniform((1, 5000, 3), 40)
        if n_valid is None:
            x[torch.rand((1, 5000), generator=torch.Generator().manual_seed(
                41)) >= 0.12] = 1e6
        else:
            x[:, n_valid:] = 1e6
        got = knn_cuda(x.to(cuda), 1, False)
        want = knn_plain(x.to(cuda), 1, False)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("c", [128, 256])
def test_scatter_rows_at_the_pcae_widths(cuda, c):
    """K2 at the PC-AE encoder's gather backward (K1 graph, k = 20,
    self-loop) for C = 128 and 256, f32: within the rounding bound of the
    plain version, with its own and a shared transpose."""
    x = _uniform((4, 1024, 3), 42).to(cuda)
    idx = knn_cuda(x, 20, True)[0].reshape(4, 1024 * 20).contiguous()
    g = torch.randn((4, 1024 * 20, c), generator=torch.Generator(
        device=cuda).manual_seed(43), device=cuda)
    want = ks.scatter_rows_plain(idx, g, 1024)
    for tr in (None, ks.transpose(idx, 1024)):
        got = ks.scatter_rows(idx, g, 1024, tr)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("static", [False, True])
def test_pcae_step_with_transposes_equals_step_without(cuda, static,
                                                       monkeypatch):
    """The PC-AE's train step builds one transpose per graph (four
    dynamic, one static) and hands it to K2; the same step given none
    gives the same loss and bit-equal gradients."""
    from fissure_segmentation_tpu_torch.models import folding_net
    from fissure_segmentation_tpu_torch.losses import chamfer_loss
    model0 = folding_net.DGCNNFoldingNet(
        k=10, n_embedding=64, shape_type="plane", n_input_points=256,
        decode_mesh=False, static=static,
        generator=torch.Generator().manual_seed(5)).to(cuda).train()
    x = _uniform((3, 256, 3), 44).to(cuda)
    import copy

    def step():
        m = copy.deepcopy(model0)
        loss, _ = chamfer_loss(m(x), x)
        loss.backward()
        return loss, [p.grad for p in m.parameters()]
    before = ks.transpose.launches
    l1, g1 = step()
    assert ks.transpose.launches - before == (1 if static else 4)
    monkeypatch.setattr(folding_net, "_graph_transpose", lambda *a: None)
    l2, g2 = step()
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_dseg_reconstruct_on_card_equals_cpu(cuda, monkeypatch):
    """DSEG-AE's reconstruct from the same labels and draws (both sides on
    the fused tail's route): the padded
    cloud (K1 at kk = 2 with 1e6 points), the masked FPS (K5) and the AE
    forward on the card give the CPU's vertices within 1e-4 of their
    scale."""
    monkeypatch.setenv("FSEG_FUSED_EDGE_TAIL", "1")
    import numpy as np
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_dataset
    from fissure_segmentation_tpu_torch.models import (DGCNNFoldingNet,
                                                       DGCNNSeg, dseg_ae)
    case = make_synthetic_dataset(1, n_points=3000, seed=2)[0]
    pc = torch.as_tensor(np.concatenate([case["coords"], case["features"]],
                                        1))
    labels = torch.as_tensor(case["labels"]).long()
    g = torch.Generator().manual_seed(6)
    seg = DGCNNSeg(k=8, in_features=4, num_classes=4, generator=g).eval()
    ae = DGCNNFoldingNet(k=10, n_embedding=64, shape_type="plane",
                         n_input_points=400, generator=g).eval()
    draws = [{"extend": (torch.rand((1, 3000), generator=g),
                         torch.randn((1, 3000, 3), generator=g),
                         torch.randn((1, 3000, 1), generator=g))}
             for _ in range(3)]
    out = {}
    for dev in ("cpu", cuda):
        m = dseg_ae.RegularizedSegDGCNN(copy_to(seg, dev), copy_to(ae, dev),
                                        256, 400, "farthest",
                                        random_extend=True)
        out[str(dev)] = m.reconstruct(pc.to(dev), labels.to(dev),
                                      draws=draws)
    for a, b in zip(out[str(cuda)], out["cpu"]):
        va, vb = a[0].cpu(), b[0]
        assert (va - vb).abs().max() <= 1e-4 * vb.abs().max()


def copy_to(model, dev):
    import copy
    return copy.deepcopy(model).to(dev)


# ---- the approximate top-k's bin kernel, serving's determinism --------------

BIN_CASES = [
    # (rows, n, L, R): the detector's rank-1 row, the kNN rows, a row off
    # L * R (padding), bins past the row's end, R = 1
    (1, 1 << 20, 1 << 15, 32),
    (300, 2048, 512, 4),
    (7, 5000, 1024, 5),
    (3, 100, 128, 1),
    (2, 4096, 4096, 1),
]


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n,n_bins,red", BIN_CASES)
def test_bin_extrema_kernel_equals_plain(cuda, rows, n, n_bins, red, dtype,
                                         largest):
    """Bit for bit, values and first-occurrence indices, on integer-valued
    scores full of ties with a masked share (+-inf)."""
    from fissure_segmentation_tpu_torch.kernels.approx_topk import (
        bin_extrema, bin_extrema_plain)
    g = torch.Generator().manual_seed(rows + n)
    x = torch.randint(0, 20, (rows, n), generator=g).to(dtype)
    x[torch.rand((rows, n), generator=g) < 0.3] = \
        -torch.inf if largest else torch.inf
    x = x.to(cuda)
    before = bin_extrema.launches
    vk, ik = bin_extrema(x, n_bins, red, largest)
    torch.cuda.synchronize()
    vp, ip = bin_extrema_plain(x, n_bins, red, largest)
    assert bin_extrema.launches == before + 1
    assert torch.equal(ik, ip) and torch.equal(vk, vp)
    assert vk.dtype == dtype and ik.dtype == torch.int32


def test_bin_extrema_kernel_checks_input(cuda):
    from fissure_segmentation_tpu_torch.kernels.approx_topk import \
        bin_extrema
    x = torch.zeros((2, 100), device=cuda)
    with pytest.raises(ValueError, match="exceed"):
        bin_extrema(x, 10, 5)
    with pytest.raises(TypeError):
        bin_extrema(x.half(), 128, 1)
    with pytest.raises(ValueError, match="contiguous"):
        bin_extrema(torch.zeros((100, 2), device=cuda).T, 128, 1)


SELECT_CASES = [
    # (rows, n, L, R): the kNN rows (L = 512 x 4) with a row count off the
    # 8 rows a block handles, n off L * R, bins past the row's end (L > n),
    # R = 1 (the exact feature graph), odd n (one element a lane, no
    # vectors), and the fast-serving static graph's rows
    (300, 2048, 512, 4),
    (7, 5000, 1024, 5),
    (3, 100, 128, 1),
    (13, 2048, 2048, 1),
    (9, 1001, 1001, 1),
    (2, 4099, 1024, 5),
]
SELECT_KS = (1, 20, 40, 41, 128)


def _tied_scores(rows, n, seed, dtype, largest):
    """Integer-valued scores full of ties, signed zeros, negative values and
    a masked share at -inf (+inf for the minimum)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-10, 11, (rows, n), generator=g).float()
    zero = x == 0
    x[zero] = torch.where(torch.rand(int(zero.sum()), generator=g) < 0.5,
                          -0.0, 0.0)
    x[torch.rand((rows, n), generator=g) < 0.25] = \
        -torch.inf if largest else torch.inf
    return x.to(dtype)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n,n_bins,red", SELECT_CASES)
def test_select_rows_kernel_equals_plain(cuda, rows, n, n_bins, red, dtype,
                                         largest):
    """The fused row selection bit for bit against its plain version (the
    bin pass's plain version, then the aggregation), for k in SELECT_KS up
    to min(n, L): values with their own bits (-0.0 kept) and indices, int64
    and int32, also from a row start off 16 bytes; one launch a call."""
    from fissure_segmentation_tpu_torch.kernels.approx_topk import (
        select_rows, select_rows_plain)
    x = _tied_scores(rows, n, rows + n, dtype, largest).to(cuda)
    off = torch.empty(rows * n + 1, dtype=dtype, device=cuda)[1:].view(
        rows, n).copy_(x)
    for k in SELECT_KS:
        if k > min(n, n_bins):
            continue
        vp, ip = select_rows_plain(x, n_bins, red, k, largest)
        before = select_rows.launches
        for src, index in ((x, torch.int64), (x, torch.int32),
                           (off, torch.int64)):
            vk, ik = select_rows(src, n_bins, red, k, largest,
                                 index_dtype=index)
            torch.cuda.synchronize()
            assert ik.dtype == index and vk.dtype == dtype
            assert torch.equal(ik.long(), ip), (k, index)
            assert torch.equal(vk, vp) and torch.equal(
                torch.signbit(vk), torch.signbit(vp)), (k, index)
        assert select_rows.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_rows_kernel_on_generic_scores(cuda, dtype):
    """Generic floats of both signs at the kNN rows' bins and at R = 1,
    both directions: equal to plain, and at R = 1 equal to torch.topk's
    values (no ties)."""
    from fissure_segmentation_tpu_torch.kernels.approx_topk import (
        select_rows, select_rows_plain)
    g = torch.Generator().manual_seed(40)
    x = torch.randn((1000, 2048), generator=g).to(cuda, dtype)
    for largest in (True, False):
        for n_bins, red, k in ((512, 4, 40), (2048, 1, 41), (2048, 1, 128)):
            got = select_rows(x, n_bins, red, k, largest)
            want = select_rows_plain(x, n_bins, red, k, largest)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
        exact = torch.topk(x.float(), 41, dim=-1, largest=largest).values
        assert torch.equal(select_rows(x, 2048, 1, 41, largest)[0].float(),
                           exact)


def test_select_rows_kernel_checks_input(cuda):
    from fissure_segmentation_tpu_torch.kernels.approx_topk import \
        select_rows
    x = torch.zeros((2, 300), device=cuda)
    with pytest.raises(ValueError, match="outside"):
        select_rows(x, 300, 1, 129)
    with pytest.raises(ValueError, match="exceed"):
        select_rows(x, 10, 5, 3)
    with pytest.raises(TypeError):
        select_rows(x.half(), 300, 1, 5)
    with pytest.raises(ValueError, match="contiguous"):
        select_rows(torch.zeros((300, 2), device=cuda).T, 300, 1, 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_feature_knn_on_card_equals_the_sort(cuda, dtype):
    """feature_knn on the card (the fused selection at one element a bin)
    equals the stable sort it replaced on the same distances, indices and
    distances: generic features at the default run's (4, 2048, 64), kk =
    41, and dyadic ones full of ties at kk = 1, 40, 128."""
    from fissure_segmentation_tpu_torch.kernels.approx_topk import \
        select_rows
    from fissure_segmentation_tpu_torch.ops.knn import (feature_knn,
                                                        pairwise_sqdist)
    g = torch.Generator().manual_seed(41)
    generic = torch.randn((4, 2048, 64), generator=g)
    dyadic = torch.randint(-16, 17, (3, 700, 64), generator=g) / 16.0
    for x, kks in ((generic, (41,)), (dyadic, (1, 40, 128))):
        x = x.to(cuda, dtype)
        d = pairwise_sqdist(x)
        sd, si = torch.sort(d, dim=-1, stable=True)
        for kk in kks:
            before = select_rows.launches
            idx, dist = feature_knn(x, kk)
            assert select_rows.launches == before + 1
            assert idx.dtype == torch.int32 and dist.dtype == dtype
            assert torch.equal(idx, si[..., :kk].to(torch.int32))
            assert torch.equal(dist, sd[..., :kk])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_approx_knn_on_card_equals_plain(cuda, dtype):
    """The approximate graph on the card (the fused row selection) equals
    the one its plain version selects from the same distances, at N = 2048
    (four scores a bin); self in slot 0."""
    from fissure_segmentation_tpu_torch.ops.approx_topk import \
        approx_top_k_plain
    from fissure_segmentation_tpu_torch.ops.knn import (approx_knn,
                                                        pairwise_sqdist)
    x = _uniform((4, 2048, 3), 31).to(cuda, dtype)
    idx, dist = approx_knn(x, 40, True, 0.9)
    d = pairwise_sqdist(x, x)
    d.diagonal(dim1=-2, dim2=-1).fill_(-1.0)
    want_d, want_i = approx_top_k_plain(d, 40, 0.9, largest=False)
    assert torch.equal(idx, want_i.to(torch.int32))
    assert torch.equal(dist, want_d.clamp(min=0.0))
    assert (idx[..., 0] == torch.arange(2048, device=cuda)).all()


def test_splat_deterministic_on_card_equals_cpu(cuda):
    """The splat's sorted scatter on the card: the same bits from run to
    run, and with three features a cell equal to the CPU's index_add_,
    which adds in the same order; with one feature the same from run to
    run, and its gradient a gather."""
    from fissure_segmentation_tpu_torch.ops.splat import point_rasterize
    g = torch.Generator().manual_seed(32)
    pts = torch.rand((3, 5000, 3), generator=g) ** 3   # crowded cells
    vals = torch.randn((3, 5000, 3), generator=g)
    want = point_rasterize(pts, vals, (32, 32, 32))
    a = point_rasterize(pts.to(cuda), vals.to(cuda), (32, 32, 32))
    b = point_rasterize(pts.to(cuda), vals.to(cuda), (32, 32, 32))
    assert torch.equal(a, b) and torch.equal(a.cpu(), want)
    one = vals[..., :1].to(cuda).requires_grad_(True)
    c = point_rasterize(pts.to(cuda), one, (32, 32, 32))
    assert torch.equal(c, point_rasterize(pts.to(cuda), one, (32, 32, 32)))
    torch.testing.assert_close(c.detach().cpu(),
                               point_rasterize(pts, vals[..., :1],
                                               (32, 32, 32)),
                               rtol=1e-5, atol=1e-5)
    c.square().sum().backward()
    ref = vals[..., :1].clone().requires_grad_(True)
    point_rasterize(pts, ref, (32, 32, 32)).square().sum().backward()
    torch.testing.assert_close(one.grad.cpu(), ref.grad, rtol=1e-5,
                               atol=1e-5)


def test_segment_cases_on_card_equals_a_loop(cuda):
    """Three cases of a 64^3 sheet: segment_cases, threaded and not, bit
    for bit equal to a loop of segment_case with the same generators; the
    fast variant too."""
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    from fissure_segmentation_tpu_torch.serving import (case_generator,
                                                        segment_case,
                                                        segment_cases)
    rng = np.random.default_rng(0)
    img = rng.normal(-700, 80, (64, 64, 64)).astype(np.float32)
    zz, yy, _ = np.meshgrid(*[np.arange(64)] * 3, indexing="ij")
    img[np.abs(zz - (28 + 0.2 * yy)) < 1.0] = -300.0
    vol = torch.from_numpy(img).to(cuda)
    mask = torch.ones(vol.shape, dtype=torch.bool, device=cuda)
    cfg = dict(max_kpts=4000, sample_points=512, n_runs_min=8,
               subset_batch=2, grid_res=(32, 32, 32), center_x=32.0)
    for kw in ({}, {"dtype": torch.bfloat16, "knn_recall": 0.9}):
        model = DGCNNSeg(k=20, in_features=3, num_classes=4, dynamic=False,
                         generator=torch.Generator().manual_seed(0),
                         **kw).to(cuda).eval()
        fast = dict(approx_top_k=bool(kw))
        loop = [segment_case(vol, mask, model, case_generator(3, i), **cfg,
                             **fast) for i in range(3)]
        for threads in (True, False):
            got = segment_cases([vol] * 3, [mask] * 3, model, seed=3,
                                pipeline_threads=threads, **cfg, **fast)
            for a, b in zip(got, loop):
                assert np.array_equal(a.kpts, b.kpts)
                assert np.array_equal(a.labels, b.labels)
                assert np.array_equal(a.labelmap, b.labelmap)
                for (t1, v1), (t2, v2) in zip(a.meshes, b.meshes):
                    assert np.array_equal(t1, t2) and np.array_equal(v1, v2)


# ---- the fused EdgeConv tail and knn(query_chunk=) ----------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_tail_on_card_equals_cpu(cuda, dtype):
    """FusedEdgeTail in train mode on (2, 512, 20, 64) edges, card against
    CPU from the same weights: the output within 1e-5 (f32) / 2^-7 (bf16)
    of its largest entry, the running statistics within 1e-5, the
    gradients of the edges, the kernel, the scale and the bias within
    1e-4 (f32) / 2e-2 (bf16) in relative L2 (cuBLAS and the CPU sum the
    product's terms in other orders)."""
    from fissure_segmentation_tpu_torch.models.blocks import FusedEdgeTail
    g = torch.Generator().manual_seed(21)
    tail = FusedEdgeTail(64, 64, generator=g, dtype=dtype)
    with torch.no_grad():
        tail.BatchNorm_0.scale.copy_(torch.randn(64, generator=g) + 0.3)
    e = torch.randn((2, 512, 20, 64), generator=g)
    w = torch.randn((2, 512, 64), generator=g)
    outs = {}
    for dev in ("cpu", cuda):
        t = copy.deepcopy(tail).to(dev).train()
        ed = e.to(dev).clone().requires_grad_(True)
        out = t(ed)
        (out.float() * w.to(dev)).sum().backward()
        outs[str(dev)] = [out.detach().float().cpu(), ed.grad.float().cpu(),
                          t.Dense_0.weight.grad.cpu(),
                          t.BatchNorm_0.scale.grad.cpu(),
                          t.BatchNorm_0.bias.grad.cpu(),
                          t.BatchNorm_0.mean.cpu(), t.BatchNorm_0.var.cpu()]
    c, d = outs["cpu"], outs[str(cuda)]
    f32 = dtype == torch.float32
    assert (d[0] - c[0]).abs().max() <= (1e-5 if f32 else 2 ** -7) * \
        c[0].abs().max()
    for a, b in zip(d[1:5], c[1:5]):
        assert (a - b).norm() <= (1e-4 if f32 else 2e-2) * b.norm()
    for a, b in zip(d[5:], c[5:]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,dtype", [(3, torch.float32),
                                     (64, torch.float32),
                                     (64, torch.bfloat16)])
def test_knn_query_chunk_on_card_equals_unchunked(cuda, c, dtype):
    """knn(query_chunk=) on the card selects the unchunked call's indices
    and distances exactly: K1's route (C = 3) and the feature route."""
    from fissure_segmentation_tpu_torch.ops.knn import knn
    x = _uniform((2, 2048, c), 31).to(dtype).to(cuda)
    whole = knn(x, 40, self_loop=True, return_dist=True)
    part = knn(x, 40, self_loop=True, return_dist=True, query_chunk=256)
    assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])
