"""The kernels on the card (K1 kNN, K2-K4 scatter) against their plain
PyTorch versions.

These tests need an NVIDIA card and skip elsewhere. The repository's
tests/conftest.py imports jax, which the card's machine does not have, so
run them there without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports no jax.
"""
import pytest
import torch

from fissure_segmentation_tpu_torch.kernels import scatter as ks
from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda, knn_plain

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
