"""K1 on the card: the CUDA kernel against its plain PyTorch version.

These tests need an NVIDIA card and skip elsewhere. The repository's
tests/conftest.py imports jax, which the card's machine does not have, so
run them there without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

This file imports no jax.
"""
import pytest
import torch

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
