"""Localized statistical shape model, kernelized multi-level PCA
(counterpart of shape_model/lssm.py; a numpy copy of its fit, which
imports no JAX beyond building its result).

The sample covariance is Schur-multiplied with exponential locality
kernels over the mean shape's point distances at a halving distance
schedule; each level's eigenpairs are cut at the target variance of its
own spectrum, and the levels' subspaces are merged one after the other by
the closest-rotation merge with kernel decorrelation. Dense `eigh` and an
SVD replace the reference library's sampled eigensolver. The stored
"eigenvalues" are the merged covariance eigenvalues (variances), where
`fit_ssm` stores singular values: both are what the reference feeds its
consumers, and neither package harmonizes them.
"""
from __future__ import annotations

import numpy as np

from .ssm import SSMParams, _params


def _exp_kernel(dist2: np.ndarray, gamma: float,
                exponent: int = 2) -> np.ndarray:
    """exp(-gamma * d^exponent) (LPCALib/kernels.py:59-69, Euclidean d)."""
    d = np.sqrt(np.maximum(dist2, 0.0))
    return np.exp(-gamma * d ** exponent)


def _level_eigpairs(cov: np.ndarray, kernel: np.ndarray | None, max_rank: int,
                    target_variance: float):
    """Per-level subspace: top-max_rank eigenpairs of the (localized)
    covariance, cut at target variance of the retained spectrum
    (subspacemodels.py:331-355 with a dense eigh for eig_fast_spsd_kernel)."""
    c = cov if kernel is None else cov * kernel
    w, v = np.linalg.eigh(c)
    order = np.argsort(w)[::-1]
    w, v = np.maximum(w[order], 0.0), v[:, order]
    w, v = w[:max_rank], v[:, :max_rank]
    requested = w.sum() * target_variance
    rank = int(np.searchsorted(np.cumsum(w), requested)) + 1
    rank = min(max(rank, 1), len(w))
    return w[:rank], v[:, :rank]


def _sqrt_psd(a: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh((a + a.T) / 2)
    return v @ np.diag(np.sqrt(np.maximum(w, 0.0))) @ v.T


def _merge_closest_rotation_decorr(basis_a: np.ndarray, evals_a: np.ndarray,
                                   basis_b: np.ndarray, evals_b: np.ndarray):
    """Closest-rotation subspace merge with kernel-mode decorrelation
    (LPCALib/utils.py:426-516): embed A into the closest same-dimension
    subspace of span(A) ∪ span(B) (Ye & Lim 2014), carry both rotated
    eigenvalue blocks, then re-diagonalize and rescale the spectrum to
    sum(evals_b)."""
    if basis_a.shape[1] >= basis_b.shape[1]:
        return basis_a, evals_a                      # utils.py:434-435

    u, _, vt = np.linalg.svd(basis_a.T @ basis_b)
    v = vt.T
    rot_a = basis_a @ u
    rot_b = basis_b @ v
    ra, rb = basis_a.shape[1], basis_b.shape[1]
    new_basis = np.concatenate([rot_a, rot_b[:, ra:]], axis=1)   # (F, rb)

    rot_a_evs = u.T @ np.diag(evals_a) @ u
    rot_b_evs = vt @ np.diag(evals_b) @ v
    new_evs = np.zeros((rb, rb))
    new_evs[:ra, :ra] = rot_a_evs
    new_evs[ra:, ra:] = rot_b_evs[ra:, ra:]

    # decorrelation_mode='kernel' (utils.py:500-505): eigendecomposition of
    # new_basis @ new_evs @ new_basis.T restricted to its rank — via SVD of
    # new_basis @ chol(new_evs); we use an eigh-based PSD sqrt instead of
    # Cholesky so semidefinite blocks don't fail
    q, s, _ = np.linalg.svd(new_basis @ _sqrt_psd(new_evs),
                            full_matrices=False)
    vals = s ** 2
    vals = vals * (evals_b.sum() / max(vals.sum(), 1e-30))
    return q[:, :rb], vals[:rb]


def fit_lssm(train_shapes: np.ndarray, num_levels: int = 5,
             alpha: float = 2.5, target_variance: float = 0.95,
             max_rank: int | None = None) -> SSMParams:
    """Fit the localized SSM (LPCA.klpca, model.py:23-75).

    :param train_shapes: (N, P, 3) corresponding point sets (or (N, F) with
        F = 3P in [x0 y0 z0 x1 ...] layout)
    :return: SSMParams with the merged localized basis; defaults mirror the
        reference LSSM (num_levels=5, alpha=2.5, ssm.py:135-137).

    NB eigenvalue units mirror the reference's own inconsistency: LSSM
    stores what LPCA returns — covariance eigenvalues, i.e. VARIANCES
    (reference ssm.py:151 <- LPCA/model.py:65) — while fit_ssm stores SVD
    singular values (reference ssm.py:56 pca_lowrank S). Downstream
    consumers (DGSSM coefficient scaling, ssm_random_samples) see the same
    values the reference feeds them; do not "harmonize" the two fits.
    """
    x = np.asarray(train_shapes, np.float64)
    if x.ndim == 3:
        x = x.reshape(x.shape[0], -1)
    n, f = x.shape
    mean = x.mean(0, keepdims=True)
    xc = x - mean

    # distance schedule over the mean shape (model.py:30-42,145-159)
    mean_pts = mean.reshape(-1, 3)
    d2 = ((mean_pts[:, None] - mean_pts[None]) ** 2).sum(-1)  # (P, P)
    max_distance = float(np.sqrt(
        ((mean_pts.min(0) - mean_pts.max(0)) ** 2).sum()))
    schedule = max_distance * 0.5 ** np.arange(num_levels)
    gammas = 1.0 / (2.0 * (2.0 * schedule) ** 2)

    cov = xc.T @ xc / max(n - 1, 1)                  # CovKernel(1/(N-1))
    d2_full = np.repeat(np.repeat(d2, 3, 0), 3, 1)   # coordinate-expanded
    if max_rank is None:
        max_rank = min(n * 10, 200)                  # model.py:52

    basis = evals = None
    for lvl in range(num_levels):
        kernel = None if lvl == 0 else _exp_kernel(d2_full, gammas[lvl])
        w, v = _level_eigpairs(cov, kernel, max_rank, target_variance)
        if lvl == 0:
            basis, evals = v, w
        else:
            basis, evals = _merge_closest_rotation_decorr(basis, evals, v, w)

    return _params(mean, evals[None], basis[None], alpha, target_variance)
