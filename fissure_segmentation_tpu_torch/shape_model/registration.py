"""Point-cloud registration: thin-plate splines and coherent point drift
(counterpart of shape_model/registration.py).

`TPS` and `thin_plate_dense` fit and evaluate a thin-plate spline and
interpolate its displacements densely (align_corners=True upsampling).
`register_cpd_rigid` and `register_cpd_deformable` are CPD's EM loops on
the tensors' device: dense Gaussian responsibilities, the closed-form
similarity M-step (a 3x3 SVD) and the Tikhonov-regularized Gaussian-kernel
M-step (a dense solve).

The E-step's squared distances are summed coordinate by coordinate into
one (M, N) buffer, never an (M, N, 3) temporary (1.8 GB at 12 288 points
a side), in the JAX package's order: sum over coordinates of (q - k)^2,
not |q|^2 - 2 q.k + |k|^2, so near-ties resolve alike. The loops keep
their state on the device and read nothing back while they run: the
deformable solve is `solve_ex`, its info checked once after the loop.
The rigid M-step's 3x3 SVD is the one host synchronisation an iteration
(torch checks LAPACK's info of every SVD). The products run in float32:
with TF32 on, CUDA inputs raise.
"""
from __future__ import annotations

import math

import torch


def _check_precision(x: torch.Tensor) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("registration needs float32 products; set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


# ------------------------------ TPS ------------------------------


class TPS:
    @staticmethod
    def d(a, b):
        ra = (a ** 2).sum(1)[:, None]
        rb = (b ** 2).sum(1)[None]
        dist = torch.clamp(ra + rb - (2.0 * a) @ b.T, min=0.0)
        return torch.sqrt(dist)

    @staticmethod
    def u(r):
        return (r ** 2) * torch.log(r + 1e-6)

    @staticmethod
    def fit(c, f, lambd: float = 0.0):
        _check_precision(c)
        n = c.shape[0]
        k = TPS.u(TPS.d(c, c)) + torch.eye(n, device=c.device) * lambd
        p = torch.cat([torch.ones((n, 1), device=c.device), c], 1)
        a = torch.zeros((n + 4, n + 4), device=c.device)
        a[:n, :n] = k
        a[:n, -4:] = p
        a[-4:, :n] = p.T
        v = torch.zeros((n + 4, f.shape[1]), device=c.device)
        v[:n] = f
        return torch.linalg.solve(a, v)

    @staticmethod
    def z(x, c, theta):
        u = TPS.u(TPS.d(x, c))
        w, aff = theta[:-4], theta[-4:]
        b = u @ w
        return (aff[0][None] + x[:, :1] * aff[1][None]
                + x[:, 1:2] * aff[2][None] + x[:, 2:3] * aff[3][None] + b)


def thin_plate_dense(x1, y1, shape, step: int = 4, lambd: float = 0.0):
    """Dense TPS displacement field.

    :param x1: (1, N, 3) control points in [-1, 1] (xyz)
    :param y1: (1, N, 3) displacements at control points
    :param shape: (D, H, W) output field shape
    :return: (1, D, H, W, 3) dense displacement field
    """
    d, h, w = shape
    d1, h1, w1 = d // step, h // step, w // step
    dev = x1.device
    # affine_grid identity with align_corners=True: linspace(-1, 1, n)
    zz, yy, xx = torch.meshgrid(torch.linspace(-1, 1, d1, device=dev),
                                torch.linspace(-1, 1, h1, device=dev),
                                torch.linspace(-1, 1, w1, device=dev),
                                indexing="ij")
    x2 = torch.stack([xx, yy, zz], -1).reshape(-1, 3)
    theta = TPS.fit(x1[0], y1[0], lambd)
    y2 = TPS.z(x2, x1[0], theta).reshape(d1, h1, w1, 3)
    return _upsample_linear_corners(y2, (d, h, w))[None]


def _upsample_linear_corners(vol: torch.Tensor, out_shape) -> torch.Tensor:
    """(D1, H1, W1, C) -> (*out_shape, C) linear resize, align_corners=True:
    output i samples input i * (n_in - 1) / (n_out - 1), one axis at a
    time (two gathers and a lerp each)."""
    for axis, n_out in enumerate(out_shape):
        n_in = vol.shape[axis]
        if n_in == n_out:
            continue
        if n_in == 1 or n_out == 1:
            idx = torch.zeros((n_out,), dtype=torch.int64, device=vol.device)
            vol = torch.index_select(vol, axis, idx)
            continue
        pos = torch.linspace(0.0, n_in - 1.0, n_out, device=vol.device)
        lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, n_in - 2)
        w = (pos - lo).reshape([-1 if a == axis else 1
                                for a in range(vol.ndim)])
        vol = (torch.index_select(vol, axis, lo) * (1.0 - w)
               + torch.index_select(vol, axis, lo + 1) * w)
    return vol


# ------------------------------ CPD ------------------------------


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, N) sum over coordinates of (a_i - b_j)^2, accumulated in place
    one coordinate at a time."""
    d2 = (a[:, None, 0] - b[None, :, 0]) ** 2
    for c in range(1, a.shape[1]):
        d2 += (a[:, None, c] - b[None, :, c]) ** 2
    return d2


def _cpd_estep(x, y_t, sigma2, w_outlier):
    """Gaussian-mixture responsibilities P (M x N) for targets x (N, 3),
    transformed sources y_t (M, 3); one (M, N) buffer, updated in place."""
    n, m = x.shape[0], y_t.shape[0]
    p = _sqdist(y_t, x).neg_().div_(2 * sigma2).exp_()
    c = ((2 * math.pi * sigma2) ** 1.5) * (w_outlier / (1 - w_outlier)) \
        * m / n
    den = p.sum(0, keepdim=True) + c
    return p.div_(torch.clamp(den, min=1e-12))


def _det3(a: torch.Tensor) -> torch.Tensor:
    return torch.dot(a[0], torch.linalg.cross(a[1], a[2]))


def register_cpd_rigid(x: torch.Tensor, y: torch.Tensor,
                       w_outlier: float = 0.0, max_iter: int = 100):
    """Rigid(+scale) CPD of source y onto target x (pycpd
    RigidRegistration).

    :param x: (N, 3) target, :param y: (M, 3) source, float32 on one device
    :return: (y_registered (M, 3), (scale (), R (3, 3), t (3,))), tensors
    """
    _check_precision(x)
    dev = x.device
    n, m = x.shape[0], y.shape[0]
    sigma2 = _sqdist(y, x).mean() / 3.0
    kw = dict(device=dev, dtype=x.dtype)
    s = torch.ones((), **kw)
    r = torch.eye(3, **kw)
    t = torch.zeros(3, **kw)
    for _ in range(max_iter):
        y_t = (s * y) @ r.T + t
        p = _cpd_estep(x, y_t, sigma2, w_outlier)
        p0, p1 = p.sum(0), p.sum(1)
        np_ = p.sum()
        mu_x = (p0 @ x) / np_
        mu_y = (p1 @ y) / np_
        xh = x - mu_x
        yh = y - mu_y
        a = xh.T @ (p.T @ yh)  # (3, 3) = X^T P^T Y
        del p
        u, _, vt = torch.linalg.svd(a)
        c = torch.diag(torch.stack([s.new_ones(()), s.new_ones(()),
                                    torch.sign(_det3(u @ vt))]))
        r = u @ c @ vt
        denom = (p1 * (yh ** 2).sum(1)).sum()
        tr = torch.trace(a.T @ r)
        s = tr / torch.clamp(denom, min=1e-12)
        t = mu_x - s * r @ mu_y
        tr_x = (p0 * (xh ** 2).sum(1)).sum()
        sigma2 = torch.clamp((tr_x - s * tr) / (np_ * 3.0), min=1e-8)
    return (s * y) @ r.T + t, (s, r, t)


def register_cpd_deformable(x: torch.Tensor, y: torch.Tensor,
                            alpha: float = 0.01, beta: float = 10.0,
                            w_outlier: float = 0.0, max_iter: int = 100):
    """Deformable CPD (pycpd DeformableRegistration).

    :param x: (N, 3) target, :param y: (M, 3) source, float32 on one device
    :return: (y_registered (M, 3), displacements G @ W (M, 3))
    :raises RuntimeError: when a solve met a singular system
    """
    _check_precision(x)
    dev = x.device
    m = y.shape[0]
    g = _sqdist(y, y).neg_().div_(2 * beta ** 2).exp_()
    sigma2 = _sqdist(y, x).mean() / 3.0
    eye = torch.eye(m, device=dev, dtype=x.dtype)
    x2 = (x ** 2).sum(1)
    w_mat = torch.zeros((m, 3), device=dev, dtype=x.dtype)
    infos = []
    for _ in range(max_iter):
        y_t = y + g @ w_mat
        p = _cpd_estep(x, y_t, sigma2, w_outlier)
        p1 = p.sum(1)                       # (M,)
        pt1 = p.sum(0)                      # (N,)
        np_ = p1.sum()
        px = p @ x                          # (M, 3)
        del p
        a = p1[:, None] * g + alpha * sigma2 * eye
        b = px - p1[:, None] * y
        w_mat, info = torch.linalg.solve_ex(a, b)
        infos.append(info)
        y_new = y + g @ w_mat
        xpx = (pt1 * x2).sum()
        ypy = (p1 * (y_new ** 2).sum(1)).sum()
        tr_pxy = (y_new * px).sum()
        sigma2 = torch.clamp((xpx - 2 * tr_pxy + ypy) / (np_ * 3.0),
                             min=1e-8)
    if infos and bool(torch.stack(infos).any()):
        raise RuntimeError("register_cpd_deformable: singular system in "
                           "the M-step's solve")
    disp = g @ w_mat
    return y + disp, disp
