"""Linear algebra: the port of ``paddle_tpu/tensor/linalg.py``, over
``torch.linalg``.  ``eig`` and ``eigvals`` compute on the host, as the JAX
ones do; ``slogdet`` returns ``[sign, logdet]`` stacked; ``lu`` gives
1-based pivots; ``cross``'s default axis is the first of size 3.
``svd_lowrank`` and ``pca_lowrank`` take the exact SVD's leading ``q``
triplets, as the JAX functions do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import run_op
from ..core.tensor import to_tensor
from .math import addmm, bmm, dot, matmul, mm  # noqa: F401  (re-export)


def _ensure(x):
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def einsum(equation, *operands):
    ts = [_ensure(o) for o in operands]
    return run_op("einsum", lambda *xs: torch.einsum(equation, *xs), *ts)


def _is_inf(p, sign):
    return isinstance(p, (int, float)) and p == sign * float("inf")


def norm(x, p=None, axis=None, keepdim=False, name=None):
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2

    def f(v):
        if axis is None:
            flat = v.reshape(-1)
            if p in ("fro", 2):
                return torch.linalg.vector_norm(flat)
            if _is_inf(p, 1):
                return torch.max(torch.abs(flat))
            if _is_inf(p, -1):
                return torch.min(torch.abs(flat))
            if p == 0:
                return torch.sum(flat != 0).to(v.dtype)
            return torch.sum(torch.abs(flat) ** p) ** (1.0 / p)
        if isinstance(axis, (list, tuple)):
            return torch.linalg.matrix_norm(v, ord=p, dim=tuple(axis),
                                            keepdim=keepdim)
        return torch.linalg.vector_norm(v, ord=p, dim=axis, keepdim=keepdim)

    return run_op("norm", f, _ensure(x))


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return run_op("vector_norm", lambda v: torch.linalg.vector_norm(
        v, ord=p, dim=ax, keepdim=keepdim), _ensure(x))


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return run_op("matrix_norm", lambda v: torch.linalg.matrix_norm(
        v, ord=p, dim=tuple(axis), keepdim=keepdim), _ensure(x))


def _dist(a, b, p):
    d = (a - b).reshape(-1)
    if p == 0:
        return torch.sum(d != 0).to(a.dtype)
    if _is_inf(p, 1):
        return torch.max(torch.abs(d))
    if _is_inf(p, -1):
        return torch.min(torch.abs(d))
    return torch.sum(torch.abs(d) ** p) ** (1.0 / p)


def dist(x, y, p=2, name=None):
    return run_op("dist", lambda a, b: _dist(a, b, p), _ensure(x),
                  _ensure(y))


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    def f(a, b):
        diff = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.sum(diff * diff, -1) + 1e-30)
        return torch.sum(torch.abs(diff) ** p, -1) ** (1.0 / p)

    return run_op("cdist", f, _ensure(x), _ensure(y))


def cross(x, y, axis=9, name=None):
    def f(a, b):
        ax = axis
        if ax == 9:          # Paddle's default: the first axis of size 3
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=ax)

    return run_op("cross", f, _ensure(x), _ensure(y))


def cholesky(x, upper=False, name=None):
    return run_op("cholesky", lambda v: torch.linalg.cholesky(
        v, upper=upper), _ensure(x))


def cholesky_solve(x, y, upper=False, name=None):
    return run_op("cholesky_solve", lambda b, L: torch.cholesky_solve(
        b, L, upper=upper), _ensure(x), _ensure(y))


def qr(x, mode="reduced", name=None):
    if mode == "r":
        return run_op("qr", lambda v: torch.linalg.qr(v, mode="r")[1],
                      _ensure(x))
    return tuple(run_op("qr", lambda v: tuple(torch.linalg.qr(v, mode=mode)),
                        _ensure(x)))


def svd(x, full_matrices=False, name=None):
    return tuple(run_op("svd", lambda v: tuple(torch.linalg.svd(
        v, full_matrices=full_matrices)), _ensure(x)))


def svdvals(x, name=None):
    return run_op("svdvals", torch.linalg.svdvals, _ensure(x))


def _leading(v, q):
    u, s, vh = torch.linalg.svd(v, full_matrices=False)
    return u[..., :q], s[..., :q], vh.transpose(-1, -2)[..., :q]


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    return tuple(run_op("svd_lowrank", lambda v: _leading(v, q),
                        _ensure(x)))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    xv = _ensure(x)
    k = q if q is not None else min(6, *xv.shape[-2:])

    def f(v):
        if center:
            v = v - torch.mean(v, -2, keepdim=True)
        return _leading(v, k)

    return tuple(run_op("pca_lowrank", f, xv))


def inv(x, name=None):
    return run_op("inv", torch.linalg.inv, _ensure(x))


inverse = inv


def det(x, name=None):
    return run_op("det", torch.linalg.det, _ensure(x))


def slogdet(x, name=None):
    return run_op("slogdet", lambda v: torch.stack(
        tuple(torch.linalg.slogdet(v)), 0), _ensure(x))


def solve(x, y, name=None):
    def f(a, b):
        if b.dim() == a.dim() - 1:
            return torch.linalg.solve(a, b[..., None])[..., 0]
        return torch.linalg.solve(a, b)

    return run_op("solve", f, _ensure(x), _ensure(y))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def f(a, b):
        if transpose:
            a = a.transpose(-1, -2)
            up = not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return run_op("triangular_solve", f, _ensure(x), _ensure(y))


def lstsq(x, y, rcond=None, driver=None, name=None):
    def f(a, b):
        r = torch.linalg.lstsq(a, b, rcond=rcond, driver="gelsd"
                               if a.device.type == "cpu" else None)
        return r.solution, r.residuals, r.rank, r.singular_values

    return tuple(run_op("lstsq", f, _ensure(x), _ensure(y)))


def lu(x, pivot=True, get_infos=False, name=None):
    out = run_op("lu", lambda v: tuple(torch.linalg.lu_factor(v)),
                 _ensure(x))
    lu_, piv = out[0], out[1].to(torch.int32)     # torch's are 1-based too
    if get_infos:
        return lu_, piv, torch.zeros(1, dtype=torch.int32, device=lu_.device)
    return lu_, piv


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    return tuple(run_op("lu_unpack", lambda a, p: tuple(torch.lu_unpack(
        a, p.to(torch.int32))), _ensure(x), _ensure(y)))


def eig(x, name=None):
    """A host op (numpy's LAPACK), as the JAX one."""
    t = _ensure(x)
    w, v = np.linalg.eig(t.detach().cpu().numpy())
    return to_tensor(w, place=t.device), to_tensor(v, place=t.device)


def eigh(x, UPLO="L", name=None):
    return tuple(run_op("eigh", lambda v: tuple(torch.linalg.eigh(
        (v + v.transpose(-1, -2).conj()) / 2)), _ensure(x)))


def eigvals(x, name=None):
    t = _ensure(x)
    return to_tensor(np.linalg.eigvals(t.detach().cpu().numpy()),
                     place=t.device)


def eigvalsh(x, UPLO="L", name=None):
    return run_op("eigvalsh", lambda v: torch.linalg.eigvalsh(v, UPLO=UPLO),
                  _ensure(x))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return run_op("pinv", lambda v: torch.linalg.pinv(
        v, rtol=rcond, hermitian=hermitian), _ensure(x))


def matrix_power(x, n, name=None):
    return run_op("matrix_power", lambda v: torch.linalg.matrix_power(v, n),
                  _ensure(x))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    def f(v):
        if tol is None:
            return torch.linalg.matrix_rank(v, hermitian=hermitian)
        return torch.linalg.matrix_rank(v, atol=tol, rtol=0.0,
                                        hermitian=hermitian)

    return run_op("matrix_rank", f, _ensure(x))


def matrix_exp(x, name=None):
    return run_op("matrix_exp", torch.linalg.matrix_exp, _ensure(x))


def multi_dot(x, name=None):
    ts = [_ensure(t) for t in x]
    return run_op("multi_dot", lambda *xs: torch.linalg.multi_dot(xs), *ts)


def householder_product(x, tau, name=None):
    return run_op("householder_product", torch.linalg.householder_product,
                  _ensure(x), _ensure(tau))


def corrcoef(x, rowvar=True, name=None):
    return run_op("corrcoef", lambda v: torch.corrcoef(
        v if rowvar else v.t()), _ensure(x))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return run_op("cov", lambda v: torch.cov(
        v if rowvar else v.t(), correction=1 if ddof else 0,
        fweights=fweights, aweights=aweights), _ensure(x))


def mv(x, vec, name=None):
    return run_op("mv", lambda m, v: m @ v, _ensure(x), _ensure(vec))


def cond(x, p=None, name=None):
    """The condition number: ``norm(x, p) * norm(inv(x), p)``, or the
    singular values' ratio for ``p`` in {None, 2, -2}."""
    def f(m):
        if p is None or p in (2, -2):
            s = torch.linalg.svdvals(m)
            smax, smin = s[..., 0], s[..., -1]
            return smax / smin if p != -2 else smin / smax
        return (torch.linalg.matrix_norm(m, ord=p)
                * torch.linalg.matrix_norm(torch.linalg.inv(m), ord=p))

    return run_op("cond", f, _ensure(x))
