"""Inner products and norms, Euclidean and B-weighted (counterpart of
:mod:`krypy_tpu.core.products`).

Blocks are ``(N, k)`` tensors.  Every value check runs on the values
themselves: there are no tracers in eager torch, so the JAX package's
``_is_concrete`` guard has no counterpart.
"""

import torch

from ..errors import InnerProductError
from .dtypes import asarray
from .operators import IdentityLinearOperator, LinearOperator, get_linearoperator

__all__ = [
    "ip_euclid",
    "inner",
    "norm_squared",
    "norm",
    "norm_MMlr",
    "orthonormality",
]


def _mm(X, Y):
    """``X @ Y`` in the promoted dtype (torch's matmul takes one dtype)."""
    dt = torch.promote_types(X.dtype, Y.dtype)
    return X.to(dt) @ Y.to(dt)


def ip_euclid(X, Y):
    """Euclidean block inner product :math:`X^* Y` for ``(N, m)`` x ``(N, n)``
    blocks, result ``(m, n)``."""
    return _mm(X.conj().T, Y)


def inner(X, Y, ip_B=None):
    """Block inner product :math:`\\langle X, Y\\rangle`.

    :param ip_B: ``None`` (Euclidean), a matrix/operator ``B`` giving
      :math:`X^* B Y`, or a callable ``ip_B(X, Y)``.

    B is applied to the narrower block.
    """
    X = asarray(X)
    Y = asarray(Y, device=X.device)
    if ip_B is None or isinstance(ip_B, IdentityLinearOperator):
        return _mm(X.conj().T, Y)
    (N, m) = X.shape
    n = Y.shape[1]
    if isinstance(ip_B, LinearOperator) or hasattr(ip_B, "shape"):
        B = get_linearoperator((N, N), ip_B, device=X.device)
        if m > n:
            return _mm(B.dot(X).conj().T, Y)
        return _mm(X.conj().T, B.dot(Y))
    # callable inner product
    return asarray(ip_B(X, Y), device=X.device)


def norm_squared(x, Mx=None, inner_product=ip_euclid):
    """Squared norm w.r.t. a given product; raises
    :class:`InnerProductError` on a (1, 1) value with a significant
    imaginary part or a negative real part."""
    assert x.ndim == 2
    rho = inner_product(x, x if Mx is None else Mx)
    if tuple(rho.shape) == (1, 1):
        val = complex(rho[0, 0])
        if abs(val.imag) > abs(val) * 1e-10 or val.real < 0.0:
            raise InnerProductError(
                f"<x,Mx> = {val}. Is the inner product indefinite?"
            )
    return torch.linalg.matrix_norm(rho, 2)


def norm(x, y=None, ip_B=None):
    r"""Compute :math:`\sqrt{\langle x, y\rangle}` (block-norm for blocks).

    Raises :class:`InnerProductError` when the diagonal of the inner
    product has a significant imaginary part, an indefiniteness indicator.
    """
    x = asarray(x)
    if y is None and (ip_B is None or isinstance(ip_B, IdentityLinearOperator)):
        if x.ndim == 1 or (x.ndim == 2 and x.shape[1] == 1):
            # a single column's spectral norm is its 2-norm
            return torch.linalg.vector_norm(x.reshape(-1))
        return torch.linalg.matrix_norm(x, 2)
    if y is None:
        y = x
    ip = inner(x, y, ip_B=ip_B)
    diag = torch.diagonal(ip)
    nrm_diag = torch.linalg.vector_norm(diag)
    nrm_diag_imag = torch.linalg.vector_norm(
        diag.imag if diag.is_complex() else torch.zeros_like(diag))
    if nrm_diag_imag > nrm_diag * 1e-10:
        raise InnerProductError(
            "inner product defined by ip_B not positive definite? "
            f"||diag(ip).imag||/||diag(ip)||={nrm_diag_imag / nrm_diag}"
        )
    return torch.sqrt(torch.linalg.matrix_norm(ip, 2))


def norm_MMlr(M, Ml, A, Mr, b, x0, yk, inner_product=ip_euclid):
    """Residual norm helper: given yk, compute xk and
    :math:`\\|M M_l (b - A(x_0 + M_r y_k))\\|_{M^{-1}}`."""
    xk = x0 + Mr * yk
    r = b - A * xk
    Mlr = Ml * r
    norm_Mlr = norm(Mlr)
    if float(norm_Mlr) == 0:
        MMlr = torch.zeros(Mlr.shape, dtype=Mlr.dtype, device=Mlr.device)
        norm_MMlr = 0
    else:
        nMMlr = M * (Mlr / norm_Mlr)
        MMlr = nMMlr * norm_Mlr
        ip_B = None if inner_product is ip_euclid else inner_product
        norm_MMlr = norm(Mlr, MMlr, ip_B=ip_B)
    return xk, Mlr, MMlr, norm_MMlr


def orthonormality(V, ip_B=None):
    """Deviation from orthonormality :math:`\\|I - \\langle V,V\\rangle\\|_2`."""
    V = asarray(V)
    return norm(torch.eye(V.shape[1], dtype=V.dtype, device=V.device)
                - inner(V, V, ip_B=ip_B))
