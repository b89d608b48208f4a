"""Householder reflections and Givens rotations, complex-safe
(counterpart of :mod:`krypy_tpu.core.rotations`).

Both come in two forms: the object form (``House``, ``Givens``) of the
reference API, and the function form (``givens_coeffs``,
``house_vector``), written without data-dependent branches as in the JAX
package, so that it keeps its values on the device.
"""

import numpy as np
import torch

from ..errors import ArgumentError
from .dtypes import asarray

__all__ = [
    "House",
    "Givens",
    "givens_coeffs",
    "givens_coeffs_host",
    "house_vector",
]


def _safe_div(a, b):
    """a / b with 0/0 -> 0 (used for direction factors of zero vectors)."""
    return torch.where(b == 0, 0.0 * a, a / torch.where(b == 0, 1.0, b))


def house_vector(x):
    """Householder data for a 1-D vector ``x``: ``(v, beta, alpha, xnorm)``
    such that, with ``H = I - beta v v^*``, ``H x = alpha * xnorm * e_1``
    with ``|alpha| = 1`` and ``v`` normalized (Golub & Van Loan alg. 5.1.1
    with the complex treatment of sec. 5.1.13)."""
    x = asarray(x)
    n = x.shape[0]
    gamma = x[0]
    abs_gamma = gamma.abs()
    if n == 1:
        sigma = torch.zeros((), dtype=abs_gamma.dtype, device=x.device)
    else:
        sigma = torch.linalg.vector_norm(x[1:])
    xnorm = torch.sqrt(abs_gamma**2 + sigma**2)

    one = torch.ones((), dtype=x.dtype, device=x.device)
    direction = _safe_div(gamma, abs_gamma.to(x.dtype))
    # direction of gamma, with the phase of 0 resolved as +1 resp. -1
    sign_pos = torch.where(abs_gamma == 0, one, direction)
    sign_neg = torch.where(abs_gamma == 0, -one, direction)

    tail_zero = sigma == 0
    # if the tail is zero the reflection degenerates to the identity
    beta = torch.where(tail_zero, 0.0, 2.0).to(abs_gamma.dtype)
    alpha = torch.where(tail_zero, sign_pos, -sign_neg)
    v0 = torch.where(tail_zero, one, gamma + sign_neg * xnorm.to(x.dtype))
    v = torch.cat([v0[None], x[1:]]) if n > 1 else v0[None]
    vnorm = torch.sqrt(v0.abs() ** 2 + sigma**2)
    v = _safe_div(v, vnorm.to(v.dtype))
    return v, beta, alpha, torch.where(tail_zero, abs_gamma, xnorm)


class House:
    """Householder transformation with :math:`Hx = \\alpha\\|x\\|_2 e_1`,
    :math:`|\\alpha| = 1`."""

    def __init__(self, x):
        x = asarray(x)
        if x.ndim != 2 or x.shape[1] != 1:
            raise ArgumentError("x is not a vector of dim (N,1)")
        v, beta, alpha, xnorm = house_vector(x[:, 0])
        self.v = v[:, None]
        self.beta = beta
        self.alpha = alpha
        self.xnorm = xnorm

    def apply(self, x):
        """Apply the transformation to an ``(N, m)`` block."""
        x = asarray(x, device=self.v.device)
        if x.ndim != 2:
            raise ArgumentError("x is not a matrix of shape (N,*)")
        dt = torch.promote_types(x.dtype, self.v.dtype)
        v = self.v.to(dt)
        x = x.to(dt)
        return x - self.beta * v * (v.conj().T @ x)

    def matrix(self):
        """Dense matrix :math:`I - \\beta v v^*` (testing only)."""
        n = self.v.shape[0]
        return torch.eye(n, dtype=self.v.dtype, device=self.v.device) \
            - self.beta * (self.v @ self.v.conj().T)


def givens_coeffs(a, b):
    """Compute ``(c, s, r)`` with real :math:`c \\ge 0` such that

    .. math::
        \\begin{bmatrix} c & s \\\\ -\\bar s & c \\end{bmatrix}
        \\begin{bmatrix} a \\\\ b \\end{bmatrix}
        = \\begin{bmatrix} r \\\\ 0 \\end{bmatrix}

    (LAPACK ``zrotg``-style convention), without data-dependent
    branches: ``a`` and ``b`` are tensors of one dtype.
    """
    a = asarray(a)
    b = asarray(b, device=a.device)
    abs_a = a.abs()
    abs_b = b.abs()
    denom = torch.sqrt(abs_a**2 + abs_b**2)

    # b == 0: identity rotation.
    # a == 0, b != 0: swap.
    sign_a = torch.where(abs_a == 0, 1.0 + 0.0 * a, _safe_div(a, abs_a))
    c = torch.where(denom == 0, 1.0, _safe_div(abs_a, denom))
    c = torch.where(abs_b == 0, 1.0, c)
    s = torch.where(
        abs_b == 0,
        0.0 * a,
        torch.where(
            abs_a == 0,
            _safe_div(b.conj(), abs_b),
            sign_a * _safe_div(b.conj(), denom),
        ),
    )
    r = torch.where(
        abs_b == 0,
        a,
        torch.where(abs_a == 0, abs_b.to(a.dtype), sign_a * denom),
    )
    return c, s, r


def givens_coeffs_host(a, b):
    """Host (numpy scalar) version of :func:`givens_coeffs` for the
    sequential QR-update control path of MINRES/GMRES."""
    a = complex(a) if np.iscomplexobj(a) or isinstance(a, complex) else float(a)
    b = complex(b) if np.iscomplexobj(b) or isinstance(b, complex) else float(b)
    abs_a, abs_b = abs(a), abs(b)
    if abs_b == 0:
        return 1.0, 0.0 * b, a
    if abs_a == 0:
        return 0.0, np.conj(b) / abs_b, abs_b + 0.0 * a
    denom = np.sqrt(abs_a**2 + abs_b**2)
    sign_a = a / abs_a
    c = abs_a / denom
    s = sign_a * np.conj(b) / denom
    r = sign_a * denom
    return c, s, r


class Givens:
    """2x2 rotation zeroing the second component of a vector.

    The rotation parameters are small control data, computed and stored
    on the host (numpy).  ``apply`` takes numpy or a tensor and returns
    the same kind.
    """

    def __init__(self, x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        if x.shape != (2, 1):
            raise ArgumentError("x is not a vector of shape (2,1)")
        a, b = x[0, 0], x[1, 0]
        c, s, r = givens_coeffs_host(a, b)
        self.c = c
        self.s = s
        self.r = r
        self.G = np.array([[c, s], [-np.conj(s), c]])

    def apply(self, x):
        if isinstance(x, torch.Tensor):
            G = torch.as_tensor(self.G, device=x.device)
            dt = torch.promote_types(G.dtype, x.dtype)
            return G.to(dt) @ x.to(dt)
        return np.dot(self.G, np.asarray(x))
