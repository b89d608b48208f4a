"""Orthogonal and oblique projections (counterpart of
:mod:`krypy_tpu.core.projections`).

The numerically stable XQRY representation of G. W. Stewart, "On the
numerical analysis of oblique projectors" (2011): the projection
:math:`P_{\\mathcal{X},\\mathcal{Y}^\\perp}` is stored as orthonormal bases
V (of X) and W (of Y) plus a small QR factorization of
:math:`\\langle W, V\\rangle`.  Iterated application ("twice is enough")
is the default.  All N-dimensional work is matrix products on the bases'
device.
"""

import torch

from ..errors import ArgumentError
from .dtypes import asarray, find_common_dtype
from .operators import (
    IdentityLinearOperator,
    LinearOperator,
    ZeroLinearOperator,
)
from .products import _mm, inner
from .qr import qr

__all__ = ["Projection"]


def _solve_upper(R, c, *, conj_transpose=False):
    """``R^{-1} c`` (or ``R^{-*} c``) for an upper triangular ``R``, in
    the promoted dtype."""
    dt = torch.promote_types(R.dtype, c.dtype)
    R, c = R.to(dt), c.to(dt)
    if conj_transpose:
        return torch.linalg.solve_triangular(R.conj().T, c, upper=False)
    return torch.linalg.solve_triangular(R, c, upper=True)


class Projection:
    r"""Projection :math:`P_{\mathcal{X},\mathcal{Y}^\perp}` with range
    ``colspan(X)`` and kernel ``colspan(Y)``:math:`^\perp`.

    :param X: tensor (or numpy array) with shape ``(N, k)``, full rank.
    :param Y: (optional) the same shape; defaults to ``X`` (orthogonal
      projection).
    :param ip_B: (optional) inner product, see
      :func:`~krypy_tpu_torch.core.products.inner`.
    :param orthogonalize: orthonormalize the supplied bases (default True).
    :param iterations: number of applications per :meth:`apply` call
      (default 2, per Stewart's round-off analysis).
    :param device: where numpy bases go: ``None`` means the device of
      ``X`` where it is a tensor, else ``"cuda"``.
    """

    def __init__(self, X, Y=None, ip_B=None, orthogonalize=True,
                 iterations=2, *, device=None):
        if iterations < 1:
            raise ArgumentError("iterations < 1 not allowed")
        self.ip_B = ip_B
        self.orthogonalize = orthogonalize
        self.iterations = iterations

        if device is None:
            device = X.device if isinstance(X, torch.Tensor) else "cuda"
        X = asarray(X, device=device)
        Y = X if Y is None else asarray(Y, device=X.device)
        if X.ndim != 2:
            raise ArgumentError("X does not have shape==(N,k)")
        if X.shape != Y.shape:
            raise ArgumentError("X and Y have different shapes")
        self._device = X.device

        # empty basis -> zero projection
        if X.shape[1] == 0:
            self.V = self.W = torch.zeros(X.shape, dtype=torch.float64,
                                          device=X.device)
            self.VR = self.WR = self.Q = self.R = None
            return

        if orthogonalize:
            self.V, self.VR = qr(X, ip_B=ip_B)
        else:
            self.V, self.VR = X, None

        if Y is X and orthogonalize:
            # orthogonal projection: W = V, cross Gram is the identity
            self.W, self.WR = self.V, self.VR
            self.Q = self.R = None
        else:
            if orthogonalize:
                self.W, self.WR = qr(Y, ip_B=ip_B)
            else:
                self.W, self.WR = Y, None
            M = inner(self.W, self.V, ip_B=ip_B)
            self.Q, self.R = torch.linalg.qr(M, mode="complete")

    def _zeros(self, a):
        return torch.zeros(a.shape, dtype=torch.float64, device=a.device)

    def _coerce(self, a):
        return asarray(a, device=self._device)

    # -- single applications ---------------------------------------------
    def _solve_coeffs(self, c):
        """Map :math:`\\langle W, a\\rangle` to basis coefficients of Pa."""
        if self.Q is not None and self.R is not None:
            c = _solve_upper(self.R, _mm(self.Q.conj().T, c))
        return c

    def _apply(self, a, return_Ya=False):
        if self.V.shape[1] == 0:
            Pa = self._zeros(a)
            return (Pa, self._zeros(a[:0])) if return_Ya else Pa
        c = inner(self.W, a, ip_B=self.ip_B)
        if return_Ya:
            Ya = c
            if self.WR is not None:
                Ya = _mm(self.WR.conj().T, Ya)
        Pa = _mm(self.V, self._solve_coeffs(c))
        return (Pa, Ya) if return_Ya else Pa

    def _apply_adj(self, a):
        if self.V.shape[1] == 0:
            return self._zeros(a)
        c = inner(self.V, a, ip_B=self.ip_B)
        if self.Q is not None and self.R is not None:
            c = _mm(self.Q, _solve_upper(self.R, c, conj_transpose=True))
        return _mm(self.W, c)

    # -- iterated applications -------------------------------------------
    def apply(self, a, return_Ya=False):
        r"""Apply the projection: :math:`P a`.

        With ``return_Ya=True`` also returns :math:`\langle Y, a\rangle`.
        """
        a = self._coerce(a)
        if self.V.shape[1] == 0:
            Pa = self._zeros(a)
            return (Pa, self._zeros(a[:0])) if return_Ya else Pa
        if return_Ya:
            x, Ya = self._apply(a, return_Ya=True)
        else:
            x = self._apply(a)
        for _ in range(self.iterations - 1):
            x = x + self._apply(a - x)
        return (x, Ya) if return_Ya else x

    def apply_adj(self, a):
        a = self._coerce(a)
        if self.V.shape[1] == 0:
            return self._zeros(a)
        x = self._apply_adj(a)
        for _ in range(self.iterations - 1):
            x = x + self._apply_adj(a - x)
        return x

    def apply_complement(self, a, return_Ya=False):
        r"""Apply the complementary projection
        :math:`(I - P)a = P_{\mathcal{Y}^\perp,\mathcal{X}} a`."""
        a = self._coerce(a)
        if self.V.shape[1] == 0:
            return (a, self._zeros(a[:0])) if return_Ya else a
        if return_Ya:
            x, Ya = self._apply(a, return_Ya=True)
        else:
            x = self._apply(a)
        z = a - x
        for _ in range(self.iterations - 1):
            z = z - self._apply(z)
        return (z, Ya) if return_Ya else z

    def apply_complement_adj(self, a):
        a = self._coerce(a)
        if self.V.shape[1] == 0:
            return a
        z = a - self._apply_adj(a)
        for _ in range(self.iterations - 1):
            z = z - self._apply_adj(z)
        return z

    # -- operator views ---------------------------------------------------
    def _get_operator(self, fun, fun_adj):
        N = self.V.shape[0]
        dt = find_common_dtype(self.V, self.W)
        op = LinearOperator((N, N), dt, fun, fun_adj)
        op.device = self._device
        return op

    def operator(self):
        """LinearOperator view of :meth:`apply`."""
        if self.V.shape[1] == 0:
            return ZeroLinearOperator((self.V.shape[0],) * 2)
        return self._get_operator(self.apply, self.apply_adj)

    def operator_complement(self):
        """LinearOperator view of :meth:`apply_complement`."""
        if self.V.shape[1] == 0:
            return IdentityLinearOperator((self.V.shape[0],) * 2)
        return self._get_operator(
            self.apply_complement, self.apply_complement_adj
        )

    def matrix(self):
        """Dense matrix representation (testing only)."""
        N = self.V.shape[0]
        return self.apply(torch.eye(N, dtype=torch.float64,
                                    device=self._device))
