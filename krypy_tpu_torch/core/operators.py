"""Matrix-free linear operators on tensors (counterpart of
:mod:`krypy_tpu.core.operators`).

The public surface is the JAX package's: ``dot``/``dot_adj`` and the lazy
algebra ``*``, ``+``, ``-``, ``**``, ``.adj``.  Operators act on ``(N, k)``
blocks; 1-D ``(N,)`` vectors are also accepted and returned as 1-D.  An
operator built from host data (a numpy matrix, a scipy sparse matrix)
keeps its tensors on the ``device`` it is given, which defaults to
``"cuda"``, as every constructor of the port; one built from a tensor
keeps that tensor's device.
"""

import numpy as np
import torch

from ..errors import ArgumentError, LinearOperatorError
from .dtypes import asarray, find_common_dtype, torch_dtype

__all__ = [
    "LinearOperator",
    "IdentityLinearOperator",
    "ZeroLinearOperator",
    "MatrixLinearOperator",
    "DiagonalLinearOperator",
    "FunctionLinearOperator",
    "TimedLinearOperator",
    "get_linearoperator",
]


def _is_scalar(x):
    return np.isscalar(x) and not isinstance(x, (str, bytes))


def _py_scalar(alpha):
    """A Python number for a scalar factor, so that it scales a tensor
    without changing its dtype (torch treats Python numbers as weak)."""
    return complex(alpha) if np.iscomplexobj(alpha) else float(alpha)


def _promoted_matmul(A, X):
    """``A @ X`` in the promoted dtype (torch's matmul takes one dtype;
    the JAX package's promotes)."""
    dt = torch.promote_types(A.dtype, X.dtype)
    return A.to(dt) @ X.to(dt)


class LinearOperator:
    """A linear operator ``A: C^n -> C^m`` defined by its (adjoint) action.

    :param shape: ``(m, n)``.
    :param dtype: dtype of the operator (torch or numpy).
    :param dot: callable mapping an ``(n, k)`` block to an ``(m, k)`` block.
    :param dot_adj: callable for the adjoint action (optional).

    ``device`` is where a numpy block given to :meth:`dot` goes: the
    device of the operator's own tensors where it has any (a composite
    takes its operands'), else ``"cuda"``.
    """

    device = None

    def __init__(self, shape, dtype, dot=None, dot_adj=None):
        if len(shape) != 2:
            raise LinearOperatorError("shape must be (m, n)")
        try:
            shape = (int(shape[0]), int(shape[1]))
        except (TypeError, ValueError):
            raise LinearOperatorError("shape must be (m, n) with integers")
        if dot is None and dot_adj is None:
            raise LinearOperatorError("dot or dot_adj has to be defined")
        self.shape = shape
        self.dtype = torch_dtype(dtype)
        self._dot = dot
        self._dot_adj = dot_adj

    # -- application ------------------------------------------------------
    def _apply(self, fun, X, in_dim):
        if fun is None:
            raise LinearOperatorError("action undefined")
        X = asarray(X, device=self.device or "cuda")
        flat = X.ndim == 1
        if flat:
            X = X[:, None]
        if X.shape[0] != in_dim:
            raise LinearOperatorError(
                f"dimension mismatch: operator {self.shape}, input "
                f"{tuple(X.shape)}"
            )
        if X.shape[1] == 0:
            Y = torch.zeros((self.shape[0], 0), dtype=X.dtype,
                            device=X.device)
        else:
            Y = fun(X)
        return Y[:, 0] if flat else Y

    def dot(self, X):
        return self._apply(self._dot, X, self.shape[1])

    def dot_adj(self, X):
        return self._apply(self._dot_adj, X, self.shape[0])

    def __call__(self, X):
        return self.dot(X)

    def as_function(self):
        """Return the block-action function."""
        return self.dot

    # -- algebra ----------------------------------------------------------
    @property
    def adj(self):
        return _AdjointOperator(self)

    def __mul__(self, other):
        try:
            if isinstance(other, IdentityLinearOperator):
                return self
            if isinstance(self, IdentityLinearOperator):
                return other
            if isinstance(other, LinearOperator):
                return _ProductOperator(self, other)
            if _is_scalar(other):
                return _ScaledOperator(self, other)
            return self.dot(other)
        except LinearOperatorError:
            return NotImplemented

    def __rmul__(self, alpha):
        try:
            return _ScaledOperator(self, alpha)
        except LinearOperatorError:
            return NotImplemented

    def __pow__(self, p):
        try:
            return _PowerOperator(self, p)
        except LinearOperatorError:
            return NotImplemented

    def __add__(self, other):
        try:
            return _SumOperator(self, other)
        except LinearOperatorError:
            return NotImplemented

    def __neg__(self):
        return _ScaledOperator(self, -1)

    def __sub__(self, other):
        return self + (-other)

    def __repr__(self):
        m, n = self.shape
        return f"<{m}x{n} {self.__class__.__name__} with dtype={self.dtype}>"


class _SumOperator(LinearOperator):
    def __init__(self, A, B):
        if not isinstance(A, LinearOperator) or not isinstance(B, LinearOperator):
            raise LinearOperatorError("both operands must be LinearOperator")
        if A.shape != B.shape:
            raise LinearOperatorError("shape mismatch")
        self.args = (A, B)
        self.device = A.device or B.device
        super().__init__(
            A.shape,
            find_common_dtype(A, B),
            lambda X: A.dot(X) + B.dot(X),
            lambda X: A.dot_adj(X) + B.dot_adj(X),
        )


class _ProductOperator(LinearOperator):
    def __init__(self, A, B):
        if not isinstance(A, LinearOperator) or not isinstance(B, LinearOperator):
            raise LinearOperatorError("both operands must be LinearOperator")
        if A.shape[1] != B.shape[0]:
            raise LinearOperatorError("shape mismatch")
        self.args = (A, B)
        self.device = A.device or B.device
        super().__init__(
            (A.shape[0], B.shape[1]),
            find_common_dtype(A, B),
            lambda X: A.dot(B.dot(X)),
            lambda X: B.dot_adj(A.dot_adj(X)),
        )


class _ScaledOperator(LinearOperator):
    def __init__(self, A, alpha):
        if not isinstance(A, LinearOperator):
            raise LinearOperatorError("LinearOperator expected")
        if not _is_scalar(alpha):
            raise LinearOperatorError("scalar expected")
        self.args = (A, alpha)
        self.device = A.device
        a = _py_scalar(alpha)
        a_conj = a.conjugate()
        super().__init__(
            A.shape,
            find_common_dtype(A, np.asarray(alpha).dtype),
            lambda X: a * A.dot(X),
            lambda X: a_conj * A.dot_adj(X),
        )


class _PowerOperator(LinearOperator):
    def __init__(self, A, p):
        if not isinstance(A, LinearOperator):
            raise LinearOperatorError("LinearOperator expected")
        if A.shape[0] != A.shape[1]:
            raise LinearOperatorError("square operator expected")
        if not isinstance(p, (int, np.integer)) or p < 0:
            raise LinearOperatorError("non-negative integer power expected")
        self.args = (A, p)
        self.device = A.device

        def power(fun, X):
            for _ in range(p):
                X = fun(X)
            return X

        super().__init__(
            A.shape,
            A.dtype,
            lambda X: power(A.dot, X),
            lambda X: power(A.dot_adj, X),
        )


class _AdjointOperator(LinearOperator):
    def __init__(self, A):
        if not isinstance(A, LinearOperator):
            raise LinearOperatorError("LinearOperator expected")
        self.args = (A,)
        self.device = A.device
        m, n = A.shape
        super().__init__((n, m), A.dtype, A._dot_adj, A._dot)


class IdentityLinearOperator(LinearOperator):
    def __init__(self, shape):
        super().__init__(shape, torch.float64, lambda X: X, lambda X: X)


class ZeroLinearOperator(LinearOperator):
    def __init__(self, shape):
        super().__init__(
            shape,
            torch.float64,
            lambda X: torch.zeros((shape[0],) + tuple(X.shape[1:]),
                                  dtype=X.dtype, device=X.device),
            lambda X: torch.zeros((shape[1],) + tuple(X.shape[1:]),
                                  dtype=X.dtype, device=X.device),
        )


class MatrixLinearOperator(LinearOperator):
    """Operator backed by an explicit matrix: a dense or sparse tensor
    (kept on its device), or a numpy matrix (moved to ``device``)."""

    def __init__(self, A, *, device="cuda"):
        self._A = asarray(A, device=device)
        self.device = self._A.device
        super().__init__(
            tuple(self._A.shape),
            self._A.dtype,
            lambda X: self._matmul(X),
            lambda X: self._matmul_adj(X),
        )

    def _matmul(self, X):
        return _promoted_matmul(self._A, X)

    def _matmul_adj(self, X):
        return _promoted_matmul(self._A.conj().transpose(0, 1), X)

    @property
    def array(self):
        return self._A

    def __repr__(self):
        return self._A.__repr__()


class DiagonalLinearOperator(LinearOperator):
    """Operator ``diag(d)``: O(N) storage, elementwise application."""

    def __init__(self, d, *, device="cuda"):
        d = asarray(d, device=device)
        if d.ndim != 1:
            raise ArgumentError("expected a 1-d array of diagonal entries")
        self.d = d
        self.device = d.device
        n = d.shape[0]
        super().__init__(
            (n, n),
            d.dtype,
            lambda X: self.d[:, None] * X,
            lambda X: self.d.conj()[:, None] * X,
        )


class FunctionLinearOperator(LinearOperator):
    """Operator defined by functions acting on 1-D vectors: ``matvec`` maps
    ``(n,)`` to ``(m,)`` and is applied to each block column in turn (the
    JAX package vmaps it; a loop keeps any matvec usable, the port's
    kernel wrappers included)."""

    def __init__(self, shape, dtype, matvec, rmatvec=None):
        def cols(fun):
            return lambda X: torch.stack(
                [fun(X[:, j]) for j in range(X.shape[1])], dim=1)

        self.matvec = matvec
        self.rmatvec = rmatvec
        super().__init__(shape, dtype, cols(matvec),
                         None if rmatvec is None else cols(rmatvec))


class TimedLinearOperator(LinearOperator):
    """Wraps an operator, recording the per-column wall-clock application
    time into a :class:`~krypy_tpu_torch.core.timers.Timer`.  A CUDA
    result is waited for before the timer stops."""

    def __init__(self, linear_operator, timer=None):
        from .timers import Timer

        self._linear_operator = linear_operator
        self.device = linear_operator.device
        self._timer = Timer() if timer is None else timer
        super().__init__(
            linear_operator.shape,
            linear_operator.dtype,
            linear_operator._dot,
            linear_operator._dot_adj,
        )

    def _timed(self, fun, X):
        k = X.shape[1] if X.ndim == 2 else 1
        if k == 0:
            return fun(X)
        with self._timer:
            ret = fun(X)
            if isinstance(ret, torch.Tensor) and ret.is_cuda:
                torch.cuda.synchronize(ret.device)
        self._timer[-1] /= k
        return ret

    def dot(self, X):
        return self._timed(self._linear_operator.dot, X)

    def dot_adj(self, X):
        return self._timed(self._linear_operator.dot_adj, X)


def get_linearoperator(shape, A, timer=None, *, device="cuda"):
    """Coerce ``A`` into a :class:`LinearOperator`.

    Accepts: ``None`` (identity), LinearOperator, a dense or sparse tensor
    (on its device), a numpy array or a scipy sparse matrix (as a dense /
    sparse COO tensor on ``device``), or a scipy-style LinearOperator
    (its matvec runs on the host, on numpy copies).
    """
    ret = None
    if isinstance(A, LinearOperator):
        ret = A
    elif A is None:
        ret = IdentityLinearOperator(shape)
    elif isinstance(A, (np.ndarray, torch.Tensor)):
        ret = MatrixLinearOperator(A, device=device)
    elif hasattr(A, "tocoo") and hasattr(A, "shape"):
        coo = A.tocoo()
        idx = np.vstack([coo.row, coo.col]).astype(np.int64)
        mat = torch.sparse_coo_tensor(
            torch.as_tensor(idx), torch.as_tensor(coo.data),
            size=coo.shape).coalesce().to(device)
        ret = MatrixLinearOperator(mat)
    elif hasattr(A, "matvec") and hasattr(A, "shape"):
        if not hasattr(A, "dtype"):
            raise ArgumentError("operator has no dtype")

        def host(fun):
            return lambda X: torch.as_tensor(
                np.asarray(fun(X.detach().cpu().numpy())), device=X.device)

        ret = LinearOperator(
            A.shape,
            A.dtype,
            dot=host(A.matmat if hasattr(A, "matmat") else A.matvec),
            dot_adj=(host(A.rmatvec)
                     if getattr(A, "rmatvec", None) is not None else None),
        )
    else:
        raise TypeError(f"type not understood: {type(A)}")

    if (
        A is not None
        and not isinstance(ret, IdentityLinearOperator)
        and timer is not None
    ):
        ret = TimedLinearOperator(ret, timer)

    if tuple(shape) != tuple(ret.shape):
        raise LinearOperatorError(
            f"shape mismatch: expected {shape}, got {ret.shape}"
        )
    return ret
