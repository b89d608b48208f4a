"""Shared infrastructure of the solver cores (counterpart of
:mod:`krypy_tpu.functional.common`, the subset CG needs).

Conventions follow the JAX package: vectors are 1-D ``(N,)`` tensors,
operators are plain matvec callables ``(N,) -> (N,)``, and status codes
replace exceptions.
"""

from typing import NamedTuple, Optional

import torch

#: solve reached the requested tolerance
CONVERGED = 0
#: maxiter reached without convergence
MAXITER = 1
#: the Krylov subspace became invariant (lucky breakdown)
BREAKDOWN = 2


class SolveResult(NamedTuple):
    """Result of a functional solve; every field is a tensor."""

    #: approximate solution, shape ``(N,)``
    x: torch.Tensor
    #: relative residual norms, shape ``(maxiter+1,)``; entries beyond
    #: ``niter`` are NaN
    resnorms: torch.Tensor
    #: number of iterations performed
    niter: torch.Tensor
    #: CONVERGED / MAXITER / BREAKDOWN
    status: torch.Tensor
    #: error norms if an exact solution was supplied, else None
    errnorms: Optional[torch.Tensor] = None

    @property
    def converged(self):
        return bool(self.status == CONVERGED)


def as_matvec(op):
    """Coerce ``op`` into a matvec callable ``(N,) -> (N,)``: ``None``
    (identity), a 2-D tensor, or a callable."""
    if op is None:
        return None
    if isinstance(op, torch.Tensor):
        if op.ndim != 2:
            raise ValueError("matrix operator must be 2-D")
        return lambda x: op @ x
    if callable(op):
        return op
    raise TypeError(f"cannot interpret operator of type {type(op)}")


def apply(mv, x):
    """Apply an optional matvec (None = identity)."""
    return x if mv is None else mv(x)


def cast_matvec(mv, dtype):
    """Pin a matvec's output to the system dtype.

    The right-hand side's dtype governs all solver state.  An operator
    that computes in a wider dtype (a float64 diagonal against a float32
    vector promotes to float64 under torch's rules too) is cast back
    here; the reverse case, a 0-dim float64 tensor times a float32 vector,
    stays float32 in torch where JAX would promote, and is a no-op."""
    if mv is None:
        return None
    return lambda x: mv(x).to(dtype)


def make_inner(ip):
    """Build the inner-product forms used by the cores.

    :param ip: ``None`` (Euclidean) or a matrix ``B`` (2-D tensor or
      matvec callable exposing ``.shape``) for :math:`x^* B y`.
    :return: ``(pair, rows)``: ``pair(x, y) -> 0-dim tensor`` and
      ``rows(V, w) -> (m,)`` for every row of ``V``.
    """
    if ip is None:
        def pair(x, y):
            return torch.vdot(x, y)

        def rows(V, w):
            return V.conj() @ w

        return pair, rows

    if isinstance(ip, torch.Tensor) or hasattr(ip, "shape"):
        Bmv = as_matvec(ip)

        def pair(x, y):
            return torch.vdot(x, Bmv(y))

        def rows(V, w):
            return V.conj() @ Bmv(w)

        return pair, rows

    raise NotImplementedError(
        "scalar-callable inner products are not ported yet "
        "(ROADMAP.md queue A, slice 3)"
    )


def norm_from_pair(pair, x, y=None):
    """sqrt(Re <x, y>) with the given pair product."""
    val = pair(x, x if y is None else y)
    return torch.sqrt(torch.clamp(val.real, min=0.0))


def safe_div(a, b):
    """a / b with b == 0 mapped to 0 (relative norms of a zero rhs)."""
    zero = b == 0
    return torch.where(zero, torch.zeros_like(a), a / torch.where(
        zero, torch.ones_like(b), b))


def breakdown_threshold(dtype):
    """Relative subdiagonal threshold for invariance detection: 45 eps
    of ``dtype`` (float64 eps for non-float dtypes)."""
    if dtype.is_floating_point or dtype.is_complex:
        eps = torch.finfo(dtype).eps
    else:
        eps = torch.finfo(torch.float64).eps
    return float(45 * eps)


def system_dtype(*tensors):
    """Promoted dtype of the given tensors (``None`` entries skipped)."""
    dt = None
    for t in tensors:
        if t is None:
            continue
        dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return dt
