"""scipy-style one-call solver interface (counterpart of
:mod:`krypy_tpu._convenience`).

``cg``/``minres``/``gmres`` build a
:class:`~krypy_tpu_torch.linsys.LinearSystem`, dispatch to the plain or
deflated solver depending on whether a deflation basis ``U`` is passed,
and return ``(solution_or_None, solver)``.  All three funnel through one
driver (:func:`_launch`) parameterized by a per-method spec row.

Inputs may be numpy (the reference's convention) or tensors; they go to
``device``: ``None`` means ``b``'s device where ``b`` is a tensor, else
``"cuda"``.  The solution is a tensor on that device, of ``b``'s shape.
"""

import torch

from . import deflation, linsys
from .core.dtypes import asarray

__all__ = ["cg", "minres", "gmres"]


def wrap_inner_product(inner):
    """Lift a scalar inner product ``inner(x_vec, y_vec)`` to the block
    form expected internally."""

    def _blocked(X, Y):
        if X.shape[1] == 0:
            return torch.zeros((1, 0), dtype=torch.float64, device=X.device)
        return asarray(inner(X[:, 0], Y[:, 0]),
                       device=X.device).reshape(1, 1)

    return _blocked


#: method name -> (plain solver, deflated solver, LinearSystem flags,
#: accepts ``ortho``)
_METHODS = {
    "cg": (
        linsys.Cg,
        deflation.DeflatedCg,
        dict(self_adjoint=True, positive_definite=True),
        False,
    ),
    "minres": (linsys.Minres, deflation.DeflatedMinres,
               dict(self_adjoint=True), True),
    "gmres": (linsys.Gmres, deflation.DeflatedGmres, dict(), True),
}


def _as_columns(v, device):
    """None-passthrough reshape of a vector/block to ``(N, cols)`` on
    ``device``."""
    if v is None:
        return None
    v = asarray(v, device=device)
    return v.reshape(v.shape[0], -1)


def _launch(method, A, b, options):
    """Shared driver of the one-liners: validate shapes, assemble the
    linear system with the method's assumed flags, pick the plain or
    deflated solver class, run it, and shape the result like ``b``."""
    if len(A.shape) != 2 or A.shape[0] != A.shape[1]:
        raise AssertionError("A must be square")
    if A.shape[1] != b.shape[0]:
        raise AssertionError("A and b dimensions mismatch")

    Plain, Deflated, flags, has_ortho = _METHODS[method]

    device = linsys.system_device(b, options.pop("device"))
    ip = options.pop("inner_product")
    system = linsys.LinearSystem(
        A=A,
        b=b,
        M=options.pop("M"),
        Minv=options.pop("Minv"),
        Ml=options.pop("Ml"),
        ip_B=wrap_inner_product(ip) if ip else ip,
        exact_solution=options.pop("exact_solution"),
        device=device,
        **flags,
    )
    # the reference accepts Mr but never forwards it; mirrored for parity
    options.pop("Mr")

    solver_kwargs = dict(
        x0=_as_columns(options.pop("x0"), device),
        tol=options.pop("tol"),
        maxiter=options.pop("maxiter"),
        explicit_residual=options.pop("use_explicit_residual"),
        store_arnoldi=options.pop("store_arnoldi"),
    )
    if has_ortho:
        solver_kwargs["ortho"] = options.pop("ortho")

    U = _as_columns(options.pop("U"), device)
    if options:
        raise TypeError(f"unexpected options: {sorted(options)}")

    if U is None:
        solver = Plain(system, **solver_kwargs)
    else:
        solver = Deflated(system, U=U, **solver_kwargs)

    converged = solver.resnorms[-1] < solver.tol
    x = solver.xk.reshape(b.shape) if converged else None
    return x, solver


def cg(
    A,
    b,
    M=None,
    Minv=None,
    Ml=None,
    Mr=None,
    inner_product=None,
    exact_solution=None,
    x0=None,
    U=None,
    tol=1e-5,
    maxiter=None,
    use_explicit_residual=False,
    store_arnoldi=False,
    *,
    device=None,
):
    """Conjugate gradient one-liner; see :class:`~krypy_tpu_torch.linsys.Cg`.

    :return: ``(x, solver)`` with ``x=None`` if the tolerance was not
      reached.
    """
    return _launch("cg", A, b, dict(
        M=M, Minv=Minv, Ml=Ml, Mr=Mr, inner_product=inner_product,
        exact_solution=exact_solution, x0=x0, U=U, tol=tol, maxiter=maxiter,
        use_explicit_residual=use_explicit_residual,
        store_arnoldi=store_arnoldi, device=device,
    ))


def minres(
    A,
    b,
    M=None,
    Minv=None,
    Ml=None,
    Mr=None,
    inner_product=None,
    exact_solution=None,
    ortho="mgs",
    x0=None,
    U=None,
    tol=1e-5,
    maxiter=None,
    use_explicit_residual=False,
    store_arnoldi=False,
    *,
    device=None,
):
    """MINRES one-liner; see :class:`~krypy_tpu_torch.linsys.Minres`."""
    return _launch("minres", A, b, dict(
        M=M, Minv=Minv, Ml=Ml, Mr=Mr, inner_product=inner_product,
        exact_solution=exact_solution, ortho=ortho, x0=x0, U=U, tol=tol,
        maxiter=maxiter, use_explicit_residual=use_explicit_residual,
        store_arnoldi=store_arnoldi, device=device,
    ))


def gmres(
    A,
    b,
    M=None,
    Minv=None,
    Ml=None,
    Mr=None,
    inner_product=None,
    exact_solution=None,
    ortho="mgs",
    x0=None,
    U=None,
    tol=1e-5,
    maxiter=None,
    use_explicit_residual=False,
    store_arnoldi=False,
    *,
    device=None,
):
    """GMRES one-liner; see :class:`~krypy_tpu_torch.linsys.Gmres`."""
    return _launch("gmres", A, b, dict(
        M=M, Minv=Minv, Ml=Ml, Mr=Mr, inner_product=inner_product,
        exact_solution=exact_solution, ortho=ortho, x0=x0, U=U, tol=tol,
        maxiter=maxiter, use_explicit_residual=use_explicit_residual,
        store_arnoldi=store_arnoldi, device=device,
    ))
