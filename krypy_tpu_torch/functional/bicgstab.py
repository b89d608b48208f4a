"""BiCGStab (counterpart of :mod:`krypy_tpu.functional.bicgstab`).

van der Vorst's stabilized BiCG with the preconditioner on the right,
so the tracked residual is the true residual of ``A x = b``: seven
vectors, two matvecs and two preconditioner applications per iteration.
The JAX core's ``lax.while_loop`` runs as a host loop that reads the
updated relative residual and the rho/omega breakdown flag once per
iteration (:mod:`~krypy_tpu_torch.functional._short`); the explicit
residual is computed where the JAX body computes it (the updated one at
or below ``tol``, the last iteration, or ``explicit_residual``).
"""

import numpy as np

from . import _short
from .common import BREAKDOWN, CONVERGED, MAXITER, apply, safe_div

__all__ = ["bicgstab"]


def bicgstab(
    A,
    b,
    *,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    stagnation_window=0,
    explicit_residual=False,
):
    """Solve nonsymmetric ``A x = b`` with right-preconditioned BiCGStab.

    :param A: matvec callable or 2-D tensor (or numpy array).
    :param b: right-hand side ``(N,)`` (or ``(N, 1)``, returned likewise).
    :param M: optional right preconditioner (applied inside the
      recurrence; the tracked residual is the true residual).
    :param tol: relative residual tolerance.
    :param maxiter: iteration cap (default N).
    :param stagnation_window: if > 0, stop after this many iterations
      without improving the best residual below 99% of it.
    :param explicit_residual: recompute the true residual every
      iteration.
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`;
      BREAKDOWN when rho or omega vanished (or the residual is not
      finite), with the last iterate.
    """
    sy = _short.System(A, b, x0, M)
    A_mv, (M_mv,) = sy.A_mv, sy.operators
    maxiter = sy.n_global() if maxiter is None else int(maxiter)
    tol_r = sy.np_real(tol)
    eps = sy.eps

    bv = sy.bv
    bnorm = _short.norm(bv)
    r = bv - A_mv(sy.x0v)
    rt = r  # the fixed shadow residual
    rho = _short.vdot(rt, r)
    (rel,) = _short.read(safe_div(_short.norm(r), bnorm))
    rel = sy.np_real(rel)
    x, p = sy.x0v, r
    v = sy.zeros()
    best, stall, broken, k = rel, 0, False, 0
    resnorms = [rel]

    while (rel > tol_r and k < maxiter and not broken
           and (stagnation_window <= 0 or stall < stagnation_window)):
        Mp = apply(M_mv, p)
        v = A_mv(Mp)
        rtv = _short.vdot(rt, v)
        alpha = safe_div(rho, rtv)
        s = r - alpha * v
        Ms = apply(M_mv, s)
        t = A_mv(Ms)
        tt = _short.vdot(t, t).real
        omega = safe_div(_short.vdot(t, s), tt)
        x = x + alpha * Mp + omega * Ms
        r = s - omega * t
        rho_new = _short.vdot(rt, r)
        beta = safe_div(rho_new, rho) * safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        lost = ((rho_new.abs() <= eps * rtv.abs() + eps)
                | (omega.abs() <= eps))
        rel_upd, lost = _short.read(safe_div(_short.norm(r), bnorm), lost)
        rel = sy.np_real(rel_upd)
        if explicit_residual or rel <= tol_r or k + 1 == maxiter:
            rel = sy.true_rel(x, bnorm)
        broken = bool(lost) or not np.isfinite(rel)
        stall = 0 if rel < sy.np_real(0.99) * best else stall + 1
        best = np.minimum(best, rel)
        resnorms.append(rel)
        rho = rho_new
        k += 1

    if rel <= tol_r:
        status = CONVERGED
    else:
        status = BREAKDOWN if broken else MAXITER
    return sy.finish(x, resnorms, maxiter + 1, k, status)

