"""Flexible GMRES (counterpart of :mod:`krypy_tpu.functional.fgmres`).

Saad's FGMRES keeps the preconditioned directions ``z_j = M_j(v_j)``
beside the orthonormal basis and builds the iterate from them, so ``M``
may change from one iteration to the next (an inner solve, a
preconditioner that alternates).  The Arnoldi mechanics are
:func:`~krypy_tpu_torch.functional.gmres.gmres`'s: Gram-Schmidt by
``cgs``/``cgs2`` (the active rows in one product per pass) or
``bmgs``/``bmgs2`` (panels of 16 rows), the Euclidean inner product
only, Givens rotations accumulated in one small matrix, and the
explicit residual where the JAX body computes it.  The host loop reads
the updated residual and the invariance flag once per iteration.
"""

import torch

from . import _short
from .common import (
    BREAKDOWN,
    CONVERGED,
    MAXITER,
    breakdown_threshold,
    cast_matvec,
    as_matvec,
    givens,
    make_inner,
    safe_div,
)
from .gmres import _PANEL_ROWS, _PASSES

__all__ = ["fgmres"]

#: the schemes of the JAX package's fgmres
_ORTHOS = ("cgs", "cgs2", "bmgs", "bmgs2")


def fgmres(
    A,
    b,
    *,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    ortho="cgs2",
    explicit_residual=False,
):
    """Solve ``A x = b`` with flexible right preconditioning.

    :param M: the flexible preconditioner: any callable ``v -> z``
      approximating ``A^{-1} v``, which may differ from one call to the
      next (e.g. ``lambda v: cg(A, v, maxiter=5, tol=0).x``), or a matrix;
      ``None`` reduces to plain GMRES.
    :param maxiter: Arnoldi steps (the basis holds ``maxiter + 1`` rows;
      default N).
    :param ortho: ``"cgs"``/``"cgs2"`` or ``"bmgs"``/``"bmgs2"``.
    :param explicit_residual: recompute the true residual every
      iteration.
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`;
      BREAKDOWN when the Krylov space became invariant short of ``tol``.
    """
    if ortho not in _ORTHOS:
        raise KeyError(ortho)
    passes = _PASSES[ortho]
    sy = _short.System(A, b, x0)
    A_mv, dtype, dev, N = sy.A_mv, sy.dtype, sy.dev, sy.N
    m = sy.n_global() if maxiter is None else int(maxiter)
    if M is None:
        M_fn = None
    elif callable(M) and not hasattr(M, "ndim"):
        M_fn = cast_matvec(M, dtype)
    else:
        M_fn = cast_matvec(as_matvec(M), dtype)
    _, rows = make_inner(None)
    tol_r = sy.np_real(tol)
    brk = breakdown_threshold(dtype)

    bv, x0v = sy.bv, sy.x0v
    bnorm = _short.norm(bv)
    r0 = bv - A_mv(x0v)
    beta = _short.norm(r0)
    v0 = (beta > 0).to(sy.real_dtype) * safe_div(torch.ones_like(beta), beta)
    V = sy.zeros(m + 1, N)
    V[0] = r0 * v0
    Z = sy.zeros(m, N)
    Q = torch.eye(m + 1, dtype=dtype, device=dev)
    R = sy.zeros(m + 1, m)
    y = sy.zeros(m + 1)
    y[0] = beta.to(dtype)
    hsq = sy.scalar(0.0, real=True)
    rel, invariant = _short.read(safe_div(beta, bnorm), beta == 0)
    rel, invariant = sy.np_real(rel), bool(invariant)
    resnorms = [rel]

    def orthogonalize(w, k):
        h = sy.zeros(m + 1)
        step = _PANEL_ROWS if ortho in ("bmgs", "bmgs2") else k + 1
        for _ in range(passes):
            for lo in range(0, k + 1, step):
                hi = min(lo + step, k + 1)
                coeffs = rows(V[lo:hi], w)
                w = w - coeffs @ V[lo:hi]
                h[lo:hi] += coeffs
        return w, h

    def xk_from(kk):
        """x0 + Z[:kk]^T yy, yy the solution of the leading kk x kk
        triangular system."""
        yy = torch.linalg.solve_triangular(R[:kk, :kk], y[:kk, None],
                                           upper=True)[:, 0]
        return x0v + yy @ Z[:kk]

    k = 0
    while rel > tol_r and k < m and not invariant:
        z = V[k] if M_fn is None else M_fn(V[k])
        Z[k] = z
        w, h = orthogonalize(A_mv(z), k)
        hnew = _short.norm(w)
        hsq = hsq + torch.sum(h.abs() ** 2) + hnew ** 2
        inv_t = hnew <= brk * torch.sqrt(hsq)
        h[k + 1] = hnew.to(dtype)
        inv_h = torch.where(inv_t, 0.0, safe_div(torch.ones_like(hnew),
                                                 hnew))
        V[k + 1] = w * inv_h
        # the k previous rotations in one small product against their
        # accumulated matrix, then the new one
        col = Q @ h
        c, s, rr = givens(col[k], col[k + 1])
        col[k] = rr
        col[k + 1] = 0.0
        qk, qk1 = Q[k].clone(), Q[k + 1].clone()
        Q[k] = c * qk + s * qk1
        Q[k + 1] = -s.conj() * qk + c * qk1
        R[:, k] = col
        yk = y[k].clone()
        y[k] = c * yk
        y[k + 1] = -s.conj() * yk
        rel_upd, inv = _short.read(safe_div(y[k + 1].abs(), bnorm), inv_t)
        rel, invariant = sy.np_real(rel_upd), bool(inv)
        k += 1
        if explicit_residual or rel <= tol_r or k == m or invariant:
            rel = sy.true_rel(xk_from(k), bnorm)
        resnorms.append(rel)

    if rel <= tol_r:
        status = CONVERGED
    else:
        status = BREAKDOWN if invariant else MAXITER
    return sy.finish(xk_from(k), resnorms, m + 1, k, status)

