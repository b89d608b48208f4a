"""TFQMR (counterpart of :mod:`krypy_tpu.functional.tfqmr`).

Freund's transpose-free QMR on the right-preconditioned operator ``A M``,
one loop step per HALF-step (one ``A M`` application each).  The
quasi-residual bound :math:`\\tau_m \\sqrt{m+1} / \\|b\\|` drives the
loop; where it reaches ``tol`` the candidate is verified on the true
residual before CONVERGED is reported.  The host loop reads the bound and
the breakdown flag once per half-step
(:mod:`~krypy_tpu_torch.functional._short`).
"""

import numpy as np
import torch

from . import _short
from .common import BREAKDOWN, CONVERGED, MAXITER, safe_div

__all__ = ["tfqmr"]


def tfqmr(
    A,
    b,
    *,
    M=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    stagnation_window=None,
):
    r"""Solve nonsymmetric ``A x = b`` by TFQMR.

    :param M: optional RIGHT preconditioner (the iteration runs on ``A
      M``; the returned iterate is ``x0 + M y``).
    :param tol: relative residual target; a candidate by the
      quasi-residual bound is verified on the explicit residual.
    :param maxiter: full iterations (two half-steps each; default N).
    :param stagnation_window: half-steps without improvement of the bound
      after which the solve stops with MAXITER; default ``max(100, 2 *
      maxiter // 10)``; 0 disables.
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`;
      ``resnorms[m]`` is the bound after half-step ``m`` (the explicit
      residual where a candidate was verified); ``niter`` counts full
      iterations, a final odd half-step rounded up.
    """
    sy = _short.System(A, b, x0, M)
    A_mv, (M_mv,) = sy.A_mv, sy.operators
    maxiter = sy.n_global() if maxiter is None else int(maxiter)
    mmax = 2 * maxiter
    if stagnation_window is None:
        stagnation_window = max(100, mmax // 10)
    tol_r = sy.np_real(tol)
    eps = sy.eps

    def AM(y):
        return A_mv(y if M_mv is None else M_mv(y))

    def x_of(y):
        return sy.x0v + (y if M_mv is None else M_mv(y))

    bv = sy.bv
    r0 = bv - A_mv(sy.x0v)
    bnorm = _short.norm(bv)
    inv_bnorm = safe_div(torch.ones_like(bnorm), bnorm)
    rstar = r0
    u = w = r0
    uhat = v = AM(u)
    tau = _short.norm(r0)
    rho = _short.vdot(rstar, r0)
    (rel0,) = _short.read(safe_div(tau, bnorm))
    rel0 = sy.np_real(rel0)
    done = CONVERGED if rel0 <= tol_r else -1

    y = sy.zeros()
    d = sy.zeros()
    theta = sy.scalar(0.0, real=True)
    eta = alpha = sy.scalar(0.0)
    best, stall, m = rel0, 0, 0
    resnorms = [rel0]
    while done < 0 and m < mmax:
        even = m % 2 == 0
        if even:
            alpha = safe_div(rho, _short.vdot(rstar, v))
        w = w - alpha * uhat
        d = u + safe_div((theta ** 2).to(sy.dtype) * eta, alpha) * d
        theta = safe_div(_short.norm(w), tau)
        c2 = safe_div(torch.ones_like(theta), 1.0 + theta ** 2)
        tau = tau * theta * torch.sqrt(c2)
        eta = c2.to(sy.dtype) * alpha
        y = y + eta * d
        if even:
            # the second half-step's direction
            u = u - alpha * v
            uhat = AM(u)
        else:
            # the BiCG coefficient update
            rho_new = _short.vdot(rstar, w)
            beta = safe_div(rho_new, rho)
            u = w + beta * u
            uhat_new = AM(u)
            v = uhat_new + beta * (uhat + beta * v)
            uhat, rho = uhat_new, rho_new
        # Freund's bound tau_m sqrt(m + 1), m + 1 = m + 2 half-steps done
        bound = tau * torch.sqrt(
            sy.scalar(2.0 + m, real=True)) * inv_bnorm
        lost = rho.abs() <= eps * _short.norm(w) + eps
        if even:
            lost = lost | (alpha.abs() == 0)
        bound, lost = _short.read(bound, lost)
        bound = sy.np_real(bound)
        cand = bound <= tol_r
        rel = bound
        if cand:
            rel = sy.true_rel(x_of(y), bnorm)
        converged = cand and rel <= tol_r
        # a candidate that failed its verification is no improvement
        improved = bound < best and not (cand and not converged)
        stall = 0 if improved else stall + 1
        best = np.minimum(bound, best)
        if converged:
            done = CONVERGED
        elif not np.isfinite(bound) or lost:
            done = BREAKDOWN
        elif stagnation_window > 0 and stall >= stagnation_window:
            done = MAXITER
        resnorms.append(rel)
        m += 1

    status = MAXITER if done < 0 else done
    return sy.finish(x_of(y), resnorms, mmax + 1, (m + 1) // 2, status)
