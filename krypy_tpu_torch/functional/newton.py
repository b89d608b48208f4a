r"""Jacobian-free Newton-Krylov for nonlinear systems F(x) = 0
(counterpart of :mod:`krypy_tpu.functional.newton`).

The Jacobian action is forward-mode autodiff,
``torch.func.jvp(F, (x,), (v,))[1]``: exact directional derivatives, no
finite-difference step.  ``F`` is any function that ``torch.func.jvp``
can differentiate; the port's stencil operators with ``impl="cuda"``
qualify, since K1 carries its own forward-mode rule
(:func:`krypy_tpu_torch.kernels.stencil.stencil5_affine`).

``torch.func.jvp`` evaluates the primal ``F(x)`` on every call beside the
tangent (XLA drops the unused primal inside the JAX package's compiled
solve), so each Jacobian action costs one evaluation of ``F`` and one of
its tangent: two K1 launches on the kernel lane.

The host runs the Newton loop (Eisenstat-Walker forcing term, Armijo
backtracking, convergence bookkeeping) and reads one scalar per Newton
step and per backtracking trial, ``||F||``; the inner solves are the
port's GMRES, optionally through
:class:`~krypy_tpu_torch.functional.deflation.RecyclingGmres`, whose
Ritz subspace carries over between Newton steps.  The JAX package's
``jax.jit`` of the residual and of the trial step become plain calls.
"""

import logging
import time
from typing import NamedTuple

import numpy as np
import torch

from .common import CONVERGED, MAXITER
from .deflation import RecyclingGmres
from .gmres import gmres as _gmres

__all__ = ["newton_krylov", "NewtonResult"]

_logger = logging.getLogger(__name__)


class NewtonResult(NamedTuple):
    """Result of :func:`newton_krylov`."""

    #: approximate root, shape ``(N,)``
    x: torch.Tensor
    #: ||F(x_k)|| per Newton step (numpy, host decision data)
    resnorms: np.ndarray
    #: Newton steps taken
    niter: int
    #: total inner Krylov iterations
    inner_iters: int
    #: CONVERGED / MAXITER
    status: int
    #: inner Krylov iterations per Newton step (numpy int array)
    inner_history: np.ndarray = np.zeros(0, int)
    #: wall seconds per inner (Jacobian) solve, synced by scalar fetch
    inner_walls: np.ndarray = np.zeros(0)
    #: wall seconds of the pre-loop warmup (0.0 without ``warmup=True``)
    warmup_s: float = 0.0

    @property
    def converged(self):
        return self.status == CONVERGED


def _jvp_operator(F, x):
    """``v -> J(x) v`` as ``torch.func.jvp``, with the JAX package's
    operator-family attributes (``family``, ``params``, ``rebuild``)."""
    def mv(v):
        return torch.func.jvp(F, (x,), (v,))[1]

    mv.family = "newton_jvp"
    mv.params = x
    mv.rebuild = lambda p: _jvp_operator(F, p)
    return mv


def newton_krylov(
    F,
    x0,
    *,
    tol=1e-8,
    maxiter=50,
    inner_maxiter=50,
    eta_max=0.1,
    M=None,
    recycle=0,
    recycling_solver=None,
    warmup=False,
    line_search=True,
    verbose=False,
):
    r"""Solve ``F(x) = 0`` by inexact Newton with Jacobian-free GMRES.

    :param F: residual function ``(N,) -> (N,)`` that ``torch.func.jvp``
      differentiates; the Jacobian action is ``torch.func.jvp(F, (x,),
      (v,))[1]``.
    :param x0: initial guess (a tensor; its dtype and device are the
      solve's).
    :param tol: stop when ``||F(x)|| <= tol * max(||F(x0)||, 1)``.
    :param eta_max: cap on the Eisenstat-Walker forcing term; each inner
      solve runs to
      :math:`\eta_k = \min(\eta_{max}, 0.9 (\|F_k\|/\|F_{k-1}\|)^2)`
      (choice 2), and never below half the remaining outer gap.
    :param M: optional preconditioner matvec for the inner GMRES.
    :param recycle: if > 0, route the inner solves through
      :class:`RecyclingGmres` with this many deflation vectors, so that
      the deflation subspace carries over between Newton steps.
    :param recycling_solver: explicit recycling driver to use instead of
      the default fixed-width :class:`RecyclingGmres` (e.g. an
      :class:`~krypy_tpu_torch.functional.deflation.AutoRecyclingGmres`);
      implies the recycled path regardless of ``recycle``.
    :param warmup: pre-run the recycling driver's solves (plain and
      deflated) and its Ritz extraction on the initial Jacobian with a
      zero right-hand side before the Newton loop
      (:meth:`RecyclingGmres.warmup`), so that the kernels' build and
      first launches fall outside the timed steps; ``warmup_s`` reports
      its wall.
    :param line_search: Armijo backtracking (t halved until
      :math:`\|F(x + t\,dx)\| \le (1 - 10^{-4} t)\|F(x)\|`, 8 tries);
      pure Newton otherwise.
    :param verbose: log ``||F||`` per step.
    :return: :class:`NewtonResult`.
    """
    x = x0.reshape(-1)
    warmup_s = 0.0

    def residual(xx):
        r = F(xx)
        return r, torch.linalg.vector_norm(r)

    if recycle > 0 or recycling_solver is not None:
        rec = recycling_solver or RecyclingGmres(
            n_vectors=int(recycle), which="sm", hermitian=False
        )

        if warmup:
            t_w = time.perf_counter()
            rec.warmup(_jvp_operator(F, x), torch.zeros_like(x), M=M,
                       maxiter=inner_maxiter)
            warmup_s = time.perf_counter() - t_w

        def inner(xx, rr, eta):
            res = rec.solve(
                _jvp_operator(F, xx), -rr, tol=float(eta), M=M,
                maxiter=inner_maxiter,
            )
            return res.x, int(res.niter)
    else:
        def inner(xx, rr, eta):
            # the JAX package hands this solve eta as a float32 scalar
            res = _gmres(_jvp_operator(F, xx), -rr,
                         tol=float(np.float32(eta)), M=M,
                         maxiter=inner_maxiter)
            return res.x, int(res.niter)

    def trial_step(xx, dx, t):
        # candidate iterate, its residual AND the norm
        xn = xx + t * dx
        rn = F(xn)
        return xn, rn, torch.linalg.vector_norm(rn)

    r, fnorm = residual(x)
    fnorm = float(fnorm)
    f0 = max(fnorm, 1.0)
    history = [fnorm]
    inner_total = 0
    inner_history = []
    inner_walls = []
    prev_fnorm = None
    status = MAXITER
    k = 0

    for k in range(1, maxiter + 1):
        if fnorm <= tol * f0:
            status = CONVERGED
            k -= 1
            break

        # Eisenstat-Walker choice 2 forcing term, with the oversolve
        # safeguard: never ask the inner solve for more accuracy than
        # the outer convergence test needs (half the remaining gap)
        if prev_fnorm is None:
            eta = eta_max
        else:
            eta = min(eta_max, 0.9 * (fnorm / prev_fnorm) ** 2)
        eta = max(eta, 0.5 * tol * f0 / fnorm)
        eta = min(eta, eta_max)

        t_in = time.perf_counter()
        dx, nit = inner(x, r, eta)
        inner_walls.append(time.perf_counter() - t_in)
        inner_history.append(nit)
        inner_total += nit

        t = 1.0
        xn, rn, tn = trial_step(x, dx, t)
        tn = float(tn)
        if line_search:
            # on sufficient-decrease failure the smallest step is kept
            for _ in range(7):
                if tn <= (1.0 - 1e-4 * t) * fnorm:
                    break
                t *= 0.5
                xn, rn, tn = trial_step(x, dx, t)
                tn = float(tn)

        x, r = xn, rn
        prev_fnorm = fnorm
        fnorm = tn
        history.append(fnorm)
        if verbose:
            _logger.info(
                "newton step %d: ||F|| = %.3e (t=%g)", k, fnorm, t
            )
        if not np.isfinite(fnorm):
            break

    if np.isfinite(fnorm) and fnorm <= tol * f0:
        status = CONVERGED

    return NewtonResult(
        x=x,
        resnorms=np.asarray(history),
        niter=k,
        inner_iters=inner_total,
        status=status,
        inner_history=np.asarray(inner_history, int),
        inner_walls=np.asarray(inner_walls),
        warmup_s=warmup_s,
    )
