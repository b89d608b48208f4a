r"""Least-squares Krylov solvers: LSQR and LSMR (counterpart of
:mod:`krypy_tpu.functional.lsq`).

Both solve :math:`\min_x \|b - A x\|_2` (optionally Tikhonov-damped,
:math:`\min_x \|b - Ax\|^2 + \mathrm{damp}^2\|x - x_0\|^2` -- the
damping regularizes toward the initial guess, since the Golub-Kahan
recurrence is seeded with the shifted variable :math:`dx = x - x_0`;
for the classic :math:`\mathrm{damp}^2\|x\|^2` objective use
``x0=None``) for a general rectangular operator :math:`A \in
\mathbb{C}^{M \times N}` via Golub-Kahan bidiagonalization: LSQR (Paige
& Saunders 1982) is CG on the normal equations in exact arithmetic, LSMR
(Fong & Saunders 2011) is MINRES on them, so LSMR's :math:`\|A^H r_k\|`
decreases monotonically.

The JAX package's ``lax.while_loop`` is a host loop here.  Each
iteration makes the two matvecs (:math:`A v` and :math:`A^H u`) and the
two vector norms on the device and reads the two norms, ``alpha`` and
``beta``, in ONE transfer; the scalar recurrences then run on the host in
the system's real dtype (``numpy`` scalars), so every rounding and every
stop-rule comparison is the JAX package's, and the vector updates take
the host coefficients.  An estimated stop arms the explicit check (two
more matvecs and one more read) as in the JAX package.  There is no
Krylov buffer (five vectors, whatever the iteration count).

Under an active mesh (:mod:`krypy_tpu_torch.parallel`) ``b``, ``x0`` and
the iterates are the rank's blocks of a square system, and each of the
two norms is a local partial plus one all-reduce; nothing else
communicates.
"""

import warnings

import numpy as np
import torch

from ..parallel import active_mesh
from . import _short
from .common import (
    BREAKDOWN,
    CONVERGED,
    MAXITER,
    SolveResult,
    as_matvec,
    cast_matvec,
    global_length,
    host_vectors,
    safe_div,
    system_dtype,
)
from .eigh import _is_matrix

__all__ = ["lsqr", "lsmr"]


def _setup(A, Ah):
    """Coerce the operator pair, deriving A^H for matrix operands and
    operators exposing ``.adj``."""
    if Ah is None:
        if _is_matrix(A):
            Ah = (A.conj().T if isinstance(A, torch.Tensor)
                  else np.conj(np.asarray(A)).T)
        elif hasattr(A, "adj"):
            Ah = A.adj
        else:
            raise ValueError(
                "Ah= (the conjugate-transpose matvec y -> A^H y) is "
                "required for callable operators"
            )
    return as_matvec(A), as_matvec(Ah)


def _x_dimension(A, x0, bv, dtype):
    """``x0`` as a vector and the x dimension: from ``x0`` when given,
    else the operator's shape (matrices and callables with ``.shape``).

    For a shapeless callable without ``x0`` the square fallback N = M is
    used, with the JAX package's warning.  Under an active mesh the
    vectors are the rank's blocks, so a system without ``x0`` must be
    square (its ``.shape`` the global ``(M, M)``), and x takes ``b``'s
    block."""
    M = bv.shape[0]
    if x0 is not None:
        x0v = x0.reshape(-1).to(dtype)
        return x0v, x0v.shape[0]
    shape = getattr(A, "shape", None)
    if shape is not None and len(shape) == 2 and shape[1] is not None:
        N = int(shape[1])
        if active_mesh() is not None:
            if N != global_length(bv):
                raise NotImplementedError(
                    "a rectangular operator on a mesh: pass x0= as this "
                    "rank's block of x")
            N = M
    else:
        warnings.warn(
            "operator has no .shape and no x0 was given: assuming a "
            "SQUARE system (N = M). For rectangular problems pass x0= "
            "or give the operator a .shape."
        )
        N = M
    return torch.zeros(N, dtype=dtype, device=bv.device), N


class _Problem:
    """What LSQR and LSMR share: the operands in the system dtype on
    ``b``'s device, the Golub-Kahan start, and the stop tests."""

    def __init__(self, A, b, Ah, damp, x0, tol, btol, maxiter,
                 explicit_residual):
        b, x0 = host_vectors(b, x0)
        self.flat = b.ndim == 1
        bv = b.reshape(-1)
        self.dtype = dtype = system_dtype(bv, x0)
        self.bv = bv = bv.to(dtype)
        self.dev = bv.device
        self.real_dtype = torch.empty(0, dtype=dtype).real.dtype
        self.R = R = torch.empty(
            0, dtype=self.real_dtype).numpy().dtype.type
        self.x0v, N = _x_dimension(A, x0, bv, dtype)
        A_mv, Ah_mv = _setup(A, Ah)
        self.A_mv = cast_matvec(A_mv, dtype)
        self.Ah_mv = cast_matvec(Ah_mv, dtype)
        if maxiter is None:
            M_g = global_length(bv)
            N_g = M_g if N == bv.shape[0] and active_mesh() is not None \
                else global_length(self.x0v)
            self.m = 2 * max(M_g, N_g)
        else:
            self.m = int(maxiter)
        self.damp = R(damp)
        self.tol = R(tol)
        self.btol = R(tol if btol is None else btol)
        self.tiny = R(np.finfo(R).tiny)
        self.explicit = explicit_residual

    def start(self):
        """``(u0, v0)`` on the device and ``(normb, beta0, alpha0)`` on the
        host, read in one transfer."""
        normb = _short.norm(self.bv)
        u = self.bv - self.A_mv(self.x0v)
        beta = _short.norm(u)
        u = u * safe_div(torch.ones_like(beta), beta)
        v = self.Ah_mv(u)
        alpha = _short.norm(v)
        v = v * safe_div(torch.ones_like(alpha), alpha)
        normb, beta, alpha = (self.R(t) for t in
                              _short.read(normb, beta, alpha))
        return u, v, normb, beta, alpha

    def step(self, u, v, alpha):
        """One Golub-Kahan step from ``(u, v)`` with the host ``alpha``:
        the new ``(u, v)`` and ``(alpha, beta)``, read in one transfer."""
        u = self.A_mv(v) - float(alpha) * u
        beta = _short.norm(u)
        u = u * safe_div(torch.ones_like(beta), beta)
        v = self.Ah_mv(u) - beta.to(self.dtype) * v
        alpha = _short.norm(v)
        v = v * safe_div(torch.ones_like(alpha), alpha)
        alpha, beta = (self.R(t) for t in _short.read(alpha, beta))
        return u, v, alpha, beta

    def est_tests(self, normar, normr, normA2, normb):
        ls_ok = normar <= self.tol * np.sqrt(normA2) * max(normr, self.tiny)
        res_ok = normr <= self.btol * normb
        return bool(ls_ok), bool(res_ok)

    def stop_tests(self, normar, normr, normA2, normb, x):
        """``(ls_ok, res_ok, checked)``: the estimated tests; with
        ``explicit_residual`` an estimated stop only arms the check of the
        true (damped, x0-centred) residual and normal-equations residual
        against the same thresholds, and ``checked`` says it ran."""
        ls_e, res_e = self.est_tests(normar, normr, normA2, normb)
        if not self.explicit:
            return ls_e, res_e, False
        if not (ls_e or res_e):
            return False, False, False
        rt = self.bv - self.A_mv(x)
        dx = x - self.x0v
        d2 = self.damp ** 2
        art = self.Ah_mv(rt) - float(d2) * dx
        nrt, ndx, nart = (self.R(t) for t in _short.read(
            _short.norm(rt), _short.norm(dx), _short.norm(art)))
        nr = np.sqrt(nrt ** 2 + d2 * ndx ** 2)
        ls_ok, res_ok = self.est_tests(nart, nr, normA2, normb)
        return ls_ok, res_ok, True

    def finish(self, x, resnorms, k, status):
        res_t = torch.full((self.m + 1,), float("nan"),
                           dtype=self.real_dtype, device=self.dev)
        res_t[: len(resnorms)] = torch.tensor(
            np.asarray(resnorms, dtype=self.R),
            dtype=self.real_dtype).to(self.dev)
        return SolveResult(
            x=x if self.flat else x[:, None],
            resnorms=res_t,
            niter=torch.tensor(k, dtype=torch.int64, device=self.dev),
            status=torch.tensor(status, dtype=torch.int64, device=self.dev),
        )


def _hdiv(a, b):
    """``safe_div`` on host scalars: ``a / b``, 0 where ``b == 0``."""
    return a / b if b != 0 else a * 0


def _stall(normar, best_ar, stall, failed_check):
    """The stagnation count and the best ``||A^H r||``: reset on an
    improvement, else one more; a failed explicit check (the estimates
    have drifted below the attainable floor) counts one more whatever the
    estimate did."""
    improved = normar < best_ar
    new = stall + 1 if failed_check or not improved else 0
    return new, min(normar, best_ar)


def _status(ls_ok, res_ok, invariant, stall, window):
    if ls_ok or res_ok:
        return CONVERGED
    if invariant:
        return BREAKDOWN
    return MAXITER if stall >= window else -1


def lsqr(
    A,
    b,
    *,
    Ah=None,
    damp=0.0,
    x0=None,
    tol=1e-8,
    btol=None,
    maxiter=None,
    stagnation_window=30,
    explicit_residual=True,
):
    r"""Damped least squares by LSQR.

    :param A: operator ``(N,) -> (M,)`` (2-D tensor, numpy array, or
      callable); rectangular allowed.
    :param Ah: conjugate-transpose matvec ``(M,) -> (N,)``. Derived
      automatically for matrix operands and operators with ``.adj``;
      required for plain callables (the port's kernel operators have no
      reverse mode: on the north star pass
      :func:`krypy_tpu_torch.northstar.cd_transpose`, on Poisson the
      operator itself).
    :param damp: Tikhonov parameter; solves
      :math:`\min \|b-Ax\|^2 + \mathrm{damp}^2 \|x - x_0\|^2`.
    :param tol: stop when the estimated normal-equations residual
      satisfies :math:`\|A^H r_k\| \le \mathrm{tol}\,\|A\|_F\,\|r_k\|`.
    :param btol: additionally stop when the estimated residual satisfies
      :math:`\|r_k\| \le \mathrm{btol}\,\|b\|`; defaults to ``tol``.
    :param stagnation_window: stop after this many iterations without
      improvement of :math:`\|A^H r\|`.
    :param explicit_residual: verify an estimated stop against the
      explicitly recomputed true residual.
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`;
      ``resnorms[k]`` is the estimated :math:`\|r_k\|/\|b\|` of the
      damped system.  BREAKDOWN means the bidiagonalization terminated
      (invariant subspace).
    """
    pb = _Problem(A, b, Ah, damp, x0, tol, btol, maxiter, explicit_residual)
    R, damp = pb.R, pb.damp
    u, v, normb, beta0, alpha0 = pb.start()
    normar0 = alpha0 * beta0
    rel0 = _hdiv(beta0, normb)
    resnorms = [rel0]

    x, w = pb.x0v, v
    alpha, phibar, rhobar = alpha0, beta0, alpha0
    psi2 = R(0.0)
    normA2 = alpha0 ** 2
    best_ar, stall = normar0, 0
    done = CONVERGED if (rel0 <= pb.btol or normar0 == 0) else -1
    k = 0
    while done < 0 and k < pb.m:
        u, v, alpha, beta = pb.step(u, v, alpha)

        # eliminate the damping row
        rhobar1 = np.sqrt(rhobar ** 2 + damp ** 2)
        c1 = _hdiv(rhobar, rhobar1)
        psi = _hdiv(damp, rhobar1) * phibar
        phibar1 = c1 * phibar

        # QR rotation of the lower-bidiagonal column
        rho = np.sqrt(rhobar1 ** 2 + beta ** 2)
        c = _hdiv(rhobar1, rho)
        s = _hdiv(beta, rho)
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar1
        phibar = s * phibar1

        x = x + float(_hdiv(phi, rho)) * w
        w = v - float(_hdiv(theta, rho)) * w

        psi2 = psi2 + psi ** 2
        normA2 = normA2 + alpha ** 2 + beta ** 2 + damp ** 2
        # residual of the DAMPED system; equals ||b - A x|| when damp=0
        normr = np.sqrt(phibar ** 2 + psi2)
        # phibar carries the sign of the damp rotation's c1
        normar = np.abs(phibar) * alpha * np.abs(c)
        resnorms.append(_hdiv(normr, normb))

        ls_ok, res_ok, checked = pb.stop_tests(normar, normr, normA2,
                                               normb, x)
        stall, best_ar = _stall(normar, best_ar, stall,
                                checked and not (ls_ok or res_ok))
        done = _status(ls_ok, res_ok, alpha * beta == 0, stall,
                       stagnation_window)
        k += 1

    return pb.finish(x, resnorms, k, MAXITER if done < 0 else done)


def lsmr(
    A,
    b,
    *,
    Ah=None,
    damp=0.0,
    x0=None,
    tol=1e-8,
    btol=None,
    maxiter=None,
    stagnation_window=30,
    explicit_residual=True,
):
    r"""Damped least squares by LSMR.

    Same interface and stopping rules as :func:`lsqr`.  LSMR applies
    MINRES to the normal equations, so the minimized quantity
    :math:`\|A^H r_k\|` decreases monotonically; ``resnorms`` tracks the
    estimated :math:`\|r_k\|/\|b\|` of the damped system via the Fong &
    Saunders recurrences.
    """
    pb = _Problem(A, b, Ah, damp, x0, tol, btol, maxiter, explicit_residual)
    R, damp = pb.R, pb.damp
    u, v, normb, beta0, alpha0 = pb.start()
    normar0 = alpha0 * beta0
    rel0 = _hdiv(beta0, normb)
    resnorms = [rel0]
    one, zero = R(1.0), R(0.0)

    x, h = pb.x0v, v
    hbar = torch.zeros_like(v)
    alpha, alphabar, zetabar = alpha0, alpha0, normar0
    rho, rhobar, cbar, sbar = one, one, one, zero
    betadd, betad, rhodold = beta0, zero, one
    tautildeold, thetatilde, zeta, dknorm2 = zero, zero, zero, zero
    normA2 = alpha0 ** 2
    best_ar, stall = normar0, 0
    done = CONVERGED if (rel0 <= pb.btol or normar0 == 0) else -1
    k = 0
    while done < 0 and k < pb.m:
        u, v, alpha, beta = pb.step(u, v, alpha)

        # rotation eliminating the damping term
        alphahat = np.sqrt(alphabar ** 2 + damp ** 2)
        chat = _hdiv(alphabar, alphahat)
        shat = _hdiv(damp, alphahat)

        # rotation P_k flattening the bidiagonal
        rhoold = rho
        rho = np.sqrt(alphahat ** 2 + beta ** 2)
        c = _hdiv(alphahat, rho)
        s = _hdiv(beta, rho)
        thetanew = s * alpha
        alphabar = c * alpha

        # rotation Pbar_k for the MINRES-on-normal-equations QR
        rhobarold = rhobar
        zetaold = zeta
        thetabar = sbar * rho
        rhotemp = cbar * rho
        rhobar = np.sqrt(rhotemp ** 2 + thetanew ** 2)
        cbar = _hdiv(rhotemp, rhobar)
        sbar = _hdiv(thetanew, rhobar)
        zeta = cbar * zetabar
        zetabar = -sbar * zetabar

        # solution update
        hbar = h - float(_hdiv(thetabar * rho, rhoold * rhobarold)) * hbar
        x = x + float(_hdiv(zeta, rho * rhobar)) * hbar
        h = v - float(_hdiv(thetanew, rho)) * h

        # ||r|| estimation (Fong & Saunders section 5.1)
        betaacute = chat * betadd
        betacheck = -shat * betadd
        betahat = c * betaacute
        betadd = -s * betaacute

        thetatildeold = thetatilde
        rhotildeold = np.sqrt(rhodold ** 2 + thetabar ** 2)
        ctildeold = _hdiv(rhodold, rhotildeold)
        stildeold = _hdiv(thetabar, rhotildeold)
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * betad + ctildeold * betahat

        tautildeold = _hdiv(zetaold - thetatildeold * tautildeold,
                            rhotildeold)
        taud = _hdiv(zeta - thetatilde * tautildeold, rhodold)
        dknorm2 = dknorm2 + betacheck ** 2
        normr = np.sqrt(dknorm2 + (betad - taud) ** 2 + betadd ** 2)

        normA2 = normA2 + alpha ** 2 + beta ** 2 + damp ** 2
        normar = np.abs(zetabar)
        resnorms.append(_hdiv(normr, normb))

        ls_ok, res_ok, checked = pb.stop_tests(normar, normr, normA2,
                                               normb, x)
        stall, best_ar = _stall(normar, best_ar, stall,
                                checked and not (ls_ok or res_ok))
        done = _status(ls_ok, res_ok, alpha * beta == 0, stall,
                       stagnation_window)
        k += 1

    return pb.finish(x, resnorms, k, MAXITER if done < 0 else done)
