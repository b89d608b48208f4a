r"""QMR on the two-sided Lanczos process (counterpart of
:mod:`krypy_tpu.functional.qmr`).

Freund & Nachtigal's quasi-minimal residual method in its bilinear form
(unconjugated ``w^T v`` couplings, the transpose ``A^T``, not ``A^H``),
right-preconditioned by composition: the recurrence runs on ``A_hat = A
M``, whose transpose is ``M^T A^T``, and one final ``M`` maps the iterate
back, so the tracked residual is the true residual.  Per iteration one
``A_hat`` and one ``A_hat^T`` application.

The transpose comes from ``AT=``/``MT=`` or, where they are absent, from
:func:`transpose_matvec`: the reverse-mode derivative of the matvec.
K1 (:func:`krypy_tpu_torch.kernels.stencil5_affine`) has no reverse mode,
as the JAX package's Pallas K1 has no transpose rule, so ``qmr`` on an
operator that runs K1 takes ``AT=``: for a constant-coefficient stencil
``(cc, cu, cd, cl, cr)`` it is the stencil ``(cc, cd, cu, cr, cl)``.

``variant="1r"`` takes every scalar of an iteration from ONE cross-Gram
(:func:`~krypy_tpu_torch.functional.common.make_gram`: local products,
one all-reduce on a mesh), as the JAX package's: the couplings carried
one step, the normalizations and the residual norm by one-step
expansions anchored on measured products.  The host loop reads the
updated residual and the breakdown flag once per iteration
(:mod:`~krypy_tpu_torch.functional._short`).
"""

import numpy as np
import torch

from . import _short
from .cg import resolve_variant
from .common import (
    BREAKDOWN,
    CONVERGED,
    MAXITER,
    apply,
    as_matvec,
    cast_matvec,
    make_gram,
    safe_div,
)

__all__ = ["qmr", "transpose_matvec"]


def transpose_matvec(mv, N, dtype, *, device="cuda"):
    """Bilinear transpose ``x -> A^T x`` of a linear matvec on ``(N,)``
    vectors of ``dtype``: the vector-Jacobian product of ``mv`` at zero
    (``torch.func.vjp``), which torch takes as ``A^H x``; for a complex
    dtype it is conjugated on both sides into ``A^T x``, what
    ``jax.linear_transpose`` gives.  ``mv`` must be linear and
    differentiable in reverse mode (the plain operators of
    :mod:`krypy_tpu_torch.ops` are; K1 is not, and the returned function
    raises ``NotImplementedError`` on its first call there)."""
    zero = torch.zeros(N, dtype=dtype, device=device)
    _, vjp = torch.func.vjp(mv, zero)
    cplx = dtype.is_complex

    def At(x):
        if cplx:
            return vjp(x.conj())[0].conj()
        return vjp(x)[0]

    return At


def qmr(
    A,
    b,
    *,
    M=None,
    AT=None,
    MT=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    stagnation_window=0,
    explicit_residual=False,
    variant="classic",
):
    r"""Solve nonsymmetric ``A x = b`` with right-preconditioned QMR.

    :param M: optional right preconditioner (the recurrence runs on ``A
      M``; the tracked residual is the true residual).
    :param AT: optional transpose matvec ``x -> A^T x`` (bilinear, no
      conjugation).  Default: :func:`transpose_matvec` of ``A``; an
      operator that runs K1 needs it (module docstring).
    :param MT: optional transpose of ``M`` (same contract).  With neither
      ``AT`` nor ``MT`` the transpose of ``A M`` is taken whole.
    :param stagnation_window: if > 0, stop after this many iterations
      without improving the best residual below 99% of it.
    :param explicit_residual: recompute the true residual every
      iteration.
    :param variant: ``"classic"`` (four reductions per iteration),
      ``"1r"`` (one cross-Gram per iteration) or ``"auto"`` (``"1r"`` on
      a mesh of more than one rank where
      :func:`~krypy_tpu_torch.functional.policy.prefer_one_reduce` prices
      the three saved sync points above the extra sweeps).
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`;
      BREAKDOWN when a Lanczos coefficient vanished after the first
      iteration.
    """
    sy = _short.System(A, b, x0, M)
    A_mv, (M_mv,) = sy.A_mv, sy.operators
    dtype, dev, N = sy.dtype, sy.dev, sy.N
    n_global = sy.n_global()
    maxiter = n_global if maxiter is None else int(maxiter)
    variant = resolve_variant("qmr", variant, None, n_global, dtype, dev,
                              syncs_saved=3)
    if variant not in ("classic", "1r"):
        raise ValueError(f"unknown qmr variant {variant!r}")
    one_reduce = variant == "1r"
    gram = make_gram(None) if one_reduce else None
    tol_r = sy.np_real(tol)
    eps_tiny = sy.eps

    def Ahat(x):
        return A_mv(apply(M_mv, x))

    if AT is None and MT is None:
        Ahat_t = transpose_matvec(Ahat, N, dtype, device=dev)
    else:
        AT_mv = (cast_matvec(as_matvec(AT), dtype) if AT is not None
                 else transpose_matvec(A_mv, N, dtype, device=dev))
        if M_mv is None:
            MT_mv = None
        elif MT is not None:
            MT_mv = cast_matvec(as_matvec(MT), dtype)
        else:
            MT_mv = transpose_matvec(M_mv, N, dtype, device=dev)

        def Ahat_t(x):
            return apply(MT_mv, AT_mv(x))

    bv, x0v = sy.bv, sy.x0v
    bnorm = _short.norm(bv)
    r = bv - A_mv(x0v)
    rho0 = _short.norm(r).to(dtype)
    rel, zero_r = _short.read(safe_div(_short.norm(r), bnorm), rho0 == 0)
    rel = sy.np_real(rel)
    if one_reduce:
        # the entry's reduction: the first coupling r0^T r0 / rho0^2
        # (bilinear); the loop measures ||r||^2 itself
        delta_c = safe_div(_short.bilinear(r, r), rho0 * rho0)
    vt = wt = r
    u = p = q = d = s = sy.zeros()
    rho = xi = rho0
    eps = sy.scalar(1.0)
    gamma = sy.scalar(1.0, real=True)
    eta = sy.scalar(-1.0)
    theta = sy.scalar(0.0, real=True)
    # a zero residual must not divide; the loop is skipped anyway
    broken = bool(zero_r)
    best, stall, k = rel, 0, 0
    resnorms = [rel]

    while (rel > tol_r and k < maxiter and not broken
           and (stagnation_window <= 0 or stall < stagnation_window)):
        v = vt / rho
        w = wt / xi
        delta = delta_c if one_reduce else _short.bilinear(w, v)
        if k == 0:
            p, q = v, w
        else:
            p = v - safe_div(xi * delta, eps) * p
            q = w - safe_div(rho * delta, eps) * q
        pt = Ahat(p)
        if one_reduce:
            # THE one reduction: the bilinear couplings (rows conjugated
            # ahead of the conjugating product), the norm-expansion
            # products and the measured anchors <v,v>, <w,w>, w^T v, <r,r>
            wta = Ahat_t(q)
            G = gram(torch.stack([pt, wta, r, s, w.conj(), q.conj(),
                                  wta.conj(), v, w]),
                     [v, pt, w, s, wta, r])
            pt_v, pt_pt, pt_s = G[0, 0], G[0, 1].real, G[0, 3]
            wta_w, wta_wta = G[1, 2], G[1, 4].real
            r_pt, r_s, rr_m = G[2, 1], G[2, 3], G[2, 5].real
            s_s = G[3, 3].real
            w_pt_b, delta_m = G[4, 1], G[4, 0]
            eps_k = G[5, 1]
            wta_pt_b, wta_v_b = G[6, 1], G[6, 0]
            nu_v, nu_w = G[7, 0].real, G[8, 2].real

            delta = delta_m
            beta = safe_div(eps_k, delta_m)
            b2 = beta.abs() ** 2
            rho_new = torch.sqrt(torch.clamp(
                pt_pt - 2.0 * (beta * pt_v).real + b2 * nu_v, min=0.0)
            ).to(dtype)
            xi_new = torch.sqrt(torch.clamp(
                wta_wta - 2.0 * (beta * wta_w).real + b2 * nu_w, min=0.0)
            ).to(dtype)
            vt = pt - beta * v
            wt = wta - beta * w
            # the next coupling wt^T vt, expanded from Gram entries
            wtvt = (wta_pt_b - beta * wta_v_b - beta * w_pt_b
                    + beta * beta * delta_m)
            delta_c = safe_div(wtvt, (rho_new * xi_new).to(dtype))
        else:
            eps_k = _short.bilinear(q, pt)
            beta = safe_div(eps_k, delta)
            vt = pt - beta * v
            rho_new = _short.norm(vt).to(dtype)
            wt = Ahat_t(q) - beta * w
            xi_new = _short.norm(wt).to(dtype)

        theta_new = safe_div(rho_new, gamma * beta.abs()).real.to(
            sy.real_dtype)
        gamma_new = 1.0 / torch.sqrt(1.0 + theta_new * theta_new)
        eta = -safe_div(eta * rho * gamma_new * gamma_new,
                        beta * gamma * gamma)
        # the shrink factor; zero on the first iteration, where d and s
        # are still zero
        sh = ((theta * gamma_new) ** 2 if k
              else torch.zeros_like(theta))
        d = eta * p + sh * d
        s = eta * pt + sh * s
        u = u + d
        r_new = r - s

        if one_reduce:
            # the residual norm by a one-step expansion of r - eta pt -
            # sh s_old, anchored on the measured <r, r>
            rr = torch.clamp(
                rr_m - 2.0 * (eta * r_pt + sh * r_s).real
                + eta.abs() ** 2 * pt_pt
                + 2.0 * sh * (eta.conj() * pt_s).real
                + sh * sh * s_s, min=0.0)
            rel_upd = safe_div(torch.sqrt(rr), bnorm)
        else:
            rel_upd = safe_div(_short.norm(r_new), bnorm)
        r = r_new
        lost = ((delta.abs() <= eps_tiny) | (eps_k.abs() <= eps_tiny)
                | (rho_new.abs() <= eps_tiny) | (xi_new.abs() <= eps_tiny)
                | (gamma_new <= eps_tiny))
        rel_upd, lost = _short.read(rel_upd, lost)
        rel = sy.np_real(rel_upd)
        if explicit_residual or rel <= tol_r or k + 1 == maxiter:
            rel = sy.true_rel(x0v + apply(M_mv, u), bnorm)
        broken = bool(lost) or not np.isfinite(rel)
        stall = 0 if rel < sy.np_real(0.99) * best else stall + 1
        best = np.minimum(best, rel)
        resnorms.append(rel)
        rho, xi, eps, gamma, theta = rho_new, xi_new, eps_k, gamma_new, \
            theta_new
        k += 1

    if rel <= tol_r:
        status = CONVERGED
    else:
        status = BREAKDOWN if broken and k > 0 else MAXITER
    return sy.finish(x0v + apply(M_mv, u), resnorms, maxiter + 1, k,
                     status)
