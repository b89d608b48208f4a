"""Preconditioned CG (counterpart of :mod:`krypy_tpu.functional.cg`,
classic variant).

The JAX core runs the whole solve as one ``lax.while_loop``.  Here the
same recurrence runs as a plain Python loop: the operators launch their
device work asynchronously, and the loop reads one scalar per iteration,
the updated relative residual, to decide whether to stop and whether to
verify against the explicit residual.  Every stop rule and every scalar
comparison is made in the system's real dtype, as in the compiled loop,
so the iteration counts agree with the JAX package.

Under an active mesh (:mod:`krypy_tpu_torch.parallel`) the vectors are
the rank's blocks and every inner product is a local partial and one
all-reduce (:func:`~krypy_tpu_torch.functional.common.make_inner`); the
scalars of the recurrence are the same bits on every rank.
"""

import numpy as np
import torch

from .common import (
    CONVERGED,
    MAXITER,
    SolveResult,
    apply,
    as_matvec,
    cast_matvec,
    global_length,
    make_inner,
    norm_from_pair,
    safe_div,
    system_dtype,
)

_NOT_PORTED = "is not ported yet (ROADMAP.md queue A, A3)"


def cg(
    A,
    b,
    *,
    M=None,
    Ml=None,
    Mr=None,
    ip=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    explicit_residual=False,
    exact_solution=None,
    progress=False,
    stagnation_window=0,
    operator_override=None,
    projected_r0=None,
    correct_xk=None,
    variant="classic",
    fused_deflation=None,
):
    r"""Solve :math:`M M_l A M_r y = M M_l b`, :math:`x = M_r y` with
    preconditioned CG.

    :param A: matvec callable or 2-D tensor.
    :param b: right-hand side ``(N,)`` (or ``(N, 1)``, returned likewise);
      its dtype (promoted with ``x0``'s) is the system dtype.
    :param M,Ml,Mr: optional preconditioner matvecs.
    :param ip: inner product: ``None`` (Euclidean) or a matrix ``B``.
    :param tol: relative residual tolerance.
    :param maxiter: iteration cap (default N).
    :param explicit_residual: recompute the true residual every iteration.
    :param exact_solution: optional ``(N,)`` for error-norm tracking.
    :param progress: print the relative residual of each iteration.
    :param operator_override: deflation hook: replaces the iteration
      operator :math:`M_l A M_r` (the projected operator).
    :param projected_r0: deflation hook: maps the left-preconditioned
      initial residual to its projected form.
    :param correct_xk: deflation hook: applied to each candidate solution
      before its residual is evaluated, and to the returned one.
    :param stagnation_window: if > 0, stop when the relative residual has
      not improved below 99% of its best value for this many consecutive
      iterations, and return the BEST iterate (x0 itself if the residual
      never improved).
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`.

    Every hook's output is cast to the system dtype.  ``variant="1r"``
    and ``fused_deflation`` raise ``NotImplementedError``.
    """
    if variant == "1r":
        raise NotImplementedError(f"cg variant='1r' {_NOT_PORTED}")
    if variant not in ("classic", "auto"):
        raise ValueError(f"unknown cg variant {variant!r}")
    if fused_deflation is not None:
        raise NotImplementedError(f"cg fused_deflation= {_NOT_PORTED}")

    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    maxiter = global_length(bv) if maxiter is None else int(maxiter)
    dev = bv.device

    pair, _ = make_inner(ip)
    dtype = system_dtype(bv, x0)
    bv = bv.to(dtype)
    A_mv, M_mv, Ml_mv, Mr_mv = (
        cast_matvec(as_matvec(f), dtype) for f in (A, M, Ml, Mr)
    )
    # the deflation hooks obey the system-dtype contract too
    operator_override, projected_r0, correct_xk = (
        cast_matvec(f, dtype)
        for f in (operator_override, projected_r0, correct_xk)
    )
    x0v = (torch.zeros(N, dtype=dtype, device=dev) if x0 is None
           else x0.reshape(-1).to(dtype))
    exact = (None if exact_solution is None
             else exact_solution.reshape(-1).to(dtype))
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    # host mirror of the device real dtype: the stop-rule comparisons
    # (rel <= tol, rel < 0.99 best) round exactly as the compiled loop's
    np_real = torch.empty(0, dtype=real_dtype).numpy().dtype.type
    tol_r = np_real(tol)

    def MlAMr(v):
        if operator_override is not None:
            return operator_override(v)
        return apply(Ml_mv, A_mv(apply(Mr_mv, v)))

    def residual_norm(x):
        Mlr = apply(Ml_mv, bv - A_mv(x))
        MMlr = apply(M_mv, Mlr)
        return norm_from_pair(pair, Mlr, MMlr)

    def xk_of(y):
        xk = x0v + apply(Mr_mv, y)
        return xk if correct_xk is None else correct_xk(xk)

    Mlb = apply(Ml_mv, bv)
    MMlb_norm = norm_from_pair(pair, Mlb, apply(M_mv, Mlb))

    Mlr = apply(Ml_mv, bv - A_mv(x0v))
    if projected_r0 is not None:
        Mlr = projected_r0(Mlr)
    MMlr = apply(M_mv, Mlr)
    MMlr_norm = norm_from_pair(pair, Mlr, MMlr)
    rel = np_real(safe_div(MMlr_norm, MMlb_norm).item())

    errnorm = None
    errs = []
    if exact is not None:
        def errnorm(x):
            return norm_from_pair(pair, exact - x)

        errs.append(errnorm(x0v))

    k = 0
    y = torch.zeros(N, dtype=dtype, device=dev)
    p = MMlr
    rho = MMlr_norm ** 2
    rho_old = torch.ones((), dtype=real_dtype, device=dev)
    best_rel = rel
    since_best = 0
    y_best = y
    resnorms = [rel]

    while (rel > tol_r and k < maxiter
           and (stagnation_window <= 0 or since_best < stagnation_window)):
        if k > 0:
            p = MMlr + safe_div(rho, rho_old) * p
        Ap = MlAMr(p)
        alpha = safe_div(rho, pair(p, Ap).real).real
        y = y + alpha * p
        Mlr = Mlr - alpha * Ap
        MMlr = apply(M_mv, Mlr)
        MMlr_norm = norm_from_pair(pair, Mlr, MMlr)
        rho_new = MMlr_norm ** 2
        # the one host read of the iteration
        rel_new = np_real(safe_div(MMlr_norm, MMlb_norm).item())
        if explicit_residual or rel_new <= tol_r or k + 1 == maxiter:
            rkn = residual_norm(xk_of(y))
            rel_new = np_real(safe_div(rkn, MMlb_norm).item())
            rho_new = rkn ** 2
        rho_old, rho = rho, rho_new
        if progress:
            print(f"cg iter {k + 1}: rel={rel_new:.3e}")
        resnorms.append(rel_new)
        if errnorm is not None:
            errs.append(errnorm(xk_of(y)))

        improved = rel_new < np_real(0.99) * best_rel
        if stagnation_window > 0 and rel_new < best_rel:
            y_best = y
        best_rel = min(best_rel, rel_new)
        since_best = 0 if improved else since_best + 1
        rel = rel_new
        k += 1

    if stagnation_window > 0:
        x = xk_of(y if rel <= best_rel else y_best)
        status = CONVERGED if best_rel <= tol_r else MAXITER
    else:
        x = xk_of(y)
        status = CONVERGED if rel <= tol_r else MAXITER

    res_t = torch.full((maxiter + 1,), float("nan"), dtype=real_dtype,
                       device=dev)
    res_t[: len(resnorms)] = torch.tensor(
        np.asarray(resnorms, dtype=np_real), dtype=real_dtype
    ).to(dev)
    err_t = None
    if errnorm is not None:
        err_t = torch.full((maxiter + 1,), float("nan"), dtype=real_dtype,
                           device=dev)
        err_t[: len(errs)] = torch.stack(errs)
    return SolveResult(
        x=x if flat else x[:, None],
        resnorms=res_t,
        niter=torch.tensor(k, dtype=torch.int64, device=dev),
        status=torch.tensor(status, dtype=torch.int64, device=dev),
        errnorms=err_t,
    )
