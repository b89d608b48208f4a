"""Preconditioned CG (counterpart of :mod:`krypy_tpu.functional.cg`).

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

``variant="1r"`` is the single-reduction rearrangement (Chronopoulos &
Gear 1989): a coupled recurrence ``s_k = A p_k`` lets alpha come from
``gamma = <r, u>`` and ``delta = <u, A u>``, two local products summed
by ONE all-reduce on a mesh (the JAX package's stacked ``(2, N) x (N,)``
product) instead of two reductions, at the cost of two more vector
updates.  With ``fused_deflation`` (a :class:`~krypy_tpu_torch.
functional.gmres.FusedDeflation` with its ``G``) the oblique projection
of the operator's image rides the same reduction, a ``(2 + 2d, N) x (N,
2)`` cross-Gram (:func:`~krypy_tpu_torch.functional.common.make_gram`):
still one all-reduce per deflated iteration.
"""

import numpy as np
import torch

from .common import (
    host_vectors,
    CONVERGED,
    MAXITER,
    SolveResult,
    apply,
    as_matvec,
    cast_matvec,
    global_length,
    is_scalar_ip,
    make_gram,
    make_inner,
    norm_from_pair,
    safe_div,
    system_dtype,
    twice_solver,
)
from ..parallel import active_mesh_size
from . import policy


def resolve_variant(solver, variant, ip, n_global, dtype, device,
                    syncs_saved=1):
    """The short recurrences' ``variant="auto"`` rule (the JAX package's):
    ``"1r"`` on a mesh of more than one rank where
    :func:`~krypy_tpu_torch.functional.policy.prefer_one_reduce` prices
    the saved sync points above the extra local sweeps of a shard of
    ``n_global // P`` (and ``ip`` is not a scalar callable),
    ``"classic"`` otherwise.  Other variants pass through."""
    if variant != "auto":
        return variant
    P = active_mesh_size()
    itemsize = torch.empty(0, dtype=dtype).element_size()
    if P > 1 and not is_scalar_ip(ip) and policy.prefer_one_reduce(
            solver, n_global // P, itemsize, syncs_saved, device):
        return "1r"
    return "classic"


def check_fused_deflation(fused_deflation, one_reduce, override,
                          override_name):
    """The JAX package's ``ValueError``s for ``fused_deflation``."""
    if fused_deflation is None:
        return
    if not one_reduce:
        raise ValueError(
            "fused_deflation requires variant='1r' (the deflation fold "
            "rides the one-reduce cross-Gram); classic takes the "
            f"{override_name} hook path")
    if override is not None:
        raise ValueError(f"fused_deflation and {override_name} are "
                         "mutually exclusive")


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
    :param variant: ``"classic"`` (two reductions per iteration),
      ``"1r"`` (the single-reduction rearrangement; ``ip`` ``None`` or a
      matrix) or ``"auto"`` (``"1r"`` on a mesh of more than one rank
      where :func:`~krypy_tpu_torch.functional.policy.prefer_one_reduce`
      says so, else ``"classic"``).
    :param fused_deflation: a ``FusedDeflation`` ``(UoT, W2T, G)``: fold
      the deflated operator's oblique projection into the one-reduce
      product (``variant="1r"`` only, exclusive of
      ``operator_override``).
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`.

    Every hook's output is cast to the system dtype.
    """
    b, x0, exact_solution = host_vectors(b, x0, exact_solution)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    dtype = system_dtype(bv, x0)
    dev = bv.device
    pair, rows = make_inner(ip)
    n_global = N
    if maxiter is None or (variant == "auto" and active_mesh_size() > 1):
        n_global = global_length(bv)
    maxiter = n_global if maxiter is None else int(maxiter)
    variant = resolve_variant("cg", variant, ip, n_global, dtype, dev)
    if variant not in ("classic", "1r"):
        raise ValueError(f"unknown cg variant {variant!r}")
    one_reduce = variant == "1r"
    if one_reduce and is_scalar_ip(ip):
        raise ValueError(
            "variant='1r' supports the Euclidean or operator-weighted "
            "inner product only (the one-reduce fusion batches both "
            "scalars through one stacked contraction, which a scalar "
            "callable ip cannot express)")
    check_fused_deflation(fused_deflation, one_reduce, operator_override,
                          "operator_override")
    gram = make_gram(ip) if one_reduce else None

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

    # fused deflation: the oblique projection of the operator's image
    # rides the one-reduce cross-Gram (rows Mlr, w, Uo, W2 against
    # columns MMlr, w), the second projection pass takes the stored
    # coupling Gram G = <Uo, W2>
    d_defl = 0
    if fused_deflation is not None:
        UoT = fused_deflation.UoT.to(dtype)
        W2T = fused_deflation.W2T.to(dtype)
        proj_coeffs = twice_solver(fused_deflation.G.to(dtype))
        d_defl = UoT.shape[0]

    k = 0
    y = torch.zeros(N, dtype=dtype, device=dev)
    rho = MMlr_norm ** 2
    rho_old = torch.ones((), dtype=real_dtype, device=dev)
    if one_reduce:
        # p and s start at zero: the first step (beta = 0) seats p = u0,
        # s = A u0
        w = MlAMr(MMlr)
        if d_defl:
            # the first image's projection: two reductions before the loop
            w = w - proj_coeffs(rows(UoT, w)) @ W2T
            Lb = torch.cat([torch.zeros((2, N), dtype=dtype, device=dev),
                            UoT, W2T])
        delta = pair(MMlr, w).real
        p = torch.zeros(N, dtype=dtype, device=dev)
        s_dir = torch.zeros(N, dtype=dtype, device=dev)
        alpha_old = torch.ones((), dtype=real_dtype, device=dev)
    else:
        p = MMlr
    best_rel = rel
    since_best = 0
    y_best = y
    resnorms = [rel]

    while (rel > tol_r and k < maxiter
           and (stagnation_window <= 0 or since_best < stagnation_window)):
        if one_reduce:
            # alpha from the gamma/delta recurrence; both scalars of the
            # next step from ONE stacked product at the bottom
            zero = torch.zeros((), dtype=real_dtype, device=dev)
            beta = safe_div(rho, rho_old) if k > 0 else zero
            pAp = delta - (safe_div(beta, alpha_old) if k > 0 else zero) \
                * rho
            alpha = safe_div(rho, pAp)
            p = MMlr + beta.to(dtype) * p
            s_dir = w + beta.to(dtype) * s_dir
            y = y + alpha.to(dtype) * p
            Mlr = Mlr - alpha.to(dtype) * s_dir
            MMlr = apply(M_mv, Mlr)
            w = MlAMr(MMlr)
            if d_defl:
                Lb[0], Lb[1] = Mlr, w
                G2 = gram(Lb, [MMlr, w])
                rho_new = torch.clamp(G2[0, 0].real, min=0.0)
                q = proj_coeffs(G2[2:2 + d_defl, 1])
                w = w - q @ W2T
                delta = (G2[1, 0] - torch.vdot(q, G2[2 + d_defl:, 0])).real
            else:
                # gamma = <Mlr, u>, delta = <w, u>: the one reduction
                both = gram([Mlr, w], [MMlr])[:, 0]
                rho_new = torch.clamp(both[0].real, min=0.0)
                delta = both[1].real
            MMlr_norm = torch.sqrt(rho_new)
            alpha_old = alpha.to(real_dtype)
        else:
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
