"""Preconditioned MINRES (counterpart of :mod:`krypy_tpu.functional.minres`).

Lanczos three-term recurrence, incremental QR by two lagged Givens
rotations and a three-column solution recurrence: O(1) memory in the
iteration count.  As in :mod:`~krypy_tpu_torch.functional.cg`, the JAX
package's ``lax.while_loop`` runs here as a plain Python loop that reads
ONE small tensor per iteration, the updated residual estimate and the
invariance flag, and makes every stop-rule comparison in the system's
real dtype, so that the iteration counts agree with the JAX package.
With ``M`` the Lanczos basis is kept as two bases, ``V = M P``.

Under an active mesh (:mod:`krypy_tpu_torch.parallel`) the vectors are
the rank's blocks and each inner product is a local partial and one
all-reduce (:func:`~krypy_tpu_torch.functional.common.make_inner`).

``variant="1r"`` is the single-reduction Lanczos rearrangement: the 2x2
cross-Gram of the current basis vector and the unorthogonalized ``w`` --
``nu = ||v||_M^2``, ``alpha' = <v, w>_M`` and ``sigma = ||w||_M^2`` --
comes out of local products summed by ONE all-reduce on a mesh
(:func:`~krypy_tpu_torch.functional.common.make_gram`), and the new
subdiagonal follows by the Pythagorean identity ``beta^2 = sigma -
alpha'^2 / nu``.  ``nu`` is measured, not assumed 1: the naive form
feeds its own rounding back through the next normalization and breaks
the recurrence within tens of iterations.  With ``M`` the scheme applies
``M`` twice per iteration (local work, no extra sync point).  With
``fused_deflation`` the oblique projection of the candidate rides the
same product: one all-reduce per deflated iteration.
"""

import numpy as np
import torch

from .common import (
    host_vectors,
    BREAKDOWN,
    CONVERGED,
    MAXITER,
    SolveResult,
    apply,
    as_matvec,
    breakdown_threshold,
    cast_matvec,
    givens,
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
from .cg import check_fused_deflation, resolve_variant

__all__ = ["minres"]


def minres(
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
    r"""Solve :math:`M M_l A M_r y = M M_l b` (:math:`M_l A M_r`
    self-adjoint with respect to ``ip``), :math:`x = M_r y`, with
    preconditioned MINRES.

    Parameters and result as in :func:`krypy_tpu_torch.functional.cg.cg`;
    ``ip`` is ``None``, a matrix ``B`` or a scalar callable ``ip(x, y)``.

    :param progress: print the relative residual of each iteration.
    :param stagnation_window: if > 0, also stop when the relative
      residual has not improved below 99% of its best value for this many
      consecutive iterations (the iterate is the last one, as in the JAX
      package).
    :param variant: ``"classic"``, ``"1r"`` (the single-reduction
      rearrangement; ``ip`` ``None`` or a matrix) or ``"auto"``, as in
      :func:`~krypy_tpu_torch.functional.cg.cg`.
    :param fused_deflation: a ``FusedDeflation`` ``(UoT, W2T, G)``, as in
      :func:`~krypy_tpu_torch.functional.cg.cg`.
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`;
      ``status`` is CONVERGED, MAXITER, or BREAKDOWN when the Krylov space
      became invariant short of the tolerance.
    """
    b, x0, exact_solution = host_vectors(b, x0, exact_solution)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    dtype = system_dtype(bv, x0)
    dev = bv.device
    pair, _ = make_inner(ip)
    n_global = N
    if maxiter is None or (variant == "auto" and active_mesh_size() > 1):
        n_global = global_length(bv)
    m = n_global if maxiter is None else int(maxiter)
    variant = resolve_variant("minres", variant, ip, n_global, dtype, dev)
    if variant not in ("classic", "1r"):
        raise ValueError(f"unknown minres variant {variant!r}")
    one_reduce = variant == "1r"
    if one_reduce and is_scalar_ip(ip):
        raise ValueError(
            "variant='1r' supports the Euclidean or operator-weighted "
            "inner product only (the one-reduce fusion batches nu, alpha "
            "and the squared norm through one cross-Gram contraction, "
            "which a scalar callable ip cannot express)")
    gram = make_gram(ip) if one_reduce else None
    check_fused_deflation(fused_deflation, one_reduce, operator_override,
                          "operator_override")

    with_M = M is not None
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
    # round exactly as the compiled loop's
    np_real = torch.empty(0, dtype=real_dtype).numpy().dtype.type
    tol_r = np_real(tol)
    brk = breakdown_threshold(dtype)

    def MlAMr(v):
        if operator_override is not None:
            return operator_override(v)
        return apply(Ml_mv, A_mv(apply(Mr_mv, v)))

    # fused deflation: the (2, N) x (N, 2 + 2d) cross-Gram against the
    # persistent right operand [v, M w | M W2 | Uo] yields the Lanczos
    # scalars, their projection corrections and (by conjugation) the
    # projection coefficients <Uo, w>; the sigma correction's quadratic
    # term takes K = <W2, M W2>, "twice is enough" the stored G
    d_defl = 0
    if fused_deflation is not None:
        UoT = fused_deflation.UoT.to(dtype)
        W2T = fused_deflation.W2T.to(dtype)
        proj_coeffs = twice_solver(fused_deflation.G.to(dtype))
        d_defl = UoT.shape[0]
        MW2T = torch.stack([M_mv(r) for r in W2T]) if with_M else W2T
        K = gram(W2T, MW2T)  # (d, d), one reduction before the loop
        Rb = torch.cat([torch.zeros((2, N), dtype=dtype, device=dev),
                        MW2T, UoT])

    def residual_norm(x):
        Mlr = apply(Ml_mv, bv - A_mv(x))
        return norm_from_pair(pair, Mlr, apply(M_mv, Mlr))

    def xk_of(y):
        xk = x0v + apply(Mr_mv, y)
        return xk if correct_xk is None else correct_xk(xk)

    Mlb = apply(Ml_mv, bv)
    MMlb_norm = norm_from_pair(pair, Mlb, apply(M_mv, Mlb))
    Mlr0 = apply(Ml_mv, bv - A_mv(x0v))
    if projected_r0 is not None:
        Mlr0 = projected_r0(Mlr0)
    MMlr0 = apply(M_mv, Mlr0)
    MMlr0_norm = norm_from_pair(pair, Mlr0, MMlr0)
    rel0 = safe_div(MMlr0_norm, MMlb_norm)

    inv0 = safe_div(torch.ones_like(MMlr0_norm), MMlr0_norm)
    zero_vec = torch.zeros(N, dtype=dtype, device=dev)
    # Lanczos vectors (V = M P) and, with M, the dual basis
    v_old, v_cur = zero_vec, MMlr0 * inv0
    p_old, p_cur = zero_vec, (Mlr0 * inv0 if with_M else None)
    beta = torch.zeros((), dtype=real_dtype, device=dev)
    # solution recurrence columns, the rotated rhs, the lagged rotations
    w1 = w2 = zero_vec
    ry = MMlr0_norm.to(dtype)
    c1 = torch.ones((), dtype=real_dtype, device=dev)
    s1 = torch.zeros((), dtype=dtype, device=dev)
    c2, s2 = c1, s1
    hsq = torch.zeros((), dtype=real_dtype, device=dev)
    y = zero_vec

    # the first host read: the initial residual and its invariance
    rel, inv = torch.stack([rel0, (MMlr0_norm == 0).to(real_dtype)]
                           ).tolist()
    rel, invariant = np_real(rel), bool(inv)
    resnorms = [rel]
    errs = []
    if exact is not None:
        def errnorm(x):
            return norm_from_pair(pair, exact - x)

        errs.append(errnorm(x0v))

    k = 0
    best_rel = rel
    since_best = 0
    while (rel > tol_r and k < m and not invariant
           and (stagnation_window <= 0 or since_best < stagnation_window)):
        # Lanczos step on the dual basis
        w = MlAMr(v_cur)
        w = w - beta * (p_old if with_M else v_old)
        if one_reduce:
            # the 2x2 cross-Gram in ONE product: rows [dual, w] against
            # columns [v, M w] give nu (measured), alpha' and sigma
            Mw1 = apply(M_mv, w) if with_M else w
            d = p_cur if with_M else v_cur
            if d_defl:
                Rb[0], Rb[1] = v_cur, Mw1
                G = gram([d, w], Rb)
                nu = torch.clamp(G[0, 0].real, min=0.0)
                q = proj_coeffs(G[1, 2 + d_defl:].conj())
                alpha_raw = (G[0, 1] - G[0, 2:2 + d_defl] @ q).real
                sigma = torch.clamp(
                    G[1, 1].real - 2.0 * (G[1, 2:2 + d_defl] @ q).real
                    + torch.vdot(q, K @ q).real, min=0.0)
                alpha = safe_div(alpha_raw, nu)
                # the exact total projection of the post-alpha candidate:
                # the Gram measured <Uo, d> too, so d's leak into the
                # deflation space is cancelled at no extra sync
                q_tot = q - alpha.to(dtype) * proj_coeffs(
                    G[0, 2 + d_defl:].conj())
                w = w - alpha * d - q_tot @ W2T
            else:
                G = gram([d, w], [v_cur, Mw1])
                nu = torch.clamp(G[0, 0].real, min=0.0)
                alpha_raw = G[0, 1].real
                sigma = torch.clamp(G[1, 1].real, min=0.0)
                alpha = safe_div(alpha_raw, nu)
                w = w - alpha * d
            beta_new = torch.sqrt(torch.clamp(sigma - alpha * alpha_raw,
                                              min=0.0))
            if with_M:
                # a FRESH M apply: M w by the recurrence Mw1 - alpha v
                # lets the v = M p invariant's rounding compound
                Mw = apply(M_mv, w)
        else:
            alpha = pair(v_cur, w).real
            w = w - alpha * (p_cur if with_M else v_cur)
            if with_M:
                Mw = apply(M_mv, w)
                beta_new = norm_from_pair(pair, w, Mw)
            else:
                beta_new = norm_from_pair(pair, w)

        hsq = hsq + beta ** 2 + alpha ** 2 + beta_new ** 2
        inv_t = beta_new <= brk * torch.sqrt(hsq)
        inv_b = torch.where(inv_t, 0.0,
                            safe_div(torch.ones_like(beta_new), beta_new))
        v_new = (Mw if with_M else w) * inv_b
        p_new = w * inv_b if with_M else p_cur

        # QR update of the tridiagonal column [0, beta_k, alpha_k,
        # beta_{k+1}] by the two lagged rotations
        r0 = c1 * 0.0 + s1 * beta
        r1 = c1 * beta
        r1_rot = c2 * r1 + s2 * alpha
        r2_rot = -s2.conj() * r1 + c2 * alpha
        c_new, s_new, r_diag = givens(r2_rot, beta_new.to(dtype))
        ry0 = c_new * ry
        ry = -s_new.conj() * ry
        z = (v_cur - r0 * w1 - r1_rot * w2) * safe_div(
            torch.ones_like(r_diag.real), r_diag.real)
        y = y + ry0 * z

        rel_upd = safe_div(ry.abs(), MMlb_norm)
        # the one host read of the iteration
        rel_upd, inv = torch.stack([rel_upd, inv_t.to(real_dtype)]).tolist()
        rel_upd, invariant = np_real(rel_upd), bool(inv)
        if explicit_residual or rel_upd <= tol_r or k + 1 == m or invariant:
            rel = np_real(safe_div(residual_norm(xk_of(y)),
                                   MMlb_norm).item())
        else:
            rel = rel_upd
        if progress:
            print(f"minres iter {k + 1}: rel={rel:.3e}")
        resnorms.append(rel)
        if exact is not None:
            errs.append(errnorm(xk_of(y)))

        improved = rel < np_real(0.99) * best_rel
        best_rel = min(best_rel, rel)
        since_best = 0 if improved else since_best + 1

        v_old, v_cur = v_cur, v_new
        if with_M:
            p_old, p_cur = p_cur, p_new
        beta = beta_new
        w1, w2 = w2, z
        c1, s1, c2, s2 = c2, s2, c_new.real, s_new
        k += 1

    x = xk_of(y)
    if rel <= tol_r:
        status = CONVERGED
    else:
        status = BREAKDOWN if invariant else MAXITER
    res_t = torch.full((m + 1,), float("nan"), dtype=real_dtype, device=dev)
    res_t[: len(resnorms)] = torch.tensor(
        np.asarray(resnorms, dtype=np_real), dtype=real_dtype
    ).to(dev)
    err_t = None
    if exact is not None:
        err_t = torch.full((m + 1,), float("nan"), dtype=real_dtype,
                           device=dev)
        err_t[: len(errs)] = torch.stack(errs)
    return SolveResult(
        x=x if flat else x[:, None],
        resnorms=res_t,
        niter=torch.tensor(k, dtype=torch.int64, device=dev),
        status=torch.tensor(status, dtype=torch.int64, device=dev),
        errnorms=err_t,
    )
