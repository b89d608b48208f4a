"""Preconditioned GMRES and restarted GMRES (counterpart of
:mod:`krypy_tpu.functional.gmres`, the ``cgs2`` and ``cgs2_fused``
schemes).

The JAX core runs a solve as one ``lax.while_loop``.  Here the same body
runs as a plain Python loop, as :mod:`~krypy_tpu_torch.functional.cg`
does: the Arnoldi step, the Givens update of the Hessenberg column and
the residual estimate stay on the device, and each iteration reads ONE
small tensor to the host, the updated residual estimate and the
invariance flag, to decide whether to stop and whether to verify against
the explicit residual (read on the iterations where the JAX body
computes it).  Every stop rule is compared in the system's real dtype,
so the iteration counts agree with the JAX package.

The Krylov basis lives in a zeroed ``(maxiter+1, N)`` row-major buffer.
``ortho="cgs2"`` sweeps the whole buffer with masked rows (two passes of
batched classical Gram-Schmidt); ``ortho="cgs2_fused"`` runs the three
prefix-sweep kernels of :mod:`krypy_tpu_torch.kernels.orthogonalize` over
the ``k + 1`` active rows only.  The JAX package's static prefix buckets
are not ported: ``rows`` is a run-time argument, and the rows past ``k``
that a bucket adds are zero with zero mask, so the arithmetic is the
same.
"""

import numpy as np
import torch

from ..kernels.orthogonalize import cgs2_fused, max_rows
from .common import (
    BREAKDOWN,
    CONVERGED,
    MAXITER,
    SolveResult,
    apply,
    as_matvec,
    breakdown_threshold,
    cast_matvec,
    givens,
    make_inner,
    norm_from_pair,
    safe_div,
    system_dtype,
)

__all__ = ["gmres", "restarted_gmres"]

_NOT_PORTED = "is not ported yet (ROADMAP.md queue A, item 7)"
#: the JAX package's other schemes
_UNPORTED_ORTHO = ("cgs", "mgs", "dmgs", "bmgs", "bmgs2", "cgs_pallas",
                   "cgs2_pallas", "cgs2_1r")


def _resolve_ortho(ortho, dtype, device, rows):
    """The port's ``ortho="auto"`` rule: ``cgs2_fused`` for a float32
    system on a CUDA device whose ``rows``-row basis fits the kernels
    (Euclidean inner product, no ``M``, no ``basis_dtype``: the only
    forms ported), ``cgs2`` otherwise.  An explicit ``cgs2_fused`` on a
    CUDA device with a basis taller than the kernels take raises here,
    before the first iteration."""
    limit = max_rows(torch.empty(0, dtype=dtype).element_size())
    if ortho == "auto":
        if dtype == torch.float32 and device.type == "cuda" and \
                rows <= limit:
            return "cgs2_fused"
        return "cgs2"
    if ortho == "cgs2_fused" and device.type == "cuda" and rows > limit:
        raise ValueError(
            f"gmres ortho='cgs2_fused': a basis of maxiter + 1 = {rows} rows "
            f"exceeds the kernels' {limit} at {dtype}; use ortho='cgs2' or "
            f"a smaller maxiter")
    if ortho in ("cgs2", "cgs2_fused"):
        return ortho
    if ortho in _UNPORTED_ORTHO:
        raise NotImplementedError(f"gmres ortho={ortho!r} {_NOT_PORTED}")
    raise ValueError(f"unknown ortho {ortho!r}")


def gmres(
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
    ortho="cgs2",
    explicit_residual=False,
    exact_solution=None,
    progress=False,
    operator_with_capture=None,
    capture_width=0,
    projected_r0=None,
    correct_xk=None,
    return_internal=False,
    basis_dtype=None,
    fused_deflation=None,
):
    r"""Solve :math:`M_l A M_r y = M_l b`, :math:`x = M_r y` with
    preconditioned GMRES.

    :param A: matvec callable or 2-D tensor.
    :param b: right-hand side ``(N,)`` (or ``(N, 1)``, returned likewise);
      its dtype (promoted with ``x0``'s) is the system dtype.
    :param Ml,Mr: optional left/right preconditioner matvecs.
    :param x0: optional initial guess.
    :param tol: relative residual tolerance (of the left-preconditioned
      residual).
    :param maxiter: iteration cap, which is also the basis height (default
      N).
    :param ortho: ``"cgs2"`` (two passes of batched CGS over the full
      buffer), ``"cgs2_fused"`` (K4 -> K5 -> K6 over the active prefix) or
      ``"auto"``: ``"cgs2_fused"`` for a float32 system on a CUDA device
      whose ``maxiter + 1`` basis rows fit the kernels (at most
      :func:`~krypy_tpu_torch.kernels.orthogonalize.max_rows`, 1709 in
      float32), ``"cgs2"`` otherwise (the only eligible forms: Euclidean
      inner product, no ``M``, no ``basis_dtype``).  ``"cgs2_fused"`` on
      a CUDA device with a taller basis raises ``ValueError``.
    :param explicit_residual: recompute the true residual every iteration.
    :param exact_solution: optional ``(N,)`` for error-norm tracking.
    :param progress: print the relative residual of each iteration.
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`;
      ``status`` is CONVERGED, MAXITER, or BREAKDOWN when the Krylov space
      became invariant.

    ``M``, ``ip``, ``basis_dtype``, the deflation hooks
    (``operator_with_capture``/``capture_width``, ``projected_r0``,
    ``correct_xk``, ``fused_deflation``), ``return_internal`` and the
    other ``ortho`` schemes raise ``NotImplementedError``.
    """
    for name, val in (("M", M), ("ip", ip), ("basis_dtype", basis_dtype),
                      ("operator_with_capture", operator_with_capture),
                      ("projected_r0", projected_r0),
                      ("correct_xk", correct_xk),
                      ("fused_deflation", fused_deflation)):
        if val is not None:
            raise NotImplementedError(f"gmres {name}= {_NOT_PORTED}")
    if capture_width or return_internal:
        raise NotImplementedError(
            f"gmres capture_width/return_internal {_NOT_PORTED}")

    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    m = N if maxiter is None else int(maxiter)
    dev = bv.device
    dtype = system_dtype(bv, x0)
    ortho = _resolve_ortho(ortho, dtype, dev, m + 1)

    pair, rows = make_inner(None)
    bv = bv.to(dtype)
    A_mv, Ml_mv, Mr_mv = (
        cast_matvec(as_matvec(f), dtype) for f in (A, Ml, Mr)
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
        return apply(Ml_mv, A_mv(apply(Mr_mv, v)))

    def residual_norm(x):
        return norm_from_pair(pair, apply(Ml_mv, bv - A_mv(x)))

    MMlb_norm = norm_from_pair(pair, apply(Ml_mv, bv))
    Mlr0 = apply(Ml_mv, bv - A_mv(x0v))
    MMlr0_norm = norm_from_pair(pair, Mlr0)
    rel0 = safe_div(MMlr0_norm, MMlb_norm)

    V = torch.zeros((m + 1, N), dtype=dtype, device=dev)
    V[0] = Mlr0 * ((MMlr0_norm > 0).to(real_dtype)
                   * safe_div(torch.ones_like(MMlr0_norm), MMlr0_norm))
    R = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    Q = torch.eye(m + 1, dtype=dtype, device=dev)
    y = torch.zeros(m + 1, dtype=dtype, device=dev)
    y[0] = MMlr0_norm.to(dtype)
    hsq = torch.zeros((), dtype=real_dtype, device=dev)
    row_idx = torch.arange(m + 1, device=dev)

    def xk_from(kk):
        """x_k = x0 + Mr (V[:m]^T yy) with a masked triangular solve of
        the leading kk x kk system: rows/columns >= kk get a unit diagonal
        and a zero right-hand side, so the fixed-shape solve yields the
        exact kk-dimensional solution."""
        col_mask = row_idx[:m] < kk
        Rk = R[:m, :m] + torch.diag(
            torch.where(col_mask, 0.0, 1.0).to(dtype))
        rhs = torch.where(col_mask, y[:m], 0.0)
        yy = torch.linalg.solve_triangular(Rk, rhs[:, None], upper=True)
        return x0v + apply(Mr_mv, yy[:, 0] @ V[:m])

    def orthogonalize(w, k):
        """``(w_orth, h)``: two Gram-Schmidt passes against rows 0..k."""
        mask = (row_idx <= k).to(real_dtype)
        if ortho == "cgs2_fused":
            return cgs2_fused(V, w.contiguous(), mask, rows=k + 1)
        h = torch.zeros(m + 1, dtype=dtype, device=dev)
        for _ in range(2):
            coeffs = rows(V, w) * mask
            w = w - coeffs @ V
            h = h + coeffs
        return w, h

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
    while rel > tol_r and k < m and not invariant:
        w, h = orthogonalize(MlAMr(V[k]), k)
        hnew = norm_from_pair(pair, w)
        # invariance detection on the relative subdiagonal, with the
        # Frobenius norm of H carried incrementally
        hsq = hsq + torch.sum(h.abs() ** 2) + hnew ** 2
        inv_t = hnew <= brk * torch.sqrt(hsq)
        h[k + 1] = hnew.to(dtype)
        inv_h = torch.where(inv_t, 0.0,
                            safe_div(torch.ones_like(hnew), hnew))
        V[k + 1] = w * inv_h

        # the k previous rotations in ONE small matvec against their
        # accumulated product (rows >= k of Q are still identity)
        col = Q @ h
        c, s, r = givens(col[k], col[k + 1])
        col[k] = r
        col[k + 1] = 0.0
        qk, qk1 = Q[k].clone(), Q[k + 1].clone()
        Q[k] = c * qk + s * qk1
        Q[k + 1] = -s.conj() * qk + c * qk1
        R[:, k] = col
        yk = y[k].clone()
        y[k] = c * yk
        y[k + 1] = -s.conj() * yk

        rel_upd = safe_div(y[k + 1].abs(), MMlb_norm)
        # the one host read of the iteration
        rel_upd, inv = torch.stack([rel_upd, inv_t.to(real_dtype)]).tolist()
        rel_upd, invariant = np_real(rel_upd), bool(inv)
        if explicit_residual or rel_upd <= tol_r or k + 1 == m or invariant:
            rel = np_real(safe_div(residual_norm(xk_from(k + 1)),
                                   MMlb_norm).item())
        else:
            rel = rel_upd
        if progress:
            print(f"gmres iter {k + 1}: rel={rel:.3e}")
        resnorms.append(rel)
        if exact is not None:
            errs.append(errnorm(xk_from(k + 1)))
        k += 1

    x = xk_from(k)
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


def restarted_gmres(A, b, *, max_restarts=0, maxiter=None, tol=1e-5,
                    compiled=False, **kwargs):
    """Restarted GMRES: up to ``max_restarts + 1`` cycles of
    :func:`gmres`, each started from the last iterate (reference:
    krypy/linsys.py:1021-1072); stops after a cycle that converged or
    broke down.  Both forms are host loops.

    :param compiled: keep the JAX package's ``compiled=True`` contract:
      ``resnorms`` holds one entry per CYCLE (``[0]`` the initial relative
      residual, then each cycle's final one, NaN past the last cycle),
      ``niter`` counts the inner iterations of all cycles, and
      ``errnorms`` is None.  Otherwise ``resnorms`` is the per-iteration
      history across cycles and the other fields are the last cycle's.
    """
    x = kwargs.pop("x0", None)
    if x is None:
        x = torch.zeros(b.reshape(-1).shape[0], dtype=b.dtype,
                        device=b.device)
        if b.ndim > 1:
            x = x[:, None]

    if compiled:
        return _restarted_gmres_compiled(A, b, x, max_restarts, maxiter, tol,
                                         kwargs)

    resnorms = []
    result = None
    for _ in range(max_restarts + 1):
        result = gmres(A, b, x0=x, tol=tol, maxiter=maxiter, **kwargs)
        niter = int(result.niter)
        chunk = result.resnorms[: niter + 1].tolist()
        resnorms = resnorms[:-1] + chunk if resnorms else chunk
        x = result.x
        if int(result.status) in (CONVERGED, BREAKDOWN):
            break
    return result._replace(
        resnorms=torch.tensor(resnorms, dtype=result.resnorms.dtype,
                              device=result.resnorms.device),
        x=x,
    )


def _restarted_gmres_compiled(A, b, x0, max_restarts, maxiter, tol, kwargs):
    """The ``compiled=True`` contract of :func:`restarted_gmres`, as a host
    loop over cycles."""
    cycles = int(max_restarts) + 1
    real_dtype = torch.empty(0, dtype=b.dtype).real.dtype
    rels = torch.full((cycles + 1,), float("nan"), dtype=real_dtype,
                      device=b.device)
    x, status, nit, i = x0, MAXITER, 0, 0
    while i < cycles and status == MAXITER:
        res = gmres(A, b, x0=x, tol=tol, maxiter=maxiter, **kwargs)
        if i == 0:
            rels[0] = res.resnorms[0]
        niter = int(res.niter)
        rels[i + 1] = res.resnorms[niter]
        x, status = res.x, int(res.status)
        nit += niter
        i += 1
    dev = b.device
    return SolveResult(
        x=x, resnorms=rels,
        niter=torch.tensor(nit, dtype=torch.int64, device=dev),
        status=torch.tensor(status, dtype=torch.int64, device=dev),
    )
