"""Preconditioned GMRES and restarted GMRES (counterpart of
:mod:`krypy_tpu.functional.gmres`: the batched classical Gram-Schmidt
schemes ``cgs``/``cgs2``, their kernel forms ``cgs_pallas``/``cgs2_pallas``
and ``cgs2_fused``, the dual basis of ``M``, the deflation hooks and
``return_internal``).

The JAX core runs a solve as one ``lax.while_loop``.  Here the same body
runs as a plain Python loop, as :mod:`~krypy_tpu_torch.functional.cg`
does: the Arnoldi step, the Givens update of the Hessenberg column and
the residual estimate stay on the device, and each iteration reads ONE
small tensor to the host, the updated residual estimate and the
invariance flag, to decide whether to stop and whether to verify against
the explicit residual (read on the iterations where the JAX body
computes it).  Every stop rule is compared in the system's real dtype,
so the iteration counts agree with the JAX package.

The Krylov basis lives in a zeroed ``(maxiter+1, N)`` row-major buffer
``V``; with ``M`` a second one, the dual basis ``P`` with ``V = M P``,
along which the projections subtract.  ``ortho="cgs"``/``"cgs2"`` sweep
the whole buffer with masked rows (one or two passes of batched classical
Gram-Schmidt); the kernel schemes of
:mod:`krypy_tpu_torch.kernels.orthogonalize` read the ``k + 1`` active
rows only: ``"cgs_pallas"``/``"cgs2_pallas"`` run K7 (``cgs_project``)
once or twice, ``"cgs2_fused"`` the three prefix sweeps K4-K6.  The JAX
package's static prefix buckets and full-height masked kernel sweep are
not ported: ``rows`` is a run-time argument, and the rows past ``k`` are
zero with zero mask, so the arithmetic is the same.
"""

import numpy as np
import torch

from ..kernels.orthogonalize import cgs2_fused, cgs_project, max_rows
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
#: Gram-Schmidt passes per iteration of each ported scheme
_PASSES = {"cgs": 1, "cgs2": 2, "cgs_pallas": 1, "cgs2_pallas": 2,
           "cgs2_fused": 2}
#: the schemes that run a kernel, and the kernel whose row limit binds
_KERNEL_OF = {"cgs_pallas": "cgs_project", "cgs2_pallas": "cgs_project",
              "cgs2_fused": "apply_project"}
#: the JAX package's other schemes
_UNPORTED_ORTHO = ("mgs", "dmgs", "bmgs", "bmgs2", "cgs2_1r")


def _resolve_ortho(ortho, dtype, device, rows, with_M=False):
    """The port's ``ortho="auto"`` rule: ``cgs2_fused`` for a float32
    system on a CUDA device whose ``rows``-row basis fits the kernels
    (Euclidean inner product, no ``M``, no ``basis_dtype``), ``cgs2``
    otherwise.  An explicit kernel scheme on a CUDA device with a basis
    taller than its kernels take raises here, before the first
    iteration; so does ``cgs2_fused`` with ``M`` (it has no dual-basis
    form)."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    if ortho == "auto":
        if dtype == torch.float32 and device.type == "cuda" and \
                not with_M and rows <= max_rows(itemsize):
            return "cgs2_fused"
        return "cgs2"
    if ortho == "cgs2_fused" and with_M:
        raise ValueError(
            "ortho='cgs2_fused' does not support the dual-basis form "
            "required by M; use ortho='cgs2' or 'cgs2_pallas'")
    if ortho in _KERNEL_OF and device.type == "cuda":
        limit = max_rows(itemsize, _KERNEL_OF[ortho])
        if rows > limit:
            raise ValueError(
                f"gmres ortho={ortho!r}: a basis of maxiter + 1 = {rows} "
                f"rows exceeds the kernels' {limit} at {dtype}; use "
                f"ortho='cgs2' or a smaller maxiter")
    if ortho in _PASSES:
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
    r"""Solve :math:`M M_l A M_r y = M M_l b`, :math:`x = M_r y` with
    preconditioned GMRES.

    :param A: matvec callable or 2-D tensor.
    :param b: right-hand side ``(N,)`` (or ``(N, 1)``, returned likewise);
      its dtype (promoted with ``x0``'s) is the system dtype.
    :param M: optional preconditioner that changes the inner product
      (self-adjoint, positive definite): the Krylov basis is orthonormal
      in :math:`\langle x, M^{-1} y\rangle`, kept as two bases
      ``V = M P``.
    :param Ml,Mr: optional left/right preconditioner matvecs.
    :param x0: optional initial guess.
    :param tol: relative residual tolerance (of the preconditioned
      residual).
    :param maxiter: iteration cap, which is also the basis height (default
      N).
    :param ortho: ``"cgs"``/``"cgs2"`` (one/two passes of batched CGS over
      the full buffer), ``"cgs_pallas"``/``"cgs2_pallas"`` (K7 once/twice
      over the active prefix; the kernel schemes that take ``M`` and the
      capture hook), ``"cgs2_fused"`` (K4 -> K5 -> K6 over the active
      prefix; no ``M``) or ``"auto"``: ``"cgs2_fused"`` for a float32
      system without ``M`` on a CUDA device whose ``maxiter + 1`` basis
      rows fit the kernels (at most
      :func:`~krypy_tpu_torch.kernels.orthogonalize.max_rows`, 1709 in
      float32), ``"cgs2"`` otherwise.  A kernel scheme on a CUDA device
      with a taller basis than its kernels take raises ``ValueError``.
    :param explicit_residual: recompute the true residual every iteration.
    :param exact_solution: optional ``(N,)`` for error-norm tracking.
    :param progress: print the relative residual of each iteration.
    :param operator_with_capture: deflation hook: replaces the iteration
      operator with a callable ``v -> (w, cap)``; ``cap`` (shape
      ``(capture_width,)``) is recorded per iteration into row k of the
      ``C`` buffer (the Gram column :math:`\langle U, M_l A M_r
      v_k\rangle`).
    :param projected_r0: deflation hook: maps the left-preconditioned
      initial residual to its projected form.
    :param correct_xk: deflation hook: applied to each candidate solution
      before its residual is evaluated, and to the returned one.
    :param return_internal: also return the final state as a dictionary
      with the JAX package's keys: ``V``, ``P`` (None without ``M``), the
      raw Hessenberg ``H``, the rotated ``R``, ``y``, ``C``,
      ``MMlr0_norm``, ``MMlb_norm``.
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`
      (and the dictionary, with ``return_internal``); ``status`` is
      CONVERGED, MAXITER, or BREAKDOWN when the Krylov space became
      invariant.

    Every hook's output is cast to the system dtype.  ``ip`` with a
    kernel scheme raises ``ValueError``; ``ip`` otherwise,
    ``basis_dtype``, ``fused_deflation`` and the other ``ortho`` schemes
    raise ``NotImplementedError``.
    """
    if ip is not None and ortho in _KERNEL_OF:
        raise ValueError(
            "the kernel orthogonalization schemes support the Euclidean "
            "inner product only; use ortho='cgs2' with ip")
    for name, val in (("ip", ip), ("basis_dtype", basis_dtype),
                      ("fused_deflation", fused_deflation)):
        if val is not None:
            raise NotImplementedError(f"gmres {name}= {_NOT_PORTED}")

    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    m = N if maxiter is None else int(maxiter)
    dev = bv.device
    dtype = system_dtype(bv, x0)
    with_M = M is not None
    ortho = _resolve_ortho(ortho, dtype, dev, m + 1, with_M)
    passes = _PASSES[ortho]

    pair, rows = make_inner(None)
    bv = bv.to(dtype)
    A_mv, M_mv, Ml_mv, Mr_mv = (
        cast_matvec(as_matvec(f), dtype) for f in (A, M, Ml, Mr)
    )
    # the deflation hooks obey the system-dtype contract too (they can
    # close over wider operators and bases)
    projected_r0 = cast_matvec(projected_r0, dtype)
    correct_xk = cast_matvec(correct_xk, dtype)
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

    def iteration_op(v):
        """The operator that drives the Arnoldi iteration (projected when
        deflating) and the captured Gram column, if any."""
        if operator_with_capture is not None:
            w, cap = operator_with_capture(v)
            return w.to(dtype), cap.to(dtype)
        return apply(Ml_mv, A_mv(apply(Mr_mv, v))), None

    def residual_norm(x):
        Mlr = apply(Ml_mv, bv - A_mv(x))
        return norm_from_pair(pair, Mlr, apply(M_mv, Mlr))

    Mlb = apply(Ml_mv, bv)
    MMlb_norm = norm_from_pair(pair, Mlb, apply(M_mv, Mlb))
    Mlr0 = apply(Ml_mv, bv - A_mv(x0v))
    if projected_r0 is not None:
        Mlr0 = projected_r0(Mlr0)
    MMlr0 = apply(M_mv, Mlr0)
    MMlr0_norm = norm_from_pair(pair, Mlr0, MMlr0)
    rel0 = safe_div(MMlr0_norm, MMlb_norm)

    v0 = ((MMlr0_norm > 0).to(real_dtype)
          * safe_div(torch.ones_like(MMlr0_norm), MMlr0_norm))
    V = torch.zeros((m + 1, N), dtype=dtype, device=dev)
    V[0] = MMlr0 * v0
    P = None
    if with_M:
        P = torch.zeros((m + 1, N), dtype=dtype, device=dev)
        P[0] = Mlr0 * v0
    basis = P if with_M else V
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    R = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    Q = torch.eye(m + 1, dtype=dtype, device=dev)
    y = torch.zeros(m + 1, dtype=dtype, device=dev)
    y[0] = MMlr0_norm.to(dtype)
    C = torch.zeros((m, int(capture_width)), dtype=dtype, device=dev)
    hsq = torch.zeros((), dtype=real_dtype, device=dev)
    row_idx = torch.arange(m + 1, device=dev)

    def xk_from(kk):
        """x_k = x0 + Mr (V[:m]^T yy) with a masked triangular solve of
        the leading kk x kk system: rows/columns >= kk get a unit diagonal
        and a zero right-hand side, so the fixed-shape solve yields the
        exact kk-dimensional solution; then the deflation correction."""
        col_mask = row_idx[:m] < kk
        Rk = R[:m, :m] + torch.diag(
            torch.where(col_mask, 0.0, 1.0).to(dtype))
        rhs = torch.where(col_mask, y[:m], 0.0)
        yy = torch.linalg.solve_triangular(Rk, rhs[:, None], upper=True)
        xk = x0v + apply(Mr_mv, yy[:, 0] @ V[:m])
        return xk if correct_xk is None else correct_xk(xk)

    def orthogonalize(w, k):
        """``(w_orth, h)``: ``passes`` Gram-Schmidt passes against rows
        0..k of V, subtracting along the dual basis P when M is
        present."""
        mask = (row_idx <= k).to(real_dtype)
        if ortho == "cgs2_fused":
            return cgs2_fused(V, w.contiguous(), mask, rows=k + 1)
        h = torch.zeros(m + 1, dtype=dtype, device=dev)
        for _ in range(passes):
            if ortho in ("cgs_pallas", "cgs2_pallas"):
                w, coeffs = cgs_project(V, w.contiguous(), mask, basis,
                                        rows=k + 1)
            else:
                coeffs = rows(V, w) * mask
                w = w - coeffs @ basis
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
        w, cap = iteration_op(V[k])
        if cap is not None and capture_width > 0:
            C[k] = cap
        w, h = orthogonalize(w, k)
        Mw = apply(M_mv, w)
        hnew = norm_from_pair(pair, w, Mw)
        # invariance detection on the relative subdiagonal, with the
        # Frobenius norm of H carried incrementally
        hsq = hsq + torch.sum(h.abs() ** 2) + hnew ** 2
        inv_t = hnew <= brk * torch.sqrt(hsq)
        h[k + 1] = hnew.to(dtype)
        inv_h = torch.where(inv_t, 0.0,
                            safe_div(torch.ones_like(hnew), hnew))
        V[k + 1] = Mw * inv_h
        if with_M:
            P[k + 1] = w * inv_h
        H[:, k] = h

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
    result = SolveResult(
        x=x if flat else x[:, None],
        resnorms=res_t,
        niter=torch.tensor(k, dtype=torch.int64, device=dev),
        status=torch.tensor(status, dtype=torch.int64, device=dev),
        errnorms=err_t,
    )
    if return_internal:
        return result, {
            "V": V, "P": P, "H": H, "R": R, "y": y, "C": C,
            "MMlr0_norm": MMlr0_norm, "MMlb_norm": MMlb_norm,
        }
    return result


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
