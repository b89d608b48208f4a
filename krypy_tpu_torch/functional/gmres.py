"""Preconditioned GMRES and restarted GMRES (counterpart of
:mod:`krypy_tpu.functional.gmres`: every orthogonalization scheme of the
JAX package, the dual basis of ``M``, the inner product ``ip``, the
reduced-precision basis ``basis_dtype``, the deflation hooks, the fused
deflation of the one-reduce scheme and ``return_internal``).

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
along which the projections subtract.  The schemes (``ortho=``):

* ``"cgs"``/``"cgs2"``: one/two passes of batched classical Gram-Schmidt
  over the whole buffer with masked rows;
* ``"mgs"``/``"dmgs"``: (doubly) modified Gram-Schmidt, a row at a time
  over the active rows (the reference's schemes; one reduction per row);
* ``"bmgs"``/``"bmgs2"``: one/two passes of blocked MGS: classical
  Gram-Schmidt within panels of 16 rows, modified between panels; only
  the panels that hold active rows are read;
* the kernel schemes of :mod:`krypy_tpu_torch.kernels.orthogonalize`,
  which read the ``k + 1`` active rows only: ``"cgs_pallas"``/
  ``"cgs2_pallas"`` run K7 (``cgs_project``) once or twice,
  ``"cgs2_fused"`` the three prefix sweeps K4-K6;
* ``"cgs2_1r"``: one-reduce lagged CGS2 (DCGS-2, Swirydowicz et al.
  2021): the second Gram-Schmidt pass of the previous candidate, its norm
  (Pythagorean identity) and the first pass of the new direction come out
  of ONE reduction, the JAX package's ``(k+1, N) x (N, 2)`` product (here
  two matrix-vector products per column chunk, summed in double
  precision), so an iteration on a mesh makes one all-reduce (``cgs2``
  makes five).  The Hessenberg column and the
  Givens and residual recurrences run one iteration behind the basis, so
  a solve makes one more matvec.  With ``fused_deflation``
  (:class:`FusedDeflation`) the deflation's capture and oblique
  projection ride the same product, ``(k+1+d, N) x (N, 2+d)``;
* ``"auto"``: on a mesh of more than one rank the sweep-against-sync
  price model of :mod:`~krypy_tpu_torch.functional.policy` picks
  ``"cgs2_fused"`` (bandwidth-bound shards) or ``"cgs2_1r"``
  (latency-bound ones), as the JAX package does; on one device
  ``"cgs2_fused"`` for a float32 system on a CUDA device whose basis
  fits the kernels, ``"cgs2"`` otherwise.

The JAX package's static prefix buckets and full-height masked kernel
sweeps are not ported: ``rows`` is a run-time argument, and the rows past
``k`` are zero with zero mask, so the arithmetic is the same.

``basis_dtype`` (e.g. ``torch.bfloat16``) stores the basis rows at that
dtype.  Every product on them accumulates in the system dtype and returns
it, as the JAX package's ``preferred_element_type`` does: the active rows
are upcast once per iteration (a copy that reads the narrow rows and
writes wide ones) and the products run on the copy, their other operand
rounded to ``basis_dtype`` first, as in JAX.  With ``cgs2_1r`` the
trailing candidate also lives in a full-precision side vector.

Under an active mesh (:mod:`krypy_tpu_torch.parallel`) ``b``, ``x0``
and the basis rows are the rank's blocks: every reduction over N (the
norms, the residual and error norms, every scheme's coefficients, the
one-reduce product) is a local partial and one all-reduce, through
:func:`~krypy_tpu_torch.functional.common.make_inner` or
:func:`~krypy_tpu_torch.functional.common.mesh_sum`, and
``"cgs2_fused"`` runs K9 (:func:`~krypy_tpu_torch.kernels.orthogonalize.
cgs2_fused_blocks`) on blocks of any length: three all-reduces per
iteration.  ``"cgs_pallas"``/``"cgs2_pallas"`` run K7's sharded form,
K4, an all-reduce and K6 per pass (:func:`~krypy_tpu_torch.kernels.
orthogonalize.cgs_project_blocks`).  The Hessenberg matrix, the rotations
and the projected right-hand side are replicated, the same bits on every
rank, so every rank takes the same branches.  A solve starts with one
all-reduce more than on one device, the global N.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.orthogonalize import (
    cgs2_fused,
    cgs2_fused_blocks,
    cgs_project,
    cgs_project_blocks,
    max_rows,
)
from ..parallel import active_mesh
from . import policy
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
    global_length,
    ip_matvec,
    is_scalar_ip,
    make_inner,
    mesh_sum,
    norm_from_pair,
    safe_div,
    system_dtype,
    twice_solver,
)

__all__ = ["gmres", "restarted_gmres", "FusedDeflation"]

#: Gram-Schmidt passes per iteration of each scheme
_PASSES = {"cgs": 1, "cgs2": 2, "mgs": 1, "dmgs": 2, "bmgs": 1,
           "bmgs2": 2, "cgs_pallas": 1, "cgs2_pallas": 2, "cgs2_fused": 2,
           "cgs2_1r": 2}
#: the schemes that run a kernel, and the kernel whose row limit binds
_KERNEL_OF = {"cgs_pallas": "cgs_project", "cgs2_pallas": "cgs_project",
              "cgs2_fused": "apply_project"}
#: rows of a panel of the blocked MGS schemes (the JAX package's)
_PANEL_ROWS = 16
#: all-reduces per iteration of the sharded cgs2_fused beyond cgs2_1r's
_FUSED_SHARDED_EXTRA_SYNCS = 2
#: columns per partial product of the one-reduce contraction: each
#: chunk's partials are matrix-vector products in the system dtype, the
#: chunks' add in double precision in a fixed order, so a rank block that
#: starts on a chunk boundary sums its chunks as one device does
_CHUNK = 1 << 22


class FusedDeflation(NamedTuple):
    """Deflation data of the one-reduce fused scheme (``ortho="cgs2_1r"``
    with deflation, ONE all-reduce per iteration).

    The rows of ``UoT`` ride below the Krylov basis and ``B W2`` in a
    persistent right operand, so the one product of each iteration yields
    the Gram-Schmidt coefficients, the capture column
    :math:`\\langle U, M_lAM_r v\\rangle`, the oblique projection's
    coefficients and a fresh coupling Gram :math:`\\langle U,
    W_2\\rangle`; the second projection pass needs no more communication
    (its coefficient is :math:`G^{-1}(c - G q_1)`, every factor
    replicated)."""

    #: ``(d, N)`` rows of the orthonormalized deflation basis
    UoT: torch.Tensor
    #: ``(d, N)`` rows of the image basis (the columns of W2)
    W2T: torch.Tensor
    #: ``(d, d)`` coupling Gram <Uo, W2>: GMRES takes a fresh one from its
    #: product each iteration; CG and MINRES, whose products have no W2
    #: columns, need this one
    G: torch.Tensor = None


def _resolve_ortho(ortho, dtype, device, rows, with_M=False, mesh=None, *,
                   n_local=0, ip=None, mixed=False):
    """The ``ortho="auto"`` rule, and the checks of an explicit kernel
    scheme.

    On a mesh of more than one rank (the JAX package's rule), unless
    ``ip`` is a scalar callable or ``M`` comes with ``ip`` or a
    ``basis_dtype``: ``"cgs2_fused"`` for a real system with the
    Euclidean product, no ``M`` and no ``basis_dtype``, whose basis fits
    the kernels and whose saved sweep of a shard of ``n_local`` elements
    outprices two all-reduces
    (:func:`~krypy_tpu_torch.functional.policy.fused_sharded_wins`),
    ``"cgs2_1r"`` otherwise.  (The JAX package also asks of
    ``"cgs2_fused"`` that N divide over the mesh, as its sharded kernel
    takes equal blocks only; the port's K9 takes the blocks of any N.)
    Elsewhere: ``"cgs2_fused"`` for a float32 system on a CUDA device
    whose ``rows``-row basis fits the kernels (Euclidean inner product,
    no ``M``, no ``basis_dtype``), ``"cgs2"`` otherwise.  An explicit
    kernel scheme on a CUDA device with a basis taller than its kernels
    take raises here, before the first iteration; so does ``cgs2_fused``
    with ``M`` (it has no dual-basis form)."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    fits = device.type != "cuda" or rows <= max_rows(itemsize)
    if ortho == "auto":
        plain = ip is None and not with_M and not mixed
        if mesh is not None and mesh.size > 1 and not is_scalar_ip(ip) \
                and not (with_M and (ip is not None or mixed)):
            if plain and not dtype.is_complex and fits and \
                    policy.fused_sharded_wins(
                        rows, n_local, itemsize,
                        extra_syncs=_FUSED_SHARDED_EXTRA_SYNCS,
                        device=device):
                return "cgs2_fused"
            return "cgs2_1r"
        if plain and dtype == torch.float32 and device.type == "cuda" and \
                fits:
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
    raise ValueError(f"unknown ortho {ortho!r}")


def _check_options(ortho, *, ip, with_M, mixed, dtype, fused_deflation,
                   operator_with_capture):
    """The JAX package's ``ValueError``s for the combinations of
    ``ortho``, ``ip``, ``M``, ``basis_dtype`` and ``fused_deflation``."""
    one_reduce = ortho == "cgs2_1r"
    if one_reduce and with_M:
        if ip is not None:
            raise ValueError(
                "ortho='cgs2_1r' with M supports the Euclidean base inner "
                "product only; use ortho='cgs2' for ip + M")
        if mixed:
            raise ValueError(
                "ortho='cgs2_1r' with M does not support basis_dtype (both "
                "candidate rows would need side buffers); use ortho='cgs2'")
        if fused_deflation is not None:
            raise ValueError(
                "fused_deflation does not compose with the M dual basis; "
                "use ortho='cgs2' (hook path)")
    if one_reduce and is_scalar_ip(ip):
        raise ValueError(
            "ortho='cgs2_1r' supports the Euclidean or operator-weighted "
            "inner product only (the one-reduce fusion needs the raw "
            "B-application, not a scalar callable)")
    if fused_deflation is not None:
        if not one_reduce:
            raise ValueError(
                "fused_deflation requires ortho='cgs2_1r' (the deflation "
                "fold rides the one-reduce contraction); other schemes take "
                "the operator_with_capture hook path")
        if operator_with_capture is not None:
            raise ValueError("fused_deflation and operator_with_capture "
                             "are mutually exclusive")
    if mixed:
        if ip is not None:
            raise ValueError(
                "basis_dtype requires the Euclidean inner product")
        if ortho in ("mgs", "dmgs") or ortho in _KERNEL_OF:
            raise ValueError(
                "basis_dtype requires a batched/paneled ortho scheme "
                "(cgs/cgs2/bmgs/bmgs2) or the one-reduce cgs2_1r")
        if dtype.is_complex:
            raise ValueError("basis_dtype supports real systems only")
        if fused_deflation is not None:
            raise ValueError(
                "basis_dtype does not compose with fused_deflation (the "
                "deflation basis rows would be quantized inside the shared "
                "buffer, corrupting the oblique projection); use the hook "
                "path (ortho='cgs2') for deflated quantized-basis solves")


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
    :param ip: inner product: ``None`` (Euclidean), a matrix ``B`` (2-D
      tensor or operator with ``.shape``), or a scalar callable
      ``ip(x, y)`` (not with the kernel schemes, ``cgs2_1r`` or
      ``basis_dtype``).
    :param x0: optional initial guess.
    :param tol: relative residual tolerance (of the preconditioned
      residual).
    :param maxiter: iteration cap, which is also the basis height (default
      N).
    :param ortho: the scheme (module docstring): ``"cgs"``, ``"cgs2"``,
      ``"mgs"``, ``"dmgs"``, ``"bmgs"``, ``"bmgs2"``, ``"cgs_pallas"``,
      ``"cgs2_pallas"``, ``"cgs2_fused"``, ``"cgs2_1r"`` or ``"auto"``.
      A kernel scheme on a CUDA device with a taller basis than its
      kernels take (:func:`~krypy_tpu_torch.kernels.orthogonalize.
      max_rows`, 1709 float32 rows for ``cgs2_fused``) raises
      ``ValueError``.
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
    :param basis_dtype: storage dtype of the basis rows (e.g.
      ``torch.bfloat16``), real systems with the Euclidean product and a
      batched, paneled or one-reduce scheme only.  The attainable true
      residual is floored at ``eps(basis_dtype) * kappa(A)``.
    :param fused_deflation: a :class:`FusedDeflation`: fold the deflated
      operator's projection and capture into the one-reduce product
      (``ortho="cgs2_1r"`` only, no ``M``, exclusive of
      ``operator_with_capture``; ``projected_r0``/``correct_xk`` still
      apply).
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult`
      (and the dictionary, with ``return_internal``); ``status`` is
      CONVERGED, MAXITER, or BREAKDOWN when the Krylov space became
      invariant.

    Every hook's output is cast to the system dtype.  An option
    combination the JAX package refuses raises its ``ValueError`` here
    too.
    """
    if ip is not None and ortho in _KERNEL_OF:
        raise ValueError(
            "the kernel orthogonalization schemes support the Euclidean "
            "inner product only; use ortho='cgs2' or 'bmgs2' with ip")

    flat = b.ndim == 1
    bv = b.reshape(-1)
    N = bv.shape[0]
    mesh = active_mesh()
    pair, rows = make_inner(ip)
    n_global = global_length(bv)
    m = n_global if maxiter is None else int(maxiter)
    dev = bv.device
    dtype = system_dtype(bv, x0)
    with_M = M is not None
    bdt = dtype if basis_dtype is None else basis_dtype
    mixed = bdt != dtype
    ortho = _resolve_ortho(
        ortho, dtype, dev, m + 1, with_M, mesh,
        n_local=n_global // (mesh.size if mesh is not None else 1),
        ip=ip, mixed=mixed)
    _check_options(ortho, ip=ip, with_M=with_M, mixed=mixed, dtype=dtype,
                   fused_deflation=fused_deflation,
                   operator_with_capture=operator_with_capture)
    passes = _PASSES[ortho]
    if fused_deflation is not None:
        capture_width = int(fused_deflation.UoT.shape[0])

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

    def wide(t):
        """Basis rows (or coefficients) as the system dtype."""
        return t.to(dtype) if mixed else t

    def narrow(t):
        """``t`` rounded to the basis dtype and back: the operand a
        product with the narrow rows takes (JAX's ``astype(bdt)``)."""
        return t.to(bdt).to(dtype) if mixed else t

    def xk_from(V, R, y, kk):
        """x_k = x0 + Mr (V[:kk]^T yy) with a masked triangular solve of
        the leading kk x kk system: rows/columns >= kk get a unit diagonal
        and a zero right-hand side, so the fixed-shape solve yields the
        exact kk-dimensional solution; then the deflation correction.  A
        narrow basis is upcast for it (rows past kk carry zero
        weights)."""
        col_mask = row_idx[:m] < kk
        Rk = R[:m, :m] + torch.diag(
            torch.where(col_mask, 0.0, 1.0).to(dtype))
        rhs = torch.where(col_mask, y[:m], 0.0)
        yy = torch.linalg.solve_triangular(Rk, rhs[:, None], upper=True)
        if mixed:
            xk = x0v + apply(Mr_mv, yy[:kk, 0] @ V[:kk].to(dtype))
        else:
            xk = x0v + apply(Mr_mv, yy[:, 0] @ V[:m])
        return xk if correct_xk is None else correct_xk(xk)

    row_idx = torch.arange(m + 2, device=dev)
    # the first host read: the initial residual and its invariance
    rel, inv = torch.stack([rel0, (MMlr0_norm == 0).to(real_dtype)]
                           ).tolist()
    rel, invariant = np_real(rel), bool(inv)
    resnorms = [rel]
    errs = None
    if exact is not None:
        def errnorm(x):
            return norm_from_pair(pair, exact - x)

        errs = [errnorm(x0v)]
    Q = torch.eye(m + 1, dtype=dtype, device=dev)
    R = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    y = torch.zeros(m + 1, dtype=dtype, device=dev)
    y[0] = MMlr0_norm.to(dtype)
    hsq = torch.zeros((), dtype=real_dtype, device=dev)

    def givens_step(h, j):
        """The Givens update of Hessenberg column ``j`` (``h``, ``(m+1,)``):
        the j previous rotations in ONE small matvec against their
        accumulated product (rows >= j of Q are still identity), then the
        new rotation; returns the updated residual estimate."""
        col = Q @ h
        c, s, r = givens(col[j], col[j + 1])
        col[j] = r
        col[j + 1] = 0.0
        qj, qj1 = Q[j].clone(), Q[j + 1].clone()
        Q[j] = c * qj + s * qj1
        Q[j + 1] = -s.conj() * qj + c * qj1
        R[:, j] = col
        yj = y[j].clone()
        y[j] = c * yj
        y[j + 1] = -s.conj() * yj
        return safe_div(y[j + 1].abs(), MMlb_norm)

    def record(rel_upd, inv_t, it, V):
        """The one host read of iteration ``it``: the updated residual
        estimate and the invariance flag; the explicit residual where the
        JAX body computes it.  Returns ``(rel, invariant)``."""
        rel_upd, inv = torch.stack([rel_upd, inv_t.to(real_dtype)]).tolist()
        rel_upd, invariant = np_real(rel_upd), bool(inv)
        if explicit_residual or rel_upd <= tol_r or it == m or invariant:
            rel = np_real(safe_div(residual_norm(xk_from(V, R, y, it)),
                                   MMlb_norm).item())
        else:
            rel = rel_upd
        if progress:
            print(f"gmres iter {it}: rel={rel:.3e}")
        resnorms.append(rel)
        if errs is not None:
            errs.append(errnorm(xk_from(V, R, y, it)))
        return rel, invariant

    def finish(V, P, H, C, niter):
        x = xk_from(V, R, y, niter)
        if rel <= tol_r:
            status = CONVERGED
        else:
            status = BREAKDOWN if invariant else MAXITER
        res_t = torch.full((m + 1,), float("nan"), dtype=real_dtype,
                           device=dev)
        res_t[: len(resnorms)] = torch.tensor(
            np.asarray(resnorms, dtype=np_real), dtype=real_dtype).to(dev)
        err_t = None
        if errs is not None:
            err_t = torch.full((m + 1,), float("nan"), dtype=real_dtype,
                               device=dev)
            err_t[: len(errs)] = torch.stack(errs)
        result = SolveResult(
            x=x if flat else x[:, None],
            resnorms=res_t,
            niter=torch.tensor(niter, dtype=torch.int64, device=dev),
            status=torch.tensor(status, dtype=torch.int64, device=dev),
            errnorms=err_t,
        )
        if return_internal:
            return result, {
                "V": V, "P": P, "H": H, "R": R, "y": y, "C": C,
                "MMlr0_norm": MMlr0_norm, "MMlb_norm": MMlb_norm,
            }
        return result

    if ortho == "cgs2_1r":
        # One-reduce lagged CGS2.  The basis buffer carries ONE more row,
        # row k the once-projected UNNORMALIZED trailing candidate, and the
        # Hessenberg buffer one more column (its first-pass
        # coefficients); both are cut off the results.  The Givens update,
        # the residual estimate and the stop rule run on the column
        # COMPLETED this iteration (k - 1), one behind the basis, hence
        # one more matvec per solve.
        Bmv = ip_matvec(ip)

        def prep(x):
            return x if Bmv is None else Bmv(x)

        # fused deflation: the deflation rows Uo read with the basis, and
        # B W2 below the two live columns of a persistent right operand,
        # so ONE product serves Gram-Schmidt, capture, projection and a
        # fresh coupling Gram
        d_defl = 0
        if fused_deflation is not None:
            UoT = fused_deflation.UoT.to(dtype)
            W2T = fused_deflation.W2T.to(dtype)
            d_defl = UoT.shape[0]
            BW2T = W2T if Bmv is None else torch.stack(
                [Bmv(r) for r in W2T])
            Rb = torch.cat([torch.zeros((2, N), dtype=dtype, device=dev),
                            BW2T])

        # the contraction's partials add in double precision: the
        # Pythagorean norm of the candidate is read off it
        acc = torch.complex128 if dtype.is_complex else torch.float64

        def contract(Vk, cols):
            """THE one reduction: the active rows ``Vk`` (and the
            deflation rows) against the vectors ``cols`` (a sequence, or
            the rows of ``Rb``), as an ``(m+2+d, len(cols))`` tensor, zero
            past the active rows: one matrix-vector product per vector
            and column chunk of ``_CHUNK``, the chunks summed in double
            precision, then over the mesh."""
            Z = torch.zeros((m + 2 + d_defl, len(cols)), dtype=acc,
                            device=dev)
            narrowed = [narrow(c) for c in cols]
            for lo in range(0, N, _CHUNK):
                part = slice(lo, min(lo + _CHUNK, N))
                Vc = Vk[:, part].conj()
                for j, c in enumerate(narrowed):
                    Z[: Vk.shape[0], j] += torch.mv(Vc, c[part])
                for i in range(d_defl):
                    Z[m + 2 + i] += torch.mv(cols[:, part],
                                             UoT[i, part].conj())
            return mesh_sum(Z).to(dtype)

        v0vec = MMlr0 * v0
        V = torch.zeros((m + 2, N), dtype=bdt, device=dev)
        V[0] = v0vec.to(bdt)
        P = None
        if with_M:
            P = torch.zeros((m + 2, N), dtype=dtype, device=dev)
            P[0] = Mlr0 * v0
        H = torch.zeros((m + 2, m + 1), dtype=dtype, device=dev)
        C = torch.zeros((m + 1, capture_width), dtype=dtype, device=dev)

        # the peeled step: the first pass of the first direction (one
        # reduction; the rows past 0 are zero)
        w0, cap0 = iteration_op(v0vec)
        if d_defl:
            Rb[0], Rb[1] = prep(v0vec), prep(w0)
            Z0 = contract(wide(V[:1]), Rb)
            cap0 = Z0[m + 2:, 1]
            q0 = twice_solver(Z0[m + 2:, 2:])(cap0)
            chat0 = Z0[: m + 2, 1] - Z0[: m + 2, 2:] @ q0
            w0 = w0 - q0 @ W2T
        else:
            chat0 = contract(wide(V[:1]), [prep(w0)])[:, 0]
        H[:, 0] = chat0
        uf = None
        if with_M:
            # dual-basis candidates: u_p in P-space, u_v = M u_p fresh
            up0 = w0 - chat0[:1] @ P[:1]
            P[1] = up0
            V[1] = apply(M_mv, up0)
        else:
            u0f = w0 - narrow(chat0[:1]) @ wide(V[:1])
            V[1] = u0f.to(bdt)
            uf = u0f if mixed else None
        if capture_width > 0:
            C[0] = cap0

        k = 1
        while rel > tol_r and k < m + 1 and not invariant:
            # a narrow basis: the trailing candidate from its side vector
            u = uf if mixed else V[k]
            w, cap = iteration_op(u)
            Vk = wide(V[: k + 1])  # a view, or the one upcast copy
            # THE one reduction of the iteration: the second pass of u,
            # its norm (Pythagoras on the same row) and the first pass of
            # w = op(u); with fused deflation also the capture, the
            # projection and the coupling Gram
            if d_defl:
                Rb[0], Rb[1] = prep(u), prep(w)
                Zf = contract(Vk, Rb)
                cap = Zf[m + 2:, 1]
                proj_coeffs = twice_solver(Zf[m + 2:, 2:])
                q = proj_coeffs(cap)
                # u is already projected: only the first-pass column
                # takes the correction
                col0 = Zf[: m + 2, 0]
                col1 = Zf[: m + 2, 1] - Zf[: m + 2, 2:] @ q
                w = w - q @ W2T
                # the product measured <Uo, u> too: removing it when the
                # row is sealed keeps every basis vector in the projection
                # complement
                q_seal = proj_coeffs(Zf[m + 2:, 0])
            elif with_M:
                # coefficients <v_j, u_p> = <p_j, M u_p>; norm row
                # <u_v, u_p> = ||u_p||_M^2
                up = P[k]
                Z = contract(Vk, [up, w])
                col0, col1 = Z[:, 0], Z[:, 1]
            else:
                Z = contract(Vk, [prep(u), prep(w)])
                col0, col1 = Z[:, 0], Z[:, 1]
            lt = row_idx < k
            r = torch.where(lt, col0, 0.0)
            s = col0[k].real
            c = torch.where(lt, col1, 0.0)
            t = col1[k]

            sig2 = torch.clamp(s - torch.sum(r.abs() ** 2), min=0.0)
            sigma = torch.sqrt(sig2).to(real_dtype)
            # complete Hessenberg column k - 1: the second-pass corrections
            # and the subdiagonal entry
            completed = torch.where(row_idx == k, sigma.to(dtype),
                                    H[:, k - 1] + r)
            hsq = hsq + torch.sum(completed.abs() ** 2)
            inv_t = sigma <= brk * torch.sqrt(hsq)
            H[:, k - 1] = completed

            inv_s = torch.where(inv_t, 0.0,
                                safe_div(torch.ones_like(sigma), sigma))
            vk = u - narrow(r[:k]) @ Vk[:k]
            if d_defl:
                vk = vk - q_seal @ W2T
            vk = vk * inv_s
            V[k] = vk.to(bdt)
            if with_M:
                P[k] = (up - r[:k] @ P[:k]) * inv_s

            # first-pass column k with the lag correction g = H (r/sigma)
            # (A was applied to the uncorrected u, so the exact column is
            # chat - g; small replicated work only)
            g = H @ (r * inv_s)[: m + 1]
            tk = (t - torch.vdot(r, c)) * inv_s * inv_s
            chat = torch.where(row_idx == k, tk, c * inv_s)
            if with_M:
                up_next = w * inv_s - chat[: k + 1] @ P[: k + 1]
                P[k + 1] = up_next
                V[k + 1] = apply(M_mv, up_next)
            else:
                if mixed:
                    Vk[k] = V[k].to(dtype)
                u_next = w * inv_s - narrow(chat[: k + 1]) @ Vk
                V[k + 1] = u_next.to(bdt)
                uf = u_next if mixed else None
            H[:, k] = chat - g

            if capture_width > 0:
                # the capture is linear in the iterate: op(u) = sum_j r_j
                # op(v_j) + sigma op(v_k), so <U, op v_k> = (cap - r^T C)
                # / sigma
                C[k] = (cap - r[: m + 1] @ C) * inv_s

            # Givens update and residual estimate on the COMPLETED column
            rel_upd = givens_step(completed[: m + 1], k - 1)
            rel, invariant = record(rel_upd, inv_t, k, V)
            k += 1

        return finish(V[: m + 1], None if P is None else P[: m + 1],
                      H[: m + 1, :m], C[:m], k - 1)

    V = torch.zeros((m + 1, N), dtype=bdt, device=dev)
    V[0] = (MMlr0 * v0).to(bdt)
    P = None
    if with_M:
        P = torch.zeros((m + 1, N), dtype=bdt, device=dev)
        P[0] = (Mlr0 * v0).to(bdt)
    basis = P if with_M else V
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    C = torch.zeros((m, int(capture_width)), dtype=dtype, device=dev)

    def orthogonalize(w, k):
        """``(w_orth, h)``: ``passes`` Gram-Schmidt passes against rows
        0..k of V, subtracting along the dual basis P when M is
        present."""
        mask = (row_idx[: m + 1] <= k).to(real_dtype)
        if ortho == "cgs2_fused" and mesh is not None:
            return cgs2_fused_blocks(V, w.contiguous(), mask, mesh=mesh,
                                     rows=k + 1)
        if ortho == "cgs2_fused":
            return cgs2_fused(V, w.contiguous(), mask, rows=k + 1)
        h = torch.zeros(m + 1, dtype=dtype, device=dev)
        if ortho in ("mgs", "dmgs"):
            # a row at a time, one reduction each
            for _ in range(passes):
                for j in range(k + 1):
                    coeff = rows(V[j][None, :], w)[0]
                    w = w - coeff * basis[j]
                    h[j] += coeff
            return w, h
        if ortho in ("bmgs", "bmgs2"):
            # the panels that hold active rows, one reduction each
            for _ in range(passes):
                for lo in range(0, k + 1, _PANEL_ROWS):
                    hi = min(lo + _PANEL_ROWS, k + 1)
                    Vp = wide(V[lo:hi])
                    Bp = wide(basis[lo:hi]) if with_M else Vp
                    if mixed:
                        coeffs = mesh_sum(Vp @ narrow(w))
                        w = w - narrow(coeffs) @ Bp
                    else:
                        coeffs = rows(Vp, w)
                        w = w - coeffs @ Bp
                    h[lo:hi] += coeffs
            return w, h
        if mixed:
            # the active rows upcast once, read by both passes
            Vk = V[: k + 1].to(dtype)
            Bk = P[: k + 1].to(dtype) if with_M else Vk
            for _ in range(passes):
                coeffs = mesh_sum(Vk @ narrow(w))
                w = w - narrow(coeffs) @ Bk
                h[: k + 1] += coeffs
            return w, h
        for _ in range(passes):
            if ortho in ("cgs_pallas", "cgs2_pallas") and mesh is not None:
                w, coeffs = cgs_project_blocks(V, w.contiguous(), mask, basis,
                                               mesh=mesh, rows=k + 1)
            elif ortho in ("cgs_pallas", "cgs2_pallas"):
                w, coeffs = cgs_project(V, w.contiguous(), mask, basis,
                                        rows=k + 1)
            else:
                coeffs = rows(V, w) * mask
                w = w - coeffs @ basis
            h = h + coeffs
        return w, h

    k = 0
    while rel > tol_r and k < m and not invariant:
        w, cap = iteration_op(wide(V[k]))
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
        V[k + 1] = (Mw * inv_h).to(bdt)
        if with_M:
            P[k + 1] = (w * inv_h).to(bdt)
        H[:, k] = h
        rel_upd = givens_step(h, k)
        rel, invariant = record(rel_upd, inv_t, k + 1, V)
        k += 1

    return finish(V, P, H, C, k)


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
