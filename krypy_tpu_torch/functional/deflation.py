r"""Deflated GMRES/CG and recycling GMRES (counterpart of
:mod:`krypy_tpu.functional.deflation`).

Deflation in the functional lane:

1. the deflation basis U (width d) is orthonormalized on the device in the
   relevant inner product;
2. the operator is wrapped as :math:`v \mapsto (I-P)\,M_l A M_r\,v` where
   P is the oblique projection with range
   :math:`\operatorname{colspan}(M_lAM_rU)` and kernel
   :math:`\operatorname{colspan}(U)^\perp`, applied twice per Stewart's
   round-off analysis;
3. every candidate solution is corrected by solving the d-dimensional
   deflation component of its residual;
4. the Gram column :math:`\langle U, M_lAM_r v_k\rangle` is captured each
   iteration into GMRES's ``C`` buffer, so the spectral machinery (Ritz
   values for recycling) finds all its small matrices after the solve.

Layout.  The public shapes are the JAX package's: a deflation basis is
``(N, d)``.  The working copies are contiguous ``(d, N)`` rows, so that
every product with a basis streams whole rows: the tensors that
:func:`weighted_qr`, :func:`build_deflation` and
:func:`assemble_ritz_vectors` return are ``(N, d)`` views of such rows,
and ``U.T`` of any of them is contiguous without a copy.

Small dense solves.  The d x d systems with the coupling Gram ``G`` and
with ``E`` are solved inside the iteration loop, twice per operator
application.  Both matrices are factored once per solve
(``torch.linalg.lu_factor_ex``, which reads nothing back to the host) and
each use is an ``lu_solve``: the arithmetic of a solve, no explicit
inverse, and no host synchronisation.

There is nothing to compile in torch, so the compiled-solve cache of
the JAX ``RecyclingGmres`` is not ported.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from .common import apply, as_matvec, make_inner, safe_div
from .gmres import gmres as _gmres

__all__ = [
    "deflated_gmres",
    "deflated_cg",
    "deflated_minres",
    "weighted_qr",
    "build_deflation",
    "DeflationOperator",
    "ritz_pairs",
    "assemble_ritz_vectors",
    "ritz_deflation_vectors",
    "RecyclingGmres",
    "AutoRecyclingGmres",
]


def _rows_of(U):
    """The contiguous ``(d, N)`` rows of an ``(N, d)`` basis (no copy when
    ``U`` is already a view of such rows)."""
    return U.T.contiguous()


def _qr_rows(UT, ip=None, passes=2):
    """:func:`weighted_qr` on contiguous rows: ``(QT, R)`` with the rows
    of ``QT`` ``(d, N)`` orthonormal in ``ip``."""
    pair, rows = make_inner(ip)
    d = UT.shape[0]
    R = torch.zeros((d, d), dtype=UT.dtype, device=UT.device)
    QT = torch.empty_like(UT)
    for i in range(d):
        v = UT[i]
        for _ in range(passes):
            if i:
                coeffs = rows(QT[:i], v)
                v = v - coeffs @ QT[:i]
                R[:i, i] += coeffs
        nrm = torch.sqrt(torch.clamp(pair(v, v).real, min=0.0))
        R[i, i] = nrm.to(UT.dtype)
        QT[i] = v * safe_div(torch.ones_like(nrm), nrm)
    return QT, R


def weighted_qr(U, ip=None, passes=2):
    """Orthonormalize the columns of ``(N, d)`` in the ``ip`` inner
    product via blocked classical Gram-Schmidt (``passes`` sweeps).

    Returns ``(Q, R)`` with R upper triangular; ``Q`` is an ``(N, d)``
    view of contiguous ``(d, N)`` rows.
    """
    if U.shape[1] == 0:
        return U, torch.zeros((0, 0), dtype=U.dtype, device=U.device)
    QT, R = _qr_rows(_rows_of(U), ip, passes)
    return QT.T, R


class DeflationOperator(NamedTuple):
    """Precomputed deflation data; the ``(N, d)`` members are views of
    contiguous ``(d, N)`` rows."""

    Uo: torch.Tensor      # (N, d) orthonormalized deflation basis
    AU: torch.Tensor      # (N, d) = MlAMr Uo
    W2: torch.Tensor      # (N, d) orthonormal basis of AU (in ip)
    G: torch.Tensor       # (d, d) = <Uo, W2>, the oblique coupling
    E: torch.Tensor       # (d, d) = <Uo, AU>


def _ip_for_U(ip, M, Minv, ip_defl):
    """Inner product in which the deflation basis is orthonormalized.

    Reference semantics (krypy/linsys.py:163-176 get_ip_Minv_B +
    krypy/deflation.py:40): with an inner-product-changing preconditioner
    M the basis must be orthonormal in :math:`\\langle x, M^{-1}y
    \\rangle_B`, which needs the INVERSE of M, hence the explicit
    ``Minv`` argument.
    """
    if ip_defl is not None:
        return ip_defl
    if M is None:
        return ip
    if Minv is None:
        raise ValueError(
            "deflation with the inner-product-changing preconditioner M "
            "requires Minv (or an explicit ip_defl) to orthonormalize U "
            "in the M^{-1} inner product"
        )
    base_pair, _ = make_inner(ip)
    Minv_mv = as_matvec(Minv)
    return lambda x, y: base_pair(x, Minv_mv(y))


def build_deflation(A, U, *, M=None, Minv=None, Ml=None, Mr=None, ip=None,
                    ip_defl=None):
    """Assemble the deflation data for basis U (shape ``(N, d)``).

    :param ip: solver inner product (defines the projection geometry).
    :param Minv: inverse of M, needed to orthonormalize U in the
      :math:`M^{-1}` inner product when M is present.
    :param ip_defl: explicit override of the orthonormalization product.
    """
    A_mv = as_matvec(A)
    Ml_mv = as_matvec(Ml)
    Mr_mv = as_matvec(Mr)
    _, rows = make_inner(ip)
    ip_defl = _ip_for_U(ip, M, Minv, ip_defl)

    d = U.shape[1]
    if d == 0:
        empty = torch.zeros((0, 0), dtype=U.dtype, device=U.device)
        return DeflationOperator(U, U, U, empty, empty)
    UoT, _ = _qr_rows(_rows_of(U), ip_defl)
    AUT = torch.stack([
        apply(Ml_mv, A_mv(apply(Mr_mv, u))) for u in UoT
    ])
    W2T, _ = _qr_rows(AUT, ip)
    # <Uo, W2> and <Uo, AU> as d x d blocks, a column at a time
    G = torch.stack([rows(UoT, W2T[j]) for j in range(d)], dim=1)
    E = torch.stack([rows(UoT, AUT[j]) for j in range(d)], dim=1)
    return DeflationOperator(UoT.T, AUT.T, W2T.T, G, E)


def _lu_solver(mat):
    """``c -> mat^{-1} c`` for ``(d,)`` vectors through ONE LU
    factorization with partial pivoting (what a dense solve does), taken
    now and reused by every call; neither the factorization nor the
    solves read anything back to the host."""
    LU, piv, _ = torch.linalg.lu_factor_ex(mat)

    def solve(c):
        return torch.linalg.lu_solve(LU, piv, c[:, None])[:, 0]

    return solve


def _proj_complement(defl, rows):
    """``z -> (I - P) z`` with ``P = W2 <Uo, W2>^{-1} <Uo, .>``, applied
    twice ("twice is enough", Stewart 2011)."""
    UoT, W2T = defl.Uo.T, defl.W2.T
    solve_G = _lu_solver(defl.G)

    def once(z):
        return z - solve_G(rows(UoT, z)) @ W2T

    return lambda z: once(once(z))


def _correction(defl, rows, A_mv, Ml_mv, bv):
    """``xk -> xk + Uo E^{-1} <Uo, Ml (b - A xk)>``: solve the deflation
    component of the residual (reference: krypy/deflation.py:58-68)."""
    UoT = defl.Uo.T
    solve_E = _lu_solver(defl.E)

    def correct(xk):
        r = apply(Ml_mv, bv - A_mv(xk))
        return xk + solve_E(rows(UoT, r)) @ UoT

    return correct


def deflated_gmres(
    A,
    b,
    U,
    *,
    M=None,
    Minv=None,
    Ml=None,
    Mr=None,
    ip=None,
    ip_defl=None,
    x0=None,
    tol=1e-5,
    maxiter=None,
    ortho="cgs2",
    explicit_residual=False,
    return_internal=False,
):
    r"""Deflated preconditioned GMRES.

    Solves :math:`M M_l A M_r y = M M_l b` on the complement of the
    deflation space spanned by U, correcting each iterate through the
    deflation component (reference: krypy/deflation.py DeflatedGmres).

    :param U: deflation basis, shape ``(N, d)``.
    :param ortho: as in :func:`~krypy_tpu_torch.functional.gmres.gmres`;
      the schemes that compose with the capture hook are ``"cgs"``,
      ``"cgs2"``, ``"cgs_pallas"`` and ``"cgs2_pallas"`` (K7).
      ``"auto"`` resolves to ``"cgs2"``; ``"cgs2_1r"`` (the fused
      one-reduce deflated scheme) raises ``NotImplementedError``.
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult` (plus
      the internal small matrices, with ``E``, ``Uo`` and ``AU`` added, if
      ``return_internal``).
    """
    bv = b.reshape(-1)
    A_mv = as_matvec(A)
    Ml_mv = as_matvec(Ml)
    Mr_mv = as_matvec(Mr)
    _, rows = make_inner(ip)

    defl = build_deflation(
        A, U, M=M, Minv=Minv, Ml=Ml, Mr=Mr, ip=ip, ip_defl=ip_defl
    )
    d = defl.Uo.shape[1]

    if d == 0:
        return _gmres(
            A, b, M=M, Ml=Ml, Mr=Mr, ip=ip, x0=x0, tol=tol,
            maxiter=maxiter, ortho=ortho,
            explicit_residual=explicit_residual,
            return_internal=return_internal,
        )

    if ortho == "auto":
        # the kernels that plain gmres's auto rule picks do not compose
        # with the capture hook
        ortho = "cgs2"
    if ortho == "cgs2_1r":
        raise NotImplementedError(
            "deflated_gmres ortho='cgs2_1r' (fused_deflation) is not "
            "ported yet (ROADMAP.md queue A, item 7)")

    UoT = defl.Uo.T
    proj_complement = _proj_complement(defl, rows)

    def op_with_capture(v):
        Av = apply(Ml_mv, A_mv(apply(Mr_mv, v)))
        cap = rows(UoT, Av)               # <Uo, MlAMr v>
        return proj_complement(Av), cap

    out = _gmres(
        A, b, M=M, Ml=Ml, Mr=Mr, ip=ip, x0=x0, tol=tol,
        maxiter=maxiter, ortho=ortho,
        explicit_residual=explicit_residual,
        operator_with_capture=op_with_capture,
        capture_width=d,
        projected_r0=proj_complement,
        correct_xk=_correction(defl, rows, A_mv, Ml_mv, bv),
        return_internal=return_internal,
    )
    if return_internal:
        result, internals = out
        internals["E"] = defl.E
        internals["Uo"] = defl.Uo
        internals["AU"] = defl.AU
        return result, internals
    return out


def _make_deflation_hooks(A, U, *, M, Minv, Ml, Mr, ip, ip_defl):
    """Shared hook construction for the short-recurrence deflated
    solvers: returns ``(defl, operator_override, projected_r0)``, the
    hooks None when d == 0."""
    A_mv = as_matvec(A)
    Ml_mv = as_matvec(Ml)
    Mr_mv = as_matvec(Mr)
    _, rows = make_inner(ip)

    defl = build_deflation(
        A, U, M=M, Minv=Minv, Ml=Ml, Mr=Mr, ip=ip, ip_defl=ip_defl
    )
    if defl.Uo.shape[1] == 0:
        return defl, None, None
    proj_complement = _proj_complement(defl, rows)

    def op(v):
        return proj_complement(apply(Ml_mv, A_mv(apply(Mr_mv, v))))

    return defl, op, proj_complement


def _deflated_short_recurrence(core, A, b, U, kwargs):
    """Common body of the deflated short-recurrence solvers
    (reference: DeflatedCg / DeflatedMinres, krypy/deflation.py:236-273):
    projected operator, projected initial residual, corrected iterates.
    Classic variant only: ``variant="auto"`` resolves to it, the fused
    one-reduce form (``variant="1r"``) is the core's to refuse."""
    if kwargs.get("variant") == "auto":
        kwargs["variant"] = "classic"
    ip = kwargs.get("ip")
    defl, op, proj = _make_deflation_hooks(
        A, U,
        M=kwargs.get("M"), Minv=kwargs.pop("Minv", None),
        Ml=kwargs.get("Ml"), Mr=kwargs.get("Mr"),
        ip=ip, ip_defl=kwargs.pop("ip_defl", None),
    )
    if op is None:
        return core(A, b, **kwargs)

    _, rows = make_inner(ip)
    correct = _correction(defl, rows, as_matvec(A),
                          as_matvec(kwargs.get("Ml")), b.reshape(-1))
    return core(
        A, b,
        operator_override=op,
        projected_r0=proj,
        correct_xk=correct,
        **kwargs,
    )


def deflated_cg(A, b, U, **kwargs):
    """Deflated preconditioned CG (reference: krypy/deflation.py
    DeflatedCg).  Accepts the parameters of
    :func:`krypy_tpu_torch.functional.cg.cg` plus the deflation basis U
    (and ``Minv``, ``ip_defl`` as :func:`deflated_gmres`)."""
    from .cg import cg as _cg

    return _deflated_short_recurrence(_cg, A, b, U, kwargs)


def deflated_minres(A, b, U, **kwargs):
    """Deflated MINRES: not ported (it needs ``minres``)."""
    raise NotImplementedError(
        "deflated_minres is not ported yet: it needs functional.minres "
        "(ROADMAP.md queue A, slice 3)")


def _augmented_galerkin(internals):
    """Host assembly of the augmented Galerkin matrix ``[[H + B E^{-1}C,
    B], [C, E]]`` of the space ``[V_n, U]`` from the matrices captured by
    a (deflated) GMRES solve (reference math:
    krypy/deflation.py:781-809).  Returns ``(Mblock, n, d)``.

    H, C, E and the Gram block ``B = <V, AU>`` come to the host as ONE
    flat tensor, one transfer per hand-off."""
    H_dev = internals["H"]
    n = int(internals.get("niter", H_dev.shape[1]))
    E_dev = internals.get("E")
    d = 0 if E_dev is None else int(E_dev.shape[0])

    if not d:
        return H_dev.cpu().numpy()[:n, :n], n, d

    C_dev, V = internals["C"], internals["V"]
    B_dev = V.conj() @ internals["AU"]  # (m+1, d) Gram block <V, AU>
    dt = H_dev.dtype
    for t in (C_dev, E_dev, B_dev):
        dt = torch.promote_types(dt, t.dtype)
    flat = torch.cat([t.reshape(-1).to(dt)
                      for t in (H_dev, C_dev, E_dev, B_dev)]).cpu().numpy()
    o1, o2, o3 = np.cumsum([t.numel() for t in (H_dev, C_dev, E_dev)])
    H = flat[:o1].reshape(tuple(H_dev.shape))[:n, :n]
    C = flat[o1:o2].reshape(tuple(C_dev.shape))[:n, :d].T
    E = flat[o2:o3].reshape(tuple(E_dev.shape))
    B = flat[o3:].reshape(V.shape[0], d)[:n]
    EinvC = np.linalg.solve(E, C)
    return np.block([[H + B @ EinvC, B], [C, E]]), n, d


def ritz_pairs(internals, hermitian=False):
    """Augmented Ritz values and coefficient vectors (host decision
    data) from the captured small matrices of a GMRES solve; the
    eigenproblem runs in numpy on the host, in the dtype of the fetched
    matrices."""
    Mblock, n, d = _augmented_galerkin(internals)
    if hermitian:
        theta, coeffs = np.linalg.eigh((Mblock + Mblock.conj().T) / 2)
    else:
        theta, coeffs = np.linalg.eig(Mblock)
    return theta, coeffs, n, d


def _realify_columns(sel, theta=None):
    """Real coefficient block spanning (a real surrogate of) the columns
    of complex ``sel``.

    A complex-conjugate Ritz pair ``(v, conj(v))`` must map to the real
    pair ``(Re v, Im v)``: taking the phase-aligned real part of BOTH
    members yields two IDENTICAL columns and a rank-deficient deflation
    basis (singular E, NaN solve).  With ``theta`` given, a column whose
    eigenvalue is the conjugate of an earlier selected one contributes
    its imaginary part; without ``theta`` the same rule is applied by
    detecting near-parallelism against the previous realified column.
    """
    p, k = sel.shape
    idx = np.argmax(np.abs(sel), axis=0)
    piv = sel[idx, np.arange(k)]
    phase = piv / np.where(np.abs(piv) == 0, 1.0, np.abs(piv))
    aligned = sel / phase[None, :]

    out = np.empty((p, k))
    seen = []  # eigenvalues of already-realified columns
    for j in range(k):
        col = np.real(aligned[:, j])
        use_imag = False
        if theta is not None:
            tj = complex(np.asarray(theta).reshape(-1)[j])
            if abs(tj.imag) > 1e-12 * max(abs(tj), 1.0):
                for ti in seen:
                    if abs(ti - np.conj(tj)) <= 1e-8 * max(abs(tj), 1.0):
                        use_imag = True
                        break
            seen.append(tj)
        elif j > 0:
            prev = out[:, j - 1]
            denom = np.linalg.norm(col) * np.linalg.norm(prev)
            if denom > 0 and abs(col @ prev) > 0.999 * denom:
                use_imag = True
        if use_imag:
            im = np.imag(aligned[:, j])
            if np.linalg.norm(im) > 1e-12 * np.linalg.norm(aligned[:, j]):
                col = im
        out[:, j] = col
    norms = np.linalg.norm(out, axis=0)
    return out / np.where(norms == 0, 1.0, norms)


def assemble_ritz_vectors(internals, sel, n, d, theta=None):
    """Assemble ``[V_n, U] @ sel`` on the device: ONE ``(n + d, k)``
    coefficient block goes to the device and multiplies the n active rows
    of the Krylov basis and the d rows of the deflation basis.  (The JAX
    package pads the block to the static buffer height so that the product
    compiles once; the rows it adds are zero.)  Returns ``(N, k)``, a view
    of contiguous ``(k, N)`` rows.

    :param theta: (optional) eigenvalues of the selected columns; enables
      exact conjugate-pair handling in the real-basis realification.
    """
    V = internals["V"]
    if np.iscomplexobj(sel) and not V.is_complex():
        sel = _realify_columns(sel, theta)
    # keep the basis dtype: host eigensolves may return float64/complex128,
    # which must not leak into a float32 device solve
    sel_dev = torch.tensor(np.ascontiguousarray(sel[: n + d].T),
                           device=V.device).to(V.dtype)  # (k, n + d)
    out = sel_dev[:, :n] @ V[:n]
    if d:
        out = out + sel_dev[:, n:] @ internals["Uo"].T
    return out.T


def ritz_deflation_vectors(internals, n_vectors=3, which="sm",
                           hermitian=False):
    """Extract Ritz deflation vectors for the NEXT solve from the internal
    state of a deflated (or plain) GMRES solve.

    The augmented Ritz problem is assembled from the small matrices only
    (reference math: krypy/deflation.py:737-830); the eigensolve of the
    (n+d) x (n+d) pencil runs on the host (decision data), the vector
    assembly ``[V_n, U] @ coeffs`` on the device (see
    :func:`assemble_ritz_vectors`).  ``internals`` is ``gmres``'s
    ``return_internal`` dictionary with ``"niter"`` added (default: the
    full basis) and, after a deflated solve, ``E``, ``Uo``, ``AU``.
    """
    theta, coeffs, n, d = ritz_pairs(internals, hermitian=hermitian)
    order = {
        "sm": np.argsort(np.abs(theta)),
        "lm": np.argsort(np.abs(theta))[::-1],
        "sr": np.argsort(np.real(theta)),
        "lr": np.argsort(np.real(theta))[::-1],
    }[which][:n_vectors]
    sel = np.ascontiguousarray(coeffs[:, order])
    return assemble_ritz_vectors(internals, sel, n, d, theta=theta[order])


class RecyclingGmres:
    """Recycling GMRES: construct once, call :meth:`solve` for each system
    of a sequence; deflation vectors are Ritz vectors recycled from the
    previous solve (reference: krypy/recycling/linsys.py).  The
    Ritz selection between solves is host-side decision logic on the
    small matrices, fetched in one transfer."""

    def __init__(self, n_vectors=3, which="sm", hermitian=False):
        self.n_vectors = n_vectors
        self.which = which
        self.hermitian = hermitian
        self._last_internals = None
        self._U = None

    def warmup(self, A, b, **kwargs):
        """Run the plain AND the deflated solver once on a ZERO right-hand
        side (0 iterations each), with an orthonormal placeholder basis of
        ``n_vectors`` columns, so that the kernels' build and the first
        launches of the operator fall outside :meth:`solve`.  ``kwargs``
        as for the subsequent :meth:`solve` calls.  Returns ``self``."""
        bz = torch.zeros_like(b)
        N = b.reshape(-1).shape[0]
        _gmres(A, bz, **kwargs)
        U = torch.eye(self.n_vectors, N, dtype=b.dtype, device=b.device).T
        res = deflated_gmres(A, bz, U, **kwargs)
        float(res.x.sum().real)  # wait for the device
        return self

    def _next_deflation_basis(self, kwargs):
        """Deflation basis for the upcoming solve (None = plain solve): a
        FIXED number of Ritz vectors of the last solve.  Without captured
        internals an externally seeded basis is kept."""
        if self._last_internals is None:
            return self._U
        try:
            return ritz_deflation_vectors(
                self._last_internals,
                n_vectors=self.n_vectors,
                which=self.which,
                hermitian=self.hermitian,
            )
        except np.linalg.LinAlgError:
            return None

    def _observe(self, width, niter, wall_s):
        """Timing feedback after each solve (for a subclass that prices
        the deflation width by it)."""

    def solve(self, A, b, **kwargs):
        self._U = self._next_deflation_basis(kwargs)

        t0 = time.perf_counter()
        if self._U is None:
            result, internals = _gmres(
                A, b, return_internal=True, **kwargs)
            internals["E"] = torch.zeros((0, 0), dtype=b.dtype,
                                         device=b.device)
        else:
            result, internals = deflated_gmres(
                A, b, self._U, return_internal=True, **kwargs)
        internals["niter"] = int(result.niter)  # also waits for the device
        self._observe(
            0 if self._U is None else int(self._U.shape[1]),
            internals["niter"],
            time.perf_counter() - t0,
        )
        self._last_internals = internals
        return result


def AutoRecyclingGmres(*args, **kwargs):
    """Recycling GMRES with priced deflation-width selection: not ported
    (it needs ``spectral.BoundMinres``)."""
    raise NotImplementedError(
        "AutoRecyclingGmres is not ported yet: it needs "
        "spectral.BoundMinres (ROADMAP.md queue A, slice 3)")
