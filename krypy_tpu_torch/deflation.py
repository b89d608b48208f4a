r"""Deflated Krylov solvers and Ritz extraction (counterpart of
:mod:`krypy_tpu.deflation`).

Deflation augments a Krylov solver with a subspace U: the solver runs on
the projected operator :math:`P\,M_l A M_r` where P is the oblique
projection along :math:`M_l A M_r U`, and each iterate is corrected by
re-solving the U-component of the residual.

Device/host split: the projection and all N-dimensional work (QR of U,
operator applications, iterate correction, the leak basis of
:class:`Arnoldifyer`) run on the system's device; the small Gram-matrix
machinery (E, C, B_) is read to the host where :class:`Ritz`,
:class:`Arnoldifyer` and :func:`bound_pseudo` assemble their
(n+d)-dimensional problems for host LAPACK.
"""

import numpy as np
import scipy.linalg
import torch

from . import linsys, utils
from .arnoldi import host
from .core.dtypes import asarray
from .core.products import _mm
from .core.projections import _solve_upper
from .errors import ArgumentError, AssumptionError, ConvergenceError

__all__ = [
    "DeflatedCg",
    "DeflatedMinres",
    "DeflatedGmres",
    "ObliqueProjection",
    "Ritz",
    "Arnoldifyer",
    "bound_pseudo",
]


class _Projection(utils.Projection):
    """Abstract base for deflation projections."""

    def __init__(self, linear_system, U, **kwargs):
        raise NotImplementedError(
            "abstract base class cannot be instantiated"
        )


class ObliqueProjection(_Projection):
    r"""Oblique projection for left deflation.

    Orthonormalizes U in the :math:`M^{-1}`-inner product, applies the
    operator once per deflation vector, and builds the projection with
    range ``colspan(MlAMr U)`` and kernel ``colspan(U)``:math:`^\perp`.
    """

    def __init__(self, linear_system, U, qr_reorthos=0, **kwargs):
        self.linear_system = linear_system
        U = asarray(U, device=linear_system.device)

        # orthonormalize U in the M^{-1}-B inner product
        U, _ = utils.qr(
            U, ip_B=linear_system.get_ip_Minv_B(), reorthos=qr_reorthos
        )
        self.U = U
        #: :math:`M_l A M_r U` -- d operator applications.
        self.AU = linear_system.MlAMr * U
        self._MAU = None

        # build the underlying Projection P_{AU, U^perp}
        utils.Projection.__init__(
            self, self.AU, self.U, ip_B=linear_system.ip_B,
            device=linear_system.device, **kwargs
        )

    def correct(self, z):
        """Correct an approximate solution ``z`` by solving the deflation-
        space component of its residual."""
        ls = self.linear_system
        c = ls.Ml * (ls.b - ls.A * z)
        c = utils.inner(self.W, c, ip_B=self.ip_B)
        if self.Q is not None and self.R is not None:
            c = _solve_upper(self.R, _mm(self.Q.conj().T, c))
        if self.WR is not self.VR:
            c = _mm(self.WR, _solve_upper(self.VR, c))
        return z + _mm(self.W, c)

    @property
    def MAU(self):
        """:math:`M M_l A M_r U` (cached)."""
        if self._MAU is None:
            self._MAU = self.linear_system.M * self.AU
        return self._MAU


class _DeflationMixin:
    """Mixin adding deflation to any solver class of
    :mod:`krypy_tpu_torch.linsys`.

    :param linear_system: the :class:`~krypy_tpu_torch.linsys.LinearSystem`.
    :param U: basis of the deflation space, shape ``(N, d)`` (tensor or
      numpy; numpy goes to the system's device).
    """

    def __init__(
        self, linear_system, U=None, projection_kwargs=None, *args, **kwargs
    ):
        dev = linear_system.device
        if U is None:
            U = torch.zeros((linear_system.N, 0), dtype=torch.float64,
                            device=dev)
        U = asarray(U, device=dev)
        if projection_kwargs is None:
            projection_kwargs = {}

        projection = ObliqueProjection(
            linear_system, U, **projection_kwargs
        )
        #: the oblique projection used for deflation.
        self.projection = projection

        # E = <U, MlAMr U>, recovered from the projection's factors
        if projection.Q is None and projection.R is None:
            E = torch.eye(U.shape[1], dtype=torch.float64, device=dev)
        else:
            E = _mm(projection.Q, projection.R)
        if projection.VR is not None and projection.WR is not None:
            E = _mm(projection.WR.conj().T, _mm(E, projection.VR))
        #: :math:`E = \\langle U, M_l A M_r U\\rangle`.
        self.E = E

        #: :math:`C = \\langle U, M_l A M_r V_n\\rangle`, grown column by
        #: column as the iteration proceeds.
        self.C = torch.zeros((U.shape[1], 0), dtype=U.dtype, device=dev)
        self._B_ = None

        super().__init__(linear_system, dtype=U.dtype, *args, **kwargs)

    def _solve(self):
        N = self.linear_system.N
        P = utils.LinearOperator(
            (N, N), self.projection.AU.dtype, self._apply_projection
        )
        P.device = self.linear_system.device
        # the solver now iterates with the projected operator P MlAMr
        self.MlAMr = P * self.linear_system.MlAMr
        super()._solve()

    def _apply_projection(self, Av):
        """Apply the deflation projection to an operator output and record
        the Gram column :math:`\\langle U, A v\\rangle`."""
        PAv, UAv = self.projection.apply_complement(Av, return_Ya=True)
        self.C = torch.cat([self.C, UAv], dim=1)
        return PAv

    def _get_initial_residual(self, x0):
        """Projected initial residual :math:`M P M_l (b - A x_0)`."""
        ls = self.linear_system
        if x0 is None:
            Mlr = ls.Mlb
        else:
            Mlr = ls.Ml * (ls.b - ls.A * x0)

        PMlr, self.UMlr = self.projection.apply_complement(
            Mlr, return_Ya=True
        )
        MPMlr = ls.M * PMlr
        MPMlr_norm = utils.norm(PMlr, MPMlr, ip_B=ls.ip_B)
        return MPMlr, PMlr, MPMlr_norm

    def _get_xk(self, yk):
        xk = super()._get_xk(yk)
        return self.projection.correct(xk)

    @property
    def B_(self):
        r""":math:`\underline{B} = \langle V_{n+1}, M_l A M_r U\rangle`.

        Derived from C when the operator is self-adjoint, otherwise formed
        explicitly."""
        (n_, n) = self.H.shape
        ls = self.linear_system
        if self._B_ is None or self._B_.shape[0] < n_:
            if ls.self_adjoint:
                B_ = self.C.conj().T
                if n_ > n:
                    B_ = torch.cat(
                        [
                            B_,
                            utils.inner(
                                self.V[:, [-1]],
                                self.projection.AU,
                                ip_B=ls.ip_B,
                            ),
                        ],
                        dim=0,
                    )
                self._B_ = B_
            else:
                self._B_ = utils.inner(
                    self.V, self.projection.AU, ip_B=ls.ip_B
                )
        return self._B_

    def estimate_time(self, nsteps, ndefl, deflweight=1.0):
        """Predicted wall-clock time for ``nsteps`` deflated iterations with
        ``ndefl`` deflation vectors, combining measured per-op timings with
        the analytic operation counts."""
        solver_ops = self.operations(nsteps)
        proj_ops = {
            "A": ndefl,
            "M": ndefl,
            "Ml": ndefl,
            "Mr": ndefl,
            "ip_B": (
                ndefl * (ndefl + 1) / 2
                + ndefl**2
                + 2 * ndefl * solver_ops["Ml"]
            ),
            "axpy": (
                ndefl * (ndefl + 1) / 2
                + ndefl * ndefl
                + (2 * ndefl + 2) * solver_ops["Ml"]
            ),
        }
        if not isinstance(self.linear_system, linsys.TimedLinearSystem):
            from .errors import RuntimeError as KrypyRuntimeError

            raise KrypyRuntimeError(
                "estimate_time needs measured per-operator timings: wrap "
                "the system in a TimedLinearSystem."
            )
        timings = self.linear_system.timings
        return timings.get_ops(solver_ops) + deflweight * timings.get_ops(
            proj_ops
        )


class DeflatedCg(_DeflationMixin, linsys.Cg):
    """Deflated preconditioned CG.

    Exploits the CG three-term structure to build the Gram matrix C
    without extra inner products."""

    def __init__(self, *args, **kwargs):
        self._UAps = []
        super().__init__(*args, **kwargs)

    def _apply_projection(self, Av):
        r"""Compute the column :math:`\langle U, A v_k\rangle` of C from the
        history of :math:`\langle U, A p_i\rangle` via the CG coefficient
        recurrence."""
        PAv, UAp = self.projection.apply_complement(Av, return_Ya=True)
        self._UAps.append(UAp)
        c = UAp
        rhos = self.rhos
        if self.iter > 0:
            c = c - (1 + rhos[-1] / rhos[-2]) * self._UAps[-2]
        if self.iter > 1:
            c = c + rhos[-2] / rhos[-3] * self._UAps[-3]
        c = c * (((-1) ** self.iter) / np.sqrt(rhos[-1]))
        if self.iter > 0:
            c = c - np.sqrt(rhos[-2] / rhos[-1]) * self.C[:, [-1]]
        self.C = torch.cat([self.C, c], dim=1)
        return PAv


class DeflatedMinres(_DeflationMixin, linsys.Minres):
    """Deflated preconditioned MINRES."""


class DeflatedGmres(_DeflationMixin, linsys.Gmres):
    """Deflated preconditioned GMRES."""


def _orthonormal_span(X, ip_B, drop_tol):
    """Orthonormal basis (in ``ip_B``) of the numerical column span of X.

    Column-pivoted Gram-Schmidt with a reorthogonalization pass; pivots
    whose residual norm falls below ``drop_tol`` terminate the sweep.  The
    N-dimensional contractions run on the device; only the (tiny) pivot
    decisions live on the host.  Returns ``Q`` with shape ``(N, rank)``.
    """
    X = asarray(X)
    d = X.shape[1]
    if d == 0:
        return X
    work = X
    columns = []
    for _ in range(d):
        sq = np.real(np.diag(host(utils.inner(work, work, ip_B=ip_B))))
        pivot = int(np.argmax(sq))
        size = float(np.sqrt(max(sq[pivot], 0.0)))
        if size <= drop_tol:
            break
        q = work[:, pivot] / size
        if columns:
            Qsofar = torch.stack(columns, dim=1)
            q = q - _mm(
                Qsofar, utils.inner(Qsofar, q[:, None], ip_B=ip_B)
            ).reshape(-1)
            q = q / utils.norm(q[:, None], ip_B=ip_B)
        columns.append(q)
        # deflate the remaining columns and retire the pivot
        work = work - _mm(q[:, None],
                          utils.inner(q[:, None], work, ip_B=ip_B))
        work[:, pivot] = 0.0
    if not columns:
        return X[:, :0]
    return torch.stack(columns, dim=1)


def _unitary_from_column(q):
    """Small dense unitary whose first column is ``q/||q||`` (identity when
    q vanishes).  Complex-safe via a phase-corrected LAPACK QR."""
    m = q.shape[0]
    dt = np.result_type(q.dtype, np.float64)
    size = np.linalg.norm(q)
    if m == 0 or size == 0:
        return np.eye(m, dtype=dt)
    Qf, Rf = np.linalg.qr(q.reshape(m, 1).astype(dt), mode="complete")
    Qf = np.array(Qf)
    Qf[:, 0] *= Rf[0, 0] / abs(Rf[0, 0])
    return Qf


# ---------------------------------------------------------------------------
# Predicting deflated solves: extended-basis calculus
# ---------------------------------------------------------------------------
#
# After a deflated solve we know how the preconditioned operator
# :math:`\hat A = M M_l A M_r` acts on the computed subspace
# :math:`\mathrm{span}[V_n, U]` -- exactly, with no further N-dimensional
# work.  All prediction machinery below is phrased in the ORTHONORMAL
# (w.r.t. the :math:`M^{-1}`-B inner product) extended basis
#
#     S_ext = [ V_{n+1} | U | Z ],
#
# where Z completes :math:`\hat A U` beyond span[V_{n+1}, U]; Z is obtained
# by a rank-revealing inner-product-aware Gram-Schmidt on the device.  A
# single small host matrix carries all operator information: ``action`` (G
# below), the S_ext-coordinates of :math:`\hat A [V_n, U]`.  Restricting
# coordinates to the [V_n, U] rows is mere row selection, so every oblique
# projection needed by the candidate analysis becomes a plain Euclidean
# one on coordinates.
#
# Derivation of G: the deflated Arnoldi relation gives
#   \hat A V_n = V_{n+1} \underline{H} + (M M_l A M_r U) E^{-1} C,
# and the extended basis expands M M_l A M_r U = V B_ + U E + Z R_Z, hence
#
#        [ \underline{H} + B_ E^{-1}C    B_  ]   <- V_{n+1} rows
#   G  = [ C                             E   ]   <- U rows
#        [ R_Z E^{-1} C                  R_Z ]   <- Z rows


def _on(device, X):
    """A host matrix as a tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(X), device=device)


def _column_stack(*blocks):
    """The blocks side by side in their promoted dtype (as
    ``jnp.column_stack`` promotes)."""
    dt = blocks[0].dtype
    for blk in blocks[1:]:
        dt = torch.promote_types(dt, blk.dtype)
    return torch.cat([blk.to(dt) for blk in blocks], dim=1)


class Arnoldifyer:
    r"""Predict the Arnoldi relation a *candidate* deflation subspace would
    generate, from the data of a finished deflated solve -- without any new
    N-dimensional operator applications.

    The small dense work (the action matrix, the candidate's Hessenberg
    reduction) runs on host LAPACK; the N-row blocks (the leak basis
    ``Z``, the candidate basis ``Vh``) stay on the system's device.

    :param deflated_solver: a completed deflated solver instance (with
      ``store_arnoldi=True``).

    Attributes: ``Z`` -- device basis of the leak space
    :math:`[V_{n:}, Z]` that candidate relations are perturbed through;
    ``action`` -- the extended-coordinate operator matrix G;
    ``galerkin`` -- its [V_n, U]-row restriction
    :math:`\langle [V_n,U], \hat A [V_n,U]\rangle`.
    """

    def __init__(self, deflated_solver):
        self._deflated_solver = deflated_solver
        ls = deflated_solver.linear_system
        dev = ls.device
        H = host(deflated_solver.H)  # (n_, n)
        B_ = host(deflated_solver.B_)  # (n_, d)
        C = host(deflated_solver.C)  # (d, n)
        E = host(deflated_solver.E)  # (d, d)
        n_, n = H.shape
        d = E.shape[0]
        self.n_, self.n, self.d = n_, n, d

        V = deflated_solver.V
        U = deflated_solver.projection.U
        dt = np.result_type(H.dtype, B_.dtype, C.dtype, E.dtype, np.float64)

        # U-coordinates of \hat A V_n
        ucoords = np.linalg.solve(E, C) if d else np.zeros((0, n), dt)

        # Galerkin restriction onto [V_n, U] -- assembled first because its
        # norm scales the rank decision below.
        galerkin = np.zeros((n + d, n + d), dt)
        galerkin[:n, :n] = H[:n, :] + B_[:n, :] @ ucoords
        galerkin[:n, n:] = B_[:n, :]
        galerkin[n:, :n] = C
        galerkin[n:, n:] = E
        self.galerkin = galerkin
        self.op_norm = np.linalg.norm(galerkin, 2) if n + d else 0.0

        # complete the extended basis: the part of M MlAMr U outside
        # span[V_{n+1}, U], orthonormalized on the device in the
        # M^{-1}-B ip
        ip_x = ls.get_ip_Minv_B()
        if d:
            MAU = deflated_solver.projection.MAU
            leftover = MAU - _mm(V, _on(dev, B_)) - _mm(U, _on(dev, E))
            Zq = _orthonormal_span(leftover, ip_x, 1e-14 * self.op_norm)
            R_Z = host(utils.inner(Zq, leftover, ip_B=ip_x))
        else:
            Zq = torch.zeros((U.shape[0], 0), dtype=V.dtype, device=dev)
            R_Z = np.zeros((0, 0), dt)
        r = R_Z.shape[0]

        # extended-coordinate action matrix G (see the notes above)
        G = np.zeros((n_ + d + r, n + d), dt)
        G[:n_, :n] = H + B_ @ ucoords
        G[:n_, n:] = B_
        G[n_: n_ + d, :n] = C
        G[n_: n_ + d, n:] = E
        G[n_ + d:, :n] = R_Z @ ucoords
        G[n_ + d:, n:] = R_Z
        self.action = G

        # coordinate row bookkeeping: [V_n, U] rows vs leak rows
        self._span_rows = np.concatenate([np.arange(n), n_ + np.arange(d)])
        self._leak_rows = np.concatenate(
            [np.arange(n, n_), n_ + d + np.arange(r)]
        )

        #: device basis of the leak space (columns pair with Rh rows)
        self.Z = _column_stack(V[:, n:], Zq)

        # extended coordinates of the original (unprojected) initial
        # residual: its deflated part is MMlr0_norm * v_0, its deflation-
        # space part is (M MlAMr U) E^{-1} <U, Mlr0>
        r0 = np.zeros(n_ + d + r, dt)
        r0[0] = float(deflated_solver.MMlr0_norm)
        if d:
            r0 = r0 + G[:, n:] @ np.linalg.solve(
                E, host(deflated_solver.UMlr).reshape(-1)
            )
        self._r0 = r0

    def get(self, Wt, full=False):
        r"""Arnoldi relation for the deflation-subspace choice
        :math:`W = [V_n, U]\tilde{W}` (``Wt.shape == (n+d, k)``).

        :return: ``Hh, Rh, q_norm, vdiff_norm, PWAW_norm`` (+ ``Vh, F`` if
          ``full=True``): the Hessenberg matrix of the predicted deflated
          operator, the leak-space perturbation coefficients, the norm of
          the projected initial vector, the initial-vector leak norm, and
          the norm of the projection
          :math:`P_{\mathcal{W}^\perp, A\mathcal{W}}` (host values;
          ``Vh`` a device block, ``F`` an operator on the device).
        """
        n, d = self.n, self.d
        G = self.action
        span = self._span_rows
        leak = self._leak_rows
        Wt = host(Wt)
        k = Wt.shape[1]

        # orthonormalize the selection and take its complement in C^{n+d}
        if k:
            Qw = scipy.linalg.qr(Wt)[0]
            Wt, Wco = Qw[:, :k], Qw[:, k:]
        else:
            Wco = np.eye(n + d, dtype=G.dtype)

        GW = G @ Wt  # coordinates of \hat A W
        EW = Wt.conj().T @ (self.galerkin @ Wt)  # <W, \hat A W>

        def deflate(X):
            """Euclidean-coordinate form of the oblique projection along
            span(AW) with test space W (identity when k == 0)."""
            if k == 0:
                return X
            return X - GW @ np.linalg.solve(EW, Wt.conj().T @ X[span, :])

        # projected initial vector: its [V_n,U]-complement coords and leak
        q_ext = deflate(self._r0[:, None])
        q_span = (Wco.conj().T @ q_ext[span, :]).reshape(-1)
        q_norm = float(np.linalg.norm(q_span))
        vdiff_norm = float(np.linalg.norm(q_ext[leak, :]))

        # compression of the projected operator onto the complement of W,
        # rotated so the first basis vector matches the initial vector,
        # then Hessenberg-reduced
        PGW = deflate(G @ Wco)
        compressed = Wco.conj().T @ PGW[span, :]
        U1 = _unitary_from_column(q_span)
        Hh, U2 = scipy.linalg.hessenberg(
            U1.conj().T @ compressed @ U1, calc_q=True
        )
        rotation = U1 @ U2  # unitary; first column = q_span/||q_span||

        # leak coefficients: \hat A_defl Vh = Vh Hh + Z Rh
        Rh = PGW[leak, :] @ rotation

        # norm of P_{W^perp, AW} = 1/cos(max principal angle <W, AW>)
        if k:
            AW_on = scipy.linalg.qr(GW, mode="economic")[0]
            PWAW_norm = 1.0 / np.min(
                scipy.linalg.svdvals(Wt.conj().T @ AW_on[span, :])
            )
        else:
            PWAW_norm = 1.0

        if not full:
            return Hh, Rh, q_norm, vdiff_norm, PWAW_norm

        ds = self._deflated_solver
        dev = ds.linear_system.device
        Vh = _mm(_column_stack(ds.V[:, :n], ds.projection.U),
                 _on(dev, Wco @ rotation))
        ip_x = ds.linear_system.get_ip_Minv_B()
        Z = self.Z
        Rh_dev = _on(dev, Rh)

        def perturbation(x):
            """:math:`F = -(Z R_h V_h^* + V_h R_h^* Z^*)` in the
            :math:`M^{-1}`-B geometry."""
            return -(
                _mm(Z, _mm(Rh_dev, utils.inner(Vh, x, ip_B=ip_x)))
                + _mm(Vh, _mm(Rh_dev.conj().T, utils.inner(Z, x, ip_B=ip_x)))
            )

        F = utils.LinearOperator(
            (Vh.shape[0], Vh.shape[0]), dtype=ds.dtype, dot=perturbation
        )
        F.device = dev
        return Hh, Rh, q_norm, vdiff_norm, PWAW_norm, Vh, F


def _spectral_norm(X):
    """2-norm of a (possibly empty) small dense matrix."""
    return 0.0 if X.size == 0 else float(np.linalg.norm(X, 2))


def _replayed_resnorms(arnoldifyer, Hh, q_norm, tol):
    """Residual-norm history of the small projected system
    ``Hh y = q_norm e_1``, replayed with the same solver family that
    produced the deflated solve (absolute norms); a CG replay runs on the
    host CPU, as small dense work does."""
    ds = arnoldifyer._deflated_solver
    ls = ds.linear_system
    solver_cls = type(ds)
    if issubclass(solver_cls, (linsys.Minres, linsys.Gmres)):
        history = utils.get_residual_norms(Hh, self_adjoint=ls.self_adjoint)
    else:
        small = linsys.LinearSystem(
            np.asarray(Hh),
            np.eye(Hh.shape[0], 1) * q_norm,
            normal=ls.normal,
            self_adjoint=ls.self_adjoint,
            positive_definite=ls.positive_definite,
            device="cpu",
        )
        try:
            replay = solver_cls(small, tol=tol, maxiter=Hh.shape[0])
        except ConvergenceError as caught:
            replay = caught.solver
        history = np.array(replay.resnorms)
    return np.asarray(history) * q_norm


def _residual_poly_roots(Hh, steps, solver_cls, self_adjoint):
    """Roots of the step-``steps`` residual polynomial of the replayed
    solve: Ritz values for the Galerkin (CG) family, harmonic Ritz values
    for the residual-minimizing (MINRES/GMRES) family."""
    if issubclass(solver_cls, linsys.Cg):
        roots = scipy.linalg.eigvalsh(Hh[:steps, :steps])
    else:
        Qs, Rs = scipy.linalg.qr(Hh[: steps + 1, :steps], mode="economic")
        recip = scipy.linalg.eigvals(Qs[:steps, :].conj().T, Rs)
        roots = 1.0 / recip[np.abs(recip) > 1e-14]
    return np.real(roots) if self_adjoint else roots


def bound_pseudo(
    arnoldifyer,
    Wt,
    g_norm=0.0,
    G_norm=0.0,
    GW_norm=0.0,
    WGW_norm=0.0,
    tol=1e-6,
    pseudo_type="auto",
    pseudo_kwargs=None,
    delta_n=20,
    terminate_factor=1.0,
):
    r"""Bound the residual norms of the *next* deflated system solved with
    the candidate deflation vectors :math:`W = [V, U]\tilde W`.

    The perturbation of the predicted Krylov relation is pushed through an
    :math:`\varepsilon`-pseudospectral residual-polynomial estimate,
    minimized over the pseudospectrum radius (after Gaul's dissertation).

    ``pseudo_type`` selects how perturbations enter the bound:
    ``'auto'``/``'nonnormal'``/``'normal'``/``'hermitian'`` use
    :math:`\varepsilon`-pseudospectra of the predicted Hessenberg matrix
    (computed natively, see :mod:`krypy_tpu_torch.pseudospectra`; the
    non-normal grid's batched SVD runs on the system's device);
    ``'omit'`` skips perturbation analysis and returns the
    approximate-Krylov residual norms only.
    """
    pseudo_kwargs = pseudo_kwargs or {}
    ds = arnoldifyer._deflated_solver
    ls = ds.linear_system
    solver_cls = type(ds)

    Hh, Rh, q_norm, vdiff_norm, PWAW_norm = arnoldifyer.get(Wt)

    # perturbation budget: how far the candidate relation can drift under
    # the user-supplied operator/rhs perturbation norms
    Wt = host(Wt)
    k = Wt.shape[1]
    if k:
        WAW = Wt.conj().T @ (arnoldifyer.galerkin @ Wt)
        sv_floor = np.min(scipy.linalg.svdvals(WAW))
        if sv_floor <= WGW_norm:
            raise AssumptionError(
                "candidate deflation space is too ill-conditioned: the "
                "smallest singular value of <W, A W> does not dominate "
                "the perturbation norm ||W^* G W||"
            )
        drift = GW_norm / (sv_floor - WGW_norm)
    else:
        drift = 0.0
    b_norm = float(ls.MMlb_norm)
    if g_norm >= b_norm:
        raise AssumptionError(
            "the right-hand-side perturbation exceeds the right-hand side "
            "itself (g_norm >= ||b||); no bound is possible"
        )
    beta = PWAW_norm * (drift * (b_norm + g_norm) + g_norm) + vdiff_norm

    curve = _replayed_resnorms(arnoldifyer, Hh, q_norm, tol)
    rhs_scale = b_norm - g_norm

    if pseudo_type == "omit":
        return curve / rhs_scale
    if pseudo_type == "contain":
        raise NotImplementedError(
            "pseudo_type='contain' is not implemented (matching the "
            "reference, krypy/deflation.py:661)"
        )

    evals = scipy.linalg.eigvals(Hh)
    if ls.self_adjoint:
        evals = np.real(evals)
    Hh_norm = _spectral_norm(Hh)

    if pseudo_type == "auto":
        if _spectral_norm(Hh - Hh.conj().T) < 1e-14 * Hh_norm:
            pseudo_type = "hermitian"
        elif np.linalg.cond(scipy.linalg.eig(Hh)[1], 2) < 1 + 1e-14:
            pseudo_type = "normal"
        else:
            pseudo_type = "nonnormal"
    hermitian_like = ls.self_adjoint

    radius_cap = 1e2 * np.max(np.abs(evals))
    operator_eps = PWAW_norm * (drift * (Hh_norm + G_norm) + G_norm)

    # backend selection follows the system flags (as in the reference:
    # pseudo_type only distinguishes omit/contain/auto resolution)
    from . import pseudospectra

    if not ls.normal:
        radius_floor = max(
            operator_eps + _spectral_norm(Rh[:, :1]), 1e-16
        )
        pseudo = pseudospectra.NonnormalAuto(
            Hh, radius_floor * 0.99, radius_cap * 1.01,
            device=ls.device, **pseudo_kwargs
        )
    elif not ls.self_adjoint:
        pseudo = pseudospectra.NormalEvals(evals)
    else:
        pseudo = None

    def perturbed_poly_bound(p, minmax_candidates, epsilon, delta_log):
        """Cauchy-integral style estimate of the perturbed residual
        polynomial over the radius-``delta`` pseudospectrum boundary."""
        delta = 10.0**delta_log
        if hermitian_like:
            # the pseudospectrum degenerates to a union of real intervals
            bands = utils.Intervals(
                [utils.Interval(ev - delta, ev + delta) for ev in evals]
            )
            inside = [c for c in minmax_candidates if bands.contains(c)]
            probes = np.hstack([bands.get_endpoints(), np.array(inside)])
            poly_max = np.max(np.abs(p(probes)))
            boundary_len = 2 * delta
        else:
            paths = pseudo.contour_paths(delta)
            boundary_len = paths.length()
            if boundary_len <= 0:
                # level set below grid resolution: no information at this
                # radius; an infinite value steers the minimizer away
                return np.inf
            poly_max = np.max(np.abs(p(paths.vertices())))
        return (
            boundary_len
            / (2 * np.pi * delta)
            * (epsilon / (delta - epsilon) * (q_norm + beta) + beta)
            * poly_max
        )

    from scipy.optimize import minimize_scalar

    bounds = [curve[0]]
    for step in range(1, len(curve)):
        epsilon = max(operator_eps + _spectral_norm(Rh[:, :step]), 1e-16)
        if epsilon >= radius_cap:
            break

        roots = _residual_poly_roots(Hh, step, solver_cls, hermitian_like)
        p = utils.NormalizedRootsPolynomial(roots)
        minmax_candidates = p.minmax_candidates() if hermitian_like else ()

        best = minimize_scalar(
            lambda dl: perturbed_poly_bound(
                p, minmax_candidates, epsilon, dl
            ),
            bounds=(np.log10(1.01 * epsilon), np.log10(radius_cap)),
            method="bounded",
            options={"maxiter": delta_n},
        )
        value = curve[step] + best.fun

        if step > 1 and value / bounds[-1] > terminate_factor:
            break
        bounds.append(min(value, bounds[-1]))
    return np.array(bounds) / rhs_scale


class Ritz:
    r"""Ritz (or harmonic Ritz) pairs of the *augmented* subspace
    :math:`[V_n, U]` from a deflated solve, via small block generalized
    eigenproblems assembled on the host from H, B_, C, E and F.

    :param deflated_solver: a completed deflated solver.
    :param mode: ``'ritz'`` or ``'harmonic'``.

    ``values``, ``coeffs`` and ``resnorms`` are numpy; the vectors are
    tensors on the system's device.
    """

    def __init__(self, deflated_solver, mode="ritz"):
        self._deflated_solver = deflated_solver
        ls = deflated_solver.linear_system

        H_ = host(deflated_solver.H)
        (n_, n) = H_.shape
        H = H_[:n, :n]
        projection = deflated_solver.projection
        m = projection.U.shape[1]

        if n + m == 0:
            self.values = np.zeros((0,))
            self.coeffs = np.zeros((0,))
            self.resnorms = np.zeros((0,))
            return

        if not isinstance(projection, ObliqueProjection):
            raise ArgumentError(
                "deflated_solver carries an unsupported projection type; "
                "only ObliqueProjection is handled here."
            )

        E = host(deflated_solver.E)
        C = host(deflated_solver.C)
        EinvC = np.linalg.solve(E, C) if m > 0 else C
        B_ = host(deflated_solver.B_)
        B = B_[:n, :]

        # Galerkin matrix of the augmented space
        M = np.block([[H + B @ EinvC, B], [C, E]])
        # Gram matrix of [V_{n+1}, MlAMr U, U]
        F = host(utils.inner(projection.AU, projection.MAU, ip_B=ls.ip_B))
        S = np.block(
            [
                [np.eye(n_), B_, np.zeros((n_, m))],
                [B_.conj().T, F, E],
                [np.zeros((m, n_)), E.conj().T, np.eye(m)],
            ]
        )

        eig = scipy.linalg.eigh if ls.self_adjoint else scipy.linalg.eig

        if mode == "ritz":
            self.values, self.coeffs = eig(M)
        elif mode == "harmonic":
            L = np.block([[H_, np.zeros((n_, m))], [EinvC, np.eye(m)]])
            K = np.block([[np.eye(n_), B_], [B_.conj().T, F]])
            sigmas, self.coeffs = eig(M.conj().T, L.conj().T @ (K @ L))
            self.values = np.zeros(m + n, dtype=sigmas.dtype)
            zero = np.abs(sigmas) < np.finfo(float).eps
            self.values[~zero] = 1.0 / sigmas[~zero]
            self.values[zero] = np.inf
        else:
            raise ArgumentError(
                f"unknown mode '{mode}' (choose 'ritz' or 'harmonic')"
            )

        # normalize coefficient vectors
        self.coeffs = self.coeffs / np.linalg.norm(self.coeffs, axis=0)

        # cheap residual norms through the S Gram matrix
        self.resnorms = np.zeros(m + n)
        for i in range(n + m):
            mu = self.values[i]
            y = self.coeffs[:, [i]]
            G = np.block(
                [
                    [H_ - mu * np.eye(n_, n), np.zeros((n_, m))],
                    [EinvC, np.eye(m)],
                    [np.zeros((m, n)), -mu * np.eye(m)],
                ]
            )
            Gy = G @ y
            resnorm2 = Gy.conj().T @ (S @ Gy)
            self.resnorms[i] = np.sqrt(np.abs(resnorm2[0, 0]))

    def get_vectors(self, indices=None):
        """Ritz vectors :math:`[V_n, U]\\,\\text{coeffs}`."""
        ds = self._deflated_solver
        (n_, n) = ds.H.shape
        coeffs = (
            self.coeffs if indices is None else self.coeffs[:, list(indices)]
        )
        basis = torch.cat([ds.V[:, :n], ds.projection.U], dim=1)
        return _mm(basis, torch.as_tensor(coeffs, device=basis.device))

    def get_explicit_residual(self, indices=None):
        """Explicit residual :math:`M_l A M_r Z - Z\\,\\text{diag}(\\mu)`."""
        ritz_vecs = self.get_vectors(indices)
        values = self.values if indices is None else self.values[list(indices)]
        values = torch.as_tensor(values, device=ritz_vecs.device)
        return self._deflated_solver.linear_system.MlAMr * ritz_vecs - (
            ritz_vecs * values
        )

    def get_explicit_resnorms(self, indices=None):
        """Explicit residual norms of the Ritz pairs."""
        res = self.get_explicit_residual(indices)
        ls = self._deflated_solver.linear_system
        Mres = ls.M * res
        resnorms = np.zeros(res.shape[1])
        for i in range(resnorms.shape[0]):
            resnorms[i] = float(
                utils.norm(res[:, [i]], Mres[:, [i]], ip_B=ls.ip_B)
            )
        return resnorms
