r"""Deflated Krylov solvers and Ritz extraction (counterpart of
:mod:`krypy_tpu.deflation`).

Deflation augments a Krylov solver with a subspace U: the solver runs on
the projected operator :math:`P\,M_l A M_r` where P is the oblique
projection along :math:`M_l A M_r U`, and each iterate is corrected by
re-solving the U-component of the residual.

Device/host split: the projection and all N-dimensional work (QR of U,
operator applications, iterate correction) run on the system's device;
the small Gram-matrix machinery (E, C, B_) is read to the host where
:class:`Ritz` assembles its (n+d)-dimensional eigenproblems for host
LAPACK.

Not ported yet: ``Arnoldifyer`` and ``bound_pseudo``, which need
``pseudospectra`` (ROADMAP.md queue A, A9); their names raise
``NotImplementedError``.
"""

import numpy as np
import scipy.linalg
import torch

from . import linsys, utils
from .arnoldi import host
from .core.dtypes import asarray
from .core.products import _mm
from .core.projections import _solve_upper
from .errors import ArgumentError

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


class Arnoldifyer:
    """Not ported yet: it predicts candidate relations for ``bound_pseudo``,
    which needs ``pseudospectra`` (ROADMAP.md queue A, A9)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "deflation.Arnoldifyer is not ported yet (ROADMAP.md queue A, "
            "A9: it comes with bound_pseudo and pseudospectra)")


def bound_pseudo(*args, **kwargs):
    """Not ported yet: it needs ``pseudospectra`` (ROADMAP.md queue A,
    A9)."""
    raise NotImplementedError(
        "deflation.bound_pseudo is not ported yet (ROADMAP.md queue A, A9: "
        "it needs pseudospectra)")


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
