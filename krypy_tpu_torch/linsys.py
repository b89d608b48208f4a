"""Linear systems and Krylov solvers, the reference-compatible lane
(counterpart of :mod:`krypy_tpu.linsys`).

:class:`LinearSystem` describes the preconditioned system
:math:`M M_l A M_r y = M M_l b`, :math:`x = M_r y`; the solver classes run
the solve on construction and expose ``xk``/``resnorms``/``errnorms``.
The iteration loop, the stopping rule and the updated-vs-explicit
residual policy live once in :class:`_KrylovSolver`; each method
contributes its numerics through four hooks (``_prepare``/``_step``/
``_coefficients``/``_stalled``).  The Hessenberg least-squares
bookkeeping that MINRES and GMRES share is :class:`_GivensQR`, CG's
Lanczos reconstruction :class:`_LanczosTape`.

The lane runs eagerly on tensors, as the JAX package's does on arrays:
each operator application is a launch on the system's device, and the
host reads a scalar exactly where the JAX lane calls ``float`` or numpy
on a device value.  Operators, preconditioners and ``ip_B`` come as
numpy or scipy matrices, tensors, :mod:`~krypy_tpu_torch.core.operators`
objects, or the port's matvec callables with a ``.shape`` (those of
:mod:`krypy_tpu_torch.ops`): a callable becomes a
:class:`~krypy_tpu_torch.core.operators.LinearOperator` that applies it
to each column of an ``(N, k)`` block, in the right-hand side's dtype.

Dtypes follow the JAX lane: a system's dtype promotes its right-hand
side and every operator slot, an omitted slot being a float64 identity,
and the default initial guess is float64 zeros; so for a float32 system
the Krylov vectors stay float32 (the operators compute in their input's
dtype, and float32 launches the float32 kernels) while the iterate, the
explicitly recomputed residual and the small dense matrices on the host
are float64.  The compile-once cores are
:mod:`krypy_tpu_torch.functional`.
"""

import warnings

import numpy as np
import scipy.linalg
import torch

from . import utils
from .arnoldi import host, host_dtype
from .core.dtypes import torch_dtype
from .core.products import _mm
from .errors import ArgumentError, ConvergenceError

__all__ = [
    "LinearSystem",
    "TimedLinearSystem",
    "ConvertedTimedLinearSystem",
    "Cg",
    "Minres",
    "Gmres",
    "RestartedGmres",
]


def system_device(b, device):
    """The device of a system: ``device`` where given, else ``b``'s where
    it is a tensor, else ``"cuda"`` (numpy inputs go to the card, and
    raise where torch sees none)."""
    if device is not None:
        return torch.device(device)
    if isinstance(b, torch.Tensor):
        return b.device
    return torch.device("cuda")


def _is_matvec(op):
    """A matvec callable (``(N,) -> (N,)``), as opposed to the operand
    kinds ``get_linearoperator`` takes itself."""
    return (callable(op) and not isinstance(op, utils.LinearOperator)
            and not hasattr(op, "matvec") and not hasattr(op, "tocoo")
            and not hasattr(op, "ndim"))


def _columns(matvec):
    """The block action of a matvec callable: each column of an ``(N, k)``
    block in turn (one call for a single column), handed over contiguous
    as the kernels take it."""
    def dot(X):
        if X.shape[1] == 1:
            return matvec(X[:, 0].contiguous())[:, None]
        return torch.stack([matvec(X[:, j].contiguous())
                            for j in range(X.shape[1])], dim=1)
    return dot


def get_operator(shape, op, device, dtype, timer=None):
    """``get_linearoperator`` of one slot of a system on ``device``; a
    matvec callable becomes an operator of ``dtype`` (it computes in its
    input's dtype) that applies it column by column."""
    if _is_matvec(op):
        wrapped = utils.LinearOperator(shape, dtype, _columns(op))
        wrapped.device = device
        op = wrapped
    return utils.get_linearoperator(shape, op, timer, device=device)


def _is_operator_ip(ip_B):
    """Whether ``ip_B`` is a matrix or operator ``B`` (coerced to an
    operator), as opposed to a block callable ``ip_B(X, Y)``."""
    return (ip_B is None or isinstance(ip_B, utils.LinearOperator)
            or hasattr(ip_B, "shape"))


class LinearSystem:
    r"""A (preconditioned) linear system

    .. math::
        M M_l A M_r y = M M_l b, \qquad x = M_r y.

    :param A: linear operator on :math:`\mathbb{C}^N` (anything accepted by
      :func:`~krypy_tpu_torch.utils.get_linearoperator`, or a matvec
      callable with ``.shape``).
    :param b: right hand side with ``b.shape in {(N,), (N,1)}``.
    :param M: (optional) self-adjoint positive-definite preconditioner;
      changes the inner product to
      :math:`\langle x, y\rangle_M = \langle M x, y\rangle`.
    :param Minv: (optional) inverse of M; needed for deflation/Ritz.
    :param Ml: (optional) left preconditioner.
    :param Mr: (optional) right preconditioner.
    :param ip_B: (optional) inner product (matrix, operator, or block
      callable ``ip_B(X, Y)``), see :func:`~krypy_tpu_torch.utils.inner`.
    :param normal: is :math:`M_l A M_r` normal w.r.t. ``ip_B``?
    :param self_adjoint: is :math:`M_l A M_r` self-adjoint w.r.t. ``ip_B``?
      (implies ``normal``).
    :param positive_definite: is :math:`M_l A M_r` positive definite?
    :param exact_solution: (optional) known solution for error tracking.
    :param device: where the system lives: ``None`` means ``b``'s device
      where ``b`` is a tensor, else ``"cuda"``.
    """

    #: the operator slots coerced through ``get_linearoperator``
    _OPERATOR_SLOTS = ("A", "M", "Minv", "Ml", "Mr")

    def __init__(
        self,
        A,
        b,
        M=None,
        Minv=None,
        Ml=None,
        Mr=None,
        ip_B=None,
        normal=None,
        self_adjoint=False,
        positive_definite=False,
        exact_solution=None,
        *,
        device=None,
    ):
        self.device = device = system_device(b, device)
        self.N = b.shape[0]
        b_dtype = torch_dtype(b.dtype)

        for name, op in zip(self._OPERATOR_SLOTS, (A, M, Minv, Ml, Mr)):
            setattr(self, name, self._operator(name, op, b_dtype))
        self.MlAMr = self.Ml * self.A * self.Mr
        self.ip_B = (
            ip_B if not _is_operator_ip(ip_B)
            else self._operator("ip_B", ip_B, b_dtype)
        )

        self.flat_vecs, (self.b, self.exact_solution) = utils.shape_vecs(
            b, exact_solution, device=device
        )

        self.self_adjoint = self_adjoint
        if self_adjoint:
            if normal is not None and not normal:
                warnings.warn(
                    "a self-adjoint operator is normal by definition; "
                    "overriding normal=False."
                )
            normal = True
        self.normal = bool(normal) if normal is not None else False
        self.positive_definite = positive_definite
        if self_adjoint and not self.normal:
            raise ArgumentError(
                "inconsistent flags: every self-adjoint operator is normal"
            )

        self.dtype = utils.find_common_dtype(
            self.A, self.b, self.M, self.Ml, self.Mr,
            self.ip_B if isinstance(self.ip_B, utils.LinearOperator) else None,
        )

        # norm of the (preconditioned) right hand side:  ||M Ml b||_{M^{-1}}
        self.Mlb = self.Ml * self.b
        self.MMlb = self.M * self.Mlb
        self.MMlb_norm = utils.norm(self.Mlb, self.MMlb, ip_B=self.ip_B)

    def _operator(self, name, op, dtype):
        return get_operator((self.N, self.N), op, self.device, dtype)

    def get_residual(self, z, compute_norm=False):
        r"""Residual :math:`r = M M_l (b - A z)` (and optionally its
        :math:`M^{-1}`-norm) for an approximate solution ``z``."""
        if z is None:
            if compute_norm:
                return self.MMlb, self.Mlb, self.MMlb_norm
            return self.MMlb, self.Mlb
        Mlr = self.Ml * (self.b - self.A * z)
        MMlr = self.M * Mlr
        if compute_norm:
            return MMlr, Mlr, utils.norm(Mlr, MMlr, ip_B=self.ip_B)
        return MMlr, Mlr

    def get_ip_Minv_B(self):
        r"""The inner product implicitly used with the preconditioner M:
        :math:`\langle x, y\rangle_{M^{-1}} = x^* B M^{-1} y` (the
        Hermitian orientation, as in the JAX package)."""
        if isinstance(self.M, utils.IdentityLinearOperator):
            return self.ip_B
        if isinstance(self.Minv, utils.IdentityLinearOperator):
            raise ArgumentError(
                "the M^{-1}-inner product needs the inverse preconditioner: "
                "pass Minv= alongside M."
            )
        if isinstance(self.ip_B, utils.LinearOperator):
            return self.ip_B * self.Minv
        return lambda x, y: self.ip_B(x, self.Minv * y)

    def __repr__(self):
        parts = ["LinearSystem {"]
        for k in (
            "A", "b", "M", "Minv", "Ml", "Mr", "ip_B",
            "normal", "self_adjoint", "positive_definite", "exact_solution",
        ):
            op = getattr(self, k, None)
            if op is not None and not isinstance(
                op, utils.IdentityLinearOperator
            ):
                parts.append(f"  {k}: {op!r}")
        return "\n".join(parts) + "\n}"


class TimedLinearSystem(LinearSystem):
    """A :class:`LinearSystem` whose operators record application timings
    into a shared :class:`~krypy_tpu_torch.utils.Timings` registry (a
    CUDA application is waited for before its timer stops)."""

    def __init__(
        self,
        A,
        b,
        M=None,
        Minv=None,
        Ml=None,
        Mr=None,
        ip_B=None,
        normal=None,
        self_adjoint=False,
        positive_definite=False,
        exact_solution=None,
        *,
        device=None,
    ):
        self.timings = utils.Timings()

        if not _is_operator_ip(ip_B):
            def _ip_B(X, Y, _ip=ip_B):
                m, n = X.shape[1], Y.shape[1]
                if m == 0 or n == 0:
                    return _ip(X, Y)
                with self.timings["ip_B"]:
                    ret = _ip(X, Y)
                    if isinstance(ret, torch.Tensor) and ret.is_cuda:
                        torch.cuda.synchronize(ret.device)
                self.timings["ip_B"][-1] /= m * n
                return ret
        else:
            _ip_B = ip_B

        super().__init__(
            A=A,
            b=b,
            M=M,
            Minv=Minv,
            Ml=Ml,
            Mr=Mr,
            ip_B=_ip_B,
            normal=normal,
            self_adjoint=self_adjoint,
            positive_definite=positive_definite,
            exact_solution=exact_solution,
            device=device,
        )

    def _operator(self, name, op, dtype):
        return get_operator((self.N, self.N), op, self.device, dtype,
                            timer=self.timings[name])


class ConvertedTimedLinearSystem(TimedLinearSystem):
    """Upgrade an existing :class:`LinearSystem` to a timed one."""

    def __init__(self, linear_system):
        kwargs = {
            k: getattr(linear_system, k)
            for k in (
                "A", "b", "M", "Minv", "Ml", "Mr", "ip_B",
                "normal", "self_adjoint", "positive_definite",
                "exact_solution", "device",
            )
        }
        super().__init__(**kwargs)


class _GivensQR:
    """Incremental QR of an extended Hessenberg matrix by a Givens chain,
    carrying the rotated projected right-hand side along; host numpy.

    Full mode (GMRES): the complete triangular factor is kept for the
    final back-substitution.  Banded mode (MINRES): only the live
    rotations are kept and each rotated column is handed back at once.

    :param beta: norm of the initial residual (first rhs entry).
    :param dtype: numpy dtype of the factor.
    :param ncols: full mode -- maximal number of columns.
    :param window: banded mode -- band width w (2 for a tridiagonal H).
    """

    def __init__(self, beta, dtype, ncols=None, window=None):
        if (ncols is None) == (window is None):
            raise ArgumentError("specify exactly one of ncols / window")
        self._rotations = []
        self._window = window
        self.k = 0
        if window is None:
            self.R = np.zeros((ncols + 1, ncols), dtype=dtype)
            self.y = np.zeros((ncols + 1, 1), dtype=dtype)
            self.y[0, 0] = beta
        else:
            self._tail = beta  # trailing entry of the rotated rhs

    # -- full mode ---------------------------------------------------------
    def push(self, h):
        """Absorb column ``k`` of the extended Hessenberg matrix (its first
        ``k+2`` entries are given in ``h``).

        :return: the residual-norm estimate ``|rotated-rhs tail|``.
        """
        k = self.k
        col = self.R[:, k: k + 1]
        col[: k + 2, 0] = h
        for j, G in enumerate(self._rotations):
            col[j: j + 2] = G.apply(col[j: j + 2])
        G = utils.Givens(col[k: k + 2])
        self._rotations.append(G)
        col[k, 0] = G.r
        col[k + 1, 0] = 0
        self.y[k: k + 2] = G.apply(self.y[k: k + 2])
        self.k += 1
        return abs(self.y[k + 1, 0])

    def coefficients(self):
        """Solve the leading triangular system ``R[:k,:k] z = y[:k]``."""
        k = self.k
        return scipy.linalg.solve_triangular(self.R[:k, :k], self.y[:k])

    # -- banded mode ---------------------------------------------------------
    def absorb_band(self, h):
        """Absorb a column given as its dense band ``h`` of length
        ``window+2`` (row ``k-window`` .. ``k+1`` of column k).

        :return: ``(band, yk, tail)`` -- the rotated band (rows
          ``k-window`` .. ``k``), the freshly finished rhs entry
          :math:`y_k`, and the residual-norm estimate ``|tail|``.
        """
        w = self._window
        band = np.asarray(h, dtype=np.float64).reshape(-1, 1)
        offset = w - len(self._rotations)
        for j, G in enumerate(self._rotations):
            r = j + offset
            band[r: r + 2] = G.apply(band[r: r + 2])
        G = utils.Givens(band[w: w + 2])
        band[w, 0] = G.r
        band[w + 1, 0] = 0
        self._rotations.append(G)
        if len(self._rotations) > w:
            del self._rotations[0]
        rotated = G.apply(np.array([[self._tail], [0.0]]))
        self._tail = rotated[1, 0]
        self.k += 1
        return band[: w + 1, 0], rotated[0, 0], abs(self._tail)


class _LanczosTape:
    """Reconstruct the Lanczos basis/tridiagonal from CG coefficients.

    With step sizes :math:`\\alpha_k` and direction couplings
    :math:`\\beta_k = \\rho_{k+1}/\\rho_k`,

    .. math::
        T_{kk} = 1/\\alpha_k + \\beta_{k-1}/\\alpha_{k-1}, \\qquad
        T_{k+1,k} = \\sqrt{\\beta_k}/\\alpha_k,

    and the k-th Lanczos vector is the k-th (normalized) residual with
    alternating sign.
    """

    def __init__(self, maxiter, dtype, device, with_P):
        self._diag = np.zeros(maxiter)
        self._sub = np.zeros(maxiter)
        self._v = []
        self._p = [] if with_P else None
        self._dtype = dtype
        self._device = device

    def seed(self, Mres, res, norm):
        """Record the normalized initial residual as the first basis
        vector (skipped when the initial residual vanishes)."""
        if float(norm) > 0:
            self._v.append(Mres / norm)
            if self._p is not None:
                self._p.append(res / norm)

    def record(self, k, alpha, alpha_prev, beta_prev, beta, Mres, res, norm):
        """Record one CG step: tridiagonal entries for column ``k`` plus
        the next (sign-alternated) basis vector."""
        self._diag[k] = 1.0 / alpha
        if k > 0:
            self._diag[k] += beta_prev / alpha_prev
        self._sub[k] = np.sqrt(beta) / alpha
        flip = -1.0 if k % 2 == 0 else 1.0
        self._v.append(flip * Mres / norm)
        if self._p is not None:
            self._p.append(flip * res / norm)

    def export(self, niter, N):
        """Return ``(V, H[, P])`` for ``niter`` completed steps; the basis
        is zero-padded to ``niter+1`` columns if seeding was skipped."""
        H = np.zeros((niter + 1, niter))
        idx = np.arange(niter)
        H[idx, idx] = self._diag[:niter]
        H[idx + 1, idx] = self._sub[:niter]
        if niter > 1:
            H[idx[:-1], idx[1:]] = self._sub[: niter - 1]

        def assemble(cols):
            cols = list(cols[: niter + 1])
            while len(cols) < niter + 1:
                cols.append(torch.zeros((N, 1), dtype=self._dtype,
                                        device=self._device))
            return torch.cat(cols, dim=1)

        V = assemble(self._v)
        P = assemble(self._p) if self._p is not None else None
        return V, H, P


class _KrylovSolver:
    """Common lifecycle of all Krylov solvers: argument handling, initial
    residual, the iteration driver, and the per-iteration residual policy
    (updated vs. explicit).

    The solve runs in the constructor.  Attributes on completion:

    * ``xk`` -- approximate solution, a ``(N, 1)`` tensor on the system's
      device,
    * ``resnorms`` -- relative residual norms per iteration (floats),
    * ``errnorms`` -- error norms (if ``exact_solution`` given),
    * ``V``, ``H`` (, ``P``) -- Krylov data (if ``store_arnoldi=True``;
      ``H`` on the host).

    Subclasses implement the numerics through four hooks: ``_prepare``
    (allocate iteration state), ``_step`` (one iteration; returns the
    updated-residual estimate), ``_coefficients`` (whatever ``_get_xk``
    consumes to form the current iterate), and optionally ``_stalled``
    (extra halting condition, e.g. an invariant Krylov subspace).
    """

    def __init__(
        self,
        linear_system,
        x0=None,
        tol=1e-5,
        maxiter=None,
        explicit_residual=False,
        store_arnoldi=False,
        dtype=None,
    ):
        if not isinstance(linear_system, LinearSystem):
            raise ArgumentError(
                f"expected a LinearSystem, got {type(linear_system)!r}"
            )
        self.linear_system = linear_system
        N = linear_system.N
        dev = linear_system.device
        self.maxiter = N if maxiter is None else maxiter
        self.flat_vecs, (self.x0,) = utils.shape_vecs(x0, device=dev)
        self.explicit_residual = explicit_residual
        self.store_arnoldi = store_arnoldi
        self.tol = tol
        self.xk = None
        self.iter = 0
        self.resnorms = []

        # initial guess and residual go through overridable hooks so that
        # deflation can project them (krypy_tpu_torch/deflation.py)
        self.x0 = self._get_initial_guess(self.x0)
        self.MMlr0, self.Mlr0, self.MMlr0_norm = self._get_initial_residual(
            self.x0
        )
        if self.x0 is None:
            self.x0 = torch.zeros((N, 1), dtype=torch.float64, device=dev)

        self.dtype = torch.promote_types(
            utils.find_common_dtype(self.x0, dtype),
            linear_system.dtype,
        )
        self._hdtype = host_dtype(self.dtype)

        # the operator the iteration actually runs on; deflation wraps it
        self.MlAMr = linear_system.MlAMr

        rhs_norm = float(self.linear_system.MMlb_norm)
        if rhs_norm == 0:
            # the right hand side vanishes: the solution is x = 0
            self.xk = self.x0 = torch.zeros((N, 1), dtype=torch.float64,
                                            device=dev)
            self.resnorms.append(0.0)
        else:
            self.resnorms.append(float(self.MMlr0_norm) / rhs_norm)

        if self.linear_system.exact_solution is not None:
            self.errnorms = [self._errnorm(self._get_xk(None))]

        self._solve()
        self._finalize()

    # -- hooks (overridden by deflation) ---------------------------------
    def _get_initial_guess(self, x0):
        return x0

    def _get_initial_residual(self, x0):
        return self.linear_system.get_residual(x0, compute_norm=True)

    def _get_xk(self, yk):
        if yk is not None:
            return self.x0 + self.linear_system.Mr * yk
        return self.x0

    # -- numerics hooks (implemented by each method) ----------------------
    def _prepare(self):
        raise NotImplementedError(
            "_prepare has to be implemented by the solver class."
        )

    def _step(self):
        raise NotImplementedError(
            "_step has to be implemented by the solver class."
        )

    def _coefficients(self):
        raise NotImplementedError(
            "_coefficients has to be implemented by the solver class."
        )

    def _stalled(self):
        """Extra halting condition checked before each step."""
        return False

    def _post_register(self, rkn):
        """Called after residual bookkeeping with the explicit residual
        norm (or None); CG re-seats its rho history here."""

    # -- the iteration driver ---------------------------------------------
    def _solve(self):
        """Run the method: prepare state, iterate until the stopping rule
        fires, then form the final iterate."""
        self._prepare()
        while (
            self.resnorms[-1] > self.tol
            and self.iter < self.maxiter
            and not self._stalled()
        ):
            estimate = self._step()
            rkn = self._register(estimate)
            self._post_register(rkn)
            self.iter += 1
        if self.xk is None:
            self.xk = self._get_xk(self._coefficients())

    def _errnorm(self, xk):
        ls = self.linear_system
        return float(utils.norm(ls.exact_solution - xk, ip_B=ls.ip_B))

    def _register(self, estimate):
        """Residual bookkeeping for the iterate just produced.

        The cheap updated-residual estimate drives the iteration; the true
        residual is recomputed from the iterate whenever the user asked
        for it (``explicit_residual``), the estimate signals convergence,
        or the iteration budget is exhausted.  A discrepancy between the
        two at the convergence check is surfaced as a warning; running out
        of iterations raises :class:`ConvergenceError` carrying ``self``.

        :return: the explicit residual norm if it was computed, else None.
        """
        self.xk = None
        ls = self.linear_system

        if ls.exact_solution is not None:
            self.xk = self._get_xk(self._coefficients())
            self.errnorms.append(self._errnorm(self.xk))

        rhs_norm = float(ls.MMlb_norm)
        estimate = float(estimate)
        updated_rel = estimate / rhs_norm
        budget_spent = self.iter + 1 == self.maxiter

        if not (
            self.explicit_residual or updated_rel <= self.tol or budget_spent
        ):
            self.resnorms.append(updated_rel)
            return None

        # recompute the true residual from the iterate
        if self.xk is None:
            self.xk = self._get_xk(self._coefficients())
        _, _, rkn = ls.get_residual(self.xk, compute_norm=True)
        rkn = float(rkn)
        explicit_rel = rkn / rhs_norm
        self.resnorms.append(explicit_rel)

        if explicit_rel > self.tol:
            if budget_spent:
                self._finalize()
                raise ConvergenceError(
                    f"iteration budget exhausted (maxiter={self.maxiter}) "
                    f"at relative residual {explicit_rel}.",
                    self,
                )
            if not self.explicit_residual and updated_rel <= self.tol:
                warnings.warn(
                    "the updated residual estimate reached the tolerance "
                    "but the explicitly recomputed residual did not "
                    f"(estimate {estimate}, tol {self.tol}, explicit "
                    f"{explicit_rel}); continuing."
                )
        return rkn

    def _finalize(self):
        pass

    @staticmethod
    def operations(nsteps):
        """Analytic operation-count model for ``nsteps`` iterations; keys
        match the :class:`~krypy_tpu_torch.utils.Timings` registry."""
        raise NotImplementedError(
            "each solver class supplies its own operations() model."
        )


def _solver_repr(solver, name):
    """Compact state dump."""
    lines = [f"krypy_tpu {name} object"]
    lines.append(f"    tol: {solver.tol}")
    lines.append(f"    maxiter: {solver.maxiter}")
    lines.append(f"    iter: {solver.iter}")
    lines.append(f"    explicit residual: {solver.explicit_residual}")
    lines.append(f"    store_arnoldi: {solver.store_arnoldi}")
    if solver.resnorms:
        lines.append(
            f"    resnorms: [{solver.resnorms[0]}, ..., "
            f"{solver.resnorms[-1]}]"
        )
    if solver.xk is not None:
        xk = host(solver.xk)
        lines.append(f"    xk: [{xk[0]}, ..., {xk[-1]}]")
    return "\n".join(lines)


class Cg(_KrylovSolver):
    r"""Preconditioned conjugate gradient method.

    Requires :math:`M_l A M_r` self-adjoint and positive definite w.r.t.
    ``ip_B``; minimizes the :math:`A`-norm of the error over
    :math:`x_0 + M_r K_k(M M_l A M_r, r_0)` via the coupled two-term
    recurrence.  Memory: 3 vectors (6 with M).
    """

    def __init__(self, linear_system, **kwargs):
        if (
            not linear_system.self_adjoint
            or not linear_system.positive_definite
        ):
            warnings.warn(
                "CG expects a self-adjoint positive-definite system; "
                "this one is not flagged as such. MINRES or GMRES may be "
                "the better fit."
            )
        super().__init__(linear_system, **kwargs)

    def __repr__(self):
        return _solver_repr(self, "CG")

    def _prepare(self):
        ls = self.linear_system
        self._yk = torch.zeros((ls.N, 1), dtype=self.dtype, device=ls.device)
        #: squared residual M^{-1}-norms; DeflatedCg reads this history to
        #: reconstruct Gram columns without extra inner products
        self.rhos = [float(self.MMlr0_norm) ** 2]
        self._resid = self.Mlr0      # Ml r
        self._Mresid = self.MMlr0    # M Ml r
        self._direction = self.MMlr0
        self._alpha = None           # step size of the latest iteration
        self._alpha_prev = None
        self._tape = None
        if self.store_arnoldi:
            self._tape = _LanczosTape(
                self.maxiter,
                self.dtype,
                ls.device,
                with_P=not isinstance(ls.M, utils.IdentityLinearOperator),
            )
            self._tape.seed(self.MMlr0, self.Mlr0, self.MMlr0_norm)

    def _coefficients(self):
        return self._yk

    def _step(self):
        ls = self.linear_system
        k = self.iter
        beta_prev = self.rhos[-1] / self.rhos[-2] if k > 0 else 0.0
        if k > 0:
            self._direction = self._Mresid + beta_prev * self._direction
        p = self._direction
        Ap = self.MlAMr * p

        alpha = self.rhos[-1] / complex(
            utils.inner(p, Ap, ip_B=ls.ip_B)[0, 0].item()
        )
        if abs(alpha.imag) > 1e-12:
            warnings.warn(
                f"CG step {k} produced a step size with imaginary part "
                f"{abs(alpha.imag)} (> 1e-12); the operator is likely not "
                "self-adjoint in the chosen inner product."
            )
        alpha = alpha.real

        self._yk = self._yk + alpha * p
        self._resid = self._resid - alpha * Ap
        self._Mresid = ls.M * self._resid
        resid_norm = utils.norm(self._resid, self._Mresid, ip_B=ls.ip_B)
        self.rhos.append(float(resid_norm) ** 2)

        if self._tape is not None:
            self._tape.record(
                k, alpha, self._alpha_prev,
                self.rhos[-2] / self.rhos[-3] if k > 0 else 0.0,
                self.rhos[-1] / self.rhos[-2],
                self._Mresid, self._resid, resid_norm,
            )
        self._alpha_prev = alpha
        self._alpha = alpha
        return resid_norm

    def _post_register(self, rkn):
        # keep the rho recurrence consistent with the explicitly
        # recomputed residual when one was taken
        if rkn is not None:
            self.rhos[-1] = rkn ** 2

    def _finalize(self):
        super()._finalize()
        if self.store_arnoldi and self._tape is not None:
            V, H, P = self._tape.export(self.iter, self.linear_system.N)
            self.V, self.H = V, H
            if P is not None:
                self.P = P

    @staticmethod
    def operations(nsteps):
        return {
            "A": 1 + nsteps,
            "M": 2 + nsteps,
            "Ml": 2 + nsteps,
            "Mr": 1 + nsteps,
            "ip_B": 2 + 2 * nsteps,
            "axpy": 2 + 2 * nsteps,
        }


class Minres(_KrylovSolver):
    r"""Preconditioned MINRES method.

    Requires :math:`M_l A M_r` self-adjoint w.r.t. ``ip_B``; minimizes the
    preconditioned residual norm via the Lanczos recurrence, the banded
    Givens QR of :class:`_GivensQR`, and a three-column solution
    recurrence.  Memory: 3 vectors (6 with M).
    """

    def __init__(self, linear_system, ortho="lanczos", **kwargs):
        if not linear_system.self_adjoint:
            warnings.warn(
                "MINRES expects a self-adjoint system; this one is not "
                "flagged as such. GMRES may be the better fit."
            )
        self.ortho = ortho
        super().__init__(linear_system, **kwargs)

    def __repr__(self):
        return _solver_repr(self, "MINRES")

    def _prepare(self):
        ls = self.linear_system
        self.lanczos = utils.Arnoldi(
            self.MlAMr,
            self.Mlr0,
            maxiter=self.maxiter,
            ortho=self.ortho,
            M=ls.M,
            Mv=self.MMlr0,
            Mv_norm=self.MMlr0_norm,
            ip_B=ls.ip_B,
        )
        self._qr = _GivensQR(
            float(self.MMlr0_norm), dtype=np.float64, window=2
        )
        zero = torch.zeros((ls.N, 1), dtype=self.dtype, device=ls.device)
        self._wcols = (zero, zero)  # last two solution-recurrence columns
        self._yk = zero

    def _coefficients(self):
        return self._yk

    def _stalled(self):
        return self.lanczos.invariant

    def _step(self):
        k = self.iter
        self.lanczos.advance()
        T = self.lanczos.H
        band, yk_entry, tail = self._qr.absorb_band(
            [
                0.0,
                np.real(T[k - 1, k]) if k > 0 else 0.0,
                np.real(T[k, k]),
                np.real(T[k + 1, k]),
            ]
        )
        # three-term solution recurrence
        w_old, w = self._wcols
        z = (self.lanczos.basis_vector(k) - float(band[0]) * w_old
             - float(band[1]) * w) / float(band[2])
        self._wcols = (w, z)
        self._yk = self._yk + float(yk_entry) * z
        return tail

    def _finalize(self):
        super()._finalize()
        if self.store_arnoldi:
            data = self.lanczos.get()
            if isinstance(self.linear_system.M, utils.IdentityLinearOperator):
                self.V, self.H = data
            else:
                self.V, self.H, self.P = data

    @staticmethod
    def operations(nsteps):
        return {
            "A": 1 + nsteps,
            "M": 2 + nsteps,
            "Ml": 2 + nsteps,
            "Mr": 1 + nsteps,
            "ip_B": 2 + 2 * nsteps,
            "axpy": 4 + 8 * nsteps,
        }


class Gmres(_KrylovSolver):
    r"""Preconditioned GMRES method.

    Full Arnoldi (``ortho='mgs'`` default) with the growing Givens QR of
    :class:`_GivensQR`; the solution is reconstructed on demand by a host
    triangular solve followed by one product with the Krylov basis on the
    device.  Memory: maxiter+1 vectors (2x with M).
    """

    def __init__(self, linear_system, ortho="mgs", **kwargs):
        self.ortho = ortho
        super().__init__(linear_system, **kwargs)

    def __repr__(self):
        return _solver_repr(self, "GMRES")

    @property
    def R(self):
        """Triangular factor of the Hessenberg QR (host buffer)."""
        return self._qr.R

    def _get_xk(self, y):
        if y is None or self._qr.k == 0:
            return self.x0
        k = self._qr.k
        coeffs = torch.as_tensor(self._qr.coefficients(),
                                 device=self.linear_system.device)
        yk = _mm(self.arnoldi.V[:, :k], coeffs)
        return self.x0 + self.linear_system.Mr * yk

    def _prepare(self):
        ls = self.linear_system
        self.arnoldi = utils.Arnoldi(
            self.MlAMr,
            self.Mlr0,
            maxiter=self.maxiter,
            ortho=self.ortho,
            M=ls.M,
            Mv=self.MMlr0,
            Mv_norm=self.MMlr0_norm,
            ip_B=ls.ip_B,
        )
        self._qr = _GivensQR(
            float(self.MMlr0_norm), dtype=self._hdtype, ncols=self.maxiter
        )

    def _coefficients(self):
        return self._qr.y[: self._qr.k]

    def _stalled(self):
        return self.arnoldi.invariant

    def _step(self):
        k = self.iter
        self.arnoldi.advance()
        return self._qr.push(self.arnoldi.H[: k + 2, k])

    def _finalize(self):
        super()._finalize()
        if self.store_arnoldi:
            data = self.arnoldi.get()
            if isinstance(self.linear_system.M, utils.IdentityLinearOperator):
                self.V, self.H = data
            else:
                self.V, self.H, self.P = data

    @staticmethod
    def operations(nsteps):
        return {
            "A": 1 + nsteps,
            "M": 2 + nsteps,
            "Ml": 2 + nsteps,
            "Mr": 1 + nsteps,
            "ip_B": 2 + nsteps + nsteps * (nsteps + 1) / 2,
            "axpy": 4 + 2 * nsteps + nsteps * (nsteps + 1) / 2,
        }


class _RestartedSolver:
    """Outer restart loop around an inner solver: re-launch with the last
    iterate as initial guess, harvesting the partial solver carried by
    :class:`ConvergenceError` when the inner budget runs out."""

    def __init__(self, Solver, linear_system, max_restarts=0, **kwargs):
        self.xk = None
        track_errors = linear_system.exact_solution is not None
        # histories start with a sentinel that each cycle's first entry
        # replaces, so concatenation never duplicates a point
        self.resnorms = [np.inf]
        if track_errors:
            self.errnorms = [np.inf]
        tol = None
        cycle_kwargs = dict(kwargs)

        for cycle in range(max_restarts + 1):
            if self.xk is not None:
                cycle_kwargs["x0"] = self.xk
            try:
                inner = Solver(linear_system, **cycle_kwargs)
            except ConvergenceError as exc:
                inner = exc.solver

            self.xk = inner.xk
            tol = inner.tol
            self.resnorms[-1:] = inner.resnorms
            if track_errors:
                self.errnorms[-1:] = inner.errnorms

            if self.resnorms[-1] <= tol:
                break

        if self.resnorms[-1] > tol:
            raise ConvergenceError(
                f"restart budget exhausted ({max_restarts} restarts) at "
                f"relative residual {self.resnorms[-1]}.",
                self,
            )


class RestartedGmres(_RestartedSolver):
    """Restarted GMRES."""

    def __init__(self, *args, **kwargs):
        super().__init__(Gmres, *args, **kwargs)
