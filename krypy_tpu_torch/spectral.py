"""Spectral analysis tools: Ritz extraction, principal angles, a-priori
convergence bounds, interval algebra, residual polynomials (counterpart
of :mod:`krypy_tpu.spectral`).

Device/host split, as in the JAX package: what works on N-dimensional
data (``angles``, ``hegedus``) runs in torch on the operands' device.
The small dense eigenproblems of ``ritz`` (k x k, k the Krylov
dimension) are decision data: the Hermitian standard problem is
``torch.linalg.eigh`` on the matrix's device, and the non-Hermitian and
generalized problems run on the host (numpy / scipy LAPACK), as in the
JAX package.  The gap, interval, bound and polynomial tools are host
numpy, the same code as the JAX package's.
"""

import warnings

import numpy as np
import scipy.linalg
import torch

from .errors import ArgumentError, AssumptionError
from .core.dtypes import asarray
from .core.operators import get_linearoperator
from .core.products import inner
from .core.rotations import Givens
from .core.qr import qr

__all__ = [
    "angles",
    "hegedus",
    "ritz",
    "gap",
    "Interval",
    "Intervals",
    "BoundCG",
    "BoundMinres",
    "bound_perturbed_gmres",
    "NormalizedRootsPolynomial",
    "get_residual_norms",
    "strakos",
]


def _mm(X, Y):
    dt = torch.promote_types(X.dtype, Y.dtype)
    return X.to(dt) @ Y.to(dt)


def _host(t):
    return t.detach().cpu().resolve_conj().resolve_neg().numpy()


# ---------------------------------------------------------------------------
# principal angles
# ---------------------------------------------------------------------------
def angles(F, G, ip_B=None, compute_vectors=False):
    r"""Principal angles between ``colspan(F)`` and ``colspan(G)`` in the
    inner product ``ip_B``.

    Small-angle-stable algorithm 6.2 of Knyazev & Argentati, "Principal
    angles between subspaces in an A-based scalar product" (2002): cosines
    from an SVD of :math:`\langle Q_F, Q_G\rangle`, sines from an SVD of
    the orthogonal complement part.

    :return: ``theta`` sorted ascending in :math:`[0, \pi/2]` with shape
      ``(max(k, l),)``; with ``compute_vectors=True`` also the principal
      vectors U, V.
    """
    F = asarray(F)
    G = asarray(G, device=F.device)
    reverse = False
    if F.shape[1] < G.shape[1]:
        reverse = True
        F, G = G, F

    QF, _ = qr(F, ip_B=ip_B)
    QG, _ = qr(G, ip_B=ip_B)
    real = torch.empty(0, dtype=torch.promote_types(F.dtype, G.dtype)).real
    half_pi = torch.full((F.shape[1] - G.shape[1],), np.pi / 2,
                         dtype=real.dtype, device=F.device)

    if G.shape[1] == 0:
        theta = half_pi
        U, V = QF, QG
    else:
        Y, s, Zh = torch.linalg.svd(inner(QF, QG, ip_B=ip_B))
        Vcos = _mm(QG, Zh.conj().T)
        n_large = int(torch.count_nonzero(s**2 < 0.5))
        n_small = s.shape[0] - n_large
        theta = torch.cat(
            [torch.arccos(torch.clamp(s[n_small:], -1.0, 1.0)), half_pi])
        U = V = None
        if compute_vectors:
            Ucos = _mm(QF, Y)
            U = Ucos[:, n_small:]
            V = Vcos[:, n_small:]
        if n_small > 0:
            # sine-based path for the small angles
            RG = Vcos[:, :n_small]
            S = RG - _mm(QF, inner(QF, RG, ip_B=ip_B))
            _, R = qr(S, ip_B=ip_B)
            Y2, u, Z2h = torch.linalg.svd(R)
            theta = torch.cat(
                [torch.arcsin(torch.clamp(torch.flip(u, [0])[:n_small],
                                          -1.0, 1.0)), theta])
            if compute_vectors:
                RF = Ucos[:, :n_small]
                Vsin = _mm(RG, Z2h.conj().T)
                Usin = _mm(RF, _mm(torch.diag(1.0 / s[:n_small]),
                                   _mm(Z2h.conj().T, torch.diag(s[:n_small]))))
                U = torch.cat([Usin, U], 1)
                V = torch.cat([Vsin, V], 1)

    if compute_vectors:
        if reverse:
            U, V = V, U
        return theta, U, V
    return theta


# ---------------------------------------------------------------------------
# Hegedüs trick
# ---------------------------------------------------------------------------
def hegedus(A, b, x0, M=None, Ml=None, ip_B=None):
    r"""Rescale the initial guess to :math:`\gamma_{\min} x_0` so that the
    initial residual norm never exceeds :math:`\|M M_l b\|_{M^{-1}}`."""
    b = asarray(b)
    x0 = asarray(x0, device=b.device)
    N = b.shape[0]
    shape = (N, N)
    A = get_linearoperator(shape, A, device=b.device)
    M = get_linearoperator(shape, M, device=b.device)
    Ml = get_linearoperator(shape, Ml, device=b.device)

    MlAx0 = Ml * (A * x0)
    z = M * MlAx0
    znorm2 = inner(z, MlAx0, ip_B=ip_B)
    if float(znorm2[0, 0].abs()) <= 1e-15:
        return torch.zeros((N, 1), dtype=torch.float64, device=b.device)
    gamma = inner(z, Ml * b, ip_B=ip_B) / znorm2
    return gamma * x0


# ---------------------------------------------------------------------------
# Ritz pairs from a (pure Krylov) Hessenberg matrix
# ---------------------------------------------------------------------------
def ritz(H, V=None, hermitian=False, type="ritz"):
    r"""Ritz, harmonic Ritz, or improved harmonic Ritz pairs from an
    Arnoldi/Lanczos relation.

    :param H: Hessenberg matrix, shape ``(n+1, n)`` or ``(n, n)``.
    :param V: (optional) Arnoldi basis ``(N, n+1)``; if given, Ritz vectors
      ``Z = V[:, :n] @ U`` are returned as well.
    :param hermitian: use the symmetric path (``eigh``).
    :param type: ``'ritz'`` (X=Y=K_n), ``'harmonic'`` (Y=A K_n), or
      ``'harmonic_improved'`` (harmonic vectors with Rayleigh-quotient
      values).
    :return: ``theta, U, resnorm[, Z]``, tensors on ``H``'s device.
    """
    H = asarray(H)
    dev = H.device
    n = H.shape[1]
    if V is not None and V.shape[1] != H.shape[0]:
        raise ArgumentError("shape mismatch with V and H")
    if H.shape[0] not in (n, n + 1):
        raise ArgumentError("H not of shape (n+1,n) or (n,n)")
    symmres = torch.linalg.norm(H[:n, :] - H[:n, :].conj().T)
    if hermitian and float(symmres) >= 5e-14:
        warnings.warn(
            f"Hessenberg matrix is not symmetric: |H-H^*|={symmres}"
        )

    def eig(A):
        if hermitian:
            return torch.linalg.eigh(A)
        theta, U = np.linalg.eig(_host(A))
        return torch.as_tensor(theta, device=dev), torch.as_tensor(U,
                                                                   device=dev)

    def eig_gen(A, B):
        if hermitian:
            theta, U = scipy.linalg.eigh(_host(A), _host(B))
        else:
            theta, U = scipy.linalg.eig(_host(A), _host(B))
        return torch.as_tensor(theta, device=dev), torch.as_tensor(U,
                                                                   device=dev)

    if type == "ritz":
        theta, U = eig(H[:n, :])
        beta = 0 if H.shape[0] == n else H[-1, -1]
        resnorm = (beta * U[-1, :]).abs()
    elif type in ("harmonic", "harmonic_improved"):
        theta, U = eig_gen(H[:n, :].conj().T, H.conj().T @ H)
        # normalize the eigenvector columns
        U = U / torch.linalg.vector_norm(U, dim=0, keepdim=True)
        if type == "harmonic":
            theta = 1.0 / theta
        else:
            # improved harmonic Ritz values: Rayleigh quotients (Morgan&Zeng)
            dt = torch.promote_types(U.dtype, H.dtype)
            theta = torch.einsum("ji,jk,ki->i", U.conj().to(dt),
                                 H[:n, :].to(dt), U.to(dt))
        dt = torch.promote_types(torch.promote_types(H.dtype, U.dtype),
                                 theta.dtype)
        res = H.to(dt) @ U.to(dt)
        res[:n, :] -= theta[None, :].to(dt) * U.to(dt)
        resnorm = torch.linalg.vector_norm(res, dim=0)
    else:
        raise ArgumentError(f"unknown Ritz type {type}")

    if V is not None:
        V = asarray(V, device=dev)
        return theta, U, resnorm, _mm(V[:, :n], U)
    return theta, U, resnorm


# ---------------------------------------------------------------------------
# spectral gap and interval algebra
# ---------------------------------------------------------------------------
def gap(lamda, sigma, mode="individual"):
    r"""Spectral gap :math:`\delta \ge 0` between two real sets
    (reference: krypy/utils.py:1651-1708).

    * ``'individual'``: :math:`\min_{i,j}|\lambda_i - \sigma_j|`.
    * ``'interval'``: maximal :math:`\delta` with
      :math:`\Sigma \cap [\min\Lambda - \delta, \max\Lambda + \delta] =
      \emptyset`; ``None`` if no such :math:`\delta` exists.
    """
    lamda = np.atleast_1d(np.asarray(lamda))
    sigma = np.atleast_1d(np.asarray(sigma))
    if not np.isreal(lamda).all() or not np.isreal(sigma).all():
        raise ArgumentError("complex spectra not yet implemented")
    lamda = np.real(lamda)
    sigma = np.real(sigma)

    if mode == "individual":
        return np.min(np.abs(lamda[:, None] - sigma[None, :]))
    if mode == "interval":
        lamda_min, lamda_max = np.min(lamda), np.max(lamda)
        sigma_lo = sigma <= lamda_min
        sigma_hi = sigma >= lamda_max
        if not np.all(sigma_lo | sigma_hi):
            return None
        delta = np.inf
        if np.any(sigma_lo):
            delta = lamda_min - np.max(sigma[sigma_lo])
        if np.any(sigma_hi):
            delta = min(delta, np.min(sigma[sigma_hi]) - lamda_max)
        return delta
    raise ArgumentError(f"unknown mode {mode}")


class Interval:
    """A closed real interval (possibly a point).

    Semantics match krypy/utils.py:1711-1749; a lightweight immutable
    value object here -- the set algebra lives in :class:`Intervals`'
    endpoint-array representation, not in pairwise object merging.
    """

    __slots__ = ("left", "right")

    def __init__(self, left, right=None):
        right = left if right is None else right
        if left > right:
            raise ArgumentError(
                f"interval endpoints must satisfy left <= right "
                f"(got [{left}, {right}])"
            )
        object.__setattr__(self, "left", left)
        object.__setattr__(self, "right", right)

    def __setattr__(self, *_):
        raise AttributeError("Interval is immutable")

    def __and__(self, other):
        lo, hi = max(self.left, other.left), min(self.right, other.right)
        return Interval(lo, hi) if lo <= hi else None

    def __or__(self, other):
        if (self & other) is None:
            return None
        return Interval(
            min(self.left, other.left), max(self.right, other.right)
        )

    def __repr__(self):
        return f"[{self.left},{self.right}]"

    def contains(self, alpha):
        return self.left <= alpha <= self.right

    def distance(self, other):
        """0 if the intervals intersect, else the gap between them."""
        return max(
            0, other.left - self.right, self.left - other.right
        )


class Intervals:
    """A union of closed real intervals, stored as ONE sorted ``(m, 2)``
    endpoint array of pairwise disjoint components.

    Query semantics match krypy/utils.py:1752-1844; the representation
    and algorithms differ by design: components are
    maintained by a vectorized sort-scan-merge over the endpoint array
    (a row opens a new component exactly when its left endpoint exceeds
    the running maximum of right endpoints), and every query is an
    array scan -- no per-object set algebra.
    """

    def __init__(self, intervals=None):
        raw = np.asarray(
            [(iv.left, iv.right) for iv in (intervals or [])], float
        ).reshape(-1, 2)
        self._bounds = self._coalesce(raw)

    @staticmethod
    def _coalesce(raw):
        """Disjoint components of a union of [l, r] rows (vectorized)."""
        if raw.shape[0] == 0:
            return raw
        raw = raw[np.argsort(raw[:, 0], kind="stable")]
        running_right = np.maximum.accumulate(raw[:, 1])
        opens = np.empty(raw.shape[0], bool)
        opens[0] = True
        # strict inequality: touching CLOSED intervals intersect
        opens[1:] = raw[1:, 0] > running_right[:-1]
        starts = np.flatnonzero(opens)
        return np.column_stack(
            [raw[opens, 0], np.maximum.reduceat(raw[:, 1], starts)]
        )

    @property
    def bounds(self):
        """The ``(m, 2)`` sorted disjoint endpoint array (read-only)."""
        return self._bounds

    def add(self, new):
        self._bounds = self._coalesce(
            np.vstack([self._bounds, [[new.left, new.right]]])
        )

    def contains(self, alpha):
        b = self._bounds
        return bool(np.any((b[:, 0] <= alpha) & (alpha <= b[:, 1])))

    def get_endpoints(self):
        """Sorted endpoints; point components contribute one value."""
        out = []
        for lo, hi in self._bounds:
            out.append(lo)
            if hi != lo:
                out.append(hi)
        return out

    def __len__(self):
        return self._bounds.shape[0]

    def __iter__(self):
        return (Interval(lo, hi) for lo, hi in self._bounds)

    def __repr__(self):
        return ", ".join(repr(iv) for iv in self)

    def _require_nonempty(self, what):
        if self._bounds.shape[0] == 0:
            raise ArgumentError(f"{what}() of an empty interval set")

    def min(self):
        self._require_nonempty("min")
        return self._bounds[0, 0]

    def max(self):
        self._require_nonempty("max")
        return self._bounds[-1, 1]

    def min_pos(self):
        """Minimal positive value, or None (also None if 0 is covered)."""
        self._require_nonempty("min_pos")
        if self.contains(0):
            return None
        lefts = self._bounds[:, 0]
        pos = lefts[lefts > 0]
        return pos[0] if pos.size else None

    def max_neg(self):
        """Maximal negative value, or None (also None if 0 is covered)."""
        self._require_nonempty("max_neg")
        if self.contains(0):
            return None
        rights = self._bounds[:, 1]
        neg = rights[rights < 0]
        return neg[-1] if neg.size else None

    def min_abs(self):
        self._require_nonempty("min_abs")
        if self.contains(0):
            return 0
        return min(
            abs(v)
            for v in (self.max_neg(), self.min_pos())
            if v is not None
        )

    def max_abs(self):
        self._require_nonempty("max_abs")
        return max(abs(self.min()), abs(self.max()))


# ---------------------------------------------------------------------------
# a-priori convergence bounds
# ---------------------------------------------------------------------------
class BoundCG:
    r"""CG :math:`\kappa`-bound
    :math:`\eta_n = 2\left(\frac{\sqrt{\kappa_{\rm eff}}-1}
    {\sqrt{\kappa_{\rm eff}}+1}\right)^n` for the A-norm of the error
    (reference: krypy/utils.py:1847-1916)."""

    def __init__(self, evals, exclude_zeros=False):
        if isinstance(evals, Intervals):
            if evals.min() <= 0:
                raise AssumptionError(
                    "non-positive eigenvalues not allowed with intervals"
                )
            evals = [evals.min(), evals.max()]

        if len(evals) == 0:
            raise AssumptionError("empty spectrum not allowed")
        evals = np.asarray(evals)
        if not np.isreal(evals).all():
            raise AssumptionError("non-real eigenvalues not allowed")
        evals = np.sort(np.real(evals).astype(np.float64))
        evals = evals / evals[-1]

        if exclude_zeros is False and not (evals > 1e-15).all():
            raise AssumptionError(
                "non-positive eigenvalues not allowed (use exclude_zeros?)"
            )
        kappa = 1.0 / np.min(evals[evals > 1e-15])
        self.base = (np.sqrt(kappa) - 1) / (np.sqrt(kappa) + 1)

    def eval_step(self, step):
        """Evaluate the bound after ``step`` iterations."""
        return 2 * self.base**step

    def get_step(self, tol):
        """Step count at which the bound falls below ``tol``."""
        return np.log(tol / 2.0) / np.log(self.base)


class BoundMinres:
    r"""MINRES residual bound for indefinite spectra
    :math:`\eta_n = 2\left(\frac{a - b}{a + b}\right)^{[n/2]}` with
    :math:`a = \sqrt{|\lambda_1\lambda_N|}`,
    :math:`b = \sqrt{|\lambda_s\lambda_t|}` (reference:
    krypy/utils.py:1919-2003).  Degrades gracefully to :class:`BoundCG`
    when the spectrum is non-negative."""

    def __new__(cls, evals):
        pos = False
        if isinstance(evals, Intervals):
            if evals.min() > 0:
                pos = True
        elif (np.asarray(evals) > -1e-15).all():
            pos = True
        if pos:
            return BoundCG(evals)
        return super().__new__(cls)

    def __init__(self, evals):
        if isinstance(evals, Intervals):
            if evals.contains(0):
                raise AssumptionError(
                    "zero eigenvalues not allowed with intervals"
                )
            evals = [
                val
                for val in (
                    evals.min(), evals.max_neg(), evals.min_pos(), evals.max()
                )
                if val is not None
            ]

        if len(evals) == 0:
            raise AssumptionError("empty spectrum not allowed")
        evals = np.asarray(evals)
        if not np.isreal(evals).all():
            raise AssumptionError("non-real eigenvalues not allowed")
        evals = np.sort(np.real(evals).astype(np.float64))
        evals = evals / np.max(np.abs(evals))
        negative = evals < -1e-15
        positive = evals > 1e-15

        lambda_1 = np.min(evals[negative])
        lambda_s = np.max(evals[negative])
        lambda_t = np.min(evals[positive])
        lambda_N = np.max(evals[positive])

        a = np.sqrt(np.abs(lambda_1 * lambda_N))
        b = np.sqrt(np.abs(lambda_s * lambda_t))
        self.base = (a - b) / (a + b)

    def eval_step(self, step):
        """Evaluate the bound after ``step`` iterations."""
        return 2 * self.base ** np.floor(step / 2.0)

    def get_step(self, tol):
        """Step count at which the bound falls below ``tol``."""
        return 2 * np.log(tol / 2.0) / np.log(self.base)


def bound_perturbed_gmres(pseudo, p, epsilon, deltas):
    """GMRES perturbation bound via pseudospectra (Sifuentes, Embree &
    Morgan 2013) -- reference: krypy/utils.py:2006-2033.

    :param pseudo: a pseudospectrum object exposing ``contour_paths(delta)``
      (see :mod:`krypy_tpu_torch.pseudospectra`).
    """
    if not np.all(np.asarray(deltas) > epsilon):
        raise ArgumentError("all deltas have to be greater than epsilon")

    bound = []
    for delta in deltas:
        paths = pseudo.contour_paths(delta)
        vertices = paths.vertices()
        supremum = np.max(np.abs(p(vertices)))
        bound.append(
            epsilon
            / (delta - epsilon)
            * paths.length()
            / (2 * np.pi * delta)
            * supremum
        )
    return bound


# ---------------------------------------------------------------------------
# residual polynomial with prescribed roots
# ---------------------------------------------------------------------------
class NormalizedRootsPolynomial:
    r"""The polynomial
    :math:`p(\lambda) = \prod_{i=1}^n (1 - \lambda/\theta_i)` with
    :math:`p(0) = 1` (reference: krypy/utils.py:2036-2100).

    Evaluation interleaves large- and small-magnitude factors to avoid
    under-/overflow in the running product.
    """

    def __init__(self, roots):
        roots = np.asarray(roots)
        if roots.ndim != 1:
            raise ArgumentError("one-dimensional array of roots expected.")
        self.roots = roots

    def minmax_candidates(self):
        """Roots of p' -- candidates for interval extrema (real roots)."""
        from numpy.polynomial import Polynomial as P

        p = P.fromroots(self.roots)
        return p.deriv(1).roots()

    def __call__(self, points):
        p = np.asarray(points)
        if p.ndim > 1:
            raise ArgumentError(
                "scalar or one-dimensional array of points expected."
            )
        n = self.roots.shape[0]
        vals = 1 - np.atleast_1d(p)[None, :] / self.roots.reshape(n, 1)

        # interleave large and small magnitudes to keep the running
        # product in range
        order = np.argsort(np.abs(vals), axis=0)
        mid = int(np.ceil(n / 2.0))
        interleaved = np.empty_like(order)
        interleaved[::2] = order[:mid]
        interleaved[1::2] = order[mid:][::-1]
        vals = np.take_along_axis(vals, interleaved, axis=0)

        vals = np.prod(vals, axis=0)
        if np.isscalar(points):
            return vals.item()
        return vals


def get_residual_norms(H, self_adjoint=False):
    """Recover the full GMRES/MINRES relative residual-norm history from a
    Hessenberg matrix alone by replaying the Givens QR.  Assumes a zero
    initial guess.  ``H`` is numpy or a tensor; the history is numpy."""
    if isinstance(H, torch.Tensor):
        H = _host(H)
    H = np.array(np.asarray(H), copy=True)
    n_, n = H.shape
    y = np.eye(n_, 1, dtype=H.dtype)
    resnorms = [1.0]
    for i in range(n_ - 1):
        Gm = Givens(H[i: i + 2, [i]]).G
        if self_adjoint:
            H[i: i + 2, i: i + 3] = Gm @ H[i: i + 2, i: i + 3]
        else:
            H[i: i + 2, i:] = Gm @ H[i: i + 2, i:]
        y[i: i + 2] = Gm @ y[i: i + 2]
        resnorms.append(float(np.abs(y[i + 1, 0])))
    if n_ == n:
        resnorms.append(0.0)
    return np.array(resnorms)


def strakos(n, l_min=0.1, l_max=100, rho=0.9, *, device="cuda"):
    """The Strakoš diagonal test matrix, float64 on ``device``."""
    d = [
        l_min + (i - 1) / (n - 1) * (l_max - l_min) * (rho ** (n - i))
        for i in range(1, n + 1)
    ]
    return torch.diag(torch.tensor(d, dtype=torch.float64, device=device))
