r"""Interior eigenpairs by Chebyshev-Jackson filtered subspace iteration
(counterpart of :mod:`krypy_tpu.functional.filtered`).

:func:`eigsh_window` computes the eigenpairs of a Hermitian :math:`A`
inside a window :math:`[\xi_0, \xi_1]` with no inner solves: a
Jackson-damped Chebyshev approximation of the window's indicator is
applied to a trial block (``degree`` block matvecs by the three-term
recurrence, no reduction), then two-pass SVQB and Rayleigh-Ritz on A
(EVSL / ChASE; Di Napoli, Polizzi & Saad 2016).  :func:`window_count`
estimates the number of eigenvalues in a window (Hutchinson trace of the
same filter), :func:`kpm_dos` the density of states (kernel polynomial
method), :func:`estimate_spectrum_bounds` the spectrum's bounds by one
Lanczos sweep.

The JAX package's ``lax.while_loop`` is a host loop here that reads one
flag per outer iteration; the filter, the SVQB and Rayleigh-Ritz Grams
and their small eigendecompositions (``torch.linalg.eigh``, on the
device) read nothing back.  Operators are applied to the row blocks one
row at a time.  Under an active mesh the filter stays local, each Gram
and row norm is one all-reduce, and the Chebyshev moments of
:func:`window_count` and :func:`kpm_dos` are summed locally over the
whole recurrence and reduced once.

The random probes: the JAX package's ``key`` (a ``jax.random`` PRNG key)
is a ``torch.Generator`` or an integer seed here, in the same position.
The Rademacher rows are drawn on the generator's device (a seed makes a
generator on the solve's device) over the whole length N and each rank
keeps its columns, so that a sharded estimate draws the one-device
probes.  The draw is :func:`_rademacher_rows`.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..core.dtypes import asarray, torch_dtype
from ..parallel import active_mesh, block_of
from .common import (
    CONVERGED,
    MAXITER,
    as_matvec,
    cast_matvec,
    global_length,
    mesh_sum,
    safe_div,
    system_dtype,
)
from .eigh import (
    _block_matvec,
    _cos_block,
    _cos_start,
    _default_float,
    _eps_floor,
    _gram,
    _hermitian_eigh,
    _norm,
    _operator_dtype,
    _real,
    _row_norms,
    _start_device,
    _svqb_transform,
    lanczos_cgs2_sweep,
    spurious_ritz_mask,
)

__all__ = [
    "eigsh_window",
    "estimate_spectrum_bounds",
    "WindowResult",
    "jackson_cheby_coeffs",
    "window_count",
    "kpm_dos",
]


class WindowResult(NamedTuple):
    """Result of :func:`eigsh_window`.

    The block holds ``p`` Ritz pairs; the pairs INSIDE the window come
    first (ascending), then the rest (leaked / spurious directions, also
    ascending).  Only the ``n_inside`` leading pairs are deliverables.
    """

    #: Ritz values, shape ``(p,)``, inside-window pairs first
    theta: torch.Tensor
    #: Ritz vectors as columns, shape ``(N, p)``
    U: torch.Tensor
    #: boolean mask, shape ``(p,)``: pair lies inside the window (and is
    #: not a deflated-junk direction)
    inside: torch.Tensor
    #: number of window eigenpairs found (== ``inside.sum()``)
    n_inside: torch.Tensor
    #: worst inside-window relative residual per outer iteration
    resnorms: torch.Tensor
    #: outer (filter + Rayleigh-Ritz) iterations performed
    niter: torch.Tensor
    #: CONVERGED / MAXITER (an empty window reports MAXITER with
    #: ``n_inside == 0``)
    status: torch.Tensor
    #: final per-pair relative residuals, shape ``(p,)``
    pair_resnorms: torch.Tensor
    #: True when every live pair of the block sits inside the window at
    #: exit: the window likely holds more eigenpairs than the block
    saturated: torch.Tensor
    #: spectrum bounds ``(lmin, lmax)`` the filter was built on
    bounds: tuple = None
    #: Chebyshev degree used (matvecs per pair per outer iteration)
    degree: int = None

    @property
    def converged(self):
        return bool(self.status == CONVERGED)


def jackson_cheby_coeffs(lo, hi, lmin, lmax, degree):
    r"""Host-side coefficients of the Jackson-damped degree-``degree``
    Chebyshev expansion of the indicator function of ``[lo, hi]`` on a
    spectrum contained in ``[lmin, lmax]``: ``(coeffs, center,
    half_width)``, ``coeffs[j]`` the weight of :math:`T_j(l(t))` under
    :math:`l(t) = (t - c)/e` (numpy, the JAX package's formula)."""
    lo, hi = float(lo), float(hi)
    lmin, lmax = float(lmin), float(lmax)
    if not lo < hi:
        raise ValueError(f"window=({lo}, {hi}): need lo < hi")
    if not lmin < lmax:
        raise ValueError(f"bounds=({lmin}, {lmax}): need lmin < lmax")
    c = 0.5 * (lmax + lmin)
    e = 0.5 * (lmax - lmin)
    a = (lo - c) / e
    b = (hi - c) / e
    if b <= -1.0 or a >= 1.0:
        raise ValueError(
            f"window=({lo}, {hi}) lies entirely outside the spectrum "
            f"bounds ({lmin}, {lmax}); nothing to filter for")
    a = max(a, -1.0)
    b = min(b, 1.0)
    d = int(degree)
    if d < 2:
        raise ValueError(f"degree must be >= 2, got {degree}")
    j = np.arange(d + 1)
    # raw Chebyshev moments of the indicator: arccos is decreasing
    pa, pb = np.arccos(a), np.arccos(b)
    mu = np.empty(d + 1)
    mu[0] = (pa - pb) / np.pi
    jj = j[1:]
    mu[1:] = 2.0 / (np.pi * jj) * (np.sin(jj * pa) - np.sin(jj * pb))
    return mu * _jackson(d), c, e


def _jackson(d):
    """The Jackson damping factors ``g_j^d``, ``j = 0..d``."""
    j = np.arange(d + 1)
    alpha = np.pi / (d + 2)
    return ((d + 2 - j) * np.sin(alpha) * np.cos(j * alpha)
            + np.cos(alpha) * np.sin(j * alpha)) / ((d + 2) * np.sin(alpha))


def _resolve_n(A, n, what="A"):
    if n is not None:
        return int(n)
    shape = getattr(A, "shape", None)
    if shape is None:
        raise ValueError(f"n= or X0= required when {what} has no .shape")
    return int(shape[0])


def estimate_spectrum_bounds(A, *, n=None, v0=None, m=24, safety=0.01):
    r"""Estimated spectrum bounds ``(lmin, lmax)`` of a Hermitian
    operator, as Python floats, by an ``m``-step Lanczos sweep: each
    extremal Ritz value pushed outward by its residual norm, then the
    interval widened by ``safety`` relatively on each side."""
    A_mv = as_matvec(A)
    if v0 is not None:
        v0 = asarray(v0, device=_start_device(A)).reshape(-1)
        N = global_length(v0)
    else:
        N = _resolve_n(A, n)
        v0 = _cos_start(N, _start_device(A))
        op_dt = _operator_dtype(A)
        if op_dt is not None and op_dt.is_complex:
            v0 = v0.to(op_dt)
    dtype = _default_float(system_dtype(v0))
    real_dtype = _real(dtype)
    dev = v0.device
    m = min(int(m), N)
    A_c = cast_matvec(A_mv, dtype)

    one = torch.ones((), dtype=real_dtype, device=dev)
    v = v0.to(dtype)
    V = torch.zeros((m + 1, v.shape[0]), dtype=dtype, device=dev)
    V[0] = v * safe_div(one, _norm(v))
    H = torch.zeros((m + 1, m + 1), dtype=dtype, device=dev)
    V, H = lanczos_cgs2_sweep(A_c, V, H, 0, m, dtype, real_dtype)
    theta, S = _hermitian_eigh(H[:m, :m])
    # residual of each Ritz pair: beta_m |e_m^T s_i|
    res = torch.abs(H[m, m - 1]) * torch.abs(S[m - 1, :])
    spur = spurious_ritz_mask(V[:m], S)
    big = torch.finfo(real_dtype).max
    lmin = torch.min(torch.where(spur, big, theta - res))
    lmax = torch.max(torch.where(spur, -big, theta + res))
    lmin, lmax = torch.stack([lmin, lmax]).tolist()
    pad = float(safety) * max(lmax - lmin, abs(lmax), abs(lmin), 1e-30)
    return lmin - pad, lmax + pad


def _cheby_moments(A, degree, bounds, Z):
    r"""Per-probe Chebyshev moments :math:`\mu_j = z^H T_j(l(A)) z` for
    the rows of ``Z``, shape ``(degree+1, n_probes)``: one batched
    three-term recurrence, the local moments reduced once at the end."""
    lmin, lmax = float(bounds[0]), float(bounds[1])
    c = 0.5 * (lmax + lmin)
    inv_e = 2.0 / (lmax - lmin)
    dtype = Z.dtype
    real_dtype = _real(dtype)
    A_blk = _block_matvec(A, dtype)

    def lA(Y):
        return (A_blk(Y) - c * Y) * inv_e

    def qf(Y):
        return torch.sum(Z.conj() * Y, dim=1).real.to(real_dtype)

    d = int(degree)
    mu = torch.zeros((d + 1, Z.shape[0]), dtype=real_dtype, device=Z.device)
    T0, T1 = Z, lA(Z)
    mu[0], mu[1] = qf(T0), qf(T1)
    for j in range(2, d + 1):
        T0, T1 = T1, 2.0 * lA(T1) - T0
        mu[j] = qf(T1)
    return mesh_sum(mu)


def _rademacher_rows(A, key, n_probes, N, dtype=None, device=None):
    """Real Rademacher probe rows ``(n_probes, N)`` in the operator's
    (real) dtype, or in ``dtype`` (default float64 for a bare callable),
    drawn over the whole length ``N`` by the ``torch.Generator`` ``key``
    (on its device) or by a generator seeded by the integer ``key`` on
    ``device``; this rank's columns of them under a mesh."""
    dt = _operator_dtype(A) if dtype is None else torch_dtype(dtype)
    real_dt = _real(_default_float(dt))
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=device).manual_seed(int(key))
    Z = torch.randint(0, 2, (int(n_probes), int(N)), generator=gen,
                      device=gen.device).to(real_dt) * 2 - 1
    mesh = active_mesh()
    if mesh is not None:
        Z = Z[:, block_of(int(N), mesh)].contiguous()
    return Z


def _probes(A, key, n, n_probes, dtype):
    """The global N and the probe rows of :func:`window_count` and
    :func:`kpm_dos`, on the generator's device (or, for a seed, on the
    solve's, as :func:`~krypy_tpu_torch.functional.eigh.eigsh`'s
    start)."""
    N = _resolve_n(A, n)
    dev = (key.device if isinstance(key, torch.Generator)
           else _start_device(A))
    return N, _rademacher_rows(A, key, n_probes, N, dtype, dev)


def window_count(
    A, window, key, *, n=None, bounds=None, degree=None, n_probes=16,
    dtype=None,
):
    r"""Stochastic estimate of the NUMBER of eigenvalues of Hermitian
    ``A`` inside ``window = (lo, hi)``: the Hutchinson trace of the
    Jackson-Chebyshev window filter of :func:`eigsh_window`.

    :param key: a ``torch.Generator`` or an integer seed for the
      Rademacher probes (module docstring).
    :param bounds: spectrum bounds; estimated when omitted.
    :param degree: filter degree; :func:`eigsh_window`'s default policy.
    :param dtype: probe dtype; defaults to the operator's when it can be
      probed, else float64.
    :return: ``(count, stderr)`` Python floats.
    """
    lo, hi = float(window[0]), float(window[1])
    A_mv = as_matvec(A)
    N, Z = _probes(A, key, n, n_probes, dtype)
    if bounds is None:
        bounds = estimate_spectrum_bounds(A, n=N)
    lmin, lmax = float(bounds[0]), float(bounds[1])
    span = lmax - lmin
    width = min(hi, lmax) - max(lo, lmin)
    if width <= 0:
        raise ValueError(
            f"window=({lo}, {hi}) lies entirely outside the spectrum "
            f"bounds ({lmin}, {lmax})")
    if degree is None:
        degree = int(np.clip(np.ceil(4.0 * span / width), 16, 1000))
    coeffs, _, _ = jackson_cheby_coeffs(lo, hi, lmin, lmax, degree)
    mu = _cheby_moments(A_mv, degree, (lmin, lmax), Z)
    per_probe = (torch.tensor(coeffs, dtype=mu.dtype, device=mu.device)
                 @ mu).cpu().numpy().astype(float)
    count = float(per_probe.mean())
    stderr = (float(per_probe.std(ddof=1) / np.sqrt(len(per_probe)))
              if len(per_probe) > 1 else float("inf"))
    return count, stderr


def kpm_dos(
    A,
    key,
    *,
    n=None,
    bounds=None,
    degree=180,
    n_probes=16,
    npoints=200,
    dtype=None,
):
    r"""Kernel polynomial method estimate of the spectral density of
    Hermitian ``A`` from Jackson-damped Hutchinson moments (Weisse,
    Wellein, Alvermann & Fehske 2006), normalized so that
    :math:`\int \rho\,d\lambda = N`.

    :param key: a ``torch.Generator`` or an integer seed (module
      docstring).
    :param degree: moment count = resolution.
    :param dtype: probe dtype (see :func:`window_count`).
    :return: ``(grid, density)`` numpy arrays of length ``npoints``.
    """
    A_mv = as_matvec(A)
    N, Z = _probes(A, key, n, n_probes, dtype)
    if bounds is None:
        bounds = estimate_spectrum_bounds(A, n=N)
    lmin, lmax = float(bounds[0]), float(bounds[1])
    d = int(degree)
    mu = torch.mean(_cheby_moments(A_mv, d, (lmin, lmax), Z), dim=1)
    gmu = _jackson(d) * mu.cpu().numpy().astype(float)
    # open Chebyshev grid (never touches x = +-1)
    x = np.cos(np.pi * (np.arange(npoints) + 0.5) / npoints)[::-1]
    T0, T1 = np.ones_like(x), x
    y = gmu[0] * T0 + 2.0 * gmu[1] * T1
    for jj in range(2, d + 1):
        T0, T1 = T1, 2 * x * T1 - T0
        y += 2.0 * gmu[jj] * T1
    c = 0.5 * (lmax + lmin)
    e = 0.5 * (lmax - lmin)
    return c + e * x, y / (np.pi * np.sqrt(1.0 - x ** 2)) / e


def eigsh_window(
    A,
    window,
    *,
    block=None,
    k=None,
    X0=None,
    n=None,
    degree=None,
    bounds=None,
    maxiter=100,
    tol=1e-8,
    criterion="backward",
):
    r"""Eigenpairs of Hermitian ``A`` inside ``window = (lo, hi)`` by
    Chebyshev-Jackson filtered subspace iteration.

    :param A: Hermitian operator (matvec callable, 2-D tensor or numpy
      array).
    :param window: ``(lo, hi)``, the open spectral interval wanted.
    :param block: trial-block width ``p``; must exceed the number of
      eigenvalues in the window (check ``result.saturated``).  Default
      ``k + max(4, k//2)`` when ``k`` is given.
    :param k: expected number of window eigenpairs (sets the default
      block width only).
    :param X0: starting block ``(N, p)``; overrides ``block``/``k``.
    :param n: problem size when ``A`` has no ``.shape`` and no ``X0``.
    :param degree: Chebyshev filter degree (default ``clip(4 *
      span/width, 16, 1000)``).
    :param bounds: spectrum bounds ``(lmin, lmax)``, OUTER bounds;
      estimated by :func:`estimate_spectrum_bounds` when omitted.
    :param maxiter: outer iterations.
    :param tol: per-pair residual tolerance (see ``criterion``).
    :param criterion: ``'backward'`` (default: :math:`\|Au - \theta u\|
      \le \mathrm{tol}\cdot\|A\|`, :math:`\|A\| \approx \max(|l_{min}|,
      |l_{max}|)`) or ``'rel'`` (:math:`\le \mathrm{tol}\cdot|\theta|`).
    :return: :class:`WindowResult`.
    """
    if criterion not in ("rel", "backward"):
        raise ValueError(
            f"criterion={criterion!r}: expected 'rel' or 'backward'")
    lo, hi = (float(window[0]), float(window[1]))
    if not lo < hi:
        raise ValueError(f"window={window!r}: need lo < hi")

    A_mv = as_matvec(A)

    if X0 is not None:
        X0 = asarray(X0, device=_start_device(A))
        if X0.ndim != 2:
            raise ValueError(f"X0 must be (N, p), got shape "
                             f"{tuple(X0.shape)}")
        N = global_length(X0[:, 0])
        p = int(X0.shape[1])
    else:
        N = _resolve_n(A, n)
        if block is not None:
            p = int(block)
        elif k is not None:
            p = int(k) + max(4, int(k) // 2)
        else:
            raise ValueError("one of block=, k= or X0= is required")
    if p < 1:
        raise ValueError(f"block must be >= 1, got {p}")
    if p > N:
        raise ValueError(f"block={p} exceeds the problem size N={N}")

    if X0 is None:
        X = _cos_block(N, p, _start_device(A))
        op_dt = _operator_dtype(A)
        if op_dt is not None and op_dt.is_complex:
            X = X.to(op_dt)
    else:
        X = X0.T

    dtype = _default_float(system_dtype(X))
    real_dtype = _real(dtype)
    X = X.to(dtype).contiguous()
    dev = X.device

    if bounds is None:
        bounds = estimate_spectrum_bounds(A, n=N)
    lmin, lmax = float(bounds[0]), float(bounds[1])

    span = lmax - lmin
    width = min(hi, lmax) - max(lo, lmin)
    if width <= 0:
        raise ValueError(
            f"window=({lo}, {hi}) lies entirely outside the spectrum "
            f"bounds ({lmin}, {lmax}); nothing to filter for")
    if degree is None:
        degree = int(np.clip(np.ceil(4.0 * span / width), 16, 1000))
    degree = int(degree)

    coeffs_np, c, e = jackson_cheby_coeffs(lo, hi, lmin, lmax, degree)
    coeffs = torch.tensor(coeffs_np, dtype=real_dtype, device=dev)
    inv_e = 1.0 / e
    A_blk = _block_matvec(A, dtype)

    def lA(Z):
        """Rows through the affine map l(A) = (A - c I)/e."""
        return (A_blk(Z) - c * Z) * inv_e

    def cheb_filter(Z):
        """rho(A) Z by the three-term recurrence: ``degree`` block
        matvecs, zero reductions."""
        T0, T1 = Z, lA(Z)
        Y = coeffs[0] * T0 + coeffs[1] * T1
        for j in range(2, degree + 1):
            T0, T1 = T1, 2.0 * lA(T1) - T0
            Y = Y + coeffs[j] * T1
        return Y

    eps = float(torch.finfo(real_dtype).eps)

    def svqb2(Z):
        """Two-pass SVQB of the rows of Z (lobpcg's panel factorization
        with B = I: the same dead-row rule and S^T row transform)."""
        for _ in range(2):
            d = mesh_sum(torch.sum(Z.conj() * Z, dim=1).real)
            alive = (d > (64.0 * eps) * torch.sum(d) / p).to(real_dtype)
            Z = Z * alive[:, None]
            G = _gram(Z, Z)
            T, _ = _svqb_transform(0.5 * (G + G.conj().T), eps, real_dtype,
                                   dtype)
            Z = T @ Z
        return Z

    if criterion == "backward":
        anorm = max(abs(lmin), abs(lmax))
    eps_floor = _eps_floor(real_dtype, dev)
    tol_t = torch.tensor(tol, dtype=real_dtype, device=dev)

    def rr_and_residuals(Q):
        """Rayleigh-Ritz on A over the orthonormal rows of Q, then
        per-pair residuals and the window membership mask."""
        AQ = A_blk(Q)
        theta, C = _hermitian_eigh(_gram(Q, AQ))
        spur = spurious_ritz_mask(Q, C)
        Xn, AXn = C.T @ Q, C.T @ AQ
        theta = theta.to(real_dtype)
        num = _row_norms(AXn - theta[:, None].to(dtype) * Xn)
        if criterion == "backward":
            den = torch.full((p,), anorm, dtype=real_dtype, device=dev)
        else:
            den = torch.abs(theta)
        res = num / torch.maximum(den, eps_floor)
        inside = (~spur) & (theta >= lo) & (theta <= hi)
        return Xn, theta, res, inside

    hist = torch.full((maxiter + 1,), float("nan"), dtype=real_dtype,
                      device=dev)
    theta = torch.zeros(p, dtype=real_dtype, device=dev)
    res = torch.full((p,), float("inf"), dtype=real_dtype, device=dev)
    inside = torch.zeros(p, dtype=torch.bool, device=dev)
    it, conv = 0, False
    ok_prev = torch.zeros((), dtype=torch.bool, device=dev)
    n_prev = torch.full((), -1, dtype=torch.int64, device=dev)
    while not conv and it < maxiter:
        Y = cheb_filter(X)
        # rows that overflowed (bounds that do not contain the spectrum)
        # deflate to zero instead of poisoning the Gram with NaN
        bad = mesh_sum((~torch.isfinite(Y)).sum(dim=1))
        Y = torch.where((bad == 0)[:, None], Y, torch.zeros((), dtype=dtype,
                                                            device=dev))
        X, theta, res, inside = rr_and_residuals(svqb2(Y))
        worst = torch.max(torch.where(inside, res, 0.0))
        n_in = torch.sum(inside)
        hist[it] = worst
        ok = (n_in > 0) & (worst <= tol_t)
        # pairs ENTER the window as they converge: demand two consecutive
        # passing iterations with a stable inside count
        conv_t = ok & ok_prev & (n_in == n_prev)
        ok_prev, n_prev = ok, n_in
        it += 1
        conv = bool(conv_t)  # the iteration's one host read

    # order: inside pairs first (ascending), leaked/junk tail after
    big = torch.finfo(real_dtype).max / 4
    order = torch.argsort(theta + big * (~inside).to(real_dtype), stable=True)
    theta, X, res, inside = theta[order], X[order], res[order], inside[order]
    n_inside = torch.sum(inside)
    live = mesh_sum(torch.sum(torch.abs(X) ** 2, dim=1)) > 0
    return WindowResult(
        theta=theta,
        U=X.T,
        inside=inside,
        n_inside=n_inside,
        resnorms=hist,
        niter=torch.tensor(it, dtype=torch.int64, device=dev),
        status=torch.tensor(CONVERGED if conv else MAXITER,
                            dtype=torch.int64, device=dev),
        pair_resnorms=res,
        saturated=torch.sum(live) == n_inside,
        bounds=(lmin, lmax),
        degree=degree,
    )
