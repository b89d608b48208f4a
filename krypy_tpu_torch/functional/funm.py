r"""Krylov approximation of matrix-function actions f(A) b (counterpart
of :mod:`krypy_tpu.functional.funm`).

For Hermitian :math:`A` the Lanczos approximation is :math:`f(A) b
\approx \beta V_m^T f(T_m) e_1`; :func:`funm_krylov_arnoldi` is its
Arnoldi form for general operators, :func:`inv_sqrt_multiply` an
elliptic-contour quadrature of :math:`A^{-1/2} b` over multi-shift CG,
and :func:`slq_trace` stochastic Lanczos quadrature of
:math:`\mathrm{tr} f(A)`.

The basis build is the port's full-CGS2 (or one-reduce) Lanczos sweep of
:mod:`~krypy_tpu_torch.functional.eigh` on the device; :math:`f(T_m)` of
the small projection is taken on the device (``torch.linalg.eigh``) for
the Hermitian forms, and on the host (Schur-Parlett ``scipy.linalg.funm``
or the caller's matrix function) for the Arnoldi form, as in the JAX
package.  ``f`` of :func:`funm_krylov` and :func:`slq_trace` is a
callable on torch tensors (``torch.exp``, ``lambda w: 1 / torch.sqrt(w)``);
that of :func:`funm_krylov_arnoldi` a numpy-vectorised one.

The JAX package's ``slq_trace`` vmaps its probes; the port runs them one
after the other (the same estimate; a whole ``(n_probes, maxdim + 1, N)``
basis at 4095^2 would be 33 GB in float32).  Its probes come from a
``torch.Generator`` seeded by ``key`` (or ``key`` itself, a generator) on
the operator's device; :func:`_slq_core` takes the probe block, so that a
caller can hand in the JAX package's.  Unlike the JAX package, whose
``slq_trace`` runs the CGS2 sweep for any ``ortho`` it does not know,
the port's raises ``ValueError``.

Under an active mesh every product over N is the rank's partial and one
all-reduce, and the small matrices are the same bits on every rank.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..parallel import active_mesh, block_of
from .common import (
    as_matvec,
    cast_matvec,
    global_length,
    host_vectors,
    safe_div,
    system_dtype,
)
from .eigh import (
    _norm,
    _start_device,
    lanczos_1r_sweep,
    lanczos_cgs2_sweep,
    spurious_ritz_mask,
)

__all__ = ["funm_krylov", "funm_krylov_arnoldi", "expm_multiply",
           "inv_sqrt_multiply", "slq_trace", "slq_logdet"]


class FunmResult(NamedTuple):
    """Result of :func:`funm_krylov`."""

    #: the approximation to f(A) b, shape like b
    x: torch.Tensor
    #: distances ||x_m - x_j|| to the nested approximations of the last
    #: few j (NaN elsewhere): the a-posteriori error signal
    corrections: torch.Tensor
    #: Krylov dimension used
    m: int


def _sweep_of(ortho, name):
    if ortho not in ("cgs2", "cgs2_1r"):
        raise ValueError(f"unknown {name} ortho {ortho!r}")
    return lanczos_1r_sweep if ortho == "cgs2_1r" else lanczos_cgs2_sweep


def _lanczos(A_mv, v, m, dtype, ortho, name):
    """The ``m``-step sweep from ``v``: ``(V, H, beta)`` with ``V[0] = v /
    beta``, ``beta = ||v||``."""
    sweep = _sweep_of(ortho, name)
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    beta = _norm(v)
    V = torch.zeros((m + 1, v.shape[0]), dtype=dtype, device=v.device)
    V[0] = v * safe_div(torch.ones_like(beta), beta)
    H = torch.zeros((m + 1, m + 1), dtype=dtype, device=v.device)
    V, H = sweep(A_mv, V, H, 0, m, dtype, real_dtype)
    return V, H, beta


def funm_krylov(A, b, f, *, maxdim=30, ortho="cgs2"):
    r"""Approximate ``f(A) b`` for Hermitian ``A`` by the Lanczos method.

    :param f: scalar function on a tensor of eigenvalues (``torch.exp``,
      ``lambda w: 1 / torch.sqrt(w)``), well-defined on the spectrum the
      Krylov space samples.
    :param maxdim: Krylov dimension m.  ``corrections`` holds the
      distances :math:`\|x_m - x_j\|` to the nested approximations for
      ``max(2, m-4) <= j < m`` (NaN elsewhere).
    :param ortho: ``"cgs2"`` (3 all-reduces per Lanczos step) or
      ``"cgs2_1r"`` (one per step, lagged DCGS-2).
    :return: :class:`FunmResult`.
    """
    (b,) = host_vectors(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    m = min(int(maxdim), global_length(bv))
    dtype = system_dtype(bv)
    bv = bv.to(dtype)
    A_mv = cast_matvec(as_matvec(A), dtype)
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    # the sweep deflates a round-off-sized residual to a ZERO row (a
    # garbage direction's Rayleigh quotient is unbounded: catastrophic
    # under f = exp)
    V, H, beta = _lanczos(A_mv, bv, m, dtype, ortho, "funm_krylov")
    zero = torch.zeros((), dtype=dtype, device=bv.device)

    def fT_e1(Hj, Vj):
        """``beta f(T_j) e1`` over the leading block; dead-block pairs
        (exact zeros from deflation) are masked out before f touches
        them (f(0) * 0 is NaN for f singular at 0)."""
        Tj = 0.5 * (Hj + Hj.conj().T)
        tj, Sj = torch.linalg.eigh(Tj)
        spurious = spurious_ritz_mask(Vj, Sj)
        coeff = torch.where(spurious, zero,
                            f(tj).to(dtype) * Sj[0].conj())
        return (Sj @ coeff) * beta.to(dtype)

    fe1 = fT_e1(H[:m, :m], V[:m])
    x = fe1 @ V[:m]

    corrections = torch.full((m + 1,), float("nan"), dtype=real_dtype,
                             device=bv.device)
    for j in range(max(2, m - 4), m):
        fj = fT_e1(H[:j, :j], V[:j])
        diff = fe1 - torch.cat([fj, torch.zeros(m - j, dtype=dtype,
                                                device=bv.device)])
        corrections[j] = torch.linalg.vector_norm(diff)

    return FunmResult(x=x if flat else x[:, None], corrections=corrections,
                      m=m)


def funm_krylov_arnoldi(A, b, f=None, *, maxdim=30, matfunc=None,
                        ortho="cgs2"):
    r"""Approximate ``f(A) b`` for a GENERAL operator by the Arnoldi
    method, :math:`f(A) b \approx \beta V_m f(H_m) e_1`: the sweep on the
    device, ``f`` of the small Hessenberg on the host (Schur-Parlett, or
    ``matfunc``), the assembly on the device.

    An early invariant subspace truncates to the live leading block (the
    sweep writes an exact zero subdiagonal), so ``f`` never meets the
    dead zero block.

    :param f: scalar function vectorised over a numpy array of (possibly
      complex) eigenvalues.
    :param matfunc: matrix function ``T -> f(T)`` of the small host block
      (e.g. ``scipy.linalg.expm``), instead of ``f``.
    :return: :class:`FunmResult` (``m`` is the LIVE dimension used).
    """
    import scipy.linalg as sla

    if (f is None) == (matfunc is None):
        raise ValueError("pass exactly one of f= or matfunc=")
    if matfunc is None:
        def matfunc(T):
            return sla.funm(T, lambda w: np.asarray(f(w)))

    (b,) = host_vectors(b)
    flat = b.ndim == 1
    bv = b.reshape(-1)
    m = min(int(maxdim), global_length(bv))
    dtype = system_dtype(bv)
    bv = bv.to(dtype)
    A_mv = cast_matvec(as_matvec(A), dtype)
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    V, H, beta = _lanczos(A_mv, bv, m, dtype, ortho, "funm_krylov_arnoldi")

    Hh = H.cpu().numpy()
    # live leading block: an EXACT zero subdiagonal marks deflation
    sub = np.abs(np.diag(Hh, -1))[:m]
    dead = np.nonzero(sub == 0.0)[0]
    j_live = int(dead[0]) + 1 if dead.size else m
    betah = float(beta)

    def fe1(j):
        col = np.asarray(matfunc(Hh[:j, :j]))[:, 0] * betah
        if np.iscomplexobj(col) and not dtype.is_complex:
            # f not real on the Arnoldi spectrum (a branch cut) leaves
            # imaginary mass that truncation would silently drop
            imag_mass = np.linalg.norm(col.imag)
            scale = max(np.linalg.norm(col), 1.0)
            if imag_mass > 1e3 * np.finfo(col.real.dtype).eps * scale:
                import warnings

                warnings.warn(
                    "funm_krylov_arnoldi: f(H) e1 has non-negligible "
                    f"imaginary mass ({imag_mass:.2e} vs norm "
                    f"{scale:.2e}) for a real system dtype -- f is not "
                    "real on the Arnoldi spectrum (branch cut?); the "
                    "imaginary part is being discarded.  Pass a complex "
                    "b/dtype to keep it.",
                    RuntimeWarning,
                    stacklevel=2,
                )
            col = col.real
        return col

    em = fe1(j_live)
    x = torch.from_numpy(np.ascontiguousarray(em)).to(
        device=bv.device, dtype=dtype) @ V[:j_live]

    corrections = np.full(m + 1, np.nan,
                          torch.empty(0, dtype=real_dtype).numpy().dtype)
    for j in range(max(2, j_live - 4), j_live):
        diff = em - np.concatenate([fe1(j), np.zeros(j_live - j, em.dtype)])
        corrections[j] = np.linalg.norm(diff)

    return FunmResult(x=x if flat else x[:, None],
                      corrections=torch.from_numpy(corrections).to(
                          bv.device),
                      m=j_live)


def expm_multiply(A, b, t=1.0, *, maxdim=30, hermitian=True):
    r"""``exp(t A) b``: Lanczos for Hermitian ``A`` (:func:`funm_krylov`),
    or with ``hermitian=False`` the Arnoldi form with a host Pade ``expm``
    of the Hessenberg (:func:`funm_krylov_arnoldi`).  ``t`` may be
    negative (diffusion semigroups)."""
    t = float(t)
    if not hermitian:
        import scipy.linalg as sla

        return funm_krylov_arnoldi(
            A, b, matfunc=lambda T: sla.expm(t * T), maxdim=maxdim)
    return funm_krylov(A, b, lambda w: torch.exp(t * w), maxdim=maxdim)


def inv_sqrt_multiply(
    A, b, *, lmin=None, lmax=None, terms=16, tol=1e-8, maxiter=None
):
    r"""``A^{-1/2} b`` for SPD ``A`` by the Hale-Higham-Trefethen
    elliptic-contour quadrature of :math:`\frac{2}{\pi}\int_0^\infty (A +
    t^2 I)^{-1} dt` over ONE multi-shift CG run
    (:func:`~krypy_tpu_torch.functional.shifted.shifted_cg`), combined by
    one small product.

    :param lmin,lmax: spectrum bounds (lmin must LOWER-bound); estimated by
      :func:`~krypy_tpu_torch.functional.chebyshev.spectral_bounds` with
      safety ``(0.01, 1.2)`` when omitted.
    :param terms: quadrature points.
    :param tol: target relative accuracy; the shifted solves run to
      ``max(tol/10, 50 eps)`` of ``b``'s dtype.
    :return: ``(x, info)``; ``info`` holds the shifted solve's statuses
      and the quadrature.
    """
    from scipy.special import ellipj, ellipk

    from .chebyshev import spectral_bounds
    from .shifted import shifted_cg

    (b,) = host_vectors(b)
    if lmin is None or lmax is None:
        lo, hi = spectral_bounds(A, b, safety=(0.01, 1.2))
        lmin = float(lo) if lmin is None else float(lmin)
        lmax = float(hi) if lmax is None else float(lmax)
    lmin, lmax = float(lmin), float(lmax)
    if not 0 < lmin <= lmax:
        raise ValueError(f"need 0 < lmin <= lmax, got [{lmin}, {lmax}]")

    # midpoint rule in the conformal variable u in [0, K']: t = sqrt(lmin)
    # sn/cn, dt = sqrt(lmin) dn/cn^2 du (modulus m1 = 1 - lmin/lmax)
    m1 = 1.0 - lmin / lmax
    Kp = float(ellipk(m1))
    u = (np.arange(terms) + 0.5) * Kp / terms
    sn, cn, dn, _ = ellipj(u, m1)
    shifts = lmin * (sn / cn) ** 2
    weights = (2.0 * Kp * np.sqrt(lmin) / (np.pi * terms)) * dn / cn ** 2

    eps = float(torch.finfo(b.dtype).eps)
    inner_tol = max(tol / 10.0, 50.0 * eps)
    res = shifted_cg(A, b, torch.from_numpy(shifts), tol=inner_tol,
                     maxiter=maxiter)
    w = torch.from_numpy(weights).to(device=res.X.device,
                                     dtype=res.X.real.dtype)
    x = w.to(res.X.dtype) @ res.X
    info = {
        "shift_status": res.status,
        "inner_iters": res.niter,
        "shifts": shifts,
        "weights": weights,
        "lmin": lmin,
        "lmax": lmax,
    }
    return (x if b.ndim == 1 else x[:, None]), info


def _slq_n(A, n):
    if n is None:
        shape = getattr(A, "shape", None)
        if shape is None:
            raise ValueError("n= required when A has no .shape")
        n = shape[0]
    return int(n)


def slq_trace(
    A, f, key, *, n=None, n_probes=16, maxdim=30, ortho="cgs2"
):
    r"""Stochastic Lanczos quadrature estimate of ``trace(f(A))`` for
    Hermitian ``A``: Rademacher probes :math:`z` and, for each, the Gauss
    quadrature :math:`z^T f(A) z \approx \|z\|^2 \sum_j |S_{1j}|^2
    f(\theta_j)` of its ``maxdim``-step Lanczos tridiagonalization.

    :param f: scalar function on a tensor of eigenvalues.
    :param key: seed of the probes' ``torch.Generator`` on the operator's
      device, or a generator.
    :param n: problem size when ``A`` has no ``.shape``.
    :param ortho: ``"cgs2"`` or ``"cgs2_1r"``; anything else raises
      ``ValueError``.
    :return: ``(estimate, stderr)``: the Hutchinson mean and its standard
      error over the probes (``inf`` for one probe).

    The working dtype is the operator's output dtype on a float32 input
    (one application of ``A`` to a zero vector finds it): a float32
    operator stays float32, a float64 or complex one is not truncated.
    """
    N = _slq_n(A, n)
    A_mv = as_matvec(A)
    mesh = active_mesh()
    if mesh is not None:
        device = mesh.device
    elif isinstance(key, torch.Generator):
        device = key.device
    else:
        device = _start_device(A)
    n_loc = N if mesh is None else len(range(N)[block_of(N, mesh)])
    dtype = A_mv(torch.zeros(n_loc, dtype=torch.float32,
                             device=device)).dtype
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator(device=device).manual_seed(int(key))

    def probes():
        real_dtype = torch.empty(0, dtype=dtype).real.dtype
        for _ in range(int(n_probes)):
            z = torch.randint(0, 2, (N,), generator=gen, device=device)
            z = (2 * z - 1).to(real_dtype).to(dtype)
            yield z if mesh is None else z[block_of(N, mesh)]

    return _slq_core(A, f, probes(), N, maxdim, ortho, dtype)


def _slq_core(A, f, Z, N, maxdim, ortho, dtype):
    """:func:`slq_trace` on the probes ``Z`` (rows of a tensor, or an
    iterable of vectors; the rank's blocks on a mesh) of the global
    length ``N``, in ``dtype``."""
    sweep = _sweep_of(ortho, "slq_trace")
    A_mv = cast_matvec(as_matvec(A), dtype)
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    m = min(int(maxdim), int(N))

    vals = []
    for z in Z:
        z = z.to(dtype)
        beta = _norm(z)
        V = torch.zeros((m + 1, z.shape[0]), dtype=dtype, device=z.device)
        V[0] = z * safe_div(torch.ones_like(beta), beta)
        H = torch.zeros((m + 1, m + 1), dtype=dtype, device=z.device)
        V, H = sweep(A_mv, V, H, 0, m, dtype, real_dtype)
        Tm = 0.5 * (H[:m, :m] + H[:m, :m].conj().T)
        theta, S = torch.linalg.eigh(Tm)
        spurious = spurious_ritz_mask(V[:m], S)
        w = torch.where(spurious, 0.0, torch.abs(S[0]) ** 2 * f(theta))
        vals.append(beta ** 2 * torch.sum(w))
        del V
    vals = torch.stack(vals)
    n_probes = vals.shape[0]
    est = torch.mean(vals)
    if n_probes > 1:
        # the sample standard error (ddof=1)
        stderr = torch.std(vals, correction=1) * safe_div(
            torch.ones((), dtype=real_dtype, device=vals.device),
            torch.sqrt(torch.tensor(float(n_probes), dtype=real_dtype,
                                    device=vals.device)))
    else:
        stderr = torch.tensor(float("inf"), dtype=real_dtype,
                              device=vals.device)
    return est, stderr


def slq_logdet(A, key, **kwargs):
    r"""``log det(A)`` for SPD ``A`` by stochastic Lanczos quadrature
    (:func:`slq_trace` with ``f = log``)."""
    return slq_trace(A, torch.log, key, **kwargs)
