r"""Non-Hermitian eigensolver: Krylov-Schur over device Arnoldi sweeps
(counterpart of :mod:`krypy_tpu.functional.eigs`).

Computes k eigenpairs of a general square operator ``A`` by the
Krylov-Schur method (Stewart 2002): build an m-dimensional Krylov
decomposition :math:`A V_m = V_m B_m + v_{m+1} b_m^T`, compress it to
the l wanted Schur vectors, and continue.

The split of labor is the JAX package's (docs/DESIGN.md section 7): the
Arnoldi sweeps (eigh's :func:`~krypy_tpu_torch.functional.eigh.
lanczos_cgs2_sweep` or its one-reduce sweep) and the compression
``V <- Z_l^T V`` run on the device; the ordered Schur decomposition of
the ``(m, m)`` projection runs on the host with the same
``scipy.linalg.schur`` calls, once per restart cycle, on ``H`` read back
in one transfer.  The basis is complex even for a real operator (the
compressed ``T`` is complex triangular), and the final pairs are
verified explicitly against ``A``.  Under an active mesh the sweeps'
products are local partials plus one all-reduce each, and every rank
reads the same ``H`` and runs the same Schur decomposition.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..core.dtypes import asarray
from .common import (
    CONVERGED,
    MAXITER,
    as_matvec,
    cast_matvec,
    global_length,
    safe_div,
    system_dtype,
)
from .eigh import (
    _block_matvec,
    _cos_start,
    _default_float,
    _is_matrix,
    _operator_dtype,
    _real,
    _row_norms,
    _start_device,
    lanczos_1r_sweep,
    lanczos_cgs2_sweep,
)

__all__ = ["eigs", "EigsResult"]


class EigsResult(NamedTuple):
    """Result of :func:`eigs` (the JAX package's types: ``resnorms`` a
    numpy array, ``niter`` and ``status`` Python ints)."""

    #: eigenvalue estimates, shape ``(k,)``, complex, sorted by ``which``
    theta: torch.Tensor
    #: eigenvectors as columns, shape ``(N, k)``, complex, unit norm
    U: torch.Tensor
    #: max wanted-pair residual per restart cycle
    resnorms: np.ndarray
    #: total Arnoldi steps (matvecs)
    niter: int
    #: CONVERGED / MAXITER
    status: int
    #: final explicit per-pair residuals ``||A u - theta u|| /
    #: max(|theta|, eps)``, shape ``(k,)``
    pair_resnorms: torch.Tensor

    @property
    def converged(self):
        return self.status == CONVERGED


def _selection_key(ev, which):
    if which == "lm":
        return -np.abs(ev)
    if which == "sm":
        return np.abs(ev)
    if which == "lr":
        return -ev.real
    if which == "sr":
        return ev.real
    if which == "li":
        return -ev.imag
    if which == "si":
        return ev.imag
    raise ValueError(
        f"unknown which={which!r}: expected one of "
        "'lm', 'sm', 'lr', 'sr', 'li', 'si'")


def eigs(
    A,
    k=6,
    *,
    v0=None,
    n=None,
    which="lm",
    maxdim=None,
    thick=None,
    tol=1e-8,
    max_restarts=100,
    sigma=None,
    inv=None,
    ortho="cgs2",
):
    r"""k eigenpairs of a general (non-Hermitian) operator by
    Krylov-Schur restarted Arnoldi.

    :param A: square operator (matvec callable, 2-D tensor or numpy
      array).
    :param k: number of wanted pairs.
    :param v0: start vector ``(N,)``; defaults to the deterministic
      start of :func:`~krypy_tpu_torch.functional.eigh.eigsh` (its
      device as there).
    :param n: problem size when ``A`` has no ``.shape`` and no ``v0``.
    :param which: ``'lm'`` (default), ``'sm'``, ``'lr'``, ``'sr'``,
      ``'li'`` or ``'si'``.
    :param maxdim: Krylov dimension m per cycle (default
      ``max(2k + 8, 24)``).
    :param thick: Schur vectors kept at each restart (default
      ``min(2k, m - 2)``).
    :param tol: ARPACK-style test :math:`|b^T z_i| \le \mathrm{tol}
      \cdot \max(|\theta_i|, \epsilon)` on the k wanted Schur vectors;
      ``pair_resnorms`` re-verify against A.
    :param max_restarts: restart cycles.
    :param sigma: shift-invert target (requires ``inv=``): the
      eigenvalues nearest ``sigma`` by Arnoldi on :math:`(A - \sigma
      I)^{-1}`, back-transformed and verified against A.
    :param inv: matvec applying :math:`(A - \sigma I)^{-1}` to the
      complex basis vectors.
    :param ortho: ``"cgs2"`` (default) or ``"cgs2_1r"`` (one all-reduce
      per Arnoldi step).
    :return: :class:`EigsResult`.
    """
    import scipy.linalg

    _selection_key(np.zeros(1, complex), which)  # validate early

    shift_invert = sigma is not None
    if shift_invert and inv is None:
        raise ValueError(
            "sigma= (shift-invert) requires inv=, a matvec applying "
            "(A - sigma I)^{-1}")
    if inv is not None and not shift_invert:
        raise ValueError("inv= is only meaningful together with sigma=")

    op_mv = as_matvec(inv if shift_invert else A)

    if v0 is not None:
        v0 = asarray(v0, device=_start_device(A)).reshape(-1)
        N = global_length(v0)
        base = system_dtype(v0)
        if _is_matrix(A):
            base = torch.promote_types(base, _operator_dtype(A))
    else:
        if n is None:
            shape = getattr(A, "shape", None)
            if shape is None:
                raise ValueError("n= or v0= required when A has no .shape")
            n = shape[0]
        N = int(n)
        v0 = _cos_start(N, _start_device(A))
        # no user dtype signal: the operator's dtype governs where it can
        # be probed
        base = _operator_dtype(A) or system_dtype(v0)
    base = _default_float(base)
    dtype = torch.promote_types(base, torch.complex64)
    real_dtype = _real(dtype)
    dev = v0.device

    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    m = min(N, max(2 * k + 8, 24)) if maxdim is None else min(int(maxdim), N)
    if k >= m - 1:
        raise ValueError(f"k={k} needs maxdim > k + 1 (have {m})")
    l = min(2 * k, m - 2) if thick is None else min(int(thick), m - 2)
    l = max(l, k)

    op_c = cast_matvec(op_mv, dtype)

    if ortho not in ("cgs2", "cgs2_1r"):
        raise ValueError(f"unknown eigs ortho {ortho!r}")
    sweep_fn = lanczos_1r_sweep if ortho == "cgs2_1r" else lanczos_cgs2_sweep
    key_which = "lm" if shift_invert else which

    def device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    v0 = v0.to(dtype)
    one = torch.ones((), dtype=real_dtype, device=dev)
    V = torch.zeros((m + 1, v0.shape[0]), dtype=dtype, device=dev)
    V[0] = v0 * safe_div(one, _row_norms(v0[None])[0])
    H = torch.zeros((m + 1, m + 1), dtype=dtype, device=dev)

    eps = float(torch.finfo(real_dtype).eps)
    resnorms = np.full(max_restarts, np.nan)
    j0, niter, status = 0, 0, MAXITER
    Tend = Zend = None

    for cycle in range(max_restarts):
        V, H = sweep_fn(op_c, V, H, j0, m, dtype, real_dtype)
        niter += m - j0
        Hh = H.cpu().numpy()  # the cycle's one host read
        Bm = Hh[:m, :m]
        b = Hh[m, :m]

        # dead (deflated) rows mark an invariant subspace: their
        # eigenvalues are spurious 0s
        live = np.concatenate(
            [np.ones(j0 + 1, bool), np.abs(np.diag(Hh, -1)[j0:m]) > 0])[:m]

        T, Z = scipy.linalg.schur(Bm, output="complex")
        ev = np.diag(T)
        dead_mass = (np.abs(Z) ** 2 * ~live[:, None]).sum(axis=0)
        key = _selection_key(ev, key_which)
        key = np.where(dead_mass > 0.5, np.inf, key)

        # reorder the l best to the front (LAPACK trsen via the sort
        # callable: select everything with key <= the l-th smallest)
        cutoff = np.sort(key)[min(l, m) - 1]
        T, Z, sdim = scipy.linalg.schur(
            Bm,
            output="complex",
            sort=lambda w: bool(
                _selection_key(np.asarray([w]), key_which)[0] <= cutoff),
        )
        lsel = int(min(max(sdim, k), m - 1))
        ev = np.diag(T)

        # ARPACK-style subspace residuals of the leading Schur vectors
        bz = np.abs(b @ Z[:, :lsel])
        res = bz / np.maximum(np.abs(ev[:lsel]), eps)
        worst = float(res[:k].max())
        resnorms[cycle] = worst
        if worst <= tol:
            status = CONVERGED
            Tend, Zend = T[:lsel, :lsel], Z[:, :lsel]
            break
        if cycle == max_restarts - 1:
            Tend, Zend = T[:lsel, :lsel], Z[:, :lsel]
            break

        # the static compression width l (the JAX package pads or trims
        # so that its compiled compression never retraces)
        w = min(lsel, l)
        Zl = np.zeros((m, l), complex)
        Zl[:, :w] = Z[:, :w]
        Tll = np.zeros((l, l), complex)
        Tll[:w, :w] = T[:w, :w]
        brow = np.zeros(l, complex)
        brow[:w] = (b @ Z[:, :lsel])[:w]
        Vn = torch.zeros_like(V)
        Vn[:l] = device(Zl).T @ V[:m]
        Vn[l] = V[m]
        Hn = torch.zeros_like(H)
        Hn[:l, :l] = device(Tll)
        Hn[l, :l] = device(brow)
        del V, H
        V, H = Vn, Hn
        j0 = l

    # final pairs: eigen-decompose the kept triangular block on the host,
    # pick the k wanted, assemble and verify on the device
    theta_s, Ys = np.linalg.eig(Tend)
    if shift_invert:
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = sigma + 1.0 / theta_s
        order = np.argsort(np.abs(lam - sigma))
    else:
        lam = theta_s
        order = np.argsort(_selection_key(lam, which))
    pick = order[:k]
    lam_k = lam[pick]
    Yk = Zend @ Ys[:, pick]  # back to the V[:m] coordinates

    th = device(lam_k)
    U = device(Yk).T @ V[:m]                       # (k, N) rows
    U = U * safe_div(one, _row_norms(U))[:, None]
    R = _block_matvec(A, dtype)(U) - th[:, None] * U
    den = torch.clamp(torch.abs(th).to(real_dtype),
                      min=torch.finfo(real_dtype).tiny ** 0.5)
    return EigsResult(
        theta=th,
        U=U.T,
        resnorms=resnorms[: cycle + 1],
        niter=niter,
        status=status,
        pair_resnorms=_row_norms(R) / den,
    )
