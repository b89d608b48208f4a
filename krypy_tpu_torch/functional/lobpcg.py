r"""LOBPCG: locally optimal block preconditioned conjugate gradient
(counterpart of :mod:`krypy_tpu.functional.lobpcg`).

Computes the k algebraically smallest (or largest) eigenpairs of a
Hermitian :math:`A`, or of the Hermitian-definite pencil :math:`A x =
\lambda B x`, by LOBPCG (Knyazev 2001) in the basis-orthonormalized
variant (Hetmaniuk & Lehoucq; Duersch et al. 2018): the trial basis
``S = [X; W; P]`` is kept B-orthonormal by CGS2 projection against X
and a two-pass SVQB of ``[W; P]``, so the Rayleigh-Ritz problem is an
ordinary Hermitian ``eigh``; dead directions deflate to ZERO rows and
converged pairs are soft-locked.  ``variant="fused"`` runs the whole
advance on three stacked cross-Grams (one all-reduce each on a mesh)
plus the residual check.

The JAX package's ``lax.while_loop`` is a host loop here that reads one
flag per iteration, the convergence test; the panels, Grams and the
small eigendecompositions (``torch.linalg.eigh``, on the device, in the
system dtype) read nothing back.  Operators are applied to the ``(k,
N)`` row blocks one row at a time (the JAX package's ``jax.vmap``).
Under an active mesh each Gram and row norm is the local partial plus
one all-reduce; ``variant="auto"`` picks ``"fused"`` under a mesh of
more than one rank (:func:`krypy_tpu_torch.parallel.active_mesh_size`).
"""

from typing import NamedTuple

import torch

from ..core.dtypes import asarray
from .common import (
    CONVERGED,
    MAXITER,
    as_matvec,
    breakdown_threshold,
    cast_matvec,
    global_length,
    mesh_sum,
    safe_div,
    system_dtype,
)
from .eigh import (
    _block_matvec,
    _cos_block,
    _default_float,
    _eps_floor,
    _gram,
    _hermitian_eigh,
    _opnorm,
    _operator_dtype,
    _real,
    _row_norms,
    _start_device,
    _svqb_transform,
    spurious_ritz_mask,
)

__all__ = ["lobpcg", "LobpcgResult"]


class LobpcgResult(NamedTuple):
    """Result of :func:`lobpcg`; every field is a tensor."""

    #: eigenvalue estimates, shape ``(k,)``, sorted by ``which``
    theta: torch.Tensor
    #: Ritz vectors as columns, shape ``(N, k)``, B-orthonormal
    U: torch.Tensor
    #: max relative residual of the k pairs per iteration
    resnorms: torch.Tensor
    #: Rayleigh-Ritz iterations performed
    niter: torch.Tensor
    #: CONVERGED / MAXITER
    status: torch.Tensor
    #: final per-pair relative residuals, shape ``(k,)``
    pair_resnorms: torch.Tensor = None

    @property
    def converged(self):
        return bool(self.status == CONVERGED)


def _selection_key(theta, which):
    if which == "sa":
        return theta
    if which == "la":
        return -theta
    raise ValueError(
        f"which={which!r}: LOBPCG finds extremal pairs only "
        "('sa'/'la'); for interior eigenvalues use eigsh(sigma=...)")


def lobpcg(
    A,
    k=6,
    *,
    X0=None,
    n=None,
    B=None,
    M=None,
    which="sa",
    tol=1e-8,
    maxiter=500,
    lock=True,
    criterion="rel",
    variant="classic",
):
    r"""k extremal eigenpairs of Hermitian ``A`` (or of the pencil
    ``(A, B)`` with SPD ``B``) by preconditioned LOBPCG.

    :param A: Hermitian operator (matvec callable, 2-D tensor or numpy
      array).
    :param k: number of wanted pairs (the trial space has ``3k``
      directions).
    :param X0: starting block ``(N, k)``; defaults to the deterministic
      block of rows ``cos(idx * (0.7391 + 0.1137 i)) + 0.01 (i + 1)``
      (its device as :func:`~krypy_tpu_torch.functional.eigh.eigsh`'s
      start).
    :param n: problem size when ``A`` has no ``.shape`` and no ``X0``.
    :param B: SPD operator of the generalized problem (no ``B^{-1}``
      needed).
    :param M: preconditioner applied to residuals, approximating
      :math:`A^{-1}` (SPD).
    :param which: ``'sa'`` (default) or ``'la'``.
    :param tol: per-pair test :math:`\|A u - \theta B u\| \le
      \mathrm{tol}\cdot\max(|\theta| \|B u\|, \epsilon)`.
    :param maxiter: Rayleigh-Ritz iterations.
    :param lock: soft-lock converged pairs (zero their residual rows
      before preconditioning).
    :param criterion: ``'rel'`` (default) or ``'backward'``
      (:math:`\|A u - \theta B u\| / ((\|A\| + |\theta| \|B\|) \|u\|)`,
      the norms by an 8-step power iteration at setup).
    :param variant: ``"classic"``, ``"fused"`` (three stacked
      cross-Grams per advance; standard problems only) or ``"auto"``
      (``"fused"`` under a mesh of more than one rank and ``B=None``).
    :return: :class:`LobpcgResult`.
    """
    if criterion not in ("rel", "backward"):
        raise ValueError(
            f"criterion={criterion!r}: expected 'rel' or 'backward'")
    if variant == "auto":
        from ..parallel import active_mesh_size

        variant = ("fused" if active_mesh_size() > 1 and B is None
                   else "classic")
    if variant not in ("classic", "fused"):
        raise ValueError(f"unknown lobpcg variant {variant!r}")
    if variant == "fused" and B is not None:
        raise ValueError(
            "variant='fused' supports standard problems only (B=None); "
            "use variant='classic' for the generalized pencil")
    fused = variant == "fused"
    A_mv = as_matvec(A)
    generalized = B is not None
    B_mv = as_matvec(B) if generalized else None

    if X0 is not None:
        X0 = asarray(X0, device=_start_device(A))
        if X0.ndim != 2:
            raise ValueError(f"X0 must be (N, k), got shape "
                             f"{tuple(X0.shape)}")
        N = global_length(X0[:, 0])
        k = int(X0.shape[1])
    else:
        if n is None:
            shape = getattr(A, "shape", None)
            if shape is None:
                raise ValueError("n= or X0= required when A has no .shape")
            n = shape[0]
        N = int(n)
        k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if 3 * k > N:
        raise ValueError(
            f"trial space needs 3k <= N (k={k}, N={N}); "
            "use a dense eigensolver at this size")

    if X0 is None:
        X = _cos_block(N, k, _start_device(A))
        # the operator's dtype must win over the (real) default start
        op_dt = _operator_dtype(A)
        if op_dt is not None and op_dt.is_complex:
            X = X.to(op_dt)
    else:
        X = X0.T

    dtype = _default_float(system_dtype(X))
    real_dtype = _real(dtype)
    X = X.to(dtype).contiguous()       # (k, N) rows
    dev = X.device

    A_mv = cast_matvec(A_mv, dtype)
    A_blk = _block_matvec(A, dtype)
    if generalized:
        B_mv = cast_matvec(B_mv, dtype)
        B_blk = _block_matvec(B, dtype)
    M_blk = None if M is None else _block_matvec(M, dtype)

    _selection_key(torch.zeros(1), which)  # validate early

    brk = breakdown_threshold(dtype)
    eps_floor = _eps_floor(real_dtype, dev)
    eps = float(torch.finfo(real_dtype).eps)

    def bx_of(Xr, BXr):
        return BXr if generalized else Xr

    def b_svqb2(Z, AZ, BZ):
        """Two-pass SVQB of the rows of Z in the B-inner product, mirrored
        on the carried A- and B-images; rows with a negligible Gram
        diagonal leave the trial space first, and rank-deficient
        directions are dropped inside the factorization (both to exact
        zero rows)."""
        j = Z.shape[0]
        for _ in range(2):
            d = mesh_sum(torch.sum(Z.conj() * bx_of(Z, BZ), dim=1).real)
            alive = (d > (64.0 * eps) * torch.sum(d) / j).to(real_dtype)
            Z = Z * alive[:, None]
            AZ = AZ * alive[:, None]
            if generalized:
                BZ = BZ * alive[:, None]
            G = _gram(Z, bx_of(Z, BZ))
            G = 0.5 * (G + G.conj().T)
            T, _ = _svqb_transform(G, eps, real_dtype, dtype)
            Z, AZ = T @ Z, T @ AZ
            if generalized:
                BZ = T @ BZ
        return Z, AZ, BZ

    def project_against(Z, AZ, BZ, Xr, AXr, BXr):
        """CGS2-project the rows of Z B-orthogonal to the B-orthonormal
        rows of Xr, mirrored on the images."""
        for _ in range(2):
            C = _gram(bx_of(Xr, BXr), Z)     # C[i, j] = <x_i, z_j>_B
            Z = Z - C.T @ Xr
            AZ = AZ - C.T @ AXr
            if generalized:
                BZ = BZ - C.T @ BXr
        return Z, AZ, BZ

    def kill_tiny_rows(Z, AZ, BZ, ref):
        """Zero rows whose post-projection norm collapsed below the
        breakdown threshold relative to their pre-projection size."""
        alive = (_row_norms(Z) > brk * ref).to(real_dtype)
        Z, AZ = Z * alive[:, None], AZ * alive[:, None]
        if generalized:
            BZ = BZ * alive[:, None]
        return Z, AZ, BZ

    def rayleigh_ritz(S, AS):
        """Hermitian RR on the basis rows of S (B-orthonormal by
        construction); dead rows sort last via the spurious mask."""
        theta, C = _hermitian_eigh(_gram(S, AS))
        spurious = spurious_ritz_mask(S, C)
        key = torch.where(spurious, torch.inf, _selection_key(theta, which))
        order = torch.argsort(key, stable=True)
        return theta[order].to(real_dtype), C[:, order]

    # ---- initial block: B-orthonormalize, then RR on X alone --------
    AX0 = A_blk(X)
    BX0 = B_blk(X) if generalized else None
    X, AX0, BX0 = b_svqb2(X, AX0, BX0)
    theta0, C0 = rayleigh_ritz(X, AX0)
    Ck = C0[:, :k]
    X, AX = Ck.T @ X, Ck.T @ AX0
    BX = Ck.T @ BX0 if generalized else None
    theta = theta0[:k]

    P = torch.zeros_like(X)
    AP = torch.zeros_like(X)
    BP = torch.zeros_like(X) if generalized else None

    hist = torch.full((maxiter + 1,), float("nan"), dtype=real_dtype,
                      device=dev)
    tol_t = torch.tensor(tol, dtype=real_dtype, device=dev)

    if criterion == "backward":
        anorm = _opnorm(A_mv, N, dtype, dev).to(real_dtype)
        bnorm = (_opnorm(B_mv, N, dtype, dev).to(real_dtype) if generalized
                 else torch.ones((), dtype=real_dtype, device=dev))

    def pair_res(Xr, AXr, BXr, th):
        R = AXr - th[:, None].to(dtype) * bx_of(Xr, BXr)
        num = _row_norms(R)
        if criterion == "backward":
            den = (anorm + torch.abs(th) * bnorm) * _row_norms(Xr)
        elif generalized:
            den = torch.abs(th) * _row_norms(BXr)
        else:
            den = torch.abs(th)  # ||x||_2 = 1 in the standard case
        return R, num / torch.maximum(den, eps_floor)

    def advance_fused(R, res, X, AX, P, AP):
        """Three stacked cross-Grams for the whole advance, every small
        factor replicated, every (*, N) operation a local GEMM/axpy."""
        Rm = R * (res > tol_t)[:, None].to(real_dtype) if lock else R
        W = M_blk(Rm) if M_blk is not None else Rm
        AW = A_blk(W)

        # sync 1: projection pass 1 + the pre-projection norms
        R2 = torch.cat([W, P])
        G2 = _gram(torch.cat([X, W, P]), R2)
        C1 = torch.cat([G2[:k, :k], G2[:k, k:]], dim=1)
        ref = torch.sqrt(torch.clamp(torch.cat([
            torch.diagonal(G2[k:2 * k, :k]).real,
            torch.diagonal(G2[2 * k:, k:]).real]), min=0.0))
        Up1 = R2 - C1.T @ X
        AUp1 = torch.cat([AW, AP]) - C1.T @ AX

        # sync 2: projection pass 2 + the SVQB pass-1 Gram (G1 = Gp1 -
        # C2^H C2, X being B-orthonormal)
        G3 = _gram(torch.cat([X, Up1]), Up1)
        C2, Gp1 = G3[:k], G3[k:]
        U1 = Up1 - C2.T @ X
        AU1 = AUp1 - C2.T @ AX
        G1 = Gp1 - C2.conj().T @ C2
        G1 = 0.5 * (G1 + G1.conj().T)
        d1 = torch.clamp(torch.diagonal(G1).real, min=0.0)
        alive1 = (d1 > (64.0 * eps) * torch.sum(d1) / G1.shape[0]) & (
            torch.sqrt(d1) > brk * ref)
        T1, _ = _svqb_transform(G1, eps, real_dtype, dtype, alive=alive1)
        U2, AU2 = T1 @ U1, T1 @ AU1

        # sync 3: the SVQB pass-2 Gram + every Rayleigh-Ritz block
        G4 = _gram(torch.cat([X, U2]), torch.cat([U2, AX, AU2]))
        Gu = 0.5 * (G4[k:, :2 * k] + G4[k:, :2 * k].conj().T)
        d2 = torch.clamp(torch.diagonal(Gu).real, min=0.0)
        alive2 = d2 > (64.0 * eps) * torch.sum(d2) / Gu.shape[0]
        T2, keep2 = _svqb_transform(Gu, eps, real_dtype, dtype,
                                    alive=alive2)
        Gxa = G4[:k, 2 * k:3 * k]
        Gxau = G4[:k, 3 * k:] @ T2.T
        Guau = (T2.conj() @ G4[k:, 3 * k:]) @ T2.T
        Grr = torch.cat([torch.cat([Gxa, Gxau], dim=1),
                         torch.cat([Gxau.conj().T, Guau], dim=1)])
        th_all, C = _hermitian_eigh(Grr)
        # the spurious mask from the transform's structure
        live = torch.cat([torch.ones(k, dtype=torch.bool, device=dev),
                          keep2])
        dead_mass = torch.sum(torch.abs(C) ** 2
                              * (~live)[:, None].to(real_dtype), dim=0)
        key = torch.where(dead_mass > 0.5, torch.inf,
                          _selection_key(th_all.to(real_dtype), which))
        order = torch.argsort(key, stable=True)
        th = th_all[order].to(real_dtype)
        C = C[:, order]

        U3, AU3 = T2 @ U2, T2 @ AU2
        S, AS = torch.cat([X, U3]), torch.cat([AX, AU3])
        Cx, Cu = C[:, :k], C[k:, :k]
        return (Cx.T @ S, Cx.T @ AS, None, Cu.T @ U3, Cu.T @ AU3, None,
                th[:k])

    def advance(R, res, X, AX, BX, P, AP, BP):
        # soft locking: converged pairs contribute no search direction,
        # but stay in X and the RR basis
        Rm = R * (res > tol_t)[:, None].to(real_dtype) if lock else R
        W = M_blk(Rm) if M_blk is not None else Rm
        wref = _row_norms(W)
        AW = A_blk(W)
        BW = B_blk(W) if generalized else None
        W, AW, BW = project_against(W, AW, BW, X, AX, BX)
        W, AW, BW = kill_tiny_rows(W, AW, BW, wref)
        pref = _row_norms(P)
        Pp, APp, BPp = project_against(P, AP, BP, X, AX, BX)
        Pp, APp, BPp = kill_tiny_rows(Pp, APp, BPp, pref)
        U, AU = torch.cat([W, Pp]), torch.cat([AW, APp])
        BU = torch.cat([BW, BPp]) if generalized else None
        U, AU, BU = b_svqb2(U, AU, BU)

        S, AS = torch.cat([X, U]), torch.cat([AX, AU])
        th, C = rayleigh_ritz(S, AS)
        Cx, Cu = C[:, :k], C[k:, :k]
        Xn, AXn = Cx.T @ S, Cx.T @ AS
        BXn = Cx.T @ torch.cat([BX, BU]) if generalized else None
        # the next conjugate direction is the W/P part of the update
        Pn, APn = Cu.T @ U, Cu.T @ AU
        BPn = Cu.T @ BU if generalized else None
        return Xn, AXn, BXn, Pn, APn, BPn, th[:k]

    it = 0
    while True:
        R, res = pair_res(X, AX, BX, theta)
        wres = torch.max(res)
        hist[it] = wres
        if bool(wres <= tol_t) or it >= maxiter:  # the iteration's read
            break
        if fused:
            X, AX, BX, P, AP, BP, theta = advance_fused(R, res, X, AX, P, AP)
        else:
            X, AX, BX, P, AP, BP, theta = advance(R, res, X, AX, BX, P, AP,
                                                  BP)
        it += 1

    # the final report (the JAX loop's last body and its final report
    # compute the same residuals of the same block)
    status = torch.where(wres <= tol_t, CONVERGED, MAXITER).to(torch.int64)
    return LobpcgResult(
        theta=theta,
        U=X.T,
        resnorms=hist,
        niter=torch.tensor(it, dtype=torch.int64, device=dev),
        status=status,
        pair_resnorms=res,
    )
