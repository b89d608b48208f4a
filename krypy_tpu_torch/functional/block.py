r"""Block solvers: one solve for multiple right-hand sides (counterpart of
:mod:`krypy_tpu.functional.block`).

* :func:`block_cg` -- classical block CG (O'Leary 1980) for SPD systems,
  with an eigenvalue-floor rank-collapse guard: converged or dependent
  columns stop moving while the rest keep the block-Krylov acceleration.
* :func:`block_gmres` -- block GMRES (Vital 1990): block Arnoldi with
  two-pass panel-blocked Gram-Schmidt, rank-guarded panel
  orthonormalization and a masked least squares per step.

The JAX package runs each solve as one ``lax.while_loop`` and applies the
operators to a panel through ``jax.vmap``.  Here the loop is a host loop
that reads one scalar per step (the worst column's residual), and a
matrix operator meets a panel in one product while any other operator is
applied one column at a time (the port's kernel wrappers take one vector
per launch: a panel of k columns is k launches of K1, or k V-cycles).
The small ``(k, k)`` eigendecompositions and the block QR of the
Hessenberg stay on the device.  Their eigenvectors differ from the JAX
package's by signs (and by the basis inside a degenerate eigenspace), so
the bases differ by those; iterates, residuals and counts agree.

Under an active mesh the panels are the ranks' row blocks, every product
over N is the rank's partial and one all-reduce, and the small matrices
are the same bits on every rank.
"""

import numpy as np
import torch

from .common import (
    BREAKDOWN,
    CONVERGED,
    MAXITER,
    SolveResult,
    as_matvec,
    cast_matvec,
    global_length,
    host_vectors,
    mesh_sum,
    system_dtype,
)
from .eigh import _is_matrix

__all__ = ["block_cg", "block_gmres"]


def _guarded_solve(G, rhs, floor_ratio):
    """Solve the Hermitian small system ``G a = rhs`` with an eigenvalue
    floor: eigenvalues below ``floor_ratio * lambda_max`` are treated as
    converged/dependent directions and their components zeroed."""
    Gh = 0.5 * (G + G.conj().T)
    w, V = torch.linalg.eigh(Gh)
    wmax = torch.clamp(torch.max(torch.abs(w)), min=1e-300)
    keep = w > floor_ratio * wmax
    winv = torch.where(keep, 1.0 / torch.where(keep, w, 1.0), 0.0)
    return V @ (winv[:, None].to(V.dtype) * (V.conj().T @ rhs))


def _columns(op, dtype):
    """``op`` lifted to ``(n, j)`` column panels in ``dtype``: a matrix in
    one product, any other operator one column at a time; ``None`` stays
    the identity."""
    if op is None:
        return lambda X: X
    if _is_matrix(op):
        mv = as_matvec(op)
        return lambda X: mv(X).to(dtype)
    mv = cast_matvec(as_matvec(op), dtype)
    return lambda X: torch.stack([mv(X[:, j].contiguous())
                                  for j in range(X.shape[1])], dim=1)


def _col_norms(X):
    """The 2-norms of the columns of ``X`` over the whole vectors."""
    return torch.sqrt(mesh_sum(torch.sum(torch.abs(X) ** 2, dim=0)))


def _block_rhs(B, X0, name):
    B, X0 = host_vectors(B, X0)
    if B.ndim != 2:
        raise ValueError(f"{name} expects B with shape (N, k)")
    dtype = system_dtype(B, X0)
    return B.to(dtype), X0, dtype


def block_cg(
    A,
    B,
    *,
    M=None,
    X0=None,
    tol=1e-5,
    maxiter=None,
    floor_ratio=1e-12,
):
    """Solve SPD ``A X = B`` for all columns of ``B`` simultaneously.

    :param B: right-hand sides, shape ``(N, k)``.
    :param M: optional SPD preconditioner (applied columnwise).
    :param tol: per-column relative residual target (Euclidean); the
      solve runs until EVERY column converges.
    :param maxiter: default N (a rank-deficient block converges like
      single-rhs CG, so ``ceil(N/k)`` is no safe bound); the per-column
      history is ``(maxiter+1, k)``.
    :param floor_ratio: relative eigenvalue floor of the direction Gram
      matrix below which directions are dropped (rank-collapse guard).
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult` with
      ``x`` of shape ``(N, k)`` and ``resnorms`` of shape
      ``(maxiter+1, k)`` (NaN beyond ``niter``).
    """
    B, X0, dtype = _block_rhs(B, X0, "block_cg")
    N, k = B.shape
    dev = B.device
    maxiter = global_length(B[:, 0]) if maxiter is None else int(maxiter)
    A_blk, M_blk = _columns(A, dtype), _columns(M, dtype)
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    np_real = torch.empty(0, dtype=real_dtype).numpy().dtype.type
    tol_r = np_real(tol)

    X = (torch.zeros((N, k), dtype=dtype, device=dev) if X0 is None
         else X0.to(dtype))
    bnorms = torch.clamp(_col_norms(B).to(real_dtype), min=1e-300)

    R = B - A_blk(X)
    Z = M_blk(R)
    P = Z
    rels = (_col_norms(R) / bnorms).to(real_dtype)
    resnorms = torch.full((maxiter + 1, k), float("nan"), dtype=real_dtype,
                          device=dev)
    resnorms[0] = rels
    max_rel = np_real(torch.max(rels).item())
    broken, it = False, 0

    while max_rel > tol_r and it < maxiter and not broken:
        Q = A_blk(P)
        PQ = mesh_sum(P.conj().T @ Q)
        PR = mesh_sum(P.conj().T @ R)
        alpha = _guarded_solve(PQ, PR, floor_ratio)
        X = X + P @ alpha
        R = R - Q @ alpha
        Z = M_blk(R)
        QZ = mesh_sum(Q.conj().T @ Z)
        beta = -_guarded_solve(PQ, QZ, floor_ratio)
        P = Z + P @ beta

        rels = (_col_norms(R) / bnorms).to(real_dtype)
        it += 1
        resnorms[it] = rels
        max_rel = np_real(torch.max(rels).item())
        broken = not np.isfinite(max_rel)

    status = CONVERGED if max_rel <= tol_r else (BREAKDOWN if broken
                                                 else MAXITER)
    return SolveResult(x=X, resnorms=resnorms,
                       niter=torch.tensor(it, device=dev),
                       status=torch.tensor(status, device=dev))


def _panel_orth(W, floor_ratio, real_dtype):
    """Orthonormalize the rows of ``W`` (k, N) with a rank guard.

    Returns ``(Q, L)`` with ``W = L Q``, Q's rows orthonormal and rows of
    collapsed directions exactly zero: the Hermitian eigendecomposition
    of the small row Gram ``G = conj(W) W^T = U diag(w) U^H`` (the block
    analog of CholQR), ``Q = diag(w^-1/2) U^T W`` and ``L = conj(U)
    diag(w^1/2)``; applied twice by the caller.
    """
    G = mesh_sum(W.conj() @ W.T)
    w, U = torch.linalg.eigh(0.5 * (G + G.conj().T))
    w = torch.clamp(w.to(real_dtype), min=0.0)
    wmax = torch.clamp(torch.max(w), min=1e-300)
    keep = w > floor_ratio * wmax
    sq = torch.sqrt(torch.where(keep, w, 1.0))
    inv = torch.where(keep, 1.0 / sq, 0.0).to(W.dtype)
    Q = inv[:, None] * (U.T @ W)
    L = U.conj() * torch.where(keep, sq, 0.0).to(W.dtype)[None, :]
    return Q, L


def block_gmres(
    A,
    B,
    *,
    Ml=None,
    Mr=None,
    X0=None,
    tol=1e-5,
    maxiter=None,
    floor_ratio=1e-12,
    return_internal=False,
):
    r"""Solve ``A X = B`` for all columns of ``B`` with block GMRES.

    Each step applies the operator to a (k, N) panel, orthogonalizes it
    against the basis with two passes of panel-blocked Gram-Schmidt (only
    panels holding active rows), and orthonormalizes it by a rank-guarded
    Gram eigendecomposition; an incremental block QR of the Hessenberg
    (the accumulated transform and one local ``(2k, k)`` QR per step)
    keeps every column's least-squares residual.

    :param B: right-hand sides, shape ``(N, k)``.
    :param Ml, Mr: left/right preconditioners (Euclidean inner product).
    :param tol: per-column relative residual target; the solve runs until
      EVERY column converges.
    :param maxiter: BLOCK steps (default ``max(1, N // k)``); the basis is
      ``((maxiter+1)*k, N)``.
    :return: :class:`~krypy_tpu_torch.functional.common.SolveResult` with
      ``x`` of shape ``(N, k)``, ``resnorms`` of shape ``(maxiter+1, k)``
      and ``niter`` counting block steps; with ``return_internal`` also
      ``{"V", "H", "Y"}``.
    """
    B, X0, dtype = _block_rhs(B, X0, "block_gmres")
    N, k = B.shape
    dev = B.device
    m = (max(1, global_length(B[:, 0]) // k) if maxiter is None
         else int(maxiter))
    K = (m + 1) * k
    A_blk, Ml_blk, Mr_blk = (_columns(f, dtype) for f in (A, Ml, Mr))
    real_dtype = torch.empty(0, dtype=dtype).real.dtype
    np_real = torch.empty(0, dtype=real_dtype).numpy().dtype.type
    tol_r = np_real(tol)

    def op_rows(P):
        """Ml A Mr on each ROW of a (k, N) panel."""
        return Ml_blk(A_blk(Mr_blk(P.T))).T

    X0v = (torch.zeros((N, k), dtype=dtype, device=dev) if X0 is None
           else X0.to(dtype))
    MlB = Ml_blk(B)
    bnorms = torch.clamp(_col_norms(MlB).to(real_dtype), min=1e-300)
    R0 = MlB if X0 is None else MlB - Ml_blk(A_blk(X0v))

    # the initial panel: with the row-form factorization R0^T = S0 Q0 the
    # column-form coordinates of R0 over the basis are S0^T
    Q0, S0 = _panel_orth(R0.T, floor_ratio, real_dtype)
    V = torch.zeros((K, N), dtype=dtype, device=dev)
    V[:k] = Q0
    H = torch.zeros((K, m * k), dtype=dtype, device=dev)
    R = torch.zeros((K, m * k), dtype=dtype, device=dev)
    Qacc = torch.eye(K, dtype=dtype, device=dev)
    g = torch.zeros((K, k), dtype=dtype, device=dev)
    g[:k] = S0.T

    rels = (_col_norms(R0) / bnorms).to(real_dtype)
    resnorms = torch.full((m + 1, k), float("nan"), dtype=real_dtype,
                          device=dev)
    resnorms[0] = rels
    max_rel = np_real(torch.max(rels).item())
    pr = max(1, min(32, K))
    rows = torch.arange(K, device=dev)
    broken, it = False, 0

    while max_rel > tol_r and it < m and not broken:
        row0 = it * k
        W = op_rows(V[row0:row0 + k])

        # two passes of panel-blocked Gram-Schmidt against active rows
        C = torch.zeros((K, k), dtype=dtype, device=dev)
        active_panels = (row0 + k - 1) // pr + 1
        for _ in range(2):
            for p in range(active_panels):
                start = min(p * pr, K - pr)
                Vp = V[start:start + pr]
                ridx = rows[start:start + pr]
                rmask = ((ridx >= p * pr) & (ridx < row0 + k)).to(
                    real_dtype)
                coeffs = mesh_sum(Vp.conj() @ W.T) * rmask[:, None]
                W = W - coeffs.T @ Vp
                C[start:start + pr] += coeffs

        # rank-guarded panel orthonormalization, twice
        Q1, L1 = _panel_orth(W, floor_ratio, real_dtype)
        Qp, L2 = _panel_orth(Q1, floor_ratio, real_dtype)
        Lfac = L1 @ L2                                    # W = Lfac Qp
        V[row0 + k:row0 + 2 * k] = Qp

        # the Hessenberg's block column: C, and Lfac^T at block row it+1
        hcol = C
        hcol[row0 + k:row0 + 2 * k] = Lfac.T
        H[:, row0:row0 + k] = hcol

        # incremental block QR: the accumulated transform, then a local
        # (2k, 2k) QR zeroes the subdiagonal block
        col = Qacc @ hcol
        qt, rt = torch.linalg.qr(col[row0:row0 + 2 * k], mode="complete")
        col[row0:row0 + 2 * k] = rt
        R[:, row0:row0 + k] = col
        qh = qt.conj().T
        Qacc[row0:row0 + 2 * k] = qh @ Qacc[row0:row0 + 2 * k]
        g[row0:row0 + 2 * k] = qh @ g[row0:row0 + 2 * k]

        # per-column LS residuals: column norms of the rotated rhs tail
        tail = torch.linalg.vector_norm(g[row0 + k:], dim=0)
        rels = tail.to(real_dtype) / bnorms
        it += 1
        resnorms[it] = rels
        max_rel = np_real(torch.max(rels).item())
        broken = not np.isfinite(max_rel)

    # minimum-norm LS coefficients: columns past the live ones and
    # collapsed directions (exactly-zero R diagonals) are bumped to 1 and
    # their Y rows zeroed
    mk = m * k
    Rk = R[:mk, :mk]
    dead = (rows[:mk] >= it * k) | (torch.abs(torch.diagonal(Rk)) == 0)
    Rk = Rk + torch.diag(dead.to(dtype))
    rhs = torch.where((rows[:mk] < it * k)[:, None], g[:mk], 0.0)
    Y = torch.linalg.solve_triangular(Rk, rhs, upper=True)
    Y = torch.where(dead[:, None], 0.0, Y)
    X = X0v + Mr_blk(V[:mk].T @ Y)

    status = CONVERGED if max_rel <= tol_r else (BREAKDOWN if broken
                                                 else MAXITER)
    result = SolveResult(x=X, resnorms=resnorms,
                         niter=torch.tensor(it, device=dev),
                         status=torch.tensor(status, device=dev))
    if return_internal:
        return result, {"V": V, "H": H, "Y": Y}
    return result
