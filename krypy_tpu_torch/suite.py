"""Ritz-deflated and recycling GMRES on the shifted Laplacian (counterpart
of benchmarks/suite.py's config 4, "DeflatedGmres with ObliqueProjection +
Ritz vectors on shifted Laplacian", in the north star's equilibrated,
multigrid-preconditioned form, which is what lets it run at the north
star's size).

The system is ``(Lap - sigma I) x = ones`` on an nx x nx Dirichlet grid,
``sigma = 200``: indefinite, with a handful of eigenvalues below the
shift.  The float32 inner system is scaled by h^2 (stencil ``(4 - sigma
h^2, -1, -1, -1, -1)`` on the grid-padded layout) and left-preconditioned
by the padded multigrid V-cycle of the Laplacian; the preconditioned
spectrum is then clustered at 1 apart from the outliers ``1 - sigma /
lambda`` of the lowest Laplacian modes, the same at every grid size, which
Ritz deflation removes.

    harvest, make_solve, A64 = make_config4(4095, "cuda", "cgs2_pallas")
    res0, U, theta = harvest()          # step 1: plain GMRES, Ritz vectors
    result, info = make_solve(U)(torch.ones(4095 ** 2, dtype=torch.float64,
                                            device="cuda"))   # step 2
    runs = recycling_sequence(4095, "cuda", "cgs2_pallas")    # step 3
"""

import numpy as np
import torch

from . import functional as F, ops

__all__ = ["SIGMA", "SIGMAS", "N_VECTORS", "INNER_TOL", "RESTART", "TOL",
           "kappa_bound", "make_config4", "recycling_sequence"]

#: the shift of config 4
SIGMA = 200.0
#: the shifts of the recycling sequence
SIGMAS = (200.0, 202.0, 204.0, 206.0)
#: Ritz vectors deflated / recycled
N_VECTORS = 6
#: tolerance and length of one float32 GMRES cycle
INNER_TOL = 1e-4
RESTART = 25
#: float64 true relative residual of the refined solve
TOL = 1e-8


def kappa_bound(nx, sigma=SIGMA):
    """The 2-norm condition number of the float64 operator ``Lap - sigma
    I`` (symmetric, eigenvalues ``lambda_pq - sigma`` with ``lambda_pq =
    4 (sin^2(p pi h / 2) + sin^2(q pi h / 2)) / h^2``): the largest over
    the smallest ``|lambda_pq - sigma|``, found among the modes below
    ``p, q <= 64`` (the Laplacian's eigenvalues grow past the shift long
    before).  It turns two iterates' residuals into a bound on their
    distance."""
    h = 1.0 / (nx + 1)
    k = np.arange(1, min(nx, 64) + 1)
    s = 4.0 * np.sin(k * np.pi * h / 2) ** 2 / h ** 2
    lam = s[:, None] + s[None, :]
    lam_max = 8.0 * np.cos(np.pi * h / 2) ** 2 / h ** 2
    return float((lam_max - sigma) / np.abs(lam - sigma).min())


def _system(nx, sigma, impl, device, dtype=torch.float32):
    """The h^2-equilibrated inner operator on the grid-padded layout (K1
    with ``impl="cuda"`` on float32) and its right-hand side ``h^2 ones``
    in ``dtype``."""
    h2 = (1.0 / (nx + 1)) ** 2
    A32, _, _ = ops._padded_stencil_matvec(
        nx, nx, (4.0 - sigma * h2, -1.0, -1.0, -1.0, -1.0), impl)
    # the float32 scale of the inner system, as the north star's
    h2_f32 = float(np.float32(h2))
    b32 = ops.pad_grid_vec(
        torch.full((nx * nx,), h2_f32, dtype=dtype, device=device),
        nx, nx)
    return A32, b32, h2_f32


def _multigrid(nx, impl, device):
    """The padded V-cycle of the Laplacian, scaled by 1/h^2 to match the
    equilibrated system."""
    h2 = (1.0 / (nx + 1)) ** 2
    return ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
        scale=1.0 / h2, device=device)


def make_config4(nx, impl, ortho, device="cuda", dtype=torch.float32):
    """The config-4 pipeline on an ``nx``-grid: ``impl="cuda"`` runs K1-K3
    in the matvec and the V-cycle, ``impl="torch"`` their plain versions;
    ``ortho`` is GMRES's scheme (``"cgs2_pallas"`` runs K7); ``dtype`` is
    the inner solves' arithmetic (float32 is the configuration; float64
    on the plain lane serves as a witness of what float32 costs).  Returns
    ``(harvest, make_solve, A64)``:

    * ``harvest() -> (res0, U, theta)``: one float32 GMRES(25) cycle to
      the inner tolerance with ``return_internal``, then the
      ``min(N_VECTORS, niter - 1)`` Ritz vectors of smallest magnitude
      (``Ml A`` is not symmetric in the Euclidean product, so
      ``hermitian=False``).  The harvest stops at the inner tolerance, so
      that only the clean leading Krylov directions enter it.  ``theta``
      are all Ritz values, sorted by magnitude; ``U`` is None when there
      is nothing to deflate.
    * ``make_solve(U) -> solve(b) -> (result, info)``: float64 iterative
      refinement to ``TOL`` around one float32 cycle per refinement step:
      ``deflated_gmres`` with basis ``U``, or plain ``gmres`` for ``U =
      None`` (the undeflated comparison); ``solve.inner`` is that one
      float32 cycle, residual in, correction out.
    * ``A64``: the float64 outer operator (unpadded).
    """
    device = ops._device(device)
    A32, b32, h2_f32 = _system(nx, SIGMA, impl, device, dtype)
    Ml = _multigrid(nx, impl, device)
    A64 = ops.shifted_laplacian_2d(nx, sigma=SIGMA, device=device)
    kw = dict(Ml=Ml, tol=INNER_TOL, maxiter=RESTART, ortho=ortho)

    def harvest():
        res0, internals = F.gmres(A32, b32, return_internal=True, **kw)
        niter = int(res0.niter)
        internals["niter"] = niter
        theta = F.ritz_pairs(internals, hermitian=False)[0]
        theta = theta[np.argsort(np.abs(theta))]
        d_eff = min(N_VECTORS, max(niter - 1, 0))
        if d_eff == 0:
            return res0, None, theta
        U = F.ritz_deflation_vectors(internals, n_vectors=d_eff,
                                     which="sm", hermitian=False)
        return res0, U, theta

    def make_solve(U):
        def inner(r32):
            rs = ops.pad_grid_vec(r32 * h2_f32, nx, nx)
            if U is None:
                res = F.gmres(A32, rs, **kw)
            else:
                res = F.deflated_gmres(A32, rs, U, **kw)
            return res._replace(x=ops.unpad_grid_vec(res.x, nx, nx))

        def solve(b):
            return F.refine_to(A64, b, inner, tol=TOL, compiled=True,
                               inner_dtype=dtype)

        solve.inner = inner
        return solve

    return harvest, make_solve, A64


def recycling_sequence(nx, impl, ortho, device="cuda", recycle=True,
                       dtype=torch.float32):
    """The four systems ``sigma in SIGMAS`` (in ``dtype``, float32 being
    the configuration) with the same V-cycle and right-hand side, each
    solved by one GMRES(25) cycle to ``INNER_TOL``: through ``RecyclingGmres(N_VECTORS, "sm",
    hermitian=False)``, which deflates each solve with Ritz vectors of the
    one before, or, with ``recycle=False``, by plain ``gmres``.  Returns
    one dictionary per system: ``sigma``, ``niter``, ``status``,
    ``rel_prec``, the true relative residual ``|Ml (b - A x)| / |Ml b|``
    of the preconditioned system, which is what the solves stop on, and
    ``rel``, the true relative residual ``|b - A x| / |b|`` of the
    UNpreconditioned one, both in the solve's own arithmetic."""
    device = ops._device(device)
    Ml = _multigrid(nx, impl, device)
    rec = F.RecyclingGmres(n_vectors=N_VECTORS, which="sm", hermitian=False)
    kw = dict(Ml=Ml, tol=INNER_TOL, maxiter=RESTART, ortho=ortho)
    runs = []
    for sigma in SIGMAS:
        A32, b32, _ = _system(nx, sigma, impl, device, dtype)
        res = rec.solve(A32, b32, **kw) if recycle else F.gmres(A32, b32,
                                                                **kw)
        r = b32 - A32(res.x)
        rel = torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b32)
        rel_prec = torch.linalg.vector_norm(Ml(r)) / \
            torch.linalg.vector_norm(Ml(b32))
        runs.append({"sigma": sigma, "niter": int(res.niter),
                     "status": int(res.status),
                     "rel_prec": float(rel_prec), "rel": float(rel)})
    return runs
