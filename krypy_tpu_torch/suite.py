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

Beside it, BASELINE configs 1-3 as benchmarks/suite.py runs them
(:func:`config1_readme_gmres`, :func:`make_config2`,
:func:`make_config3`): GMRES on the README diagonal; CG and MINRES on the
2-D Poisson operator weighted by ``w = linspace(1, 2, N)``, with the
unpadded V-cycle of ``w r`` and the inner product ``<x, w y>``; and
restarted GMRES(30) with ``Ml`` (the V-cycle), ``M`` and ``Mr`` on
convection-diffusion; configs 2 and 3 in float64 refinement to 1e-8.
And config 5 (:func:`config5_nls_newton_recycling`): Newton-Krylov on
the stationary nonlinear-Schrödinger residual with recycled Jacobian
solves, the Jacobian action ``torch.func.jvp`` (K1 and its forward-mode
rule with ``impl="cuda"``).
"""

import time

import numpy as np
import torch

from . import functional as F, interop, ops

__all__ = ["SIGMA", "SIGMAS", "N_VECTORS", "INNER_TOL", "RESTART", "TOL",
           "kappa_bound", "make_config4", "recycling_sequence",
           "config1_readme_gmres", "config2_weights", "make_config2",
           "make_config3", "config5_nls_newton_recycling"]

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


# ---------------------------------------------------------------------------
# BASELINE configs 1-3 (benchmarks/suite.py:47-151)
# ---------------------------------------------------------------------------

#: inner tolerance of configs 2 and 3, and config 2's iteration cap and
#: stagnation window
C23_INNER_TOL = 1e-4
C2_MAXITER = 200
C2_STAGNATION = 20
#: config 3's restart length and restarts
C3_RESTART = 30
C3_MAX_RESTARTS = 10


def config1_readme_gmres(device="cuda"):
    """Config 1: GMRES (tol 1e-8, maxiter 100) on the README system
    ``diag(1e-3, 2, ..., 100) x = ones`` in float64; returns the JSON
    record of benchmarks/suite.py (``niter``, ``converged``, ``wall_s``:
    the best of 3 solves after one warm-up)."""
    device = ops._device(device)
    A = ops.readme_diag(100, device=device)
    b = torch.ones(100, dtype=torch.float64, device=device)
    res = F.gmres(A, b, tol=1e-8, maxiter=100)
    wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = F.gmres(A, b, tol=1e-8, maxiter=100)
        niter = int(res.niter)  # the read synchronises
        wall = min(wall, time.perf_counter() - t0)
    return {"config": "1_readme_gmres", "niter": niter,
            "converged": bool(int(res.status) == F.CONVERGED),
            "wall_s": wall}


def config2_weights(nx):
    """Config 2's weights ``w = linspace(1, 2, N)`` in float32, as numpy:
    the state both packages take from here, so that they use the same
    bits."""
    return np.linspace(1.0, 2.0, nx * nx).astype(np.float32)


def make_config2(nx, impl, device="cuda", dtype=torch.float32):
    """Config 2 on an ``nx``-grid: ``A = W^{-1} Lap`` (self-adjoint and
    positive definite in ``ip(x, y) = <x, w y>``), ``M = V(w r)`` with
    ``V`` the unpadded V-cycle (coarsest 31, 60 coarse sweeps; Jacobi on
    ``diag(A)`` where nx is not ``2^k - 1``) and ``b = ones``.
    ``impl="cuda"`` runs K1 in the float32 matvec and in the V-cycle's
    level Laplacians, ``impl="torch"`` their plain versions; ``dtype`` is
    the inner solves' arithmetic (float32 is the configuration).  Returns
    ``(A, A64, M, ip, b, solves)``: ``solves["cg"]`` and
    ``solves["minres"]`` map ``b -> (result, info)``, float64 refinement
    to ``TOL`` around the inner solve (tol 1e-4, maxiter 200, stagnation
    window 20), which each carries as ``.inner``."""
    device = ops._device(device)
    lap = ops.poisson_2d(nx, impl=impl, device=device)
    N = nx * nx
    b = torch.ones(N, dtype=torch.float64, device=device)
    w = interop.from_numpy(config2_weights(nx), device)
    w64 = w.to(torch.float64)

    def A(x):
        return lap(x) / w.to(x.dtype)

    def A64(x):
        return lap(x) / w64

    def ip(x, y):
        return torch.vdot(x, w.to(x.dtype) * y)

    if (nx + 1) & nx == 0:
        mg = ops.multigrid_poisson_preconditioner(
            nx, coarsest=min(31, nx), coarse_sweeps=60, impl=impl,
            device=device)

        def M(r):
            return mg(w.to(r.dtype) * r)
    else:
        M = ops.jacobi_preconditioner(lap.diag.to(torch.float32) / w)

    solves = {}
    for name, solver in (("cg", F.cg), ("minres", F.minres)):
        def inner(rr, solver=solver):
            return solver(A, rr, M=M, ip=ip, tol=C23_INNER_TOL,
                          maxiter=C2_MAXITER,
                          stagnation_window=C2_STAGNATION)

        def solve(bb, inner=inner):
            return F.refine_to(A64, bb, inner, tol=TOL, compiled=True,
                               inner_dtype=dtype)

        solve.inner = inner
        solves[name] = solve
    return A, A64, M, ip, b, solves


def make_config3(nx, impl, ortho, device="cuda", dtype=torch.float32):
    """Config 3 on an ``nx``-grid: ``-Lap u + (1, 0.5) . grad u = 1``
    (upwind, Dirichlet) by restarted GMRES(30) with ``max_restarts=10``
    and ``compiled=True``, ``Ml`` the unpadded V-cycle of the Laplacian
    (coarsest 31, 60 coarse sweeps), ``M = (1 + h^2 / 2) I`` (so the
    basis is ``V = M P``) and ``Mr`` Jacobi with ``4 / h^2``, inner
    tolerance 1e-4, in float64 refinement to ``TOL``.  ``impl="cuda"``
    runs K1 in the float32 matvec and the V-cycle, ``ortho`` is GMRES's
    scheme (``"cgs2_pallas"`` runs K7 along the dual basis ``P``);
    ``dtype`` the inner arithmetic.  Returns ``(solve, A64)``:
    ``solve(b) -> (result, info)`` with ``solve.inner`` the restarted
    solve, ``A64`` the operator (float64 in, float64 out)."""
    device = ops._device(device)
    cd = ops.convection_diffusion_2d(nx, impl=impl, device=device)
    Ml = ops.multigrid_poisson_preconditioner(
        nx, coarsest=min(31, nx), coarse_sweeps=60, impl=impl,
        device=device)
    N = nx * nx
    h2 = (1.0 / (nx + 1)) ** 2
    M = ops.diagonal(torch.full((N,), 1.0 + 0.5 * h2, dtype=torch.float32,
                                device=device))
    Mr = ops.jacobi_preconditioner(torch.full((N,), 4.0 / h2,
                                              dtype=torch.float32,
                                              device=device))

    def inner(rr):
        return F.restarted_gmres(
            cd, rr, Ml=Ml, M=M, Mr=Mr, tol=C23_INNER_TOL,
            maxiter=C3_RESTART, max_restarts=C3_MAX_RESTARTS, compiled=True,
            ortho=ortho)

    def solve(b):
        return F.refine_to(cd, b, inner, tol=TOL, compiled=True,
                           inner_dtype=dtype)

    solve.inner = inner
    return solve, cd


# ---------------------------------------------------------------------------
# BASELINE config 5 (benchmarks/suite.py:191-282)
# ---------------------------------------------------------------------------


def _counting(cls):
    """A subclass of the recycling driver ``cls`` that counts the Jacobian
    actions its solves and its warmup ask for (``jvp_calls``)."""
    class Counting(cls):
        jvp_calls = 0

        def _counted(self, A):
            def mv(v):
                self.jvp_calls += 1
                return A(v)
            return mv

        def warmup(self, A, b, **kwargs):
            return super().warmup(self._counted(A), b, **kwargs)

        def solve(self, A, b, **kwargs):
            return super().solve(self._counted(A), b, **kwargs)

    return Counting


def config5_nls_newton_recycling(nx, recycle=3, auto=False, impl="torch",
                                 device="cuda"):
    """BASELINE config 5 as benchmarks/suite.py runs it: Newton on the
    stationary nonlinear-Schrödinger residual ``ops.nls_residual_2d(nx,
    kappa=1, lam=25, amplitude=3)`` from zero, in float32, with
    ``maxiter=15``, ``inner_maxiter=250`` and ``warmup=True``, every
    Jacobian solve through ``RecyclingGmres(recycle, "sm",
    hermitian=True)``, or with ``auto=True`` through
    ``AutoRecyclingGmres(max_vectors=recycle + 2, hermitian=True)``
    (suite.py's config 6).  ``impl="cuda"`` runs the Laplacian of ``F``,
    and its tangent in every Jacobian action, through K1; GMRES's
    default ``ortho="cgs2"`` is plain torch on both lanes.

    The tolerance follows suite.py: half the float32 floor (the median
    ``||F||`` of three dithered roots ``u* (1 + eps32 U(-1, 1))``, numpy
    ``RandomState(0)``) relative to ``||F(0)||``, and at least 1e-5.

    Returns the keys of suite.py's dictionary (walls unrounded) and:
    ``resnorms`` (``||F||`` per Newton step), ``tol``, ``f0``,
    ``predicted_steps`` (auto only), ``f_calls`` (evaluations of ``F``,
    those inside ``torch.func.jvp`` included) and ``jvp_calls`` (Jacobian
    actions).  On the kernel lane every call of ``F`` launches K1 once
    and every Jacobian action once more for its tangent, and building
    ``F`` launches it once (the manufactured source): ``1 + f_calls +
    jvp_calls`` K1 launches in all."""
    func, ustar = ops.nls_residual_2d(nx, kappa=1.0, lam=25.0,
                                      amplitude=3.0, impl=impl,
                                      device=device)
    calls = {"F": 0}

    def counted(u):
        calls["F"] += 1
        return func(u)

    N = nx * nx
    dev = ustar.device
    x0 = torch.zeros(N, dtype=torch.float32, device=dev)
    if auto:
        rec = _counting(F.AutoRecyclingGmres)(
            max_vectors=recycle + 2, hermitian=True)
    else:
        rec = _counting(F.RecyclingGmres)(
            n_vectors=recycle, which="sm", hermitian=True)

    # the float32 floor: the residual at a last-bit-dithered root (F(u*)
    # itself is 0 in float32, the manufactured g absorbing the rounding)
    u32 = ustar.to(torch.float32)
    eps32 = float(np.finfo(np.float32).eps)
    rng = np.random.RandomState(0)
    floor = float(np.median([
        float(torch.linalg.vector_norm(counted(
            u32 * (1 + eps32 * torch.tensor(rng.uniform(-1, 1, N),
                                            dtype=torch.float32, device=dev))
        ).to(torch.float64)))
        for _ in range(3)
    ]))
    f0 = float(torch.linalg.vector_norm(counted(x0)))
    tol = max(1e-5, 0.5 * floor / max(f0, 1.0))

    t0 = time.perf_counter()
    res = F.newton_krylov(
        counted, x0, tol=tol, maxiter=15, inner_maxiter=250,
        recycling_solver=rec, warmup=True,
    )
    total_s = time.perf_counter() - t0

    walls = res.inner_walls.tolist()
    iters = res.inner_history.tolist()
    transient = (max(walls[1:]) / walls[-1]
                 if len(walls) > 2 and walls[-1] > 0 else 1.0)
    tag = "5a_auto" if auto else "5"
    return {
        "config": f"{tag}_nls_newton_recycling_{N}dof_x{len(iters)}solves",
        "selected_widths": (
            [int(w) for w in rec.selected_widths] if auto else None
        ),
        "predicted_steps": (list(rec.predicted_steps) if auto else None),
        "newton_steps": int(res.niter),
        "fnorm_final": float(res.resnorms[-1]),
        "resnorms": res.resnorms.tolist(),
        "tol": tol,
        "f0": f0,
        "eval_floor": floor,
        "converged": bool(res.converged),
        "inner_iters": iters,
        "walls_s": walls,
        "total_s": total_s,
        "warmup_s": float(res.warmup_s),
        "serve_s": total_s - float(res.warmup_s),
        "max_transient_vs_last": transient,
        "improved": bool(len(iters) > 2 and min(iters[2:]) <= iters[1]),
        "f_calls": calls["F"],
        "jvp_calls": rec.jvp_calls,
    }
