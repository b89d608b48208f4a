"""The north-star solve (counterpart of benchmarks/northstar.py's
``_tpu_compiled`` on its padded lane, ``NORTHSTAR_PAD=1``): 2-D upwind
convection-diffusion, wind (1, 0.5), eps 1, rhs ones, solved to a float64
true relative residual of 1e-8 by float64 iterative refinement around up
to 3 float32 GMRES(25) cycles, preconditioned by the grid-padded
multigrid V-cycle on the left (or on the right, ``precond="right"``:
northstar.py's ``NORTHSTAR_PRECOND``), the Krylov basis stored in float32
or bfloat16 (``basis="bf16"``: ``NORTHSTAR_BASIS``).

    solve, cd64 = make_northstar(4095, "cuda", "cgs2_fused")
    solve, cd64 = make_northstar(4095, "cuda", "cgs2_1r", basis="bf16",
                                 precond="right")
    result, info = solve(torch.ones(4095 ** 2, dtype=torch.float64,
                                    device="cuda"))

The inner system is equilibrated by h^2 (northstar.py's scaling), so its
float32 stencil is :func:`cd_coeffs`; :func:`kappa_bound` bounds the
float64 operator's condition number, which turns two iterates' residuals
into a bound on their distance.
"""

import math

import numpy as np
import torch

from . import functional as F, ops
from .functional.common import MAXITER, SolveResult

__all__ = ["cd_coeffs", "cd_transpose", "kappa_bound", "make_northstar",
           "make_nonsym", "NONSYM_SOLVERS"]


def cd_coeffs(nx):
    """The north star's float32 stencil ``(cc, cu, cd, cl, cr)``:
    convection-diffusion with wind (h^2, h^2/2) and eps h^2 (the
    h^2-equilibrated system), whose up/left coefficients carry the upwind
    terms (cu != cd, cl != cr)."""
    h = 1.0 / (nx + 1)
    h2 = h * h
    wx, wy, eps = h2, 0.5 * h2, h2
    return (eps * (4.0 / h2) + wx / h + wy / h, -eps / h2 - wx / h,
            -eps / h2, -eps / h2 - wy / h, -eps / h2)


def cd_transpose(nx, impl):
    """The transpose of the north star's padded float32 operator on the
    logical grid: the same stencil with the up/down and left/right
    coefficients swapped, ``(cc, cd, cu, cr, cl)`` (K1 with
    ``impl="cuda"`` on float32, the plain stencil otherwise).  Its pad
    entries are zero, where the reverse-mode transpose of the padded
    operator writes the pads its forward stencil reads as ghosts; the two
    agree on the logical grid."""
    cc, cu, cd, cl, cr = cd_coeffs(nx)
    matvec, nx_pad, ny_pad = ops._padded_stencil_matvec(
        nx, nx, (cc, cd, cu, cr, cl), impl)
    matvec.shape = (nx_pad * ny_pad,) * 2
    return matvec


def kappa_bound(nx, wind=(1.0, 0.5)):
    """An upper bound on the 2-norm condition number of the north star's
    float64 operator ``L + C`` (L the Dirichlet Laplacian, C the upwind
    convection): sigma_min >= lambda_min(L), because C's symmetric part
    is positive semidefinite, and sigma_max <= lambda_max(L) + ||C||_2
    <= lambda_max(L) + 2 (wx + wy) / h."""
    h = 1.0 / (nx + 1)
    lmin = 8.0 * math.sin(math.pi * h / 2) ** 2 / h ** 2
    lmax = 8.0 * math.cos(math.pi * h / 2) ** 2 / h ** 2
    return (lmax + 2.0 * (abs(wind[0]) + abs(wind[1])) / h) / lmin


def make_northstar(nx, impl, ortho, device="cuda", *, basis="f32",
                   precond="left"):
    """The north-star pipeline on an ``nx``-grid: ``impl="cuda"`` runs
    K1-K3 in the matvec and the V-cycle, ``impl="torch"`` their plain
    versions; ``ortho`` is GMRES's scheme (``"cgs2_fused"`` runs K4-K6).
    ``basis="bf16"`` stores the Krylov basis in bfloat16
    (``basis_dtype``), ``precond="right"`` passes the V-cycle as ``Mr``
    (a bfloat16 basis needs it: with the V-cycle on the left its rounding
    noise reaches the true residual amplified by the operator, and the
    solve stalls).

    The inner solve runs up to 3 float32 GMRES(25) cycles (tol 1e-3) on
    the h^2-scaled system and keeps the best iterate by true float32
    residual, stopping on non-improvement or status 0/2.  Returns
    ``solve(b, warm=True) -> (result, info)`` (``warm``: the refinement's
    hidden warm-up solve on the first call, as ``refine_to``'s) and the
    float64 operator;
    ``info["matvecs"]`` is northstar.py's count, inner iterations +
    cycles + 1, and ``info["gmres_niters"]`` the iterations of each
    GMRES call, one list per refinement cycle."""
    if basis not in ("f32", "bf16") or precond not in ("left", "right"):
        raise ValueError(f"basis={basis!r} precond={precond!r}: expected "
                         "'f32'/'bf16' and 'left'/'right'")
    h = 1.0 / (nx + 1)
    h2 = h * h
    # northstar.py's jnp.float32(h2): the f32 scale of the inner system
    h2_f32 = float(np.float32(h2))
    cd32 = ops.convection_diffusion_2d(
        nx, wind=(1.0 * h2, 0.5 * h2), eps=h2, pad_cols=True, impl=impl,
        device=device)
    cd64 = ops.convection_diffusion_2d(nx, wind=(1.0, 0.5), eps=1.0,
                                       device=device)
    Ml = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
        scale=1.0 / h2, device=device)
    opts = {"Mr" if precond == "right" else "Ml": Ml,
            "basis_dtype": torch.bfloat16 if basis == "bf16" else None}

    calls = []

    def inner_solve(r32):
        rs = ops.pad_grid_vec(r32 * h2_f32, nx, nx)
        rs_norm = torch.clamp(torch.linalg.vector_norm(rs), min=1e-30)
        x = bx = torch.zeros_like(rs)
        best, nit = np.float32(np.inf), 0
        calls.append([])
        for _ in range(3):
            res = F.gmres(cd32, rs, x0=x, tol=1e-3, maxiter=25,
                          ortho=ortho, **opts)
            rel = np.float32((torch.linalg.vector_norm(rs - cd32(res.x))
                              / rs_norm).item())
            better = rel < best
            x = res.x
            if better:
                bx, best = res.x, rel
            nit += int(res.niter) + 2
            calls[-1].append(int(res.niter))
            if not better or int(res.status) in (0, 2):
                break
        dev = rs.device
        return SolveResult(
            x=ops.unpad_grid_vec(bx, nx, nx),
            resnorms=torch.zeros(1, dtype=torch.float32, device=dev),
            niter=torch.tensor(nit, dtype=torch.int64, device=dev),
            status=torch.tensor(MAXITER, dtype=torch.int64, device=dev))

    def solve(b, warm=True):
        calls.clear()
        res, info = F.refine_to(cd64, b, inner_solve, tol=1e-8,
                                compiled=True, warm=warm)
        info["matvecs"] = info["inner_iters"] + info["cycles"] + 1
        # the GMRES iterations of each refinement cycle's (up to 3) calls;
        # a first solve's warm-up cycles come first and are left out
        info["gmres_niters"] = calls[len(calls) - info["cycles"]:]
        return res, info

    return solve, cd64


#: the nonsymmetric short recurrences of :func:`make_nonsym`: the solver
#: and its arguments (each takes the V-cycle as its right preconditioner;
#: idrs's ``maxiter`` counts matvecs, ``s + 1`` to its cycle)
NONSYM_SOLVERS = {
    "bicgstab": ("bicgstab", {"maxiter": 10}),
    "tfqmr": ("tfqmr", {"maxiter": 10}),
    "idrs": ("idrs", {"s": 4, "maxiter": 20}),
    "idrs 1r": ("idrs", {"s": 4, "maxiter": 20, "variant": "1r"}),
    "fgmres": ("fgmres", {"ortho": "cgs2", "maxiter": 30}),
    "qmr": ("qmr", {"maxiter": 10}),
    "qmr 1r": ("qmr", {"maxiter": 10, "variant": "1r"}),
}


#: the float32 inner solves' tolerance, and the solver calls per cycle
NONSYM_TOL = 1e-3
NONSYM_RESTARTS = 2


def make_nonsym(nx, impl, solver, device="cuda", *, M=None):
    """The north star's system solved by a nonsymmetric short recurrence
    of :data:`NONSYM_SOLVERS`: float64 refinement (``refine_to(compiled=
    True)`` to 1e-8) around float32 solves of the padded, h^2-scaled
    system to ``NONSYM_TOL``, the padded V-cycle (coarsest 31, 60 coarse
    sweeps) the right preconditioner ``M``; ``qmr`` takes ``AT=``
    :func:`cd_transpose` and ``MT = M`` (the V-cycle is symmetric).
    ``impl="cuda"`` runs K1-K3 (and K1 for ``AT``), ``impl="torch"``
    their plain versions.  ``M``, where given, replaces the V-cycle (a
    flexible preconditioner for ``fgmres``).

    Each cycle's inner solve is :func:`make_northstar`'s restart control:
    up to ``NONSYM_RESTARTS`` calls of the solver, each from the last
    iterate, keeping the best by true float32 residual (one matvec per
    call), and stopping on a call that does not improve or that
    converged.  On large grids the first cycle's float32 solve cannot
    reach its tolerance: its smooth correction has a float32 floor (at
    4095^2 a float64 residual of 8e-2 after the cycle, whether its calls
    took 20 iterations or 40: chip_smoke.py's nonsym phase prints it),
    and the solvers stall there (MAXITER) or break down (BiCGStab, IDR(s),
    whose last iterate can be worse than its first); the restart from
    that iterate reaches the floor, and the later cycles, on rough
    residuals, converge in a few iterations.

    Returns ``solve(b, warm=True) -> (result, info)`` and the float64
    operator.  ``info["calls"]`` has, per solver call of the counted solve
    (the warm-up's left out), its refinement ``cycle``, ``niter``,
    ``status``, ``entries`` (the non-NaN ``resnorms``: TFQMR's half-steps
    + 1) and the applications of ``A``, ``AT`` and ``M`` it made (``MT =
    M`` counts as ``M``; the restart control's matvec is not among them);
    ``info["inner"]`` the iterations of each cycle."""
    name, kwargs = NONSYM_SOLVERS[solver]
    h = 1.0 / (nx + 1)
    h2 = h * h
    h2_f32 = float(np.float32(h2))
    cd32 = ops.convection_diffusion_2d(
        nx, wind=(1.0 * h2, 0.5 * h2), eps=h2, pad_cols=True, impl=impl,
        device=device)
    cd64 = ops.convection_diffusion_2d(nx, wind=(1.0, 0.5), eps=1.0,
                                       device=device)
    if M is None:
        M = ops.multigrid_poisson_preconditioner(
            nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
            scale=1.0 / h2, device=device)
    applied = {"A": 0, "AT": 0, "M": 0}

    def counted(key, op):
        def mv(x):
            applied[key] += 1
            return op(x)

        return mv

    kwargs = dict(kwargs, M=counted("M", M))
    if name == "qmr":
        kwargs.update(AT=counted("AT", cd_transpose(nx, impl)),
                      MT=kwargs["M"])
    A = counted("A", cd32)
    fn = getattr(F, name)
    calls = []

    def inner_solve(r32):
        rs = ops.pad_grid_vec(r32 * h2_f32, nx, nx)
        rs_norm = torch.clamp(torch.linalg.vector_norm(rs), min=1e-30)
        x = bx = torch.zeros_like(rs)
        best, nit = np.float32(np.inf), 0
        cycle = calls[-1]["cycle"] + 1 if calls else 0
        for _ in range(NONSYM_RESTARTS):
            for key in applied:
                applied[key] = 0
            res = fn(A, rs, x0=x, tol=NONSYM_TOL, **kwargs)
            rel = np.float32((torch.linalg.vector_norm(rs - cd32(res.x))
                              / rs_norm).item())
            calls.append(dict(
                applied, cycle=cycle, niter=int(res.niter),
                status=int(res.status), rel32=float(rel),
                entries=int((~torch.isnan(res.resnorms)).sum())))
            better = rel < best
            x = res.x
            if better:
                bx, best = res.x, rel
            nit += int(res.niter)
            if not better or int(res.status) == 0:
                break
        dev = rs.device
        return SolveResult(
            x=ops.unpad_grid_vec(bx, nx, nx),
            resnorms=torch.zeros(1, dtype=torch.float32, device=dev),
            niter=torch.tensor(nit, dtype=torch.int64, device=dev),
            status=torch.tensor(MAXITER, dtype=torch.int64, device=dev))

    def solve(b, warm=True):
        calls.clear()
        res, info = F.refine_to(cd64, b, inner_solve, tol=1e-8,
                                compiled=True, warm=warm)
        first = calls[-1]["cycle"] - info["cycles"] + 1 if calls else 0
        info["calls"] = [c for c in calls if c["cycle"] >= first]
        for c in info["calls"]:
            c["cycle"] -= first
        info["inner"] = [sum(c["niter"] for c in info["calls"]
                             if c["cycle"] == j)
                         for j in range(info["cycles"])]
        return res, info

    return solve, cd64
