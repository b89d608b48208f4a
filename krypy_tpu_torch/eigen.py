"""The eigensolver lane's pipelines on the main path's kernels, and the
closed-form spectra that gate them.

* :func:`poisson_inverse`: ``(A - 0 I)^{-1}`` of bench.py's Poisson
  operator (``ops.poisson_2d``, float64) for shift-invert Lanczos: float64
  refinement (``refine_to(compiled=True)``) to ``tol`` around bench.py's
  float32 multigrid-CG on the grid-padded system (``impl="cuda"``: K1-K3
  and the coarse form);
* :func:`poisson_vcycle`: the same padded V-cycle as LOBPCG's ``M``,
  applied to ``x.float()`` and cast back to ``x``'s dtype;
* :func:`northstar_inverse`: ``(A - 0 I)^{-1}`` of the north star's
  convection-diffusion operator for Krylov-Schur, the north star's
  refined GMRES (:func:`krypy_tpu_torch.northstar.make_northstar`: K1-K6
  with ``cgs2_fused``) on the real and the imaginary part of a complex
  vector (the operator is real);
* :func:`poisson_eigenvalues`, :func:`cd_eigenvalues`,
  :func:`poisson_window`: the closed forms.

Each pipeline counts what it applies (``counts``), so that a caller can
hold the kernels' launches to the applications.

    inv, A, counts = poisson_inverse(4095, "cuda", "cuda")
    r = functional.eigsh(A, 6, sigma=0.0, inv=inv, block_size=2)
"""

import math

import torch

from . import functional as F, ops
from .northstar import make_northstar

__all__ = ["poisson_inverse", "poisson_vcycle", "northstar_inverse",
           "poisson_eigenvalues", "cd_eigenvalues", "poisson_window"]


def _counted(op, counts, key):
    def mv(x):
        counts[key] += 1
        return op(x)

    return mv


def poisson_inverse(nx, impl, device="cuda", *, tol=1e-9):
    """``(inv, A64, counts)``: ``inv(v)`` solves ``A64 x = v`` to the
    float64 relative residual ``tol`` (or its floor: the refinement stops
    when a cycle does not improve) by refinement around bench.py's inner
    solve, float32 CG (tol 1e-4, at most 12 iterations, stagnation window
    4) on the grid-padded operator with the padded V-cycle (coarsest 31,
    60 coarse sweeps); ``impl="cuda"`` runs K1-K3 and the coarse form,
    ``impl="torch"`` their plain versions.  ``counts`` has the inverse's
    ``solves``, their refinement ``cycles`` and inner CG iterations
    (``inner``), and the float32 applications of the operator (``A``) and
    of the V-cycle (``M``)."""
    A64 = ops.poisson_2d(nx, device=device)
    lap32 = ops.poisson_2d(nx, pad_cols=True, impl=impl, device=device)
    M = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
        device=device)
    counts = {"solves": 0, "cycles": 0, "inner": 0, "A": 0, "M": 0}
    A32, M32 = _counted(lap32, counts, "A"), _counted(M, counts, "M")

    def inner(r32):
        res = F.cg(A32, ops.pad_grid_vec(r32, nx, nx), M=M32, tol=1e-4,
                   maxiter=12, stagnation_window=4)
        return res._replace(x=ops.unpad_grid_vec(res.x, nx, nx))

    def inv(v):
        res, info = F.refine_to(A64, v, inner, tol=tol, compiled=True,
                                warm=False)
        counts["solves"] += 1
        counts["cycles"] += info["cycles"]
        counts["inner"] += info["inner_iters"]
        return res.x

    inv.shape = A64.shape
    return inv, A64, counts


def poisson_vcycle(nx, impl, device="cuda"):
    """``(M, counts)``: the grid-padded V-cycle of :func:`poisson_inverse`
    on the logical grid, applied in float32 to ``x.float()`` and returned
    in ``x``'s dtype (``counts["M"]`` its applications)."""
    V = ops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
        device=device)
    counts = {"M": 0}

    def M(x):
        counts["M"] += 1
        y = V(ops.pad_grid_vec(x.float(), nx, nx))
        return ops.unpad_grid_vec(y, nx, nx).to(x.dtype)

    return M, counts


def northstar_inverse(nx, impl, device="cuda"):
    """``(inv, A64, counts)``: ``inv(v)`` applies the north star's refined
    solve (``make_northstar``: ``ortho="cgs2_fused"`` with
    ``impl="cuda"``, ``"cgs2"`` on the plain lane) to the real and the
    imaginary part of ``v`` (a part that is zero is not solved), each to
    the float64 relative residual 1e-8.  ``counts`` has the ``solves``,
    their refinement ``cycles`` and ``gmres_niters`` (the iterations of
    each GMRES call, as ``make_northstar``'s ``info``)."""
    solve, A64 = make_northstar(nx, impl,
                                "cgs2_fused" if impl == "cuda" else "cgs2",
                                device)
    counts = {"solves": 0, "cycles": 0, "gmres_niters": []}

    def part(p):
        if not bool(torch.any(p != 0)):
            return torch.zeros_like(p)
        res, info = solve(p.contiguous(), warm=False)
        counts["solves"] += 1
        counts["cycles"] += info["cycles"]
        counts["gmres_niters"] += info["gmres_niters"]
        return res.x

    def inv(v):
        if not v.is_complex():
            return part(v)
        return torch.complex(part(v.real), part(v.imag))

    inv.shape = A64.shape
    return inv, A64, counts


def poisson_eigenvalues(nx, count, largest=False):
    """The ``count`` smallest (``largest=True``: largest) eigenvalues of
    ``ops.poisson_2d(nx)``, ``(4/h^2)(sin^2(j pi h/2) + sin^2(k pi
    h/2))``, h = 1/(nx+1), with their ``(j, k)``: a list of ``(value, j,
    k)`` sorted from the end asked for (each degenerate pair as its two
    members)."""
    h = 1.0 / (nx + 1)
    top = int(math.isqrt(count)) + 3
    idx = (range(max(1, nx - top + 1), nx + 1) if largest
           else range(1, min(top, nx) + 1))
    vals = [(4.0 / h ** 2 * (math.sin(j * math.pi * h / 2) ** 2
                              + math.sin(k * math.pi * h / 2) ** 2), j, k)
            for j in idx for k in idx]
    return sorted(vals, reverse=largest)[:count]


def cd_eigenvalues(nx, count, wind=(1.0, 0.5), eps=1.0, largest=False):
    """The ``count`` eigenvalues nearest 0 (``largest=True``: the largest)
    of the north star's float64 operator ``ops.convection_diffusion_2d(nx,
    wind=wind, eps=eps)``: a Kronecker sum of two tridiagonal Toeplitz
    matrices whose off-diagonal products ``cu cd`` and ``cl cr`` are
    positive, so the spectrum is real, ``cc - 2 sqrt(cu cd) cos(j pi h) -
    2 sqrt(cl cr) cos(k pi h)``, here in its cancellation-free form
    ``(sqrt(-cu) - sqrt(-cd))^2 + 4 sqrt(cu cd) sin^2(j pi h/2)`` plus the
    same in k; a list of ``(value, j, k)`` sorted from the end asked for.
    The operator is linear in ``(wind, eps)``: scaling both scales the
    spectrum."""
    h = 1.0 / (nx + 1)
    wx, wy = wind
    cu, cd = -eps / h ** 2 - wx / h, -eps / h ** 2
    cl, cr = -eps / h ** 2 - wy / h, -eps / h ** 2

    def axis(lo, hi, j):
        # (sqrt(-lo) - sqrt(-hi))^2 = (lo - hi)^2 / (sqrt(-lo) + sqrt(-hi))^2
        base = (lo - hi) ** 2 / (math.sqrt(-lo) + math.sqrt(-hi)) ** 2
        return base + 4.0 * math.sqrt(lo * hi) * math.sin(
            j * math.pi * h / 2) ** 2

    top = int(math.isqrt(count)) + 3
    idx = (range(max(1, nx - top + 1), nx + 1) if largest
           else range(1, min(top, nx) + 1))
    vals = [(axis(cu, cd, j) + axis(cl, cr, k), j, k)
            for j in idx for k in idx]
    return sorted(vals, reverse=largest)[:count]


def poisson_window(nx):
    """The window of the filtered lane on ``ops.poisson_2d(nx)``: from
    ``(lambda_12 + lambda_22)/2`` to ``(lambda_13 + lambda_23)/2``, which
    holds ``lambda_22`` and the pair ``lambda_13 = lambda_31``; returns
    ``((lo, hi), inside, bounds)``: ``inside`` the three closed-form
    values, ``bounds`` the outer spectrum bounds ``(0, 8/h^2)``."""
    h = 1.0 / (nx + 1)

    def lam(j, k):
        return 4.0 / h ** 2 * (math.sin(j * math.pi * h / 2) ** 2
                               + math.sin(k * math.pi * h / 2) ** 2)

    window = ((lam(1, 2) + lam(2, 2)) / 2, (lam(1, 3) + lam(2, 3)) / 2)
    return window, [lam(2, 2), lam(1, 3), lam(3, 1)], (0.0, 8.0 / h ** 2)
