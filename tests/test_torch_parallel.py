"""The port's mesh path on gloo ranks on the CPU, against the JAX package
on the conftest's virtual CPU devices (``krypy_tpu.parallel.make_mesh(P)``
for P = 2 and 4), float64, Pallas interpreted.

Each world of P ranks is started once for the module, the worlds one
after the other (one single-threaded process per rank at nice 10,
``file://`` rendezvous in a temporary directory, a ``dist`` timeout and a
joined deadline): every rank runs all cases of :func:`rank_cases` and
writes its results to an ``.npz`` file; the tests read them, one
comparison per case.  The rank processes import this module without
JAX: JAX is imported only by the functions that run in the test process.

Tolerances: the sharded stencil (K8) ``rtol = atol = 1e-11``, as
tests/test_kernels.py's sharded stencil; the sharded fused CGS2 (K9)
``atol = 1e-10``, as tests/test_kernels.py's; solves: equal iteration
counts and status, residual histories ``rtol = 1e-8`` (``atol = 1e-14``
for the final explicit residuals near 1e-11, whose own rounding is
~1e-17), iterates ``atol = 1e-10``.  The replicated scalars (residual
histories, coefficients) must be the same bits on every rank.

    python tests/test_torch_parallel.py MODULE FUNC RANK P INIT DIR DEVICE BACKEND

is the rank process (:func:`run_ranks` starts it).
"""

import contextlib
import functools
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from krypy_tpu_torch import functional as F, interop, ops, parallel
from krypy_tpu_torch.kernels import orthogonalize as korth
from krypy_tpu_torch.kernels import stencil as kst

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (2, 4)
#: the grids of tests/test_kernels.py's sharded stencil
K8_SHAPES = ((32, 16), (64, 24), (16, 16))
OPERATORS = ("poisson", "convdiff", "shifted")
SIGMA = 7.5
#: tests/test_kernels.py's K9 case: (m, N, rows)
K9_CASE = (9, 1024, 8)
#: the GMRES parity problem: convection-diffusion, Jacobi on the left
GM_NX, GM_MAXITER, GM_TOL = 16, 100, 1e-10
#: GMRES iterations of the two runs whose difference counts collectives
COUNT_ITERS = (5, 9)
#: the GMRES schemes on the mesh: K9, the plain two passes, K7's
#: sharded form (K4, an all-reduce, K6 per pass) and the one-reduce scheme
GM_ORTHOS = ("cgs2_fused", "cgs2", "cgs2_pallas", "cgs2_1r")
#: all-reduces per iteration and per solve of a GMRES solve stopped at
#: maxiter (the global N, the two initial norms, the final explicit
#: residual; the one-reduce scheme's peeled first product), and halo
#: exchanges per solve (the initial and final residuals; its peeled
#: matvec)
GM_COUNTS = {"cgs2_1r": (1, 5, 3)}
GM_COUNTS_DEFAULT = (3, 4, 2)
#: the short recurrences' one-reduce variant on the mesh, and their fixed
#: all-reduces and halo exchanges per solve: the two initial norms, the
#: final explicit residual, and CG's initial delta (its first matvec too)
SR_COUNTS = {"cg": (4, 3), "minres": (3, 2)}
#: the ``auto`` cases: (solver, grid, maxiter); on the CPU table of the
#: price model GMRES on the 16^2 problem picks cgs2_1r and on 32^2
#: cgs2_fused, CG and MINRES on 32^2 pick 1r and CG on 64^2 classic
AUTO_CASES = (("gmres", GM_NX, GM_MAXITER), ("gmres", 32, GM_MAXITER),
              ("cg", 32, 200), ("minres", 32, 200), ("cg", 64, 400))
#: the nonsymmetric short recurrences on the mesh, each to the tolerance
#: of its sharded case in the JAX package's tests (tests/test_bicgstab.py,
#: test_tfqmr.py, test_idr.py, test_fgmres.py): the GMRES parity problem
#: with Jacobi as the right preconditioner, float64; fgmres on Poisson
#: with NS_INNER Jacobi-preconditioned CG steps (a fixed count) as its
#: flexible preconditioner.  (BiCGStab's history on this system is
#: steered by rounding below ~1e-5: one ulp of b moves its entry 40 from
#: 7.7e-7 to 3.4e-7.)
NS_TOL = {"bicgstab": 1e-3, "tfqmr": 1e-5, "idrs": 1e-5, "fgmres": 1e-4}
NS_SOLVERS = tuple(NS_TOL)
NS_INNER = 5
#: the mesh limit of residual histories against one device (PERF.md §2)
NS_HISTORY_RTOL = 3e-6
#: a length that divides over neither world: K9 runs on blocks of
#: unequal length there, the JAX package its two-pass ``fused_force_jnp``
UNEVEN_N = 61
#: the eigensolvers' sharded cases (tests/test_eigsh.py,
#: tests/test_lobpcg.py and tests/test_filtered.py), float64: eigsh on a
#: diagonal (single vector and block_size=2 with a planted degeneracy),
#: lobpcg classic and fused on the 8^2 Poisson operator (K8's plain
#: version; the JAX test's 16^2 takes 84 iterations, 8^2 31),
#: eigsh_window on the diagonal of the 16^2 operator's spectrum
#: (its filter applies the operator ``degree`` times a column per outer
#: iteration: on the stencil, a halo exchange each), and the runs whose
#: all-reduces are counted (never converging)
EIG_NX, EIG_LOBPCG_NX = 16, 8
EIG_WINDOW = dict(block=12, tol=1e-9, degree=400, maxiter=150,
                  bounds=(0.0, 8.0 * (EIG_NX + 1) ** 2))
EIG_COUNT_RESTARTS = (1, 2)
#: LOBPCG's tolerance on the mesh: unpreconditioned on a Laplacian its
#: residuals fall below ~1e-6 along a path that the order of the sums
#: steers (the JAX package at 16^2: 117 iterations to 1e-9 on a 2-device
#: mesh, 118 on a 4-device one), above it the counts agree
EIG_LOBPCG_TOL = 1e-6
#: all-reduces per LOBPCG iteration: the fused advance's three stacked
#: Grams and the residual norms
LOBPCG_FUSED_REDUCES = 4

#: the least-squares and multi-shift cases on the mesh, float64: the JAX
#: package's sharded cases (tests/test_lsq.py's diagonal, tests/
#: test_shifted.py's Poisson and shifts) at the parity grid, lsqr/lsmr
#: also on Poisson through K8's plain version with ``damp`` (~55
#: iterations, well short of the space's dimension, near which the order
#: of the sums steers the count: damp 100 takes 139 to tol 1e-10 and the
#: 4-rank mesh 138; so does a tol near the float64 floor of the explicit
#: normal-equations check, 1e-10 at damp 300: 71 against 72; below damp
#: ~20 LSQR's oscillating ||A^T r|| estimate trips its stagnation window
#: in both packages)
LS_DIAG_N, LS_TOL, LS_DAMP, LS_POISSON_TOL = 1024, 1e-5, 300.0, 1e-8
SH_SHIFTS = (0.0, 0.5, 2.0, 10.0)
SH_TOL, SH_GM_SHIFTS, SH_GM_TOL, SH_GM_MAXITER = 1e-10, 16, 1e-4, 60
#: all-reduces per multi-shift CG iteration: classic's two, 1r's one
SH_REDUCES = {"classic": 2, "1r": 1}
#: the worlds that run the least-squares, multi-shift and complex
#: cgs2_fused cases (the 2-rank world: the 4-rank one would add ~14 s to
#: the suite's longest fixture)
LANE16_WORLDS = (2,)
#: the Chebyshev, matrix-function, block and sketched cases on the mesh
#: (the JAX package's sharded cases of tests/test_chebyshev.py,
#: test_funm.py, test_block.py and test_sketch.py), float64 at the parity
#: grid through K8's plain version: Chebyshev with Jacobi on Poisson
#: (closed-form bounds of the Jacobi-scaled spectrum, check_every 8),
#: block CG and block GMRES on Poisson with B = [ones, linspace],
#: exp(-t A) b of Poisson by Lanczos and of the convection-diffusion
#: operator by Arnoldi, sketched GMRES on Poisson with a sketch the port
#: draws on every rank from one seed; run in LANE16_WORLDS
FL_T, FL_CD_T, FL_MAXDIM = 1e-3, 1e-2, 24
FL_CHEB = dict(tol=1e-5, maxiter=400, check_every=8)
FL_BCG_TOL, FL_BGM_TOL = 1e-6, 1e-5
FL_SKETCH_SEED, FL_SKETCH_M = 3, 30

#: the s-step and unstructured-gallery cases on the mesh, float64, in
#: LANE16_WORLDS: tests/test_sstep.py's sharded ca_cg (s = 4, Jacobi) and
#: ca_gmres (s = 4, Jacobi on the left; and the Newton basis) at the
#: parity grid through K8's plain version; the all-reduces of a block,
#: from two runs of SS_COUNT_BLOCKS blocks each (tol 0); the DIA, CSR,
#: block-Jacobi and SPAI cases of tests/test_preconditioners.py: DIA on
#: the graph Laplacian (N = 4096) and the tridiagonal (float32) against
#: scipy, CG with point and block Jacobi (block 32) on the CSR graph
#: Laplacian (N = 2048, 64 iterations), GMRES(16, cgs2) with and without
#: SPAI on the DIA nonsymmetric graph operator (N = 4096)
SS_S, SS_TOL, SS_GM_TOL = 4, 1e-10, 1e-8
SS_COUNT_BLOCKS = (2, 4)
#: all-reduces per block: CA-CG's conjugation, fused Gram and M-norm;
#: CA-GMRES's two Gram-Schmidt passes (one 32-row panel each while the
#: basis has at most 32 rows), the two CholQR2 Grams and the explicit
#: residual's norm, and the Newton basis' s norms
SS_BLOCK_REDUCES = {"ca_cg": 3, "ca_gmres": 5, "ca_gmres_newton": 5 + SS_S}
GAL_DIA_N, GAL_CSR_N, GAL_CG_ITERS, GAL_GM_ITERS = 4096, 2048, 64, 16

#: seconds: each collective, and the whole world
DIST_TIMEOUT, WORLD_TIMEOUT = 60, 240


# ---------------------------------------------------------------------------
# worlds of rank processes
# ---------------------------------------------------------------------------


def run_ranks(module_file, func, P, workdir, device="cpu", backend="gloo",
              timeout=WORLD_TIMEOUT):
    """Run ``func(mesh)`` of the module at ``module_file`` on P rank
    processes (:func:`krypy_tpu_torch.parallel.launch_ranks`; one thread
    each, at nice 10: the other test workers share this host's cores and
    keep their share of them); each returns
    a dict of arrays, saved as ``rank{r}.npz`` in ``workdir``.  Returns the
    P dicts.  Raises if any rank fails or the deadline passes."""
    init = parallel.file_rendezvous(workdir)
    env = {"PYTHONPATH": os.pathsep.join(
               [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    parallel.launch_ranks(
        lambda r: [sys.executable, __file__, str(module_file), func, str(r),
                   str(P), init, str(workdir), device, backend],
        P, workdir, timeout, env=env)
    return [dict(np.load(Path(workdir) / f"rank{r}.npz")) for r in range(P)]


def _rank_main(argv):
    module_file, func, rank, P, init, workdir, device, backend = argv
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    os.nice(10)
    parallel.init_distributed(init, int(P), int(rank), backend,
                              timeout=DIST_TIMEOUT)
    try:
        mesh = parallel.make_mesh(int(P), device=device)
        spec = importlib.util.spec_from_file_location("_ranks", module_file)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out = getattr(mod, func)(mesh)
        np.savez(Path(workdir) / f"rank{rank}.npz", **out)
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# what every rank runs
# ---------------------------------------------------------------------------


def _coeffs(name, nx, ny):
    """``(cc, cu, cd, cl, cr)`` of the three gallery stencils."""
    hx, hy = 1.0 / (nx + 1), 1.0 / (ny + 1)
    hx2, hy2 = hx * hx, hy * hy
    if name == "convdiff":
        wx, wy = 1.0, 0.5
        return (2.0 / hx2 + 2.0 / hy2 + wx / hx + wy / hy, -1.0 / hx2 - wx / hx,
                -1.0 / hx2, -1.0 / hy2 - wy / hy, -1.0 / hy2)
    shift = SIGMA if name == "shifted" else 0.0
    return (2.0 / hx2 + 2.0 / hy2 - shift, -1.0 / hx2, -1.0 / hx2,
            -1.0 / hy2, -1.0 / hy2)


def _operator(name, nx, ny, impl, mesh):
    kw = dict(impl=impl, mesh=mesh, device=mesh.device)
    if name == "poisson":
        return ops.poisson_2d(nx, ny, **kw)
    if name == "convdiff":
        return ops.convection_diffusion_2d(nx, ny, **kw)
    return ops.shifted_laplacian_2d(nx, ny, sigma=SIGMA, **kw)


def _error(fn):
    """The message of the exception ``fn()`` raises, prefixed by its
    type; '' where it raises none."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def _gmres_problem(mesh):
    nx = GM_NX
    A = ops.convection_diffusion_2d(nx, impl="cuda", mesh=mesh,
                                    device=mesh.device)
    b = np.random.RandomState(5).randn(nx * nx)
    return A, ops.jacobi_preconditioner(A), parallel.shard_vector(b, mesh)


def _auto_problem(solver, nx, mesh):
    """An ``auto`` case's operator and right-hand side on ``mesh``:
    convection-diffusion for GMRES (the GMRES parity problem at
    ``GM_NX``), Poisson for CG and MINRES."""
    make = ops.convection_diffusion_2d if solver == "gmres" \
        else ops.poisson_2d
    A = make(nx, impl="cuda", mesh=mesh, device=mesh.device)
    rhs = np.random.RandomState(5 if solver == "gmres" else 8).randn(nx * nx)
    return A, parallel.shard_vector(rhs, mesh)


def _uneven_matrix(P):
    """A nonsymmetric ``UNEVEN_N`` x ``UNEVEN_N`` matrix that couples
    only unknowns of one rank's block (the port's blocks of
    ``ceil(UNEVEN_N / P)``), so each rank applies its own diagonal block:
    a diagonal in [1, 4] and a super-diagonal of 0.5 inside each
    block."""
    n, step = UNEVEN_N, -(-UNEVEN_N // P)
    M = np.diag(1.0 + 3.0 * np.random.RandomState(9).rand(n))
    for i in range(n - 1):
        if i // step == (i + 1) // step:
            M[i, i + 1] = 0.5
    return M


def _ns_solve(name, mesh=None):
    """One of ``NS_SOLVERS`` on the mesh (inside ``with mesh:``) or, with
    ``mesh=None``, on one device (the whole vectors on the CPU)."""
    nx = GM_NX
    dev = "cpu" if mesh is None else mesh.device
    make = ops.poisson_2d if name == "fgmres" else \
        ops.convection_diffusion_2d
    A = make(nx, impl="cuda", mesh=mesh, device=dev)
    Mj = ops.jacobi_preconditioner(A)
    b = np.random.RandomState(5).randn(nx * nx)
    b = torch.tensor(b) if mesh is None else parallel.shard_vector(b, mesh)
    if name == "fgmres":
        return F.fgmres(A, b, tol=NS_TOL[name], maxiter=60,
                        M=lambda v: F.cg(A, v, M=Mj, tol=0.0,
                                         maxiter=NS_INNER).x)
    return getattr(F, name)(A, b, M=Mj, tol=NS_TOL[name], maxiter=400)


def _ls_problem(name, mesh=None):
    """A least-squares case on the mesh or, with ``mesh=None``, on one
    device: ``(A, Ah, b, kwargs)``.  ``"diag"`` is tests/test_lsq.py's
    sharded diagonal, ``"poisson"`` the parity grid's Poisson operator
    (its own adjoint) with ``LS_DAMP``."""
    dev = "cpu" if mesh is None else mesh.device
    if name == "diag":
        d = np.linspace(1.0, 10.0, LS_DIAG_N)
        d = torch.tensor(d) if mesh is None else parallel.shard_vector(d,
                                                                      mesh)
        b = np.ones(LS_DIAG_N)
        A = lambda v: d * v
        kw = dict(tol=LS_TOL, maxiter=200)
    else:
        A = ops.poisson_2d(GM_NX, impl="cuda", mesh=mesh, device=dev)
        b = np.random.RandomState(5).randn(GM_NX * GM_NX)
        kw = dict(tol=LS_POISSON_TOL, damp=LS_DAMP, maxiter=400)
    b = torch.tensor(b) if mesh is None else parallel.shard_vector(b, mesh)
    return A, A, b, kw


def _shifted_problem(mesh=None):
    """The multi-shift cases' Poisson operator and right-hand side."""
    dev = "cpu" if mesh is None else mesh.device
    A = ops.poisson_2d(GM_NX, impl="cuda", mesh=mesh, device=dev)
    b = np.random.RandomState(8).randn(GM_NX * GM_NX)
    return A, torch.tensor(b) if mesh is None else parallel.shard_vector(
        b, mesh)


def _complex_uneven(P):
    """The uneven block matrix made complex (still rank-local) and a
    complex right-hand side: ``cgs2_fused``'s complex case."""
    M = _uneven_matrix(P) * (1.0 + 0.5j)
    rng = np.random.RandomState(6)
    return M, rng.randn(UNEVEN_N) + 1j * rng.randn(UNEVEN_N)


def _lane16_cases(out, mesh):
    """The least-squares and multi-shift cases, and the complex
    ``cgs2_fused`` routing, on this rank."""
    gather = interop.gather_to_numpy
    with mesh:
        for name in ("diag", "poisson"):
            A, Ah, b, kw = _ls_problem(name, mesh)
            for solver in ("lsqr", "lsmr"):
                _result(out, f"ls_{solver}_{name}",
                        getattr(F, solver)(A, b, Ah=Ah, **kw), mesh)
        A, b = _shifted_problem(mesh)
        for variant in ("classic", "1r", "auto"):
            parallel.reset_collective_counts()
            res = F.shifted_cg(A, b, SH_SHIFTS, tol=SH_TOL, maxiter=400,
                               variant=variant)
            out[f"scg_{variant}_reduces"] = np.int64(
                parallel.collective_counts()["all_reduce_sum"])
            out[f"scg_{variant}_X"] = gather(res.X, mesh, axis=1)
            out[f"scg_{variant}_res"] = interop.to_numpy(res.resnorms)
            out[f"scg_{variant}_niter"] = np.int64(res.niter)
            out[f"scg_{variant}_status"] = interop.to_numpy(res.status)
        shifts = np.linspace(0.0, 100.0, SH_GM_SHIFTS)
        res = F.shifted_gmres(A, b, shifts, maxiter=SH_GM_MAXITER,
                              tol=SH_GM_TOL)
        out["sgm_X"] = gather(res.X, mesh, axis=1)
        out["sgm_res"] = interop.to_numpy(res.resnorms)
        out["sgm_niter"] = np.int64(res.niter)
        out["sgm_status"] = interop.to_numpy(res.status)

        # a complex cgs2_fused solve: the two plain passes, K9 never
        blk = parallel.block_of(UNEVEN_N, mesh)
        M, rhs = _complex_uneven(mesh.size)
        A_blk = torch.tensor(M[blk, blk])
        gmres_module = importlib.import_module(
            "krypy_tpu_torch.functional.gmres")
        k9, calls = gmres_module.cgs2_fused_blocks, []
        gmres_module.cgs2_fused_blocks = \
            lambda *a, **k: calls.append(1) or k9(*a, **k)
        try:
            res = F.gmres(lambda v: A_blk @ v, parallel.shard_vector(rhs, mesh),
                          tol=GM_TOL, maxiter=UNEVEN_N, ortho="cgs2_fused")
        finally:
            gmres_module.cgs2_fused_blocks = k9
        _result(out, "gmres_complex", res, mesh)
        out["gmres_complex_k9_calls"] = np.int64(len(calls))


def _fl_problem(mesh=None):
    """The slice-17 cases' operators and right-hand sides (the rank's
    blocks on a mesh): Poisson, Jacobi, the convection-diffusion
    operator, b random, B = [ones, linspace]."""
    dev = "cpu" if mesh is None else mesh.device
    N = GM_NX * GM_NX
    lap = ops.poisson_2d(GM_NX, impl="cuda", mesh=mesh, device=dev)
    cd = ops.convection_diffusion_2d(GM_NX, impl="cuda", mesh=mesh,
                                     device=dev)
    b = np.random.RandomState(17).randn(N)
    B = np.stack([np.ones(N), np.linspace(0.0, 1.0, N)], axis=1)
    if mesh is None:
        return lap, cd, torch.tensor(b), torch.tensor(B)
    blk = parallel.block_of(N, mesh)
    return lap, cd, parallel.shard_vector(b, mesh), torch.tensor(B[blk])


def _fl_bounds():
    """Jacobi-scaled Poisson's spectrum: [2 sin^2(pi h/2), 2 cos^2(pi
    h/2)]."""
    h = 1.0 / (GM_NX + 1)
    return (float(2 * np.sin(np.pi * h / 2) ** 2),
            float(2 * np.cos(np.pi * h / 2) ** 2))


def _fl_sketch(N):
    """The sketched case's embedding, drawn alike on every rank."""
    return F.kron_sketch(N, 8 * (FL_SKETCH_M + 1), dtype=torch.float64,
                         seed=torch.Generator().manual_seed(FL_SKETCH_SEED))


def _fl_solves(lap, cd, b, B):
    """Every slice-17 solve, with the all-reduces each made: ``{key:
    (result, all-reduces)}``."""
    lmin, lmax = _fl_bounds()
    runs = {
        "cheb": lambda: F.chebyshev(lap, b, M=ops.jacobi_preconditioner(lap),
                                    lmin=lmin, lmax=lmax, **FL_CHEB),
        "bcg": lambda: F.block_cg(lap, B, tol=FL_BCG_TOL, maxiter=600),
        "bgm": lambda: F.block_gmres(lap, B, tol=FL_BGM_TOL, maxiter=200),
        "funm": lambda: F.expm_multiply(lap, b, -FL_T, maxdim=FL_MAXDIM),
        "arnoldi_expm": lambda: F.expm_multiply(
            cd, b, -FL_CD_T / (GM_NX + 1) ** 2, hermitian=False,
            maxdim=FL_MAXDIM),
        "sgm": lambda: F.sketched_gmres(
            lap, b, tol=1e-5, maxiter=FL_SKETCH_M,
            sketch=_fl_sketch(GM_NX * GM_NX)),
    }
    out = {}
    for key, run in runs.items():
        parallel.reset_collective_counts()
        res = run()
        out[key] = (res, parallel.collective_counts()["all_reduce_sum"])
    return out


def _funm_lane_cases(out, mesh):
    """The Chebyshev, matrix-function, block and sketched cases on this
    rank."""
    lap, cd, b, B = _fl_problem(mesh)
    with mesh:
        for key, (res, reduces) in _fl_solves(lap, cd, b, B).items():
            axis = 0 if res.x.ndim == 2 else -1
            out[f"fl_{key}_x"] = interop.gather_to_numpy(res.x, mesh,
                                                          axis=axis)
            out[f"fl_{key}_reduces"] = np.int64(reduces)
            if key in ("funm", "arnoldi_expm"):
                out[f"fl_{key}_res"] = interop.to_numpy(res.corrections)
                out[f"fl_{key}_niter"] = np.int64(res.m)
            else:
                out[f"fl_{key}_res"] = interop.to_numpy(res.resnorms)
                out[f"fl_{key}_niter"] = np.int64(res.niter)
                out[f"fl_{key}_status"] = np.int64(res.status)


def _ss_problem(mesh=None):
    """The s-step cases' Poisson (K8's plain version on a mesh), its
    Jacobi preconditioner and b = ones (the rank's blocks on a mesh)."""
    dev = "cpu" if mesh is None else mesh.device
    lap = ops.poisson_2d(GM_NX, impl="cuda", mesh=mesh, device=dev)
    b = np.ones(GM_NX * GM_NX)
    b = torch.tensor(b) if mesh is None else parallel.shard_vector(b, mesh)
    return lap, ops.jacobi_preconditioner(lap), b


def _ss_solves(lap, Mj, b, maxiter=None, tol=None):
    """Each s-step solve, ``{key: thunk}``; ``maxiter``/``tol`` override
    the parity runs' (the counted runs: tol 0, a fixed number of
    blocks)."""
    def kw(m, t):
        return dict(maxiter=m if maxiter is None else maxiter,
                    tol=t if tol is None else tol, s=SS_S)

    return {
        "ca_cg": lambda: F.ca_cg(lap, b, M=Mj, **kw(500, SS_TOL)),
        "ca_gmres": lambda: F.ca_gmres(lap, b, Ml=Mj, **kw(512, SS_GM_TOL)),
        "ca_gmres_newton": lambda: F.ca_gmres(
            lap, b, Ml=Mj, basis="newton", **kw(512, SS_GM_TOL)),
    }


def _sstep_lane_cases(out, mesh):
    """The s-step cases on this rank: the parity solves, then each solve's
    all-reduces at SS_COUNT_BLOCKS blocks."""
    lap, Mj, b = _ss_problem(mesh)
    with mesh:
        for key, run in _ss_solves(lap, Mj, b).items():
            _result(out, f"ss_{key}", run(), mesh)
        for blocks in SS_COUNT_BLOCKS:
            for key, run in _ss_solves(lap, Mj, b, maxiter=blocks * SS_S,
                                       tol=0.0).items():
                parallel.reset_collective_counts()
                res = run()
                out[f"ss_{key}_reduces_{blocks}"] = np.int64(
                    parallel.collective_counts()["all_reduce_sum"])
                out[f"ss_{key}_niter_{blocks}"] = np.int64(res.niter)


def _gallery_problems():
    """The gallery cases' scipy matrices (every rank builds them alike)."""
    import scipy.sparse as sp

    def graph_laplacian(N, band=40, deg=8, seed=11):
        rng = np.random.default_rng(seed)
        rows = np.repeat(np.arange(N), deg)
        cols = (rows + rng.integers(1, band, size=rows.size)) % N
        W = sp.coo_matrix((rng.uniform(0.5, 2.0, rows.size), (rows, cols)),
                          shape=(N, N))
        W = W + W.T
        L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
        return (L + 1e-2 * sp.eye(N)).tocsr()

    def nonsym(N, seed=3):
        rng = np.random.default_rng(seed)
        rows = np.repeat(np.arange(N), 6)
        cols = (rows + rng.integers(1, 24, rows.size)) % N
        W = sp.coo_matrix((rng.uniform(0.5, 2.0, rows.size), (rows, cols)),
                          shape=(N, N))
        deg = np.asarray(W.sum(axis=1)).ravel() + np.asarray(
            W.sum(axis=0)).ravel()
        return (sp.diags(deg) - 1.7 * W - 0.3 * W.T
                + 0.5 * sp.eye(N)).tocsr()

    N = GAL_DIA_N
    tri = sp.diags([np.full(N, 4.0), -np.ones(N - 1), -np.ones(N - 1)],
                   [0, 1, -1]).tocsr()
    return {"lap_dia": graph_laplacian(N), "tri": tri,
            "lap_csr": graph_laplacian(GAL_CSR_N), "nonsym": nonsym(N)}


def _gallery_solves(mats, mesh=None):
    """The gallery's solves on one device or on the mesh (operators in
    their mesh forms), each with its collectives: ``{key: (result,
    counts)}``; and the DIA products, ``{key: (y, counts)}``."""
    dev = "cpu" if mesh is None else None

    def vec(x):
        return torch.tensor(x) if mesh is None else \
            parallel.shard_vector(x, mesh)

    csr = ops.sparse_from_scipy(mats["lap_csr"], device=dev or "cpu",
                                mesh=mesh)
    dia_ns = ops.dia_from_scipy(mats["nonsym"], device=dev or "cpu",
                                mesh=mesh)
    spai = ops.spai_preconditioner(mats["nonsym"], device=dev, mesh=mesh)
    runs = {
        "cg_jacobi": lambda: F.cg(csr, vec(np.ones(GAL_CSR_N)),
                                  M=ops.jacobi_preconditioner(csr), tol=0.0,
                                  maxiter=GAL_CG_ITERS),
        "cg_block_jacobi": lambda: F.cg(
            csr, vec(np.ones(GAL_CSR_N)),
            M=ops.block_jacobi_preconditioner(csr, 32, mesh=mesh),
            tol=0.0, maxiter=GAL_CG_ITERS),
        "gmres_plain": lambda: F.gmres(
            dia_ns, vec(np.ones(GAL_DIA_N, np.float32)), tol=1e-6,
            maxiter=GAL_GM_ITERS, ortho="cgs2"),
        "gmres_spai": lambda: F.gmres(
            dia_ns, vec(np.ones(GAL_DIA_N, np.float32)), Mr=spai, tol=1e-6,
            maxiter=GAL_GM_ITERS, ortho="cgs2"),
    }
    x = np.random.default_rng(3).standard_normal(GAL_DIA_N)
    products = {
        "lap_dia": lambda: ops.dia_from_scipy(
            mats["lap_dia"], device=dev or "cpu", mesh=mesh)(vec(x)),
        "tri": lambda: ops.dia_from_scipy(
            mats["tri"], device=dev or "cpu", mesh=mesh)(
                vec(np.ones(GAL_DIA_N, np.float32))),
    }
    out = {}
    with mesh if mesh is not None else contextlib.nullcontext():
        for key, run in {**runs, **products}.items():
            parallel.reset_collective_counts()
            out[key] = (run(), parallel.collective_counts())
    return out


def _gallery_cases(out, mesh):
    """The unstructured gallery's mesh forms on this rank."""
    mats = _gallery_problems()
    for key, (got, counts) in _gallery_solves(mats, mesh).items():
        for name, n in counts.items():
            out[f"gal_{key}_{name}"] = np.int64(n)
        if isinstance(got, torch.Tensor):
            out[f"gal_{key}_y"] = interop.gather_to_numpy(got, mesh)
        else:
            _result(out, f"gal_{key}", got, mesh)


def _result(out, key, res, mesh):
    """Store a solve's gathered x, its residual history and counts."""
    out[f"{key}_x"] = interop.gather_to_numpy(res.x, mesh)
    out[f"{key}_resnorms"] = interop.to_numpy(res.resnorms)
    out[f"{key}_niter"] = np.int64(res.niter)
    out[f"{key}_status"] = np.int64(res.status)


def rank_cases(mesh):
    """Every case, on this rank; float64 on the mesh's device."""
    P = mesh.size
    out = {}
    gather = interop.gather_to_numpy

    # K8 directly and the operators' two lanes, at the three grids
    for nx, ny in K8_SHAPES:
        x = parallel.shard_vector(np.random.RandomState(7).randn(nx * ny),
                                  mesh)
        for name in OPERATORS:
            tag = f"{name}_{nx}x{ny}"
            out[f"k8_{tag}"] = gather(kst.stencil5_sharded(
                x, nx=nx, ny=ny, coeffs=_coeffs(name, nx, ny), mesh=mesh),
                mesh)
            out[f"k8f32_{tag}"] = gather(kst.stencil5_sharded(
                x.float(), nx=nx, ny=ny, coeffs=_coeffs(name, nx, ny),
                mesh=mesh), mesh)
            for impl in ("torch", "cuda"):
                op = _operator(name, nx, ny, impl, mesh)
                out[f"op_{impl}_{tag}"] = gather(op(x), mesh)
                out[f"diag_{impl}_{tag}"] = gather(op.diag, mesh)

    # indivisible sizes
    nx_bad = 2 * P + 1
    op = ops.poisson_2d(nx_bad, 16, impl="cuda", mesh=mesh,
                        device=mesh.device)
    x_bad = parallel.shard_vector(np.zeros(nx_bad * 16), mesh)
    out["err_k8"] = np.array(_error(lambda: op(x_bad)))
    m, N, rows = K9_CASE
    V_bad = parallel.shard_vector(np.ones((m, N + 1)), mesh)
    w_bad = parallel.shard_vector(np.ones(N + 1), mesh)
    out["err_k9"] = np.array(_error(lambda: korth.cgs2_fused_sharded(
        V_bad, w_bad, torch.ones(m, dtype=torch.float64), mesh=mesh,
        rows=rows)))
    out["err_pad_cols"] = np.array(_error(lambda: ops.poisson_2d(
        8, pad_cols=True, mesh=mesh, device=mesh.device)))
    out["err_make_mesh"] = np.array(_error(
        lambda: parallel.make_mesh(P + 1, device=mesh.device)))

    # K9, tests/test_kernels.py's case
    rng = np.random.RandomState(3)
    V, w = rng.randn(m, N), rng.randn(N)
    mask = (torch.arange(m) < 6).to(torch.float64)
    w2, c = korth.cgs2_fused_sharded(
        parallel.shard_vector(V, mesh), parallel.shard_vector(w, mesh),
        mask, mesh=mesh, rows=rows)
    out["k9_w2"], out["k9_c"] = gather(w2, mesh), interop.to_numpy(c)

    # GMRES on the mesh, every scheme, and the collectives they make
    A, Ml, b = _gmres_problem(mesh)
    with mesh:
        for ortho in GM_ORTHOS:
            parallel.reset_collective_counts()
            res = F.gmres(A, b, Ml=Ml, tol=GM_TOL, maxiter=GM_MAXITER,
                          ortho=ortho)
            _result(out, f"gmres_{ortho}", res, mesh)
            counts = parallel.collective_counts()
            out[f"gmres_{ortho}_counts"] = np.array(
                [counts["all_reduce_sum"], counts["halo_exchange"]])
            for k in COUNT_ITERS:
                parallel.reset_collective_counts()
                F.gmres(A, b, Ml=Ml, tol=1e-30, maxiter=k, ortho=ortho)
                counts = parallel.collective_counts()
                out[f"count_{ortho}_{k}"] = np.array(
                    [counts["all_reduce_sum"], counts["halo_exchange"]])
        res = F.restarted_gmres(A, b, Ml=Ml, tol=GM_TOL, maxiter=6,
                                max_restarts=5, ortho="cgs2_fused")
        _result(out, "restarted", res, mesh)
        # cgs2_fused where N does not divide over the mesh: K9 on blocks
        # of unequal length
        blk = parallel.block_of(UNEVEN_N, mesh)
        A_blk = torch.tensor(_uneven_matrix(P)[blk, blk])
        b_u = parallel.shard_vector(
            np.random.RandomState(5).randn(UNEVEN_N), mesh)
        gmres_module = importlib.import_module(
            "krypy_tpu_torch.functional.gmres")
        k9, calls = gmres_module.cgs2_fused_blocks, []
        gmres_module.cgs2_fused_blocks = \
            lambda *a, **k: calls.append(1) or k9(*a, **k)
        try:
            res = F.gmres(lambda v: A_blk @ v, b_u, tol=GM_TOL,
                          maxiter=UNEVEN_N, ortho="cgs2_fused")
        finally:
            gmres_module.cgs2_fused_blocks = k9
        _result(out, "gmres_uneven", res, mesh)
        out["gmres_uneven_k9_calls"] = np.int64(len(calls))
        out["err_refine_to"] = np.array(_error(lambda: F.refine_to(
            A, b, lambda r: None)))

    # CG through the K8 operator (tests/test_kernels.py's sharded solve)
    nx = 32
    A = ops.poisson_2d(nx, impl="cuda", mesh=mesh, device=mesh.device)
    b = parallel.shard_vector(np.random.RandomState(8).randn(nx * nx), mesh)
    with mesh:
        _result(out, "cg", F.cg(A, b, tol=1e-10, maxiter=200), mesh)
        _result(out, "minres", F.minres(A, b, tol=1e-10, maxiter=200),
                mesh)
        # the one-reduce variants, and the collectives they make
        for name in SR_COUNTS:
            solver = getattr(F, name)
            parallel.reset_collective_counts()
            res = solver(A, b, tol=1e-10, maxiter=200, variant="1r")
            _result(out, f"{name}_1r", res, mesh)
            counts = parallel.collective_counts()
            out[f"{name}_1r_counts"] = np.array(
                [counts["all_reduce_sum"], counts["halo_exchange"]])
            for k in COUNT_ITERS:
                parallel.reset_collective_counts()
                solver(A, b, tol=1e-30, maxiter=k, variant="1r")
                counts = parallel.collective_counts()
                out[f"count_{name}_1r_{k}"] = np.array(
                    [counts["all_reduce_sum"], counts["halo_exchange"]])
        # an inner-product matrix: rank-local (the operator on the mesh,
        # a block of the identity), or not
        eye = torch.eye(b.shape[0], dtype=torch.float64)
        _result(out, "cg_ip", F.cg(A, b, ip=eye, tol=1e-10, maxiter=200),
                mesh)
        out["err_ip_global"] = np.array(_error(lambda: F.cg(
            A, b, ip=torch.eye(nx * nx + 1, dtype=torch.float64),
            maxiter=2)))
        out["err_ip_callable"] = np.array(_error(lambda: F.cg(
            A, b, ip=lambda u, v: torch.vdot(u, v), maxiter=2)))

    # the nonsymmetric short recurrences (one device: _ns_solve in the test
    # process)
    with mesh:
        for name in NS_SOLVERS:
            _result(out, f"ns_{name}", _ns_solve(name, mesh), mesh)

    # ortho="auto" and variant="auto": the scheme each picked, read off the
    # all-reduces it made
    for solver, n, maxiter in AUTO_CASES:
        A_auto, b_auto = _auto_problem(solver, n, mesh)
        kw = dict(Ml=ops.jacobi_preconditioner(A_auto)) \
            if solver == "gmres" else {}
        with mesh:
            parallel.reset_collective_counts()
            res = getattr(F, solver)(
                A_auto, b_auto, tol=1e-10, maxiter=maxiter,
                **{"ortho" if solver == "gmres" else "variant": "auto"},
                **kw)
        tag = f"auto_{solver}_{n}"
        _result(out, tag, res, mesh)
        out[f"{tag}_reduces"] = np.int64(
            parallel.collective_counts()["all_reduce_sum"])

    # the rest of the mesh API on the same system
    whole = np.random.RandomState(8).randn(nx * nx)
    _result(out, "sharded_solve", parallel.sharded_solve(
        F.cg, A, whole, mesh, tol=1e-10, maxiter=200), mesh)
    out["global_vector"] = gather(parallel.make_global_vector(
        mesh, lambda index: whole[index], (nx * nx,)), mesh)
    out["replicate"] = interop.to_numpy(parallel.replicate([1.0, 2.0], mesh))
    sizes = [parallel.active_mesh_size()]
    with mesh:
        sizes += [parallel.active_mesh_size(), parallel.active_mesh() is mesh]
    out["mesh_sizes"] = np.array(sizes + [parallel.active_mesh() is None])

    _eig_cases(out, mesh)
    if P in LANE16_WORLDS:
        _lane16_cases(out, mesh)
        _funm_lane_cases(out, mesh)
        _sstep_lane_cases(out, mesh)
        _gallery_cases(out, mesh)

    # the dryrun's deflation and recycling lanes (nx = 4P, ny = 8)
    nx, ny = 4 * P, 8
    N = nx * ny
    A = ops.convection_diffusion_2d(nx, ny, impl="cuda", mesh=mesh,
                                    device=mesh.device)
    Ml = ops.jacobi_preconditioner(A)
    b = parallel.shard_vector(np.ones(N), mesh)
    U = interop.shard_from_numpy(np.eye(N, 2), mesh, axis=0)
    out["U_roundtrip"] = interop.gather_to_numpy(U, mesh, axis=0)
    kw = dict(tol=1e-6, maxiter=12, ortho="cgs2")
    with mesh:
        _result(out, "deflated", F.deflated_gmres(A, b, U, Ml=Ml, **kw),
                mesh)
        lap = ops.poisson_2d(nx, ny, impl="cuda", mesh=mesh,
                             device=mesh.device)
        _result(out, "deflated_cg", F.deflated_cg(lap, b, U, tol=1e-10,
                                                  maxiter=4 * N), mesh)
        rec = F.RecyclingGmres(n_vectors=2, which="sm")
        _result(out, "recycle1", rec.solve(A, b, **kw), mesh)
        _result(out, "recycle2", rec.solve(A, b, **kw), mesh)
        out["recycle_U"] = interop.gather_to_numpy(rec._U, mesh, axis=0)
    return out


def _eig_diag(name):
    """The sharded eigsh cases' diagonals and starts (numpy): the wanted
    pairs apart from the rest of the spectrum, so that a few restart
    cycles converge (the JAX tests' evenly spaced diagonals take 294 and
    492 Lanczos steps to 1e-9, each step's all-reduces a few ms on gloo
    ranks that share a loaded host); the block case with a planted
    degeneracy."""
    if name == "single":
        return np.r_[np.linspace(1.0, 50.0, 1021), 58.0, 61.0, 64.0], \
            np.ones(1024)
    return np.r_[0.5, 0.5, 2.0, np.linspace(10.0, 20.0, 509)], \
        np.cos(np.arange(512) * 0.7391) + 0.01


EIG_EIGSH = {"single": dict(k=3, which="la", tol=1e-9),
             "block": dict(k=3, which="sa", tol=1e-9, block_size=2,
                           maxdim=24)}


def _eig_spectrum():
    """The 16^2 Laplacian's eigenvalues, ascending."""
    h = np.pi / (EIG_NX + 1)
    c = np.cos(h * np.arange(1, EIG_NX + 1))
    return np.sort((4.0 - 2.0 * c[:, None] - 2.0 * c[None, :]).ravel()) \
        * (EIG_NX + 1) ** 2


def _eig_window_range():
    """The sharded window of tests/test_filtered.py: edges inside gaps of
    the 16^2 Laplacian's spectrum."""
    ew = _eig_spectrum()
    return float((ew[98] + ew[99]) / 2), float((ew[105] + ew[106]) / 2)


def _eig_start_block(N, p):
    return np.stack([np.cos(np.arange(N) * (0.7391 + 0.1137 * i))
                     + 0.01 * (i + 1) for i in range(p)], axis=1)


def _eig_result(out, key, r, mesh):
    out[f"{key}_theta"] = interop.to_numpy(r.theta)
    out[f"{key}_U"] = interop.gather_to_numpy(r.U, mesh, axis=0)
    out[f"{key}_niter"] = np.int64(r.niter)
    out[f"{key}_status"] = np.int64(r.status)
    if hasattr(r, "n_inside"):
        out[f"{key}_n_inside"] = np.int64(r.n_inside)


def _eig_cases(out, mesh):
    """The eigensolvers on the mesh, and the all-reduces of the one-reduce
    Lanczos sweep and of LOBPCG's fused advance."""
    dev = mesh.device
    N = EIG_NX * EIG_NX
    lap = ops.poisson_2d(EIG_LOBPCG_NX, impl="cuda", mesh=mesh, device=dev)
    X0 = interop.shard_from_numpy(
        _eig_start_block(EIG_LOBPCG_NX ** 2, 3), mesh, axis=0)
    with mesh:
        for name, kw in EIG_EIGSH.items():
            d, v0 = _eig_diag(name)
            A = ops.diagonal(parallel.shard_vector(d, mesh))
            _eig_result(out, f"eigsh_{name}", F.eigsh(
                A, v0=parallel.shard_vector(v0, mesh), **kw), mesh)
        for variant in ("classic", "fused"):
            _eig_result(out, f"lobpcg_{variant}", F.lobpcg(
                lap, X0=X0, which="sa", tol=EIG_LOBPCG_TOL, variant=variant),
                mesh)
        Xw = interop.shard_from_numpy(_eig_start_block(N, 12), mesh, axis=0)
        _eig_result(out, "window", F.eigsh_window(
            ops.diagonal(parallel.shard_vector(_eig_spectrum(), mesh)),
            _eig_window_range(), X0=Xw, **EIG_WINDOW), mesh)
        # all-reduces per restart cycle of each Lanczos sweep, and per
        # LOBPCG iteration of each advance
        d, v0 = _eig_diag("single")
        A = ops.diagonal(parallel.shard_vector(d, mesh))
        v0 = parallel.shard_vector(v0, mesh)
        for ortho in ("cgs2", "cgs2_1r"):
            for c in EIG_COUNT_RESTARTS:
                parallel.reset_collective_counts()
                F.eigsh(A, k=3, v0=v0, tol=1e-300, maxdim=12,
                        max_restarts=c, ortho=ortho)
                out[f"eigsh_{ortho}_reduces_{c}"] = np.int64(
                    parallel.collective_counts()["all_reduce_sum"])
        for variant in ("classic", "fused", "auto"):
            for it in (2, 3):
                parallel.reset_collective_counts()
                F.lobpcg(lap, X0=X0, tol=1e-300, maxiter=it,
                         variant=variant)
                out[f"lobpcg_{variant}_reduces_{it}"] = np.int64(
                    parallel.collective_counts()["all_reduce_sum"])


# ---------------------------------------------------------------------------
# the tests (JAX only in here)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, one after the other: ``{P: [rank dicts]}``."""
    return {P: run_ranks(__file__, "rank_cases", P,
                         tmp_path_factory.mktemp(f"world{P}"))
            for P in WORLDS}


def _jmesh(P):
    from krypy_tpu import parallel as jparallel

    return jparallel.make_mesh(P)


def _jax_operator(name, nx, ny, mesh=None, impl="pallas"):
    from krypy_tpu import ops as jops

    if name == "poisson":
        return jops.poisson_2d(nx, ny, impl=impl, mesh=mesh)
    if name == "convdiff":
        return jops.convection_diffusion_2d(nx, ny, impl=impl, mesh=mesh)
    return jops.shifted_laplacian_2d(nx, ny, sigma=SIGMA, impl=impl,
                                     mesh=mesh)


def _close(got, want, tol=1e-11):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _jax_stencils(P, nx, ny):
    """The three JAX sharded Pallas stencils (interpreted) of
    tests/test_kernels.py's random vector on a P-device mesh, in ONE jit
    (seven times faster than three calls), and their ``.diag``."""
    import jax
    import jax.numpy as jnp
    from krypy_tpu import parallel as jparallel

    mesh = _jmesh(P)
    x = jparallel.shard_vector(
        jnp.asarray(np.random.RandomState(7).randn(nx * ny)), mesh)
    ops_j = [_jax_operator(name, nx, ny, mesh) for name in OPERATORS]
    out = jax.jit(lambda v: [op(v) for op in ops_j])(x)
    return {name: (np.asarray(y), np.asarray(op.diag))
            for name, y, op in zip(OPERATORS, out, ops_j)}


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", OPERATORS)
@pytest.mark.parametrize("nx,ny", K8_SHAPES)
def test_stencil5_sharded_matches_jax(worlds, nx, ny, name, P):
    """K8 and the operators' mesh lanes against the JAX sharded Pallas
    stencil (interpreted) on a P-device mesh; ``.diag`` is the rank's
    block."""
    want, diag = _jax_stencils(P, nx, ny)[name]
    r0, tag = worlds[P][0], f"{name}_{nx}x{ny}"
    _close(r0[f"k8_{tag}"], want)
    for impl in ("torch", "cuda"):
        _close(r0[f"op_{impl}_{tag}"], want)
        _close(r0[f"diag_{impl}_{tag}"], diag, 0.0)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", OPERATORS)
@pytest.mark.parametrize("nx,ny", K8_SHAPES)
def test_plain_stencil5_sharded_is_one_device_bitwise(worlds, nx, ny, name,
                                                      P):
    """The plain K8 in float32, gathered from every rank, equals the
    single-device plain stencil of the whole grid bit for bit: each edge
    row is computed whole with the received neighbour rows, in the
    grouped-difference arithmetic of every other row (no correction added
    after it)."""
    x = torch.from_numpy(np.random.RandomState(7).randn(nx * ny)).float()
    want = kst.stencil5_affine_torch(x.view(nx, ny), None,
                                     _coeffs(name, nx, ny), nx, ny)
    for r in worlds[P]:
        got = r[f"k8f32_{name}_{nx}x{ny}"]
        assert got.dtype == np.float32
        assert np.array_equal(got, want.numpy().reshape(-1))


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("what", ["k8", "k9", "pad_cols"])
def test_indivisible_sizes_raise_like_jax(worlds, what, P):
    """The same ValueError wording as the JAX package, on every rank."""
    import jax.numpy as jnp
    from krypy_tpu import ops as jops
    from krypy_tpu.kernels.orthogonalize import cgs2_fused_sharded

    mesh = _jmesh(P)
    m, N, rows = K9_CASE
    pattern = {"k8": "divisible", "k9": "divide over the mesh size",
               "pad_cols": "pad_cols does not compose with mesh="}[what]
    with pytest.raises(ValueError, match=pattern):
        if what == "k8":
            _jax_operator("poisson", 2 * P + 1, 16, mesh)(
                jnp.zeros((2 * P + 1) * 16))
        elif what == "k9":
            cgs2_fused_sharded(jnp.ones((m, N + 1)), jnp.ones(N + 1),
                               jnp.ones(m), mesh=mesh, rows=rows)
        else:
            jops.poisson_2d(8, pad_cols=True, mesh=mesh)
    for r in worlds[P]:
        msg = str(r[f"err_{what}"])
        assert msg.startswith("ValueError") and pattern in msg, msg


@pytest.mark.parametrize("P", WORLDS)
def test_cgs2_fused_sharded_matches_jax(worlds, P):
    """K9 against the JAX sharded fused CGS2 (interpreted), atol 1e-10;
    its coefficients are the same bits on every rank."""
    import jax
    from krypy_tpu import parallel as jparallel
    from krypy_tpu.kernels.orthogonalize import cgs2_fused_sharded

    m, N, rows = K9_CASE
    rng = np.random.RandomState(3)
    V, w = rng.randn(m, N), rng.randn(N)
    mesh = _jmesh(P)
    Vs = jax.device_put(V, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "n")))
    w2, c = cgs2_fused_sharded(Vs, jparallel.shard_vector(w, mesh),
                               (np.arange(m) < 6).astype(float), mesh=mesh,
                               rows=rows, interpret=True)
    ranks = worlds[P]
    np.testing.assert_allclose(ranks[0]["k9_w2"], np.asarray(w2),
                               atol=1e-10)
    np.testing.assert_allclose(ranks[0]["k9_c"], np.asarray(c), atol=1e-10)
    assert all(r["k9_c"].tobytes() == ranks[0]["k9_c"].tobytes()
               for r in ranks)


def _compare(r, key, res, x_atol=1e-10):
    assert int(r[f"{key}_niter"]) == int(res.niter)
    assert int(r[f"{key}_status"]) == int(res.status)
    np.testing.assert_allclose(r[f"{key}_resnorms"],
                               np.asarray(res.resnorms), rtol=1e-8,
                               atol=1e-14)
    np.testing.assert_allclose(r[f"{key}_x"], np.asarray(res.x).reshape(-1),
                               rtol=0, atol=x_atol)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("ortho", GM_ORTHOS)
def test_gmres_on_mesh_matches_jax(worlds, ortho, P):
    """GMRES through K8 (and K9 for ``cgs2_fused``, K7's sharded form for
    ``cgs2_pallas``, where the JAX package runs its single-device Pallas
    kernel on the sharded basis) against the JAX solve under ``with
    mesh:``; every rank's residual history is the same bits."""
    import jax
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, ops as jops, parallel as jp

    mesh = _jmesh(P)
    A = _jax_operator("convdiff", GM_NX, GM_NX, mesh)
    b = jp.shard_vector(
        jnp.asarray(np.random.RandomState(5).randn(GM_NX * GM_NX)), mesh)
    Ml = jops.jacobi_preconditioner(A)
    with mesh:
        res = jax.jit(lambda v: JF.gmres(A, v, Ml=Ml, tol=GM_TOL,
                                         maxiter=GM_MAXITER,
                                         ortho=ortho))(b)
    ranks = worlds[P]
    _compare(ranks[0], f"gmres_{ortho}", res)
    assert int(res.status) == F.CONVERGED
    key = f"gmres_{ortho}_resnorms"
    assert all(r[key].tobytes() == ranks[0][key].tobytes() for r in ranks)


@pytest.mark.parametrize("P", WORLDS)
def test_gmres_cgs2_fused_on_indivisible_mesh_matches_jax(worlds, P):
    """``ortho="cgs2_fused"`` where N does not divide over the mesh: the
    JAX package runs its batched two-pass jnp scheme there
    (``fused_force_jnp``), the port K9 on the ranks' blocks of unequal
    length, once per iteration.  Against the JAX solve under ``with
    mesh:`` on the same nonsymmetric block-diagonal matrix: equal
    iteration counts and status, the file's GMRES tolerances; every
    rank's residual history is the same bits."""
    import jax
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, parallel as jp

    mesh = _jmesh(P)
    A = jnp.asarray(_uneven_matrix(P))
    b = jp.shard_vector(
        jnp.asarray(np.random.RandomState(5).randn(UNEVEN_N)), mesh)
    with mesh:
        res = jax.jit(lambda v: JF.gmres(A, v, tol=GM_TOL, maxiter=UNEVEN_N,
                                         ortho="cgs2_fused"))(b)
    ranks = worlds[P]
    _compare(ranks[0], "gmres_uneven", res)
    assert int(res.status) == F.CONVERGED
    key = "gmres_uneven_resnorms"
    assert all(r[key].tobytes() == ranks[0][key].tobytes() for r in ranks)
    assert all(int(r["gmres_uneven_k9_calls"]) == int(res.niter)
               for r in ranks)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("ortho", GM_ORTHOS)
def test_gmres_collectives_per_iteration(worlds, ortho, P):
    """Three all-reduces per GMRES iteration (K9's two plus the norm, as
    tests/test_collectives.py pins for the JAX loop body; ``cgs2``'s and
    ``cgs2_pallas``'s two passes plus the norm), ONE for ``cgs2_1r`` (as
    tests/test_collectives.py pins it), and one halo exchange per
    matvec.  A solve of k iterations that stops at ``maxiter``: 3 k + 4
    all-reduces (the global N, the two initial norms, the final explicit
    residual) and k + 2 exchanges (the initial and final residuals);
    ``cgs2_1r`` k + 5 and k + 3, its peeled first product and matvec
    added."""
    per, fixed, halo = GM_COUNTS.get(ortho, GM_COUNTS_DEFAULT)
    k1, k2 = COUNT_ITERS
    for r in worlds[P]:
        c1, c2 = r[f"count_{ortho}_{k1}"], r[f"count_{ortho}_{k2}"]
        assert list((c2 - c1) // (k2 - k1)) == [per, 1]
        assert list((c2 - c1) % (k2 - k1)) == [0, 0]
        assert list(c1) == [per * k1 + fixed, k1 + halo]
        n = int(r[f"gmres_{ortho}_niter"])
        assert list(r[f"gmres_{ortho}_counts"]) == [per * n + fixed,
                                                    n + halo]


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", list(SR_COUNTS))
def test_one_reduce_short_recurrences_on_mesh(worlds, name, P):
    """CG and MINRES with ``variant="1r"`` through K8 against the JAX
    package's under ``with mesh:``, every rank's history the same bits,
    and ONE all-reduce per iteration (tests/test_collectives.py pins it
    on the JAX loop body) and one halo exchange per matvec; fixed per
    solve: the two initial norms and the final explicit residual, and
    CG's initial ``delta`` and its matvec."""
    import jax
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, parallel as jp

    nx = 32
    mesh = _jmesh(P)
    b = jp.shard_vector(
        jnp.asarray(np.random.RandomState(8).randn(nx * nx)), mesh)
    A = _jax_operator("poisson", nx, nx, mesh)
    with mesh:
        res = jax.jit(lambda v: getattr(JF, name)(
            A, v, tol=1e-10, maxiter=200, variant="1r"))(b)
    ranks = worlds[P]
    _compare(ranks[0], f"{name}_1r", res)
    assert int(res.status) == F.CONVERGED
    key = f"{name}_1r_resnorms"
    assert all(r[key].tobytes() == ranks[0][key].tobytes() for r in ranks)
    fixed, halo = SR_COUNTS[name]
    k1, k2 = COUNT_ITERS
    for r in ranks:
        n = int(r[f"{name}_1r_niter"])
        assert list(r[f"{name}_1r_counts"]) == [n + fixed, n + halo]
        for k in COUNT_ITERS:
            assert list(r[f"count_{name}_1r_{k}"]) == [k + fixed, k + halo]


def _jax_auto(solver, nx, maxiter, P, pick):
    """The JAX package's ``auto`` solve on ``make_mesh(P)`` and whether
    it picked ``pick``: its compiled auto solve is the same program as
    the one of the scheme it resolved to, so its iterate equals that
    scheme's bit for bit (and differs from the other's).  Returns
    ``(picked pick, auto result)``."""
    import jax
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, ops as jops, parallel as jp

    mesh = _jmesh(P)
    make = jops.convection_diffusion_2d if solver == "gmres" \
        else jops.poisson_2d
    A = make(nx, nx, impl="pallas", mesh=mesh)
    b = jp.shard_vector(jnp.asarray(np.random.RandomState(
        5 if solver == "gmres" else 8).randn(nx * nx)), mesh)
    key = "ortho" if solver == "gmres" else "variant"
    kw = dict(Ml=jops.jacobi_preconditioner(A)) if solver == "gmres" else {}
    runs = {}
    for choice in ("auto", pick):
        with mesh:
            runs[choice] = jax.jit(lambda v: getattr(JF, solver)(
                A, v, tol=1e-10, maxiter=maxiter, **{key: choice},
                **kw))(b)
    same = np.array_equal(np.asarray(runs[pick].x),
                          np.asarray(runs["auto"].x))
    return same, runs["auto"]


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("solver,nx,maxiter", AUTO_CASES)
def test_auto_on_mesh_picks_as_jax(worlds, solver, nx, maxiter, P):
    """``ortho="auto"`` (GMRES) and ``variant="auto"`` (CG, MINRES) on
    the mesh pick the scheme the JAX package picks on ``make_mesh(P)``
    for the same shard sizes (both price it with the CPU row of the
    model, :mod:`krypy_tpu_torch.functional.policy`), and the solve
    matches the JAX package's.  The port's pick is read off the
    all-reduces the solve made: GMRES ``cgs2_1r`` k + 5 against
    ``cgs2_fused``'s 3 k + 4, CG ``1r`` k + 5 against classic's 2 k + 4,
    MINRES ``1r`` k + 4 against 2 k + 4 (the short recurrences' ``auto``
    reduces the global N once more)."""
    tag = f"auto_{solver}_{nx}"
    picks = set()
    for r in worlds[P]:
        n, reduces = int(r[f"{tag}_niter"]), int(r[f"{tag}_reduces"])
        # the short recurrences' auto also reduces the global N
        one_reduce = {"gmres": n + 5, "cg": n + 5, "minres": n + 4}[solver]
        other = {"gmres": 3 * n + 4, "cg": 2 * n + 4,
                 "minres": 2 * n + 4}[solver]
        assert reduces in (one_reduce, other)
        picks.add(("cgs2_1r" if solver == "gmres" else "1r")
                  if reduces == one_reduce else
                  ("cgs2_fused" if solver == "gmres" else "classic"))
    assert len(picks) == 1
    got = picks.pop()
    # the grid spans both answers
    assert got == {(GM_NX, "gmres"): "cgs2_1r", (32, "gmres"): "cgs2_fused",
                   (32, "cg"): "1r", (32, "minres"): "1r",
                   (64, "cg"): "classic"}[nx, solver]
    same, res = _jax_auto(solver, nx, maxiter, P, got)
    assert same, f"the JAX package's auto did not pick {got}"
    _compare(worlds[P][0], tag, res)


@pytest.mark.parametrize("P", WORLDS)
def test_restarted_gmres_on_mesh_matches_one_device(worlds, P):
    """``restarted_gmres`` (GMRES(6), ``cgs2_fused``) on the mesh against
    the port's own single-device run on the whole vectors."""
    nx = GM_NX
    A = ops.convection_diffusion_2d(nx, impl="cuda", device="cpu")
    b = torch.tensor(np.random.RandomState(5).randn(nx * nx))
    res = F.restarted_gmres(A, b, Ml=ops.jacobi_preconditioner(A),
                            tol=GM_TOL, maxiter=6, max_restarts=5,
                            ortho="cgs2_fused")
    _compare(worlds[P][0], "restarted", res)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", NS_SOLVERS)
def test_nonsym_on_mesh_matches_one_device(worlds, name, P):
    """``bicgstab``, ``tfqmr``, ``idrs`` (its shadow panel drawn whole on
    every rank, each keeping its rows) and the flexible ``fgmres`` under
    ``with mesh:``: the one-device iteration count and status, residual
    history within the mesh limit of PERF.md §2 (the same bits on every
    rank), iterate to ``1e-8`` of its largest entry."""
    res = _ns_solve(name)
    ranks = worlds[P]
    r = ranks[0]
    key = f"ns_{name}"
    assert int(r[f"{key}_niter"]) == int(res.niter)
    assert int(r[f"{key}_status"]) == int(res.status) == F.CONVERGED
    np.testing.assert_allclose(r[f"{key}_resnorms"],
                               interop.to_numpy(res.resnorms),
                               rtol=NS_HISTORY_RTOL, atol=1e-14)
    x = interop.to_numpy(res.x)
    np.testing.assert_allclose(r[f"{key}_x"], x, rtol=0,
                               atol=1e-8 * np.max(np.abs(x)))
    assert all(q[f"{key}_resnorms"].tobytes()
               == r[f"{key}_resnorms"].tobytes() for q in ranks)


def _mesh_close(r, key, res, rtol=1e-8, atol=1e-14, x_rtol=1e-8):
    """The one-device iteration count and status, the residual history
    within ``rtol`` and ``atol`` (the same bits on every rank is checked
    by the callers), the iterate to ``x_rtol`` of its largest entry."""
    assert int(r[f"{key}_niter"]) == int(res.niter)
    assert int(r[f"{key}_status"]) == int(res.status)
    np.testing.assert_allclose(r[f"{key}_resnorms"],
                               interop.to_numpy(res.resnorms),
                               rtol=rtol, atol=atol)
    x = interop.to_numpy(res.x).reshape(-1)
    np.testing.assert_allclose(r[f"{key}_x"], x, rtol=0,
                               atol=x_rtol * np.max(np.abs(x)))


@pytest.mark.parametrize("P", LANE16_WORLDS)
@pytest.mark.parametrize("name", ["diag", "poisson"])
@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
def test_lsq_on_mesh_matches_one_device(worlds, solver, name, P):
    """``lsqr``/``lsmr`` under ``with mesh:`` (the two norms of an
    iteration each a local partial and one all-reduce): tests/test_lsq.py's
    sharded diagonal, and Poisson through K8's plain version with
    ``damp``, against the same solve on one device (the histories within
    the mesh limit of PERF.md §2); every rank's history is the same
    bits."""
    A, Ah, b, kw = _ls_problem(name)
    res = getattr(F, solver)(A, b, Ah=Ah, **kw)
    assert int(res.status) == F.CONVERGED
    ranks = worlds[P]
    key = f"ls_{solver}_{name}"
    _mesh_close(ranks[0], key, res, rtol=NS_HISTORY_RTOL)
    assert all(q[f"{key}_resnorms"].tobytes()
               == ranks[0][f"{key}_resnorms"].tobytes() for q in ranks)


@pytest.mark.parametrize("P", LANE16_WORLDS)
@pytest.mark.parametrize("variant", ["classic", "1r", "auto"])
def test_shifted_cg_on_mesh_matches_one_device(worlds, variant, P):
    """Multi-shift CG under ``with mesh:`` against one device: counts,
    per-shift statuses, the explicit residuals and the iterates; classic
    makes 2 all-reduces per iteration and 1r one, whatever the number of
    shifts (4 and 5 more per solve: the length, the two initial norms,
    1r's initial delta and the final residuals); ``auto`` picks 1r on
    these shards (the CPU row of the price model) and gives its iterates
    bit for bit, as tests/test_shifted.py asserts of the JAX package."""
    A, b = _shifted_problem()
    one = "1r" if variant == "auto" else variant
    res = F.shifted_cg(A, b, SH_SHIFTS, tol=SH_TOL, maxiter=400,
                       variant=one)
    assert interop.to_numpy(res.status).tolist() == [F.CONVERGED] * len(
        SH_SHIFTS)
    ranks = worlds[P]
    r = ranks[0]
    key = f"scg_{variant}"
    assert int(r[f"{key}_niter"]) == int(res.niter)
    assert r[f"{key}_status"].tolist() == interop.to_numpy(
        res.status).tolist()
    np.testing.assert_allclose(r[f"{key}_res"], interop.to_numpy(
        res.resnorms), rtol=1e-6, atol=1e-14)
    X = interop.to_numpy(res.X)
    np.testing.assert_allclose(r[f"{key}_X"], X, rtol=0,
                               atol=1e-8 * np.max(np.abs(X)))
    fixed = {"classic": 4, "1r": 5}[one]
    assert int(r[f"{key}_reduces"]) == \
        fixed + SH_REDUCES[one] * int(res.niter)
    if variant == "auto":
        assert r["scg_auto_X"].tobytes() == r["scg_1r_X"].tobytes()
    assert all(q[f"{key}_X"].tobytes() == r[f"{key}_X"].tobytes()
               for q in ranks)


@pytest.mark.parametrize("P", LANE16_WORLDS)
def test_shifted_gmres_on_mesh_matches_one_device(worlds, P):
    """tests/test_shifted.py's sharded family (Poisson, shifts 0..100,
    m = 60, tol 1e-4) at the parity grid: the one-device Krylov
    dimension, statuses, residuals and iterates."""
    A, b = _shifted_problem()
    res = F.shifted_gmres(A, b, np.linspace(0.0, 100.0, SH_GM_SHIFTS),
                          maxiter=SH_GM_MAXITER, tol=SH_GM_TOL)
    assert bool((res.status == F.CONVERGED).all())
    r = worlds[P][0]
    assert int(r["sgm_niter"]) == int(res.niter)
    assert r["sgm_status"].tolist() == interop.to_numpy(res.status).tolist()
    np.testing.assert_allclose(r["sgm_res"], interop.to_numpy(res.resnorms),
                               rtol=1e-6, atol=1e-14)
    X = interop.to_numpy(res.X)
    np.testing.assert_allclose(r["sgm_X"], X, rtol=0,
                               atol=1e-8 * np.max(np.abs(X)))


@functools.lru_cache(maxsize=None)
def _fl_jax(P):
    """The slice-17 solves of the JAX package under ``with mesh:`` on
    ``make_mesh(P)`` (sharded inputs, one jit per solve) and the port's on
    one device: ``{key: (jax result, port result, port all-reduces)}``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as Pspec
    from krypy_tpu import functional as JF, ops as jops, parallel as jp
    from krypy_tpu.functional import sketch as jsk

    mesh = _jmesh(P)
    lap_t, cd_t, b_t, B_t = _fl_problem()
    one = _fl_solves(lap_t, cd_t, b_t, B_t)
    lap = _jax_operator("poisson", GM_NX, GM_NX, mesh)
    cd = _jax_operator("convdiff", GM_NX, GM_NX, mesh)
    b = jp.shard_vector(jnp.asarray(b_t.numpy()), mesh)
    B = jax.device_put(jnp.asarray(B_t.numpy()),
                       NamedSharding(mesh, Pspec("n", None)))
    S = _fl_sketch(GM_NX * GM_NX)
    sk = jsk.KronSketch(S1=jnp.asarray(S.S1.numpy()),
                        S2=jnp.asarray(S.S2.numpy()),
                        signs=jnp.asarray(S.signs.numpy()), N=S.N)
    lmin, lmax = _fl_bounds()
    Mj = jops.jacobi_preconditioner(lap)
    with mesh:
        want = {
            "cheb": jax.jit(lambda v: JF.chebyshev(
                lap, v, M=Mj, lmin=lmin, lmax=lmax, **FL_CHEB))(b),
            "bcg": jax.jit(lambda V: JF.block_cg(
                lap, V, tol=FL_BCG_TOL, maxiter=600))(B),
            "bgm": jax.jit(lambda V: JF.block_gmres(
                lap, V, tol=FL_BGM_TOL, maxiter=200))(B),
            "funm": jax.jit(lambda v: JF.expm_multiply(
                lap, v, -FL_T, maxdim=FL_MAXDIM))(b),
            "arnoldi_expm": JF.expm_multiply(
                cd, b, -FL_CD_T / (GM_NX + 1) ** 2, hermitian=False,
                maxdim=FL_MAXDIM),
            "sgm": jax.jit(lambda v: JF.sketched_gmres(
                lap, v, tol=1e-5, maxiter=FL_SKETCH_M, sketch=sk))(b),
        }
    return {k: (want[k],) + one[k] for k in want}


#: the slice-17 solves' all-reduces beyond their per-iteration ones:
#: Chebyshev's two initial norms (then ONE per block of check_every
#: steps), the matrix functions' length and norm
FL_FIXED = {"cheb": 2}


@pytest.mark.parametrize("P", LANE16_WORLDS)
@pytest.mark.parametrize("key", ["cheb", "bcg", "bgm", "funm",
                                 "arnoldi_expm", "sgm"])
def test_funm_lane_on_mesh_matches_jax(worlds, key, P):
    """Chebyshev (one all-reduce per block of ``check_every`` steps, as
    tests/test_collectives.py pins the JAX form), ``block_cg``,
    ``block_gmres``, ``funm_krylov`` (the Hermitian ``expm_multiply``),
    the Arnoldi ``expm_multiply`` and ``sketched_gmres`` (a sketch drawn
    alike on every rank; each rank sketches its band of the reshape and
    all-reduces once) under ``with mesh:`` against the JAX package on
    ``make_mesh(P)``: counts (Krylov dimensions) and statuses equal,
    iterates to ``1e-10`` of their largest entry, histories (the
    matrix functions' correction tails: ``1e-9`` of ||x||, as on one
    device) to ``1e-8``; against the port on one device the same, and
    every rank's history the same bits."""
    want, one, one_reduces = _fl_jax(P)[key]
    ranks = worlds[P]
    r = ranks[0]
    x = r[f"fl_{key}_x"]
    scale = np.abs(np.asarray(want.x)).max()
    for ref in (want, one):
        xr = np.asarray(ref.x if not isinstance(ref.x, torch.Tensor)
                        else ref.x.numpy())
        np.testing.assert_allclose(x.reshape(xr.shape), xr, rtol=0,
                                   atol=1e-10 * scale)
        if key in ("funm", "arnoldi_expm"):
            assert int(r[f"fl_{key}_niter"]) == ref.m
            got = np.asarray(ref.corrections if not isinstance(
                ref.corrections, torch.Tensor) else ref.corrections.numpy())
            np.testing.assert_allclose(r[f"fl_{key}_res"], got, rtol=1e-8,
                                       atol=1e-9 * np.linalg.norm(xr))
        else:
            assert int(r[f"fl_{key}_niter"]) == int(ref.niter)
            # (sketched GMRES's one cycle of 30 ends short of tol here)
            assert int(r[f"fl_{key}_status"]) == int(ref.status) == (
                F.MAXITER if key == "sgm" else F.CONVERGED)
            got = np.asarray(ref.resnorms if not isinstance(
                ref.resnorms, torch.Tensor) else ref.resnorms.numpy())
            np.testing.assert_allclose(r[f"fl_{key}_res"], got, rtol=1e-8,
                                       atol=1e-14)
    assert all(q[f"fl_{key}_res"].tobytes() == r[f"fl_{key}_res"].tobytes()
               for q in ranks)
    reduces = int(r[f"fl_{key}_reduces"])
    if key == "cheb":
        blocks = int(r["fl_cheb_niter"]) // FL_CHEB["check_every"]
        assert reduces == FL_FIXED["cheb"] + blocks
    # one device makes no all-reduce
    assert one_reduces == 0 and reduces > 0


@functools.lru_cache(maxsize=None)
def _ss_jax(P):
    """The s-step solves of the JAX package under ``with mesh:`` on
    ``make_mesh(P)`` (one jit each) and the port's on one device."""
    import jax
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, ops as jops, parallel as jp

    mesh = _jmesh(P)
    one = {k: run() for k, run in _ss_solves(*_ss_problem()).items()}
    lap = _jax_operator("poisson", GM_NX, GM_NX, mesh, impl="jnp")
    Mj = jops.jacobi_preconditioner(lap)
    b = jp.shard_vector(jnp.ones(GM_NX * GM_NX), mesh)
    with mesh:
        want = {
            "ca_cg": jax.jit(lambda v: JF.ca_cg(
                lap, v, s=SS_S, M=Mj, tol=SS_TOL, maxiter=500))(b),
            "ca_gmres": jax.jit(lambda v: JF.ca_gmres(
                lap, v, s=SS_S, Ml=Mj, tol=SS_GM_TOL, maxiter=512))(b),
            "ca_gmres_newton": jax.jit(lambda v: JF.ca_gmres(
                lap, v, s=SS_S, Ml=Mj, basis="newton", tol=SS_GM_TOL,
                maxiter=512))(b)}
    return {k: (want[k], one[k]) for k in want}


@pytest.mark.parametrize("P", LANE16_WORLDS)
@pytest.mark.parametrize("key", list(SS_BLOCK_REDUCES))
def test_sstep_on_mesh_matches_jax(worlds, key, P):
    """tests/test_sstep.py's sharded ``ca_cg`` and ``ca_gmres`` (and the
    Newton basis) under ``with mesh:``: against the JAX package on
    ``make_mesh(P)`` and the port on one device, counts and statuses
    equal, iterates to ``1e-8`` of their largest entry, histories within
    the mesh limit of PERF.md §2 (``NS_HISTORY_RTOL``; ``atol`` 1e-12: the
    last entry is the explicit residual at ~1e-12, whose own rounding,
    eps ||A|| ||x|| / ||b||, is ~1e-13), every rank's history the same
    bits; then the all-reduces of a block."""
    want, one = _ss_jax(P)[key]
    ranks = worlds[P]
    r = ranks[0]
    tag = f"ss_{key}"
    assert int(r[f"{tag}_status"]) == F.CONVERGED
    _mesh_close(r, tag, one, rtol=NS_HISTORY_RTOL, atol=1e-12)
    _mesh_close(r, tag, SimpleNamespace(
        niter=int(want.niter), status=int(want.status),
        resnorms=torch.tensor(np.asarray(want.resnorms)),
        x=torch.tensor(np.asarray(want.x))), rtol=NS_HISTORY_RTOL,
        atol=1e-12)
    assert all(q[f"{tag}_resnorms"].tobytes()
               == r[f"{tag}_resnorms"].tobytes() for q in ranks)
    lo, hi = SS_COUNT_BLOCKS
    for blocks in SS_COUNT_BLOCKS:
        assert int(r[f"{tag}_niter_{blocks}"]) == blocks * SS_S
    per_block = (int(r[f"{tag}_reduces_{hi}"])
                 - int(r[f"{tag}_reduces_{lo}"])) // (hi - lo)
    assert per_block == SS_BLOCK_REDUCES[key]


@pytest.mark.parametrize("P", LANE16_WORLDS)
def test_dia_on_mesh_takes_neighbour_exchanges_only(worlds, P):
    """tests/test_preconditioners.py:274 and :304: the DIA product of the
    rank's block is scipy's to the bit (the graph Laplacian, float64, its
    wrapping couplings taken as short rolls around the ring of ranks) and
    the one device's (the tridiagonal, float32), through ONE periodic halo
    exchange and no all-reduce or all-gather."""
    mats = _gallery_problems()
    one = _gallery_solves(mats)
    x = np.random.default_rng(3).standard_normal(GAL_DIA_N)
    r = worlds[P][0]
    assert r["gal_lap_dia_y"].tobytes() == (mats["lap_dia"] @ x).tobytes()
    assert r["gal_tri_y"].tobytes() == interop.to_numpy(
        one["tri"][0]).tobytes()
    for key in ("lap_dia", "tri"):
        assert int(r[f"gal_{key}_halo_exchange"]) == 1
        assert int(r[f"gal_{key}_all_reduce_sum"]) == 0
        assert int(r[f"gal_{key}_all_gather"]) == 0


@pytest.mark.parametrize("P", LANE16_WORLDS)
def test_csr_block_jacobi_and_spai_add_no_all_reduce(worlds, P):
    """tests/test_preconditioners.py:247 and :398: CG with block Jacobi
    makes as many all-reduces as with point Jacobi (its blocks are the
    rank's own), GMRES with SPAI (a DIA operator) as many as without; the
    CSR operator takes one all-gather of x per application.  Each solve
    against the one device's within the mesh limit (the GMRES runs are
    float32, as the JAX test's: histories to ``1e-4`` and iterates to
    ``1e-5`` of their largest entry, float32's sums in another order)."""
    one = _gallery_solves(_gallery_problems())
    ranks = worlds[P]
    r = ranks[0]
    for key in ("cg_jacobi", "cg_block_jacobi", "gmres_plain",
                "gmres_spai"):
        f32 = key.startswith("gmres")
        _mesh_close(r, f"gal_{key}", one[key][0],
                    rtol=1e-4 if f32 else NS_HISTORY_RTOL,
                    x_rtol=1e-5 if f32 else 1e-8)
        assert all(q[f"gal_{key}_resnorms"].tobytes()
                   == r[f"gal_{key}_resnorms"].tobytes() for q in ranks)
    assert int(r["gal_cg_jacobi_niter"]) == GAL_CG_ITERS
    assert int(r["gal_cg_block_jacobi_all_reduce_sum"]) == \
        int(r["gal_cg_jacobi_all_reduce_sum"])
    assert int(r["gal_gmres_spai_all_reduce_sum"]) == \
        int(r["gal_gmres_plain_all_reduce_sum"])
    # CG's matvecs: the initial residual and one per iteration
    for key in ("cg_jacobi", "cg_block_jacobi"):
        assert int(r[f"gal_{key}_all_gather"]) >= int(r[f"gal_{key}_niter"])
        assert int(r[f"gal_{key}_halo_exchange"]) == 0
    assert int(r["gal_gmres_spai_all_gather"]) == 0
    # one device makes no collective
    assert all(n == 0 for _, counts in one.values() for n in counts.values())


@pytest.mark.parametrize("P", LANE16_WORLDS)
def test_complex_cgs2_fused_on_mesh_takes_two_passes(worlds, P):
    """A complex system with ``ortho="cgs2_fused"`` under ``with mesh:``
    orthogonalizes by two plain passes over the active rows (the JAX
    package's ``fused_force_jnp``), never through K9, which takes real
    bases; it matches the one-device ``cgs2_fused`` solve."""
    M, rhs = _complex_uneven(P)
    res = F.gmres(torch.tensor(M), torch.tensor(rhs), tol=GM_TOL,
                  maxiter=UNEVEN_N, ortho="cgs2_fused")
    assert int(res.status) == F.CONVERGED
    ranks = worlds[P]
    _mesh_close(ranks[0], "gmres_complex", res)
    assert all(int(q["gmres_complex_k9_calls"]) == 0 for q in ranks)
    assert all(int(q["gmres_uneven_k9_calls"]) > 0 for q in ranks)


@pytest.mark.parametrize("P", WORLDS)
def test_restarted_gmres_on_mesh_matches_jax(worlds, P):
    """``restarted_gmres`` (GMRES(6), ``cgs2_fused``: K8 and K9) on the
    mesh against the JAX restarted GMRES under ``with mesh:`` (its cycle
    compiled, through the sharded Pallas stencil and fused CGS2); every
    rank's residual history is the same bits."""
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, ops as jops, parallel as jp

    mesh = _jmesh(P)
    A = _jax_operator("convdiff", GM_NX, GM_NX, mesh)
    b = jp.shard_vector(
        jnp.asarray(np.random.RandomState(5).randn(GM_NX * GM_NX)), mesh)
    with mesh:
        res = JF.restarted_gmres(A, b, Ml=jops.jacobi_preconditioner(A),
                                 tol=GM_TOL, maxiter=6, max_restarts=5,
                                 ortho="cgs2_fused")
    ranks = worlds[P]
    _compare(ranks[0], "restarted", res)
    assert len(ranks[0]["restarted_resnorms"]) > 7  # more than one cycle
    key = "restarted_resnorms"
    assert all(r[key].tobytes() == ranks[0][key].tobytes() for r in ranks)


@pytest.mark.parametrize("P", WORLDS)
def test_cg_through_k8_matches_jax(worlds, P):
    """CG through the K8 operator against the JAX CG through its sharded
    Pallas stencil under ``with mesh:`` (tests/test_kernels.py:179); the
    same with a rank-local inner-product matrix (the identity's block),
    and through ``sharded_solve`` from the whole right-hand side."""
    import jax
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, parallel as jp

    nx = 32
    mesh = _jmesh(P)
    b = jp.shard_vector(
        jnp.asarray(np.random.RandomState(8).randn(nx * nx)), mesh)
    A = _jax_operator("poisson", nx, nx, mesh)
    with mesh:
        res = jax.jit(lambda v: JF.cg(A, v, tol=1e-10, maxiter=200))(b)
    for key in ("cg", "cg_ip", "sharded_solve"):
        _compare(worlds[P][0], key, res)


@pytest.mark.parametrize("P", WORLDS)
def test_minres_through_k8_matches_jax(worlds, P):
    """MINRES through the K8 operator (the inner products a local
    partial and one all-reduce each) against the JAX MINRES through its
    sharded Pallas stencil under ``with mesh:``; every rank's residual
    history is the same bits."""
    import jax
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, parallel as jp

    nx = 32
    mesh = _jmesh(P)
    b = jp.shard_vector(
        jnp.asarray(np.random.RandomState(8).randn(nx * nx)), mesh)
    A = _jax_operator("poisson", nx, nx, mesh)
    with mesh:
        res = jax.jit(lambda v: JF.minres(A, v, tol=1e-10, maxiter=200))(b)
    ranks = worlds[P]
    _compare(ranks[0], "minres", res)
    assert int(res.status) == F.CONVERGED
    assert all(r["minres_resnorms"].tobytes()
               == ranks[0]["minres_resnorms"].tobytes() for r in ranks)


@pytest.mark.parametrize("P", WORLDS)
def test_mesh_api(worlds, P):
    """``make_global_vector`` assembles the blocks of the whole vector,
    ``replicate`` gives every rank the same tensor, and the active mesh
    is the one of the enclosing ``with`` block (none outside it)."""
    whole = np.random.RandomState(8).randn(32 * 32)
    for r in worlds[P]:
        np.testing.assert_array_equal(r["global_vector"], whole)
        np.testing.assert_array_equal(r["replicate"], [1.0, 2.0])
        assert list(r["mesh_sizes"]) == [0, P, 1, 1]


@pytest.mark.parametrize("P", WORLDS)
def test_deflated_gmres_on_mesh_matches_jax(worlds, P):
    """The dryrun's L3 lane: ``deflated_gmres`` with a sharded basis
    ``eye(N, 2)`` and Jacobi ``Ml`` (nx = 4P, ny = 8)."""
    import jax
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, ops as jops, parallel as jp

    nx, ny = 4 * P, 8
    N = nx * ny
    mesh = _jmesh(P)
    A = jops.convection_diffusion_2d(nx, ny)
    U = jax.device_put(jnp.eye(N, 2), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("n", None)))
    Ml = jops.jacobi_preconditioner(A)
    with mesh:
        res = jax.jit(lambda v, W: JF.deflated_gmres(
            A, v, W, Ml=Ml, tol=1e-6, maxiter=12, ortho="cgs2"))(
                jp.shard_vector(jnp.ones(N), mesh), U)
    r0 = worlds[P][0]
    _compare(r0, "deflated", res)
    np.testing.assert_array_equal(r0["U_roundtrip"], np.eye(N, 2))


@pytest.mark.parametrize("P", WORLDS)
def test_deflated_cg_on_mesh_matches_jax(worlds, P):
    """``deflated_cg`` through K8 with the sharded ``eye(N, 2)`` basis."""
    import jax
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, ops as jops, parallel as jp

    nx, ny = 4 * P, 8
    N = nx * ny
    mesh = _jmesh(P)
    A = jops.poisson_2d(nx, ny)
    U = jax.device_put(jnp.eye(N, 2), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("n", None)))
    with mesh:
        res = jax.jit(lambda v, W: JF.deflated_cg(
            A, v, W, tol=1e-10, maxiter=4 * N))(
                jp.shard_vector(jnp.ones(N), mesh), U)
    _compare(worlds[P][0], "deflated_cg", res)


@pytest.mark.parametrize("P", WORLDS)
def test_recycling_handoff_on_mesh_matches_jax(worlds, P):
    """The dryrun's L4 lane: two ``RecyclingGmres(2, "sm")`` solves; the
    second runs deflated by Ritz vectors of the first's sharded basis.
    The Ritz vectors span the JAX package's (each projects onto the
    other's span within 1e-8); the solves match it."""
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, ops as jops, parallel as jp

    nx, ny = 4 * P, 8
    mesh = _jmesh(P)
    A = jops.convection_diffusion_2d(nx, ny)
    b = jp.shard_vector(jnp.ones(nx * ny), mesh)
    rec = JF.RecyclingGmres(n_vectors=2, which="sm")
    kw = dict(tol=1e-6, maxiter=12, ortho="cgs2")
    with mesh:
        res1 = rec.solve(A, b, **kw)
        res2 = rec.solve(A, b, **kw)
    r0 = worlds[P][0]
    _compare(r0, "recycle1", res1)
    _compare(r0, "recycle2", res2)
    qa = np.linalg.qr(r0["recycle_U"])[0]
    qb = np.linalg.qr(np.asarray(rec._U))[0]
    assert qa.shape == (nx * ny, 2)
    assert np.linalg.norm(qa - qb @ (qb.T @ qa), 2) < 1e-8


@pytest.mark.parametrize("P", WORLDS)
def test_mesh_rejects_what_is_not_ported(worlds, P):
    """``refine_to``, an inner-product matrix that is not rank-local and a
    scalar-callable inner product raise ``NotImplementedError`` on a mesh;
    ``make_mesh`` of another size than the world ``ValueError``.
    (``cgs2_pallas`` runs on a mesh now: test_gmres_on_mesh_matches_jax.)"""
    for r in worlds[P]:
        for key in ("refine_to", "ip_global", "ip_callable"):
            assert str(r[f"err_{key}"]).startswith("NotImplementedError"), \
                (key, str(r[f"err_{key}"]))
        assert "one rank per shard" in str(r["err_make_mesh"])


def _eig_compare(ranks, key, res, rtol=1e-10, width=None, angle=1e-8):
    """A sharded eigensolve against the JAX package's: status and count
    equal, eigenvalues to ``rtol`` (the same bits on every rank), the
    gathered Ritz vectors spanning the same subspace (sine of the largest
    principal angle at most ``angle``)."""
    from torch_eigen_cases import sin_angle

    r = ranks[0]
    assert int(r[f"{key}_status"]) == int(res.status) == F.CONVERGED
    assert int(r[f"{key}_niter"]) == int(res.niter)
    w = slice(None) if width is None else slice(0, width)
    np.testing.assert_allclose(r[f"{key}_theta"][w],
                               np.asarray(res.theta)[w], rtol=rtol)
    assert sin_angle(r[f"{key}_U"][:, w], np.asarray(res.U)[:, w]) <= angle
    assert all(q[f"{key}_theta"].tobytes() == r[f"{key}_theta"].tobytes()
               for q in ranks)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", list(EIG_EIGSH))
def test_eigsh_on_mesh_matches_jax(worlds, name, P):
    """``eigsh`` under ``with mesh:`` (tests/test_eigsh.py's sharded cases
    in float64; single vector and block Lanczos) against the JAX package
    on its P-device mesh."""
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, ops as jops, parallel as jp

    mesh = _jmesh(P)
    d, v0 = _eig_diag(name)
    with mesh:
        res = JF.eigsh(jops.diagonal(jnp.asarray(d)),
                       v0=jp.shard_vector(jnp.asarray(v0), mesh),
                       **EIG_EIGSH[name])
    _eig_compare(worlds[P], f"eigsh_{name}", res)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("variant", ["classic", "fused"])
def test_lobpcg_on_mesh_matches_jax(worlds, variant, P):
    """``lobpcg`` through K8's plain version on the mesh (tests/
    test_lobpcg.py's sharded case, at 8^2) against the JAX package's,
    classic and fused (``variant="auto"``'s pick:
    test_eigen_collectives)."""
    import jax.numpy as jnp
    from krypy_tpu import functional as JF, ops as jops, parallel as jp

    mesh = _jmesh(P)
    nx = EIG_LOBPCG_NX
    X0 = jp.shard_vector(jnp.asarray(_eig_start_block(nx * nx, 3)).T,
                         mesh).T
    with mesh:
        res = JF.lobpcg(jops.poisson_2d(nx), X0=X0, which="sa",
                        tol=EIG_LOBPCG_TOL, variant=variant)
    # each run's subspace is within tol * theta_3 / gap of the invariant
    # one (Davis-Kahan; gap = lambda_22 - lambda_12 of the closed form)
    h = np.pi / (nx + 1)
    lam = [(4 - 2 * np.cos(i * h) - 2 * np.cos(j * h)) * (nx + 1) ** 2
           for i, j in ((1, 2), (2, 2))]
    _eig_compare(worlds[P], f"lobpcg_{variant}", res, rtol=1e-9,
                 angle=2 * EIG_LOBPCG_TOL * lam[0] / (lam[1] - lam[0]))


@pytest.mark.parametrize("P", WORLDS)
def test_eigsh_window_on_mesh_matches_jax(worlds, P):
    """``eigsh_window`` on the mesh (tests/test_filtered.py's sharded case,
    on the diagonal of the 16^2 Laplacian's spectrum: the filter local,
    the SVQB and Rayleigh-Ritz Grams one all-reduce each) against the JAX
    package's."""
    import jax.numpy as jnp
    from krypy_tpu import ops as jops, parallel as jp
    from krypy_tpu.functional.filtered import eigsh_window

    mesh = _jmesh(P)
    N = EIG_NX * EIG_NX
    X0 = jp.shard_vector(jnp.asarray(_eig_start_block(N, 12)).T, mesh).T
    with mesh:
        res = eigsh_window(jops.diagonal(jnp.asarray(_eig_spectrum())),
                           _eig_window_range(), X0=X0, **EIG_WINDOW)
    r = worlds[P][0]
    assert int(r["window_n_inside"]) == int(res.n_inside) > 0
    _eig_compare(worlds[P], "window", res, rtol=1e-9,
                 width=int(res.n_inside))


@pytest.mark.parametrize("P", WORLDS)
def test_eigen_collectives(worlds, P):
    """All-reduces per restart cycle of eigsh (maxdim 12, k = 3: m - l =
    6 Lanczos steps a cycle): the classic CGS2 sweep 3 per step, the
    one-reduce sweep one per step plus the peel and the seal, each cycle
    one more for the dead-row mask; per LOBPCG iteration the fused
    advance ``LOBPCG_FUSED_REDUCES``, fewer than the classic one, and
    ``variant="auto"`` the fused advance on a mesh of more than one
    rank."""
    r = worlds[P][0]
    c1, c2 = EIG_COUNT_RESTARTS
    steps = 12 - 6
    per_cycle = {"cgs2": 3 * steps + 1, "cgs2_1r": steps + 1 + 1}
    for ortho, want in per_cycle.items():
        got = (r[f"eigsh_{ortho}_reduces_{c2}"]
               - r[f"eigsh_{ortho}_reduces_{c1}"]) / (c2 - c1)
        assert got == want, (ortho, got, want)
    fused = r["lobpcg_fused_reduces_3"] - r["lobpcg_fused_reduces_2"]
    classic = r["lobpcg_classic_reduces_3"] - r["lobpcg_classic_reduces_2"]
    assert fused == LOBPCG_FUSED_REDUCES < classic
    for it in (2, 3):
        assert r[f"lobpcg_auto_reduces_{it}"] == \
            r[f"lobpcg_fused_reduces_{it}"]


@pytest.mark.parametrize("N", [10, 12, 13, 3])
@pytest.mark.parametrize("P", WORLDS)
def test_block_layout(N, P):
    """``shard_vector``'s blocks: ceil(N / P) each, in rank order, the last
    ones shorter or empty; where P divides N they are the JAX package's
    shards.  (Where it does not, XLA keeps the JAX vector replicated or
    2-way sharded: ROADMAP.md queue C.)"""
    from krypy_tpu import parallel as jp

    got = [parallel.block_of(N, SimpleNamespace(size=P, rank=r))
           for r in range(P)]
    step = -(-N // P)
    assert [(s.start, s.stop) for s in got] == [
        (min(r * step, N), min((r + 1) * step, N)) for r in range(P)]
    if N % P == 0:
        x = jp.shard_vector(np.arange(N, dtype=float), _jmesh(P))
        want = sorted((s.index[0].start, s.index[0].stop)
                      for s in x.addressable_shards)
        assert [(s.start, s.stop) for s in got] == want


@pytest.mark.parametrize("failure", ["exit", "deadline"])
def test_launch_ranks_stops_the_world(tmp_path, failure):
    """A rank that exits non-zero, or a world that passes its deadline,
    raises with every rank's log, and no rank is left running; a world
    whose ranks all exit 0 returns their logs."""
    script = ("import sys, time\n"
              "rank, mode = int(sys.argv[1]), sys.argv[2]\n"
              "print('rank', rank, flush=True)\n"
              "if rank == 1 and mode == 'exit':\n"
              "    sys.exit(3)\n"
              "time.sleep(0 if mode == 'none' else 60)\n")

    def argv(mode):
        return lambda r: [sys.executable, "-c", script, str(r), mode]

    assert parallel.launch_ranks(argv("none"), 3, tmp_path / "ok", 30) == [
        f"rank {r}\n" for r in range(3)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"exit codes \[") as err:
        parallel.launch_ranks(argv(failure), 3, tmp_path / failure,
                              30 if failure == "exit" else 2)
    assert time.monotonic() - t0 < 20  # not the others' 60 s sleep
    for r in range(3):
        assert f"rank {r}" in str(err.value)
    if failure == "exit":
        assert "3" in str(err.value).splitlines()[0]


def test_axis_name_is_the_one_axis():
    """``make_mesh``, ``shard_vector`` and ``make_global_vector`` take the
    JAX package's ``axis_name=``: ``"n"`` (or None) is the one axis of a
    mesh of the port, any other name raises ``ValueError`` before a
    process group is needed.  No rank world: a stand-in mesh of rank 1 of
    2."""
    from krypy_tpu import parallel as jp

    mesh = SimpleNamespace(size=2, rank=1, device=torch.device("cpu"))
    x = np.arange(10.0)
    want = jp.shard_vector(x, _jmesh(2), axis_name="n")
    assert want.sharding.spec == ("n",)
    for name in (None, "n"):
        np.testing.assert_array_equal(
            interop.to_numpy(parallel.shard_vector(x, mesh,
                                                   axis_name=name)), x[5:])
        np.testing.assert_array_equal(interop.to_numpy(
            parallel.make_global_vector(mesh, lambda i: x[i], (10,),
                                        axis_name=name)), x[5:])
    for call in (lambda: parallel.shard_vector(x, mesh, axis_name="x"),
                 lambda: parallel.make_global_vector(
                     mesh, lambda i: x[i], (10,), axis_name="x"),
                 lambda: parallel.make_mesh(2, axis_name="x")):
        with pytest.raises(ValueError, match="axis"):
            call()
    # "n" passes the check and reaches the process group, which is absent
    with pytest.raises(RuntimeError, match="not initialized"):
        parallel.make_mesh(2, axis_name="n")


def test_init_distributed_rejects_local_device_count():
    with pytest.raises(ValueError, match="no counterpart"):
        parallel.init_distributed(local_device_count=2)


@pytest.mark.parametrize("args,kwargs,want", [
    ((), dict(coordinator_address="10.0.0.1:1234", num_processes=4,
              process_id=2), ("tcp://10.0.0.1:1234", 4, 2)),
    (("localhost:5", 2, 1), {}, ("tcp://localhost:5", 2, 1)),
    (("file:///tmp/x", 3, 0), {}, ("file:///tmp/x", 3, 0)),
    ((), dict(init_method="tcp://h:7", world_size=2, rank=1),
     ("tcp://h:7", 2, 1)),
    ((), {}, (None, -1, -1)),
])
def test_init_distributed_takes_the_jax_keywords(monkeypatch, args, kwargs,
                                                 want):
    """The JAX package's ``coordinator_address`` (``"host:port"``, which
    becomes ``tcp://host:port``), ``num_processes`` and ``process_id``,
    by keyword or position, map to torch's ``init_method``, ``world_size``
    and ``rank``, which stay as keyword extras; a URL passes as it is."""
    seen = {}

    def fake(backend, init_method=None, world_size=-1, rank=-1, **kw):
        seen.update(backend=backend, got=(init_method, world_size, rank))

    monkeypatch.setattr(parallel.dist, "init_process_group", fake)
    parallel.init_distributed(*args, backend="gloo", **kwargs)
    assert seen == {"backend": "gloo", "got": want}
    with pytest.raises(TypeError, match="same argument"):
        parallel.init_distributed("a:1", rank=0, process_id=0)


def test_init_distributed_jax_keywords_start_a_world(tmp_path):
    """One gloo rank started with the JAX package's keywords over
    ``tcp://127.0.0.1`` and a free port: the world has one rank, and a
    mesh's all-reduce runs on it."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    code = (
        "import torch\n"
        "from krypy_tpu_torch import parallel\n"
        f"parallel.init_distributed(coordinator_address='127.0.0.1:{port}',"
        " num_processes=1, process_id=0, backend='gloo', timeout=60)\n"
        "mesh = parallel.make_mesh(1, device='cpu')\n"
        "s = parallel.all_reduce_sum(torch.ones(3), mesh)\n"
        "assert s.tolist() == [1.0, 1.0, 1.0]\n"
        "print('world', mesh.size, mesh.rank, flush=True)\n"
        "torch.distributed.destroy_process_group()\n")
    logs = parallel.launch_ranks(
        lambda r: [sys.executable, "-c", code], 1, tmp_path, 120,
        env={"PYTHONPATH": str(ROOT)})
    assert "world 1 0" in logs[0]


def test_parallel_imports_without_jax():
    """The port's package, its mesh layer included, imports in an
    interpreter where ``jax`` and ``krypy_tpu`` cannot be imported."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['krypy_tpu'] = None\n"
            "import krypy_tpu_torch.parallel, krypy_tpu_torch\n"
            "assert sys.modules['jax'] is None\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
