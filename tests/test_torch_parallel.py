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
#: a length that divides over neither world: K9 runs on blocks of
#: unequal length there, the JAX package its two-pass ``fused_force_jnp``
UNEVEN_N = 61
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
