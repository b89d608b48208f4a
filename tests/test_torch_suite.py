"""The deflation slice end to end at 127^2: benchmarks/suite.py's config 4
(Ritz-deflated GMRES on the shifted Laplacian) in its equilibrated,
multigrid-preconditioned form, and the four-system recycling sequence,
through both packages.

The port's side is :mod:`krypy_tpu_torch.suite`, the pipeline the card
runs (``chip_smoke.py``); the JAX side is the same pipeline written with
the JAX package (its Pallas kernels in interpret mode on the kernel lane).

Float32 reductions are summed in another order in the two frameworks
(ROADMAP.md queue C), so the inner iteration counts may move by one per
float32 solve: the harvest, each recycling solve and a refined solve's
total within 1; the refinement cycle count may not move, both sides must reach the float64 target 1e-8, and the six
Ritz values of the harvest agree to 1e-3 (float32 Hessenberg entries,
eigenvalues separated by 0.1).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu_torch import suite

torch.set_num_threads(1)

NX = 127
LANES = [
    # the kernel lane: K1-K3 in the V-cycle and the matvec, K7 in the
    # orthogonalization (plain versions on the CPU; JAX interpreted)
    ("pallas", "cuda", "cgs2_pallas"),
    # the plain lane the card compares the kernel lane with
    ("jnp", "torch", "cgs2"),
]


def _jax_system(nx, sigma, impl, dtype=jnp.float32):
    h2 = (1.0 / (nx + 1)) ** 2
    A32, _, _ = jops._padded_stencil_matvec(
        nx, nx, (4.0 - sigma * h2, -1.0, -1.0, -1.0, -1.0), impl)
    h2_f32 = jnp.float32(h2)
    b32 = jops.pad_grid_vec(jnp.full(nx * nx, h2_f32, dtype), nx, nx)
    Ml = jops.multigrid_poisson_preconditioner(
        nx, coarsest=31, coarse_sweeps=60, pad_cols=True, impl=impl,
        scale=1.0 / h2)
    return A32, b32, Ml, h2_f32


def _jax_config4(nx, impl, ortho):
    """suite.make_config4 with the JAX package: ``(niter0, theta, runs)``
    with ``runs[kind] = (cycles, inner_iters, rel, outer residuals)``."""
    A32, b32, Ml, h2_f32 = _jax_system(nx, suite.SIGMA, impl)
    A64 = jops.shifted_laplacian_2d(nx, sigma=suite.SIGMA)
    kw = dict(Ml=Ml, tol=suite.INNER_TOL, maxiter=suite.RESTART, ortho=ortho)
    res0, internals = JF.gmres(A32, b32, return_internal=True, **kw)
    internals = dict(internals)
    niter0 = int(res0.niter)
    internals["niter"] = niter0
    internals["E"] = jnp.zeros((0, 0))
    theta = JF.ritz_pairs(internals, hermitian=False)[0]
    theta = theta[np.argsort(np.abs(theta))]
    U = JF.ritz_deflation_vectors(
        internals, n_vectors=min(suite.N_VECTORS, niter0 - 1), which="sm",
        hermitian=False)
    b = jnp.ones(nx * nx, jnp.float64)
    runs = {}
    for kind in ("deflated", "undeflated"):
        def inner(r32, kind=kind):
            rs = jops.pad_grid_vec(r32 * h2_f32, nx, nx)
            res = (JF.deflated_gmres(A32, rs, U, **kw) if kind == "deflated"
                   else JF.gmres(A32, rs, **kw))
            return res._replace(x=jops.unpad_grid_vec(res.x, nx, nx))

        res, info = JF.refine_to(A64, b, inner, tol=suite.TOL, compiled=True)
        rel = float(jnp.linalg.norm(b - A64(res.x)) / jnp.linalg.norm(b))
        runs[kind] = (info["cycles"], int(info["inner_iters"]), rel,
                      np.asarray(res.resnorms)[: info["cycles"] + 1].tolist())
    return niter0, theta, runs


@pytest.mark.parametrize("jax_impl,impl,ortho", LANES,
                         ids=["kernel-lane", "plain-lane"])
def test_config4_matches_jax(jax_impl, impl, ortho):
    niter_j, theta_j, runs_j = _jax_config4(NX, jax_impl, ortho)
    harvest, make_solve, A64 = suite.make_config4(NX, impl, ortho, "cpu")
    res0, U, theta = harvest()
    assert abs(int(res0.niter) - niter_j) <= 1
    assert U.shape == (res0.x.shape[0], suite.N_VECTORS)
    assert U.dtype == torch.float32 and U.T.is_contiguous()
    np.testing.assert_allclose(np.sort(np.real(theta[:6])),
                               np.sort(np.real(theta_j[:6])), atol=1e-3)
    b = torch.ones(NX * NX, dtype=torch.float64)
    iters = {}
    for kind, basis in (("deflated", U), ("undeflated", None)):
        res, info = make_solve(basis)(b)
        rel = float(torch.linalg.vector_norm(b - A64(res.x))
                    / torch.linalg.vector_norm(b))
        cycles_j, iters_j, rel_j, _ = runs_j[kind]
        assert res.x.dtype == torch.float64 and res.x.shape == (NX * NX,)
        assert rel <= suite.TOL and rel_j <= suite.TOL
        assert info["cycles"] == cycles_j
        assert abs(info["inner_iters"] - iters_j) <= 1
        iters[kind] = info["inner_iters"]
    # deflation pays: fewer inner iterations to the same target
    assert iters["deflated"] < iters["undeflated"]


@pytest.mark.parametrize("jax_impl,impl,ortho", LANES,
                         ids=["kernel-lane", "plain-lane"])
def test_recycling_sequence_matches_jax(jax_impl, impl, ortho):
    rec = JF.RecyclingGmres(n_vectors=suite.N_VECTORS, which="sm",
                            hermitian=False)
    want = []
    for sigma in suite.SIGMAS:
        A32, b32, Ml, _ = _jax_system(NX, sigma, jax_impl)
        res = rec.solve(A32, b32, Ml=Ml, tol=suite.INNER_TOL,
                        maxiter=suite.RESTART, ortho=ortho)
        want.append((int(res.niter), int(res.status)))
    runs = suite.recycling_sequence(NX, impl, ortho, "cpu")
    plain = suite.recycling_sequence(NX, impl, ortho, "cpu", recycle=False)
    assert [r["sigma"] for r in runs] == list(suite.SIGMAS)
    for r, (niter_j, status_j) in zip(runs, want):
        assert r["status"] == status_j == 0
        assert abs(r["niter"] - niter_j) <= 1
        assert np.isfinite(r["rel"])
        # converged in the residual the solve stops on, recomputed (1%
        # for the float32 recomputation)
        assert r["rel_prec"] <= 1.01 * suite.INNER_TOL
    # the first solve has nothing to recycle; the later ones save
    # iterations
    assert runs[0]["niter"] == plain[0]["niter"]
    assert all(r["niter"] < p["niter"] for r, p in zip(runs[1:], plain[1:]))


def test_kappa_bound_against_the_dense_operator():
    """The condition number of ``Lap - sigma I`` at 15^2, from numpy's
    singular values."""
    nx = 15
    lap1 = (np.diag(np.full(nx, 2.0)) - np.diag(np.ones(nx - 1), 1)
            - np.diag(np.ones(nx - 1), -1)) * (nx + 1) ** 2
    dense = (np.kron(lap1, np.eye(nx)) + np.kron(np.eye(nx), lap1)
             - suite.SIGMA * np.eye(nx * nx))
    np.testing.assert_allclose(suite.kappa_bound(nx), np.linalg.cond(dense),
                               rtol=1e-10)


def test_entry_points_default_to_the_card():
    """``make_config4`` and ``recycling_sequence`` build on ``"cuda"``
    unless asked for the CPU, and raise where torch sees no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        suite.make_config4(31, "torch", "cgs2")
    with pytest.raises(RuntimeError, match="CUDA"):
        suite.recycling_sequence(31, "torch", "cgs2")


def _first_cycles_float64(nx):
    """Both packages' FIRST refinement cycle with float64 inner arithmetic
    on the plain lane: harvest, six Ritz vectors, then one deflated and
    one undeflated inner solve of the right-hand side, and the float64
    relative residual each leaves.  Float64 takes the rounding noise out,
    so the two packages' values can be compared digit for digit.  Returns
    ``{(package, kind): (harvest niter, inner niter, residual)}``."""
    out = {}
    A, b_in, Ml, h2 = _jax_system(nx, suite.SIGMA, "jnp", jnp.float64)
    A64 = jops.shifted_laplacian_2d(nx, sigma=suite.SIGMA)
    kw = dict(Ml=Ml, tol=suite.INNER_TOL, maxiter=suite.RESTART, ortho="cgs2")
    res0, internals = JF.gmres(A, b_in, return_internal=True, **kw)
    internals = dict(internals)
    internals["niter"] = int(res0.niter)
    internals["E"] = jnp.zeros((0, 0))
    U = JF.ritz_deflation_vectors(internals, n_vectors=suite.N_VECTORS,
                                  which="sm", hermitian=False)
    b = jnp.ones(nx * nx, jnp.float64)
    rs = jops.pad_grid_vec(b * jnp.float64(h2), nx, nx)
    for kind in ("deflated", "undeflated"):
        res = (JF.deflated_gmres(A, rs, U, **kw) if kind == "deflated"
               else JF.gmres(A, rs, **kw))
        x = jops.unpad_grid_vec(res.x, nx, nx)
        rel = float(jnp.linalg.norm(b - A64(x)) / jnp.linalg.norm(b))
        out["jax", kind] = (int(res0.niter), int(res.niter), rel)
    harvest, make_solve, A64t = suite.make_config4(
        nx, "torch", "cgs2", "cpu", dtype=torch.float64)
    res0, U, _ = harvest()
    assert U.dtype == torch.float64
    bt = torch.ones(nx * nx, dtype=torch.float64)
    for kind, basis in (("deflated", U), ("undeflated", None)):
        res = make_solve(basis).inner(bt)
        rel = float(torch.linalg.vector_norm(bt - A64t(res.x))
                    / torch.linalg.vector_norm(bt))
        out["port", kind] = (int(res0.niter), int(res.niter), rel)
    return out


def test_config4_float64_first_cycle_matches_jax():
    """``make_config4(dtype=float64)``: with the rounding noise gone the
    port's first refinement cycle, deflated and undeflated, leaves the
    JAX package's float64 residual to 1e-8 relative, after the same
    iteration counts."""
    out = _first_cycles_float64(NX)
    for kind in ("deflated", "undeflated"):
        assert out["port", kind][:2] == out["jax", kind][:2]
        np.testing.assert_allclose(out["port", kind][2], out["jax", kind][2],
                                   rtol=1e-8)


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_suite.py NX [float64]: both
    # packages' config-4 solves on the plain lane of this host's CPU at
    # one grid size, with their float64 outer residuals cycle by cycle
    # (how the first float32 cycle of the deflated solve fares against
    # the undeflated one as the grid grows); with ``float64``, only the
    # first cycle of each, in float64 inner arithmetic
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    nx = int(sys.argv[1])
    if sys.argv[2:] == ["float64"]:
        for (package, kind), (n0, n, rel) in _first_cycles_float64(
                nx).items():
            print(f"{package:4s} float64 nx={nx} {kind}: harvest {n0}, {n} "
                  f"inner iterations, residual after the first cycle "
                  f"{rel!r}", flush=True)
        sys.exit(0)
    niter_j, _, runs_j = _jax_config4(nx, "jnp", "cgs2")
    for kind, (cycles, iters, rel, hist) in runs_j.items():
        print(f"jax  nx={nx} {kind}: harvest {niter_j}, {cycles} cycles, "
              f"{iters} inner iterations, rel {rel:.3e}, outer {hist}",
              flush=True)
    harvest, make_solve, A64 = suite.make_config4(nx, "torch", "cgs2", "cpu")
    res0, U, _ = harvest()
    b = torch.ones(nx * nx, dtype=torch.float64)
    for kind, basis in (("deflated", U), ("undeflated", None)):
        res, info = make_solve(basis)(b)
        print(f"port nx={nx} {kind}: harvest {int(res0.niter)}, "
              f"{info['cycles']} cycles, {info['inner_iters']} inner "
              f"iterations, rel {float(res.resnorms.min()):.3e}, outer "
              f"{res.resnorms.tolist()}", flush=True)
