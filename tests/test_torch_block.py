"""The port's block solvers (``block_cg``, ``block_gmres``) against
krypy_tpu.functional's on the same numpy inputs, float64.

Every case of tests/test_block.py but the sharded ones (those run in
tests/test_torch_parallel.py), with that test's claims on the port's
result and, against the JAX package: block-step counts and statuses
equal, ``X`` to ``1e-10`` relative (norm-wise, per column), per-column
residual histories to ``1e-10`` absolute.  The small eigendecompositions'
eigenvectors differ between the packages by signs (and inside degenerate
eigenspaces, which the duplicate and rank-deficient right-hand sides
make), so ``block_gmres``'s basis is held by what is invariant: the
iterates, the histories and ``V``'s span.

The JAX reference runs through ``jax.jit`` (one compile per shape and
option set).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu_torch import functional as F, ops
from krypy_tpu_torch.functional import block as tblock

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _same(r, rj, x_rtol=1e-10, hist_atol=1e-10):
    assert int(r.niter) == int(rj.niter)
    assert int(r.status) == int(rj.status)
    X, Xj = r.x.numpy(), np.asarray(rj.x)
    assert X.shape == Xj.shape
    err = np.linalg.norm(X - Xj, axis=0) / np.linalg.norm(Xj, axis=0)
    assert err.max() <= x_rtol
    np.testing.assert_allclose(r.resnorms.numpy(), np.asarray(rj.resnorms),
                               rtol=0, atol=hist_atol)


def _dense_spd(n=80, seed=0):
    r = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(r.randn(n, n))
    return Q @ np.diag(np.linspace(1, 100, n)) @ Q.T


@functools.lru_cache(maxsize=None)
def _jax_block(solver, op=None, nx=None, **kw):
    """One jitted JAX block solve per solver, operator and option set:
    ``op`` None takes the matrix as an argument, else it names a stencil
    problem of grid ``nx`` (``"lap"``, ``"lap_jacobi"``:
    Jacobi as ``M``/``Ml``, ``"lap_jacobi2"``: as ``Ml`` and ``Mr``)."""
    fn = getattr(JF, solver)
    if op is None:
        return jax.jit(lambda A, B: fn(A, B, **kw))
    lap = jops.poisson_2d(nx)
    Mj = jops.jacobi_preconditioner(lap)
    pre = {"lap": {}, "lap_jacobi": {"M" if solver == "block_cg" else "Ml":
                                     Mj},
           "lap_jacobi2": {"Ml": Mj, "Mr": Mj}}[op]
    return jax.jit(lambda B: fn(lap, B, **pre, **kw))


def test_block_cg_accelerates_over_single():
    A = _dense_spd()
    B = np.random.RandomState(1).randn(80, 4)
    rj = _jax_block("block_cg", tol=1e-10, maxiter=200)(jnp.asarray(A),
                                                      jnp.asarray(B))
    r = F.block_cg(_t(A), _t(B), tol=1e-10, maxiter=200)
    _same(r, rj)
    assert int(r.status) == 0
    rels = np.linalg.norm(B - A @ r.x.numpy(), axis=0) / np.linalg.norm(
        B, axis=0)
    assert (rels <= 1e-9).all()
    worst_single = max(int(F.cg(_t(A), _t(B[:, j]), tol=1e-10,
                                maxiter=200).niter) for j in range(4))
    assert int(r.niter) < worst_single


def test_block_cg_rank_collapse_duplicate_columns():
    nx = 24
    lap = ops.poisson_2d(nx, device="cpu")
    Mj = ops.jacobi_preconditioner(lap)
    N = nx * nx
    B = np.stack([np.ones(N), np.ones(N), np.linspace(0, 1, N)], axis=1)
    rj = _jax_block("block_cg", "lap_jacobi", nx, tol=1e-10,
                    maxiter=400)(jnp.asarray(B))
    r = F.block_cg(lap, _t(B), M=Mj, tol=1e-10, maxiter=400)
    _same(r, rj)
    assert int(r.status) == 0
    for j in range(3):
        rel = float(torch.linalg.norm(_t(B[:, j]) - lap(r.x[:, j]))
                    / np.linalg.norm(B[:, j]))
        assert rel <= 1e-9


def test_block_cg_shapes_and_errors():
    A = _dense_spd(20)
    with pytest.raises(ValueError, match="block_cg expects B"):
        F.block_cg(_t(A), torch.ones(20, dtype=torch.float64))
    res = F.block_cg(_t(A), torch.ones((20, 2), dtype=torch.float64),
                     tol=1e-12)
    assert res.x.shape == (20, 2)
    assert res.resnorms.shape[1] == 2
    rj = JF.block_cg(jnp.asarray(A), jnp.ones((20, 2)), tol=1e-12)
    _same(res, rj)
    assert res.resnorms.shape == rj.resnorms.shape


@pytest.mark.parametrize("floor_ratio", [1e-12, 1e-3])
def test_block_cg_x0_and_floor(floor_ratio):
    """``X0`` and a coarse rank-collapse floor (which drops live
    directions: the solve still converges, in more steps)."""
    A = _dense_spd(60, 4)
    rng = np.random.RandomState(5)
    B, X0 = rng.randn(60, 3), rng.randn(60, 3)
    kw = dict(tol=1e-10, maxiter=200, floor_ratio=floor_ratio)
    rj = JF.block_cg(jnp.asarray(A), jnp.asarray(B), X0=jnp.asarray(X0),
                     **kw)
    r = F.block_cg(_t(A), _t(B), X0=_t(X0), **kw)
    _same(r, rj)
    assert int(r.status) == 0


def test_block_cg_callable_columnwise():
    """A matvec-only operator is applied one column at a time (k calls
    per step, plus k for the start and k of ``M``)."""
    d = np.linspace(1.0, 30.0, 200)
    D = torch.tensor(d)
    calls = {"A": 0, "M": 0}

    def A(v):
        assert v.ndim == 1
        calls["A"] += 1
        return D * v

    def M(v):
        calls["M"] += 1
        return v / D.sqrt()

    B = np.random.RandomState(2).randn(200, 3)
    r = F.block_cg(A, _t(B), M=M, tol=1e-10, maxiter=100)
    rj = JF.block_cg(lambda v: jnp.asarray(d)[:, None] * v if v.ndim == 2
                     else jnp.asarray(d) * v, jnp.asarray(B),
                     M=lambda v: v / jnp.sqrt(jnp.asarray(d)), tol=1e-10,
                     maxiter=100)
    _same(r, rj)
    steps = int(r.niter)
    assert calls == {"A": 3 * (steps + 1), "M": 3 * (steps + 1)}


def test_guarded_solve_drops_the_floor():
    """A rank-one Gram: the guarded solve keeps the one live direction,
    as the JAX package's."""
    from krypy_tpu.functional import block as jblock

    u = np.array([1.0, 2.0, 2.0])
    G = np.outer(u, u) + 1e-15 * np.eye(3)
    rhs = np.random.RandomState(0).randn(3, 2)
    got = tblock._guarded_solve(_t(G), _t(rhs), 1e-12).numpy()
    want = np.asarray(jblock._guarded_solve(jnp.asarray(G), jnp.asarray(rhs),
                                            1e-12))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got, np.outer(u, u @ rhs) / (u @ u) ** 2,
                               rtol=1e-10)


# ---------------------------------------------------------------- block GMRES


def test_block_gmres_nonsymmetric_beats_single():
    rng = np.random.RandomState(0)
    A = np.diag(np.linspace(1, 10, 100)) + 0.1 * rng.randn(100, 100)
    B = rng.randn(100, 4)
    rj = _jax_block("block_gmres", tol=1e-10, maxiter=60)(jnp.asarray(A),
                                                         jnp.asarray(B))
    r = F.block_gmres(_t(A), _t(B), tol=1e-10, maxiter=60)
    _same(r, rj)
    assert int(r.status) == 0
    X = r.x.numpy()
    rels = np.linalg.norm(B - A @ X, axis=0) / np.linalg.norm(B, axis=0)
    assert rels.max() <= 1e-10
    single = F.gmres(_t(A), _t(B[:, 0]), tol=1e-10, maxiter=60)
    assert int(r.niter) < int(single.niter)


def test_block_gmres_complex():
    rng = np.random.RandomState(1)
    A = (np.diag(np.linspace(1, 8, 60))
         + 0.05 * (rng.randn(60, 60) + 1j * rng.randn(60, 60)))
    B = rng.randn(60, 3) + 1j * rng.randn(60, 3)
    rj = _jax_block("block_gmres", tol=1e-10, maxiter=60)(jnp.asarray(A),
                                                         jnp.asarray(B))
    r = F.block_gmres(_t(A), _t(B), tol=1e-10, maxiter=60)
    _same(r, rj)
    assert int(r.status) == 0
    X = r.x.numpy()
    rels = np.linalg.norm(B - A @ X, axis=0) / np.linalg.norm(B, axis=0)
    assert rels.max() <= 1e-10


def test_block_gmres_rank_deficient_rhs():
    rng = np.random.RandomState(2)
    nx = 32
    lap = ops.poisson_2d(nx, device="cpu")
    Mj = ops.jacobi_preconditioner(lap)
    B = np.stack([np.ones(nx * nx), np.ones(nx * nx), rng.randn(nx * nx)],
                 axis=1)
    rj = _jax_block("block_gmres", "lap_jacobi", nx, tol=1e-9,
                    maxiter=150)(jnp.asarray(B))
    r = F.block_gmres(lap, _t(B), Ml=Mj, tol=1e-9, maxiter=150)
    _same(r, rj, x_rtol=1e-9)
    assert int(r.status) == 0
    for j in range(3):
        rel = float(torch.linalg.norm(_t(B[:, j]) - lap(r.x[:, j]))
                    / np.linalg.norm(B[:, j]))
        assert rel <= 1e-8


def test_block_gmres_preconditioned_stencil():
    nx = 24
    lap = ops.poisson_2d(nx, device="cpu")
    Mj = ops.jacobi_preconditioner(lap)
    B = np.stack([np.ones(nx * nx), np.linspace(0.0, 1.0, nx * nx)], axis=1)
    rj = _jax_block("block_gmres", "lap_jacobi2", nx, tol=1e-9,
                    maxiter=200)(jnp.asarray(B))
    r = F.block_gmres(lap, _t(B), Ml=Mj, Mr=Mj, tol=1e-9, maxiter=200)
    _same(r, rj)
    assert int(r.status) == 0
    for j in range(2):
        rel = float(torch.linalg.norm(_t(B[:, j]) - lap(r.x[:, j]))
                    / np.linalg.norm(B[:, j]))
        assert rel <= 1e-8


def test_block_gmres_x0_default_maxiter_and_internals():
    """``X0``, the default ``maxiter = N // k``, ``return_internal``: V's
    rows orthonormal (``conj(V) V^T = I`` on the live rows) and spanning
    the JAX package's, ``H`` the relation ``Ml A Mr V^T = V^T H`` (row
    form) on the steps taken; a 1-D ``B`` raises."""
    rng = np.random.RandomState(3)
    n, k = 120, 2
    A = np.diag(np.linspace(1, 4, n)) + 0.05 * rng.randn(n, n)
    B, X0 = rng.randn(n, k), rng.randn(n, k)
    rj, ij = JF.block_gmres(jnp.asarray(A), jnp.asarray(B),
                            X0=jnp.asarray(X0), tol=1e-10,
                            return_internal=True)
    r, it = F.block_gmres(_t(A), _t(B), X0=_t(X0), tol=1e-10,
                          return_internal=True)
    _same(r, rj)
    assert r.resnorms.shape == (n // k + 1, k)
    s = int(r.niter)
    assert (s + 1) * k < n
    V = it["V"][: (s + 1) * k].numpy()
    Vj = np.asarray(ij["V"])[: (s + 1) * k]
    live = np.linalg.norm(V, axis=1) > 0
    G = V[live].conj() @ V[live].T
    np.testing.assert_allclose(G, np.eye(live.sum()), atol=1e-10)
    # the same span: Vj's live rows lie in V's
    P = V[live].T @ V[live].conj()
    np.testing.assert_allclose(Vj @ P.T, Vj, atol=1e-8)
    H = it["H"][: (s + 1) * k, : s * k].numpy()
    np.testing.assert_allclose(A @ V[: s * k].T, V.T @ H, atol=1e-9)
    with pytest.raises(ValueError, match="block_gmres expects B"):
        F.block_gmres(_t(A), _t(B[:, 0]))


def test_card_problem_block_cg_beats_single_cg():
    """The card phase's block_cg problem at 31^2 through K1's plain version
    and the unpadded V-cycle: four right-hand sides (ones, seeded random,
    one sine mode, linspace), the count at or below single-vector CG's
    worst column, and block_gmres with ``Ml`` the V-cycle on the north
    star's operator (k = 2), the per-column true residuals."""
    nx = 31
    N = nx * nx
    lap = ops.poisson_2d(nx, impl="cuda", device="cpu")
    M = ops.multigrid_poisson_preconditioner(nx, impl="cuda", device="cpu")
    g = np.arange(1, nx + 1) / (nx + 1)
    sine = np.outer(np.sin(np.pi * g), np.sin(2 * np.pi * g)).reshape(-1)
    B = np.stack([np.ones(N), np.random.default_rng(17).standard_normal(N),
                  sine, np.linspace(0.0, 1.0, N)], axis=1)
    r = F.block_cg(lap, _t(B), M=M, tol=1e-8, maxiter=100)
    assert int(r.status) == 0
    worst = max(int(F.cg(lap, _t(B[:, j]), M=M, tol=1e-8, maxiter=100).niter)
                for j in range(4))
    assert int(r.niter) <= worst
    rel = np.linalg.norm(B - np.stack([lap(r.x[:, j]).numpy()
                                       for j in range(4)], 1), axis=0)
    assert (rel / np.linalg.norm(B, axis=0)).max() <= 1e-8
    h2 = 1.0 / (nx + 1) ** 2
    A = ops.convection_diffusion_2d(nx, wind=(h2, 0.5 * h2), eps=h2,
                                    pad_cols=True, impl="cuda", device="cpu")
    Ml = ops.multigrid_poisson_preconditioner(
        nx, coarsest=7, pad_cols=True, impl="cuda", scale=1.0 / h2,
        device="cpu")
    B2 = torch.stack([ops.pad_grid_vec(_t(c), nx, nx) for c in (
        np.ones(N), np.linspace(0.0, 1.0, N))], dim=1)
    r = F.block_gmres(A, B2, Ml=Ml, tol=1e-9, maxiter=40)
    assert int(r.status) == 0
    AX = torch.stack([A(r.x[:, j]) for j in range(2)], 1)
    rel = torch.linalg.norm(B2 - AX, dim=0) / torch.linalg.norm(B2, dim=0)
    assert float(rel.max()) <= 1e-8
