"""The port's CG (krypy_tpu_torch.functional.cg) against
krypy_tpu.functional.cg in float64 on the same numpy inputs: the same
iteration count and status, residual histories to 1e-10 relative and
solutions to 1e-10 relative.  Float64 reductions taken in another order
differ by round-off, which stays many digits below both bounds; the one
exception is a history entry at the round-off floor itself (an exact
final step gives ~1e-16), hence the absolute 1e-13 beside the relative
bound."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu_torch import functional as F, interop, ops

torch.set_num_threads(1)


def _t(a):
    return interop.from_numpy(np.asarray(a), "cpu")


def _compare(rj, rt, rtol=1e-10):
    assert int(rt.niter) == int(rj.niter)
    assert int(rt.status) == int(rj.status)
    want = np.asarray(rj.resnorms)
    got = interop.to_numpy(rt.resnorms)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    live = ~np.isnan(want)
    np.testing.assert_allclose(got[live], want[live], rtol=rtol, atol=1e-13)
    xj, xt = np.asarray(rj.x), interop.to_numpy(rt.x)
    assert np.linalg.norm(xt - xj) <= rtol * np.linalg.norm(xj)


def _rhs(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def test_cg_poisson_jacobi_matches_jax():
    nx = 15
    b = _rhs(nx * nx, 0)
    Aj, At = jops.poisson_2d(nx), ops.poisson_2d(nx, device="cpu")
    rj = JF.cg(Aj, jnp.asarray(b), M=jops.jacobi_preconditioner(Aj),
               tol=1e-10, maxiter=200)
    rt = F.cg(At, _t(b), M=ops.jacobi_preconditioner(At), tol=1e-10,
              maxiter=200)
    assert int(rt.status) == F.CONVERGED
    _compare(rj, rt)


def test_cg_padded_multigrid_matches_jax():
    nx = 31
    bp = np.asarray(jops.pad_grid_vec(jnp.asarray(_rhs(nx * nx, 1)), nx,
                                      nx))
    kw = dict(coarsest=7, coarse_sweeps=12, pad_cols=True)
    Aj = jops.poisson_2d(nx, pad_cols=True)
    At = ops.poisson_2d(nx, pad_cols=True, device="cpu")
    rj = JF.cg(Aj, jnp.asarray(bp),
               M=jops.multigrid_poisson_preconditioner(nx, **kw),
               tol=1e-10, maxiter=40)
    rt = F.cg(At, _t(bp),
              M=ops.multigrid_poisson_preconditioner(nx, device="cpu", **kw),
              tol=1e-10, maxiter=40)
    assert int(rt.status) == F.CONVERGED
    _compare(rj, rt)


def test_cg_maxiter_status():
    nx = 15
    b = _rhs(nx * nx, 2)
    Aj, At = jops.poisson_2d(nx), ops.poisson_2d(nx, device="cpu")
    rj = JF.cg(Aj, jnp.asarray(b), tol=1e-12, maxiter=7)
    rt = F.cg(At, _t(b), tol=1e-12, maxiter=7)
    assert int(rt.status) == F.MAXITER and int(rt.niter) == 7
    _compare(rj, rt)


@pytest.mark.parametrize("explicit", [False, True])
def test_cg_x0_ml_mr_exact_solution_match_jax(explicit):
    """Split preconditioning Ml = Mr = diag^{-1/2}, an initial guess,
    error-norm tracking and the explicit-residual policy."""
    nx = 15
    N = nx * nx
    b, x0 = _rhs(N, 3), _rhs(N, 4)
    d = np.full(N, 8.0 * (nx + 1) ** 2)
    s = 1.0 / np.sqrt(d)
    Aj, At = jops.poisson_2d(nx), ops.poisson_2d(nx, device="cpu")
    lap1 = (np.diag(np.full(nx, 2.0)) - np.diag(np.ones(nx - 1), 1)
            - np.diag(np.ones(nx - 1), -1)) * (nx + 1) ** 2
    dense = np.kron(lap1, np.eye(nx)) + np.kron(np.eye(nx), lap1)
    xs = np.linalg.solve(dense, b)
    kw = dict(tol=1e-9, maxiter=100, explicit_residual=explicit)
    rj = JF.cg(Aj, jnp.asarray(b), Ml=lambda v: jnp.asarray(s) * v,
               Mr=lambda v: jnp.asarray(s) * v, x0=jnp.asarray(x0),
               exact_solution=jnp.asarray(xs), **kw)
    rt = F.cg(At, _t(b), Ml=lambda v: _t(s) * v, Mr=lambda v: _t(s) * v,
              x0=_t(x0), exact_solution=_t(xs), **kw)
    _compare(rj, rt)
    ej, et = np.asarray(rj.errnorms), interop.to_numpy(rt.errnorms)
    live = ~np.isnan(ej)
    np.testing.assert_array_equal(np.isnan(et), ~live)
    np.testing.assert_allclose(et[live], ej[live], rtol=1e-9, atol=1e-13)


def test_cg_weighted_inner_product_matches_jax():
    n = 40
    rng = np.random.default_rng(5)
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    B = np.diag(rng.uniform(1.0, 3.0, n)) @ A
    b = rng.standard_normal(n)
    rj = JF.cg(jnp.asarray(np.linalg.solve(B, A)), jnp.asarray(b),
               ip=jnp.asarray(B), tol=1e-10, maxiter=n)
    rt = F.cg(_t(np.linalg.solve(B, A)), _t(b), ip=_t(B), tol=1e-10,
              maxiter=n)
    _compare(rj, rt, rtol=1e-9)


def test_cg_column_rhs_shape():
    nx = 7
    b = _rhs(nx * nx, 6)[:, None]
    rt = F.cg(ops.poisson_2d(nx, device="cpu"), _t(b), tol=1e-10, maxiter=60)
    assert tuple(rt.x.shape) == b.shape
    rj = JF.cg(jops.poisson_2d(nx), jnp.asarray(b), tol=1e-10, maxiter=60)
    _compare(rj, rt)


def test_cg_stagnation_returns_best_iterate():
    """With the stagnation guard the solve stops at the float32 floor
    and returns the iterate whose (explicit) residual is the best seen,
    as the JAX core does."""
    nx = 31
    kw = dict(coarsest=7, coarse_sweeps=12, pad_cols=True)
    At = ops.poisson_2d(nx, pad_cols=True, device="cpu")
    Mt = ops.multigrid_poisson_preconditioner(nx, device="cpu", **kw)
    bp = np.asarray(jops.pad_grid_vec(
        jnp.asarray(_rhs(nx * nx, 7)), nx, nx)).astype(np.float32)
    common = dict(tol=1e-12, maxiter=60, stagnation_window=3,
                  explicit_residual=True)
    rt = F.cg(At, _t(bp), M=Mt, **common)
    niter = int(rt.niter)
    assert niter < 60 and int(rt.status) == F.MAXITER
    hist = interop.to_numpy(rt.resnorms)[: niter + 1]
    # the stop rule: the last `window` iterations did not improve
    assert np.all(hist[-3:] >= np.float32(0.99) * np.min(hist[:-3]))
    # the returned x is the best-residual iterate: its explicit M-norm
    # residual is the smallest of the history
    r = bp - interop.to_numpy(At(rt.x))
    Mr = interop.to_numpy(Mt(_t(r)))
    Mb = interop.to_numpy(Mt(_t(bp)))
    rel = np.sqrt(np.dot(r, Mr)) / np.sqrt(np.dot(bp, Mb))
    np.testing.assert_allclose(rel, np.min(hist), rtol=1e-3)
    # same semantics on the JAX side
    rj = JF.cg(jops.poisson_2d(nx, pad_cols=True), jnp.asarray(bp),
               M=jops.multigrid_poisson_preconditioner(nx, **kw), **common)
    assert int(rj.status) == F.MAXITER and int(rj.niter) < 60


def test_cg_deflation_hooks_match_jax():
    """``operator_override``, ``projected_r0`` and ``correct_xk`` with
    the orthogonal projection off one fixed direction (which keeps the
    projected operator symmetric positive semidefinite)."""
    nx = 11
    b = _rhs(nx * nx, 8)
    u = _rhs(nx * nx, 9)
    u /= np.linalg.norm(u)
    Aj, At = jops.poisson_2d(nx), ops.poisson_2d(nx, device="cpu")
    ut, uj = _t(u), jnp.asarray(u)

    def pt(v):
        return v - ut * torch.dot(ut, v)

    def pj(v):
        return v - uj * jnp.dot(uj, v)

    # 12 iterations: the hooks are arbitrary (the "correction" is a fixed
    # shift), so the solve is held to the reference, not to convergence
    kw = dict(tol=1e-14, maxiter=12)
    rt = F.cg(At, _t(b), operator_override=lambda v: pt(At(pt(v))),
              projected_r0=pt, correct_xk=lambda x: x + 0.25 * ut, **kw)
    rj = JF.cg(Aj, jnp.asarray(b), operator_override=lambda v: pj(Aj(pj(v))),
               projected_r0=pj, correct_xk=lambda x: x + 0.25 * uj, **kw)
    assert int(rt.niter) == 12 and int(rt.status) == F.MAXITER
    _compare(rj, rt, rtol=1e-8)
    # hook outputs in another dtype are cast to the system dtype
    r32 = F.cg(At, _t(b), operator_override=lambda v: pt(At(pt(v))).float(),
               projected_r0=lambda r: pt(r).float(),
               correct_xk=lambda x: x.float(), tol=1e-10, maxiter=3)
    assert r32.x.dtype == torch.float64 and int(r32.niter) == 3


def test_cg_scalar_callable_ip_matches_jax():
    n = 30
    rng = np.random.default_rng(12)
    w = rng.uniform(1.0, 3.0, n)
    Q = rng.standard_normal((n, n))
    S = Q @ Q.T + n * np.eye(n)
    A = S / w[:, None]            # self-adjoint in <x, y>_w = x^T diag(w) y
    b = rng.standard_normal(n)
    rj = JF.cg(jnp.asarray(A), jnp.asarray(b),
               ip=lambda x, y: jnp.vdot(x, jnp.asarray(w) * y), tol=1e-10,
               maxiter=n)
    rt = F.cg(_t(A), _t(b), ip=lambda x, y: torch.vdot(x, _t(w) * y),
              tol=1e-10, maxiter=n)
    _compare(rj, rt, rtol=1e-9)


def test_cg_progress_prints_what_jax_prints(capsys):
    """``progress=True`` prints each iteration's relative residual, the
    JAX package's lines (``cg iter k: rel=...``) to the digits printed
    (float64: float32 sums in another order move the third digit, ROADMAP.md
    queue C)."""
    import jax

    nx = 15
    b = _rhs(nx * nx, 2)
    JF.cg(jops.poisson_2d(nx), jnp.asarray(b), tol=1e-8, progress=True)
    jax.effects_barrier()
    want = capsys.readouterr().out.splitlines()
    F.cg(ops.poisson_2d(nx, device="cpu"), _t(b), tol=1e-8, progress=True)
    got = capsys.readouterr().out.splitlines()
    assert len(want) > 10 and got == want
    assert got[0].startswith("cg iter 1: rel=")


def test_cg_unported_options_raise():
    """The options that raised before the one-reduce lane was ported now
    run (``variant="1r"``: the JAX package's solve, count and iterate) or
    raise the JAX package's ``ValueError`` (``fused_deflation`` without
    ``variant="1r"``); the others raise as they did."""
    A, b = ops.poisson_2d(7, device="cpu"), torch.ones(49, dtype=torch.float64)
    Aj, bj = jops.poisson_2d(7), jnp.ones(49)
    _compare(JF.cg(Aj, bj, variant="1r", tol=1e-10),
             F.cg(A, b, variant="1r", tol=1e-10))
    for fn, args in ((JF.cg, (Aj, bj)), (F.cg, (A, b))):
        with pytest.raises(ValueError, match="fused_deflation requires"):
            fn(*args, fused_deflation=object())
    with pytest.raises(ValueError):
        F.cg(A, b, variant="pipelined")
    with pytest.raises(TypeError):
        F.cg(A, b, ip=3.0)


@pytest.mark.parametrize("solver", ["cg", "minres", "gmres"])
def test_solvers_take_numpy_operands(solver):
    """The JAX package's solvers take numpy operands: ``A``, ``M`` and
    ``ip`` as numpy matrices, ``x0`` as a numpy vector (an 8x8 diagonal
    float64 system, tol 1e-10).  The port's do too, a numpy matrix or
    ``x0`` going to the device of ``b`` (a CPU tensor here): the same
    status, iterations and ``x`` to 1e-12."""
    d = np.linspace(1.0, 8.0, 8)
    A = np.diag(d)
    M = np.diag(1.0 / np.sqrt(d))
    ip = np.diag(np.linspace(1.0, 2.0, 8))
    b = np.ones(8)
    x0 = np.full(8, 0.1)
    kw = dict(M=M, ip=ip, x0=x0, tol=1e-10)
    rj = getattr(JF, solver)(A, b, **kw)
    rt = getattr(F, solver)(A, _t(b), **kw)
    assert int(rt.status) == int(rj.status) == JF.CONVERGED
    assert int(rt.niter) == int(rj.niter)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(interop.to_numpy(rt.x) - xj) <= \
        1e-12 * np.linalg.norm(xj)
    assert rt.x.device.type == "cpu"


def test_numpy_rhs_goes_to_the_card():
    """A numpy ``b`` goes to the default device, the card: without one
    the solver raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        F.cg(np.eye(4), np.ones(4))
