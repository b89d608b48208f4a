"""The port's Chebyshev iteration (``chebyshev``, ``spectral_bounds``),
``ops.chebyshev_preconditioner`` and matrix functions (``funm_krylov``,
``funm_krylov_arnoldi``, ``expm_multiply``, ``inv_sqrt_multiply``,
``slq_trace``, ``slq_logdet``) against krypy_tpu's on the same numpy
inputs, float64.

Every case of tests/test_chebyshev.py, tests/test_funm.py and
tests/test_preconditioners.py's Chebyshev preconditioner, but the sharded
ones (those run in tests/test_torch_parallel.py), with that test's claims
on the port's result and, against the JAX package: iteration counts and
statuses equal, iterates to ``1e-10`` relative (norm-wise), residual
histories to ``1e-10`` absolute; Krylov dimensions equal and ``x`` to
``1e-10`` relative.  The ``corrections`` tails of the matrix functions
are distances between nested approximations: where they have decayed to
round-off they are compared to ``1e-9`` of ``||x||`` (the two
eigensolvers round differently there), elsewhere to ``1e-8`` relative.
SLQ takes the JAX package's Rademacher probes through the port's
``funm._slq_core``: estimate to ``1e-10`` relative, standard error to
``1e-10`` of the estimate.  The port's own probes are held to the JAX
tests' statistical claims.

The JAX reference runs through ``jax.jit`` where it compiles (one
compile per shape and option set, cached across cases).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu_torch import functional as F, ops
from krypy_tpu_torch.functional import funm as tfunm

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def _same_solve(r, rj, x_rtol=1e-10, hist_atol=1e-10):
    assert int(r.niter) == int(rj.niter)
    assert int(r.status) == int(rj.status)
    assert _rel(r.x.numpy(), rj.x) <= x_rtol
    np.testing.assert_allclose(r.resnorms.numpy(), np.asarray(rj.resnorms),
                               rtol=0, atol=hist_atol)


def _same_funm(r, rj, x_rtol=1e-10):
    assert r.m == rj.m
    x = r.x.numpy()
    assert _rel(x, rj.x) <= x_rtol
    got, want = r.corrections.numpy(), np.asarray(rj.corrections)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    floor = 1e-9 * np.linalg.norm(x)
    live = ~np.isnan(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-8, atol=floor)


# ---------------------------------------------------------------------------
# chebyshev (tests/test_chebyshev.py)
# ---------------------------------------------------------------------------


def _diag_system(N=2048, lo=1.0, hi=50.0, seed=0):
    rng = np.random.default_rng(seed)
    d = np.linspace(lo, hi, N)
    return d, rng.standard_normal(N)


def _diag_ops(d):
    D = jnp.asarray(d, jnp.float64)
    Dt = torch.tensor(d)
    return (lambda v: D.astype(v.dtype) * v), (lambda v: Dt.to(v.dtype) * v)


@functools.lru_cache(maxsize=None)
def _jax_cheb(lmin, lmax, tol, maxiter, check_every=16, mg=None):
    """One jitted JAX Chebyshev solve per option set on the diagonal
    system (``mg``: the multigrid case's grid instead)."""
    if mg is None:
        def solve(d, b):
            return JF.chebyshev(lambda v: d.astype(v.dtype) * v, b,
                                lmin=lmin, lmax=lmax, tol=tol,
                                maxiter=maxiter, check_every=check_every)
    else:
        lap = jops.poisson_2d(mg)
        Mg = jops.multigrid_poisson_preconditioner(mg, coarsest=7)

        def solve(d, b):
            return JF.chebyshev(lap, b, M=Mg, lmin=lmin, lmax=lmax, tol=tol,
                                maxiter=maxiter, check_every=check_every)
    return jax.jit(solve)


@pytest.mark.parametrize("with_m", [False, True])
def test_spectral_bounds_matches_jax(with_m):
    """Lanczos bounds on A, and on M A with a diagonal M (the multigrid
    case below feeds the port's bounds to both packages' solves)."""
    d, b = _diag_system()
    Aj, At = _diag_ops(d)
    m = np.linspace(0.5, 2.0, d.size)
    Mj = (lambda v: jnp.asarray(m) * v) if with_m else None
    Mt = (lambda v: torch.tensor(m) * v) if with_m else None
    want = JF.spectral_bounds(Aj, jnp.asarray(b), M=Mj, steps=24)
    got = F.spectral_bounds(At, _t(b), M=Mt, steps=24)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    if not with_m:
        assert 0 < got[0] <= 1.0 and 50.0 <= got[1] < 60.0


def test_chebyshev_converges_with_estimated_bounds():
    d, b = _diag_system()
    _, At = _diag_ops(d)
    lmin, lmax = F.spectral_bounds(At, _t(b), steps=24)
    rj = _jax_cheb(lmin, lmax, 1e-10, 400)(jnp.asarray(d), jnp.asarray(b))
    r = F.chebyshev(At, _t(b), lmin=lmin, lmax=lmax, tol=1e-10, maxiter=400)
    _same_solve(r, rj)
    # the JAX test's claims on the port
    assert int(r.status) == 0
    rel = float(torch.linalg.norm(_t(b) - At(r.x)) / torch.linalg.norm(_t(b)))
    assert rel <= 1e-10
    rc = F.cg(At, _t(b), tol=1e-10, maxiter=400)
    assert int(r.niter) <= 2 * int(rc.niter)


@pytest.mark.parametrize("window", [4, 0])
def test_chebyshev_wrong_bounds_reports_honestly(window):
    """Bounds inside the spectrum: the stagnation guard stops the solve
    (``stagnation_window=0``: it runs to ``maxiter``)."""
    d, b = _diag_system()
    Aj, At = _diag_ops(d)
    rj = JF.chebyshev(Aj, jnp.asarray(b), lmin=5.0, lmax=20.0, tol=1e-10,
                      maxiter=400, stagnation_window=window)
    r = F.chebyshev(At, _t(b), lmin=5.0, lmax=20.0, tol=1e-10, maxiter=400,
                    stagnation_window=window)
    assert int(r.status) != 0
    assert int(r.niter) == int(rj.niter) and int(r.status) == int(rj.status)
    # the residuals grow past 1e100: compare relatively
    np.testing.assert_allclose(r.resnorms.numpy(), np.asarray(rj.resnorms),
                               rtol=1e-10, atol=0)


def test_chebyshev_multigrid_preconditioned():
    nx = 63
    lap = ops.poisson_2d(nx, device="cpu")
    Mg = ops.multigrid_poisson_preconditioner(nx, coarsest=7, device="cpu")
    b = torch.ones(nx * nx, dtype=torch.float64)
    lmin, lmax = F.spectral_bounds(lap, b, M=Mg, steps=24)
    rj = _jax_cheb(lmin, lmax, 1e-10, 200, 8, mg=nx)(
        jnp.zeros(1), jnp.ones(nx * nx))
    r = F.chebyshev(lap, b, M=Mg, lmin=lmin, lmax=lmax, tol=1e-10,
                    maxiter=200, check_every=8)
    _same_solve(r, rj)
    assert int(r.status) == 0
    assert int(r.niter) <= 40
    rel = float(torch.linalg.norm(b - lap(r.x)) / torch.linalg.norm(b))
    assert rel <= 1e-10


@pytest.mark.parametrize("x0", [False, True])
@pytest.mark.parametrize("check_every", [1, 7, 16])
def test_chebyshev_options_match_jax(check_every, x0):
    """``check_every`` (a ragged last block: maxiter not a multiple),
    ``x0``, a column right-hand side, and the launch identity: per block
    ``check_every`` applications of A and M, plus one A for the true
    residual; one A and one M before the first block."""
    d, b = _diag_system(N=300, hi=20.0, seed=3)
    Aj, _ = _diag_ops(d)
    Dt = torch.tensor(d)
    calls = {"A": 0, "M": 0}

    def At(v):
        calls["A"] += 1
        return Dt * v

    def Mt(v):
        calls["M"] += 1
        return v / Dt

    xinit = np.random.default_rng(4).standard_normal(300) if x0 else None
    kw = dict(lmin=0.9, lmax=1.1, tol=1e-11, maxiter=50,
              check_every=check_every)
    rj = JF.chebyshev(Aj, jnp.asarray(b)[:, None], M=lambda v: v / d,
                      x0=None if xinit is None else jnp.asarray(xinit), **kw)
    r = F.chebyshev(At, _t(b)[:, None], M=Mt,
                    x0=None if xinit is None else _t(xinit), **kw)
    assert r.x.shape == (300, 1)
    _same_solve(r, rj)
    blocks = int(r.niter) // check_every
    assert calls == {"A": 1 + blocks * (check_every + 1),
                     "M": 1 + blocks * check_every}


def test_chebyshev_zero_rhs_and_float32():
    Aj, At = _diag_ops(np.linspace(1.0, 4.0, 64))
    r = F.chebyshev(At, torch.zeros(64, dtype=torch.float64), lmin=1.0,
                    lmax=4.0)
    rj = JF.chebyshev(Aj, jnp.zeros(64), lmin=1.0, lmax=4.0)
    _same_solve(r, rj)
    assert int(r.niter) == 0 and int(r.status) == 0
    b = np.random.default_rng(2).standard_normal(64).astype(np.float32)
    r = F.chebyshev(At, torch.tensor(b), lmin=1.0, lmax=4.0, tol=1e-5)
    rj = JF.chebyshev(Aj, jnp.asarray(b), lmin=1.0, lmax=4.0, tol=1e-5)
    assert r.x.dtype == torch.float32 and r.resnorms.dtype == torch.float32
    assert int(r.niter) == int(rj.niter) and int(r.status) == 0
    assert _rel(r.x.numpy(), rj.x) <= 1e-5


# ---------------------------------------------------------------------------
# ops.chebyshev_preconditioner (tests/test_preconditioners.py:11)
# ---------------------------------------------------------------------------


def _poisson_1d_bounds(n):
    h = 1.0 / (n + 1)
    return (float(4 * np.sin(np.pi * h / 2) ** 2 / h ** 2),
            float(4 * np.cos(np.pi * h / 2) ** 2 / h ** 2))


@pytest.mark.parametrize("degree", [1, 2, 6, 8])
def test_chebyshev_preconditioner_matches_jax(degree):
    n = 64
    lmin, lmax = _poisson_1d_bounds(n)
    Mj = jops.chebyshev_preconditioner(jops.poisson_1d(n), degree=degree,
                                       lmin=lmin, lmax=lmax)
    M = ops.chebyshev_preconditioner(ops.poisson_1d(n, device="cpu"),
                                     degree=degree, lmin=lmin, lmax=lmax)
    assert M.degree == degree and M.shape == (n, n)
    x = np.random.RandomState(degree).randn(n)
    np.testing.assert_allclose(M(_t(x)).numpy(), np.asarray(Mj(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12 * np.abs(x).max())
    # float32 stays float32 (plain-float scalars)
    assert M(torch.ones(n)).dtype == torch.float32


def test_chebyshev_preconditioner_spd_and_effective():
    n = 64
    lmin, lmax = _poisson_1d_bounds(n)
    lap = ops.poisson_1d(n, device="cpu")
    M = ops.chebyshev_preconditioner(lap, degree=6, lmin=lmin, lmax=lmax)
    dense = torch.stack([M(torch.eye(n, dtype=torch.float64)[:, j])
                         for j in range(n)], dim=1).numpy()
    np.testing.assert_allclose(dense, dense.T, atol=1e-10)
    assert np.linalg.eigvalsh(dense).min() > 0
    rng = np.random.RandomState(3)
    b = rng.randn(n)
    plain = F.cg(lap, _t(b), tol=1e-10, maxiter=300)
    cheb = F.cg(lap, _t(b), M=M, tol=1e-10, maxiter=300)
    assert int(cheb.status) == F.CONVERGED
    assert int(cheb.niter) <= int(plain.niter) // 2
    Mj = jops.chebyshev_preconditioner(jops.poisson_1d(n), degree=6,
                                       lmin=lmin, lmax=lmax)
    rj = JF.cg(jops.poisson_1d(n), jnp.asarray(b), M=Mj, tol=1e-10,
               maxiter=300)
    assert int(cheb.niter) == int(rj.niter)
    assert _rel(cheb.x.numpy(), rj.x) <= 1e-10


def test_chebyshev_preconditioner_default_bounds():
    """``lmax`` from ``op.diag`` (2 max), ``lmin = lmax 1e-4``; no
    ``.diag`` and no ``lmax`` raises."""
    nx = 15
    Mj = jops.chebyshev_preconditioner(jops.poisson_2d(nx))
    M = ops.chebyshev_preconditioner(ops.poisson_2d(nx, device="cpu"))
    x = np.random.RandomState(1).randn(nx * nx)
    np.testing.assert_allclose(M(_t(x)).numpy(), np.asarray(Mj(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="lmax"):
        ops.chebyshev_preconditioner(lambda v: v)
    with pytest.raises(ValueError, match="lmax"):
        jops.chebyshev_preconditioner(lambda v: v)


# ---------------------------------------------------------------------------
# funm (tests/test_funm.py)
# ---------------------------------------------------------------------------


def _sym(n=150, seed=0):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    return (B + B.T) / 2, rng.standard_normal(n)


@functools.lru_cache(maxsize=None)
def _jax_funm(f_name, maxdim, ortho="cgs2", t=None):
    fs = {"exp": lambda w: jnp.exp(t * w), "isqrt": lambda w: 1 / jnp.sqrt(w),
          "exp1": jnp.exp}
    return jax.jit(lambda A, b: JF.funm_krylov(
        A, b, fs[f_name], maxdim=maxdim, ortho=ortho))


@pytest.mark.parametrize("ortho", ["cgs2", "cgs2_1r"])
@pytest.mark.parametrize("t", [0.5, -0.5])
def test_expm_multiply_matches_scipy(t, ortho):
    Am, b = _sym()
    ref = scipy.linalg.expm(t * Am) @ b
    rj = _jax_funm("exp", 40, ortho, t)(jnp.asarray(Am), jnp.asarray(b))
    if ortho == "cgs2":
        r = F.expm_multiply(_t(Am), _t(b), t, maxdim=40)
    else:
        r = F.funm_krylov(_t(Am), _t(b), lambda w: torch.exp(t * w),
                          maxdim=40, ortho=ortho)
    _same_funm(r, rj)
    err = np.linalg.norm(r.x.numpy() - ref)
    assert err <= 1e-10 * np.linalg.norm(ref)
    assert float(r.corrections[r.m - 1]) < 1e-8


def test_funm_inverse_sqrt_spd():
    rng = np.random.default_rng(1)
    n = 150
    d = np.linspace(0.5, 10, n)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    Aspd = Q @ np.diag(d) @ Q.T
    b = rng.standard_normal(n)
    ref = Q @ ((Q.T @ b) / np.sqrt(d))
    rj = _jax_funm("isqrt", 40)(jnp.asarray(Aspd), jnp.asarray(b))
    r = F.funm_krylov(_t(Aspd), _t(b), lambda w: 1 / torch.sqrt(w),
                      maxdim=40)
    _same_funm(r, rj)
    assert np.linalg.norm(r.x.numpy() - ref) <= 1e-8 * np.linalg.norm(ref)


def test_expm_multiply_diffusion_semigroup():
    n = 128
    h = 1.0 / (n + 1)
    xgrid = np.arange(1, n + 1) * h
    mode1 = np.sin(np.pi * xgrid)
    lam1 = (4.0 / h ** 2) * np.sin(np.pi * h / 2) ** 2
    dt = 1e-4
    rj = jax.jit(lambda v: JF.expm_multiply(jops.poisson_1d(n), v, -dt,
                                            maxdim=30))(jnp.asarray(mode1))
    r = F.expm_multiply(ops.poisson_1d(n, device="cpu"), _t(mode1), -dt,
                        maxdim=30)
    _same_funm(r, rj)
    ref = np.exp(-dt * lam1) * mode1
    assert np.linalg.norm(r.x.numpy() - ref) <= 1e-8 * np.linalg.norm(ref)


def test_funm_small_correction_under_exact_invariance():
    d = np.r_[1.0, 2.0, 3.0, np.full(50, 7.0)]
    b = np.zeros(53)
    b[:3] = [1.0, 2.0, -1.0]
    rj = jax.jit(lambda dd, v: JF.funm_krylov(
        jops.diagonal(dd), v, jnp.exp, maxdim=10))(jnp.asarray(d),
                                                   jnp.asarray(b))
    r = F.funm_krylov(ops.diagonal(_t(d)), _t(b), torch.exp, maxdim=10)
    _same_funm(r, rj)
    assert np.allclose(r.x.numpy(), np.exp(d) * b, atol=1e-10)


def test_funm_singular_f_with_early_invariance_no_nan():
    d = np.repeat(np.array([1.0, 4.0, 9.0]), 20)
    b = np.ones(60)
    rj = jax.jit(lambda dd, v: JF.funm_krylov(
        jops.diagonal(dd), v, lambda w: 1 / jnp.sqrt(w), maxdim=12))(
        jnp.asarray(d), jnp.asarray(b))
    r = F.funm_krylov(ops.diagonal(_t(d)), _t(b), lambda w: 1 / torch.sqrt(w),
                      maxdim=12)
    assert bool(torch.all(torch.isfinite(r.x)))
    _same_funm(r, rj)
    assert np.allclose(r.x.numpy(), b / np.sqrt(d), atol=1e-10)


def test_funm_column_rhs_and_unknown_ortho():
    Am, b = _sym(40, 3)
    r = F.funm_krylov(_t(Am), _t(b)[:, None], torch.exp, maxdim=12)
    rj = jax.jit(lambda M, v: JF.funm_krylov(M, v, jnp.exp, maxdim=12))(
        jnp.asarray(Am), jnp.asarray(b)[:, None])
    assert r.x.shape == (40, 1)
    _same_funm(r, rj)
    with pytest.raises(ValueError, match="unknown funm_krylov ortho"):
        F.funm_krylov(_t(Am), _t(b), torch.exp, maxdim=5, ortho="mgs")
    with pytest.raises(ValueError, match="unknown funm_krylov ortho"):
        JF.funm_krylov(Am, b, jnp.exp, maxdim=5, ortho="mgs")


def test_inv_sqrt_multiply_matches_exact():
    n = 2000
    d = np.linspace(1.0, 1e4, n)
    b = np.random.default_rng(0).standard_normal(n)
    ref = b / np.sqrt(d)
    Aj, At = jops.diagonal(jnp.asarray(d)), ops.diagonal(_t(d))
    xj, ij = JF.inv_sqrt_multiply(Aj, jnp.asarray(b), lmin=1.0, lmax=1e4,
                                  terms=16, tol=1e-10, maxiter=2000)
    x, info = F.inv_sqrt_multiply(At, _t(b), lmin=1.0, lmax=1e4, terms=16,
                                  tol=1e-10, maxiter=2000)
    assert int(info["inner_iters"]) == int(ij["inner_iters"])
    assert info["shift_status"].tolist() == np.asarray(
        ij["shift_status"]).tolist()
    np.testing.assert_allclose(info["shifts"], ij["shifts"], rtol=1e-14)
    np.testing.assert_allclose(info["weights"], ij["weights"], rtol=1e-14)
    assert _rel(x.numpy(), xj) <= 1e-10
    assert np.linalg.norm(x.numpy() - ref) <= 1e-9 * np.linalg.norm(ref)
    assert bool(torch.all(info["shift_status"] == F.CONVERGED))

    # estimated bounds (spectral_bounds with the 100x lmin slack)
    xj2, ij2 = JF.inv_sqrt_multiply(Aj, jnp.asarray(b), terms=20, tol=1e-9,
                                    maxiter=3000)
    x2, info2 = F.inv_sqrt_multiply(At, _t(b), terms=20, tol=1e-9,
                                    maxiter=3000)
    np.testing.assert_allclose([info2["lmin"], info2["lmax"]],
                               [ij2["lmin"], ij2["lmax"]], rtol=1e-10)
    assert int(info2["inner_iters"]) == int(ij2["inner_iters"])
    assert _rel(x2.numpy(), xj2) <= 1e-10
    assert np.linalg.norm(x2.numpy() - ref) <= 1e-7 * np.linalg.norm(ref)


def test_inv_sqrt_multiply_squares_back():
    nx = 20
    lap = ops.poisson_2d(nx, device="cpu")
    b = torch.ones(nx * nx, dtype=torch.float64)
    h2lmin = 2 * (np.pi / (nx + 1)) ** 2 * (nx + 1) ** 2 * 0.5
    kw = dict(lmin=h2lmin * 0.5, lmax=8.0 * (nx + 1) ** 2, terms=20,
              tol=1e-10, maxiter=4000)
    x1, _ = F.inv_sqrt_multiply(lap, b, **kw)
    x2, _ = F.inv_sqrt_multiply(lap, x1, **kw)
    rel = float(torch.linalg.norm(b - lap(x2)) / torch.linalg.norm(b))
    assert rel <= 1e-7
    xj, _ = JF.inv_sqrt_multiply(jops.poisson_2d(nx), jnp.ones(nx * nx),
                                 **kw)
    assert _rel(x1.numpy(), xj) <= 1e-10


def test_inv_sqrt_multiply_guards():
    for fn, mod in ((F.inv_sqrt_multiply, ops), (JF.inv_sqrt_multiply, jops)):
        d = _t(np.ones(8)) if mod is ops else jnp.ones(8)
        with pytest.raises(ValueError, match="lmin"):
            fn(mod.diagonal(d), d, lmin=-1.0, lmax=1.0)


def _jax_probes(key, n_probes, N, dtype=jnp.float64):
    return torch.tensor(np.asarray(jax.random.rademacher(
        key, (int(n_probes), N)).astype(dtype)))


def _slq_pair(Aj, At, f_j, f_t, seed, N, **kw):
    """The JAX estimate, and the port's core on the JAX probes."""
    key = jax.random.PRNGKey(seed)
    ej, sj = jax.jit(lambda k: JF.slq_trace(Aj, f_j, k, **kw))(key)
    n_probes = kw.get("n_probes", 16)
    est, se = tfunm._slq_core(At, f_t, _jax_probes(key, n_probes, N), N,
                              kw.get("maxdim", 30), kw.get("ortho", "cgs2"),
                              torch.float64)
    np.testing.assert_allclose(float(est), float(ej), rtol=1e-10)
    assert abs(float(se) - float(sj)) <= 1e-10 * abs(float(ej))
    return est, se


@pytest.mark.parametrize("ortho", ["cgs2", "cgs2_1r"])
def test_slq_logdet_diagonal_zero_variance(ortho):
    n = 400
    d = np.linspace(0.5, 20.0, n)
    Aj, At = jops.diagonal(jnp.asarray(d)), ops.diagonal(_t(d))
    exact = np.sum(np.log(d))
    _slq_pair(Aj, At, jnp.log, torch.log, 0, n, n_probes=8, maxdim=30,
              ortho=ortho)
    est, se = F.slq_logdet(At, 0, n_probes=8, maxdim=30, ortho=ortho)
    assert abs(float(est) - exact) <= 1e-5 * abs(exact)
    assert float(se) <= 1e-8 * abs(exact)


def test_slq_logdet_dense_within_error_bars():
    rng = np.random.default_rng(0)
    n = 200
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.linspace(1.0, 30.0, n)
    Am = Q @ np.diag(d) @ Q.T
    exact = np.linalg.slogdet(Am)[1]
    _slq_pair(jnp.asarray(Am), _t(Am), jnp.log, torch.log, 2, n,
              n_probes=48, maxdim=30)
    est, se = F.slq_logdet(_t(Am), 2, n_probes=48, maxdim=30)
    assert abs(float(est) - exact) <= 4.0 * float(se) + 1e-6 * abs(exact)


def test_slq_trace_inverse_and_reproducibility():
    n = 300
    d = np.linspace(1.0, 50.0, n)
    Aj, At = jops.diagonal(jnp.asarray(d)), ops.diagonal(_t(d))
    _slq_pair(Aj, At, lambda w: 1.0 / w, lambda w: 1.0 / w, 7, n,
              n_probes=8, maxdim=40)
    e1, _ = F.slq_trace(At, lambda w: 1.0 / w, 7, n_probes=8, maxdim=40)
    e2, _ = F.slq_trace(At, lambda w: 1.0 / w, 7, n_probes=8, maxdim=40)
    assert float(e1) == float(e2)
    e3, _ = F.slq_trace(At, lambda w: 1.0 / w,
                        torch.Generator().manual_seed(7), n_probes=8,
                        maxdim=40)
    assert float(e3) == float(e1)
    exact = np.sum(1.0 / d)
    assert abs(float(e1) - exact) <= 1e-4 * exact


def test_slq_trace_dtype_follows_the_operator():
    """A float32 operator stays float32, a float64 one float64; one probe
    gives an infinite standard error; a bare callable needs ``n=``."""
    d = np.linspace(1.0, 5.0, 50)
    est, se = F.slq_trace(ops.diagonal(_t(d).float()), torch.log, 1,
                          n_probes=1, maxdim=10)
    assert est.dtype == torch.float32 and float(se) == float("inf")
    est, _ = F.slq_trace(ops.diagonal(_t(d)), torch.log, 1, n_probes=2,
                         maxdim=10)
    assert est.dtype == torch.float64
    with pytest.raises(ValueError, match="n="):
        F.slq_trace(lambda v: v, torch.log, 0)


@pytest.mark.parametrize("ortho", ["mgs", "cgs", "lanczos"])
def test_slq_trace_rejects_unknown_ortho(ortho):
    """The port's ``slq_trace`` raises on an ``ortho`` it does not know
    (the message form of ``funm_krylov``'s).  The JAX package's accepts
    any string and runs its CGS2 sweep (ROADMAP.md C): this documents the
    difference; the port is not held to it."""
    d = np.linspace(1.0, 5.0, 40)
    with pytest.raises(ValueError, match=f"unknown slq_trace ortho '{ortho}'"):
        F.slq_trace(ops.diagonal(_t(d)), torch.log, 0, n_probes=2,
                    maxdim=5, ortho=ortho)
    est, _ = jax.jit(lambda dd, k: JF.slq_trace(
        jops.diagonal(dd), jnp.log, k, n_probes=2, maxdim=5, ortho=ortho))(
        jnp.asarray(d), jax.random.PRNGKey(0))
    assert np.isfinite(float(est))


def _nonsym(n=120, seed=5):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / np.sqrt(n) - 0.5 * np.eye(n)
    return A, rng.standard_normal(n)


def test_expm_multiply_arnoldi_matches_scipy():
    A, b = _nonsym()
    oracle = scipy.linalg.expm(A) @ b
    rj = JF.expm_multiply(jnp.asarray(A), jnp.asarray(b), hermitian=False,
                          maxdim=60)
    r = F.expm_multiply(_t(A), _t(b), hermitian=False, maxdim=60)
    _same_funm(r, rj)
    np.testing.assert_allclose(r.x.numpy(), oracle, rtol=1e-10,
                               atol=1e-12 * np.linalg.norm(oracle))
    assert np.nanmax(r.corrections.numpy()) < 1e-10


@pytest.mark.parametrize("ortho", ["cgs2", "cgs2_1r"])
def test_funm_arnoldi_polynomial_exactness(ortho):
    A, b = _nonsym()
    rj = JF.funm_krylov_arnoldi(jnp.asarray(A), jnp.asarray(b),
                                lambda w: w ** 3 + 2 * w, maxdim=10,
                                ortho=ortho)
    r = F.funm_krylov_arnoldi(_t(A), _t(b), lambda w: w ** 3 + 2 * w,
                              maxdim=10, ortho=ortho)
    _same_funm(r, rj)
    direct = A @ A @ A @ b + 2 * (A @ b)
    np.testing.assert_allclose(r.x.numpy(), direct, rtol=1e-12,
                               atol=1e-12 * np.linalg.norm(direct))


def test_funm_arnoldi_invariant_subspace_truncation():
    d = np.r_[2.0, 3.0, np.linspace(4, 5, 38)]
    A = np.diag(d)
    A[0, 1] = 1.0
    b = np.zeros(40)
    b[0], b[1] = 1.0, 0.5
    rj = JF.funm_krylov_arnoldi(jnp.asarray(A), jnp.asarray(b),
                                lambda w: 1.0 / w, maxdim=12)
    r = F.funm_krylov_arnoldi(_t(A), _t(b), lambda w: 1.0 / w, maxdim=12)
    assert r.m == 2
    _same_funm(r, rj)
    np.testing.assert_allclose(r.x.numpy(), np.linalg.solve(A, b),
                               atol=1e-12)


def test_funm_arnoldi_validates_f_xor_matfunc():
    A, b = _nonsym(20)
    for fn, conv in ((F.funm_krylov_arnoldi, _t),
                     (JF.funm_krylov_arnoldi, jnp.asarray)):
        with pytest.raises(ValueError, match="exactly one"):
            fn(conv(A), conv(b))
        with pytest.raises(ValueError, match="exactly one"):
            fn(conv(A), conv(b), np.exp, matfunc=scipy.linalg.expm)


def test_funm_arnoldi_warns_on_imaginary_mass():
    """sqrt of a real operator with negative eigenvalues: both packages
    warn and drop the imaginary part."""
    A = np.diag(np.linspace(-2.0, -1.0, 20))
    b = np.ones(20)
    with pytest.warns(RuntimeWarning, match="imaginary mass"):
        r = F.funm_krylov_arnoldi(_t(A), _t(b), np.sqrt, maxdim=6)
    with pytest.warns(RuntimeWarning, match="imaginary mass"):
        rj = JF.funm_krylov_arnoldi(jnp.asarray(A), jnp.asarray(b), np.sqrt,
                                    maxdim=6)
    assert r.x.dtype == torch.float64
    _same_funm(r, rj)


def test_expm_arnoldi_convdiff_matches_jax():
    """tests/test_funm.py's sharded semigroup on one device (the mesh form
    runs in tests/test_torch_parallel.py)."""
    cd = jops.convection_diffusion_2d(24, wind=(1.0, 0.5), eps=1.0)
    cdt = ops.convection_diffusion_2d(24, wind=(1.0, 0.5), eps=1.0,
                                      device="cpu")
    rj = JF.expm_multiply(cd, jnp.ones(576), t=-0.01, hermitian=False,
                          maxdim=40)
    r = F.expm_multiply(cdt, torch.ones(576, dtype=torch.float64), t=-0.01,
                        hermitian=False, maxdim=40)
    _same_funm(r, rj)


# ---------------------------------------------------------------------------
# the card phase's problems, small (Poisson through K1's plain version)
# ---------------------------------------------------------------------------


def _dst_matrix(n):
    """The orthonormal DST-I matrix of size n (its own inverse)."""
    j = np.arange(1, n + 1)
    return np.sqrt(2.0 / (n + 1)) * np.sin(np.pi * np.outer(j, j) / (n + 1))


def test_card_problems_closed_forms():
    """At 31^2, float64 through ``impl="cuda"`` (K1's plain version on the
    CPU): ``expm_multiply`` and ``inv_sqrt_multiply`` of Poisson on a
    seeded random b against the DST closed forms, ``slq_logdet`` within
    5 standard errors of the exact sum, as the card phase gates them."""
    nx = 31
    lap = ops.poisson_2d(nx, impl="cuda", device="cpu")
    h = 1.0 / (nx + 1)
    lam1 = 4.0 / h ** 2 * np.sin(np.arange(1, nx + 1) * np.pi * h / 2) ** 2
    lam = lam1[:, None] + lam1[None, :]
    S = _dst_matrix(nx)
    b = np.random.default_rng(17).standard_normal(nx * nx)
    B = S @ b.reshape(nx, nx) @ S
    t = 1e-4
    want = (S @ (np.exp(-t * lam) * B) @ S).reshape(-1)
    r = F.expm_multiply(lap, _t(b), -t, maxdim=30)
    assert np.linalg.norm(r.x.numpy() - want) <= 1e-8 * np.linalg.norm(want)
    want = (S @ (B / np.sqrt(lam)) @ S).reshape(-1)
    x, info = F.inv_sqrt_multiply(lap, _t(b), lmin=float(lam.min()),
                                  lmax=float(lam.max()), tol=1e-9)
    assert np.linalg.norm(x.numpy() - want) <= 1e-7 * np.linalg.norm(want)
    est, se = F.slq_logdet(lap, 3, n=nx * nx, n_probes=16, maxdim=30)
    exact = np.sum(np.log(lam))
    assert abs(float(est) - exact) <= 5 * float(se)
