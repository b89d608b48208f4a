"""The port's sketched lane (``KronSketch``, ``kron_sketch``,
``padded_kron_sketch``, ``sketch_apply``, ``sketched_gmres``,
``restarted_sketched_gmres``, ``sketched_eigs``) against
krypy_tpu.functional.sketch on the same numpy inputs.

torch cannot redraw what ``jax.random`` drew, so every parity case
carries the JAX package's sketch across
(:func:`krypy_tpu_torch.interop.kron_sketch_from_numpy`): the one
``sketched_gmres``/``sketched_eigs`` would draw from their ``seed``
passed as ``sketch=``, and the restart driver's escalated draws through a
monkeypatched ``sketch.padded_kron_sketch``/``sketch.kron_sketch``
(each JAX draw from the seed the driver hands over).  Against the JAX
package: counts, statuses and ``sketch_d`` equal, ``x`` to ``1e-10``
relative (norm-wise) in float64, the sketched histories to ``1e-8``
relative or ``1e-13`` absolute, the true residual that ends a history to
``1e-14`` absolute and the distortion certificate made from it
accordingly (:func:`_same`);
``sketched_eigs``'s values to ``1e-10`` and its certified residuals to
``1e-6`` relative (round-off sized).  Every case of tests/test_sketch.py
(its sharded case runs in tests/test_torch_parallel.py) also holds the
port's own draw to that test's claims.  float32 cases compare counts
only where rounding cannot steer them, and hold the claims.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu.functional import sketch as jsk
from krypy_tpu_torch import functional as F, interop, ops
from krypy_tpu_torch.functional import sketch as tsk

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)


def _carry(S):
    """A JAX ``KronSketch`` as the port's, on the CPU."""
    return interop.kron_sketch_from_numpy(
        np.asarray(S.S1), np.asarray(S.S2), np.asarray(S.signs), S.N,
        device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_sketch(N, d, seed=0, dtype=jnp.float64):
    """The JAX package's draw, through one ``jax.jit`` per shape."""
    return jax.jit(functools.partial(jsk.kron_sketch, N, d, seed=seed,
                                     dtype=dtype))()


#: the stencil problems of the JAX parity cases, by name: (A, M)
_STENCILS = {
    "convdiff32_jacobi": lambda: (lambda cd: (
        cd, jops.jacobi_preconditioner(cd)))(
        jops.convection_diffusion_2d(32, 32)),
    "poisson63": lambda: (jops.poisson_2d(63), None),
}


@functools.lru_cache(maxsize=None)
def _jax_sgmres(stencil=None, **static):
    """The JAX package's ``sketched_gmres`` through one ``jax.jit`` per
    problem and option set, the matrix (or ``stencil``'s operator), the
    right-hand side, the initial guess and the sketch's factors traced
    (an eager call compiles its while_loop at every call)."""
    A_M = _STENCILS[stencil]() if stencil else None

    def run(A, b, x0, S1, S2, signs):
        sk = jsk.KronSketch(S1=S1, S2=S2, signs=signs, N=b.shape[0])
        if A_M is not None:
            A, M = A_M
            return JF.sketched_gmres(A, b, x0=x0, M=M, sketch=sk, **static)
        return JF.sketched_gmres(A, b, x0=x0, sketch=sk, **static)

    return jax.jit(run)


def _jax_solve(A, b, S, x0=None, stencil=None, **static):
    """``_jax_sgmres`` on numpy inputs (``A`` ignored for a stencil)."""
    b = jnp.asarray(b)
    return _jax_sgmres(stencil, **static)(
        jnp.zeros(1) if stencil else jnp.asarray(A), b,
        jnp.zeros_like(b) if x0 is None else jnp.asarray(x0), S.S1, S.S2,
        S.signs)


def _dense_nonsym(n, seed=0, spread=(1, 20), skew=0.3):
    rng = np.random.RandomState(seed)
    A = (np.diag(np.linspace(*spread, n))
         + skew * np.triu(rng.randn(n, n), 1) / np.sqrt(n))
    return A, rng


def _same(r, rj, x_rtol=1e-10, floor=1e-14):
    """Counts, statuses, ``sketch_d``, ``x``; the sketched histories to
    ``1e-8`` relative or ``1e-13`` absolute (tail norms of the
    reflected right-hand side, which round at ~1e-16 of its start) and
    the final TRUE residual to ``floor`` absolute
    (it sits at the round-off floor of ``b - A x``), the certificate (the
    true over the sketched residual) to the same floor relative to that
    residual."""
    assert int(r.niter) == int(rj.niter)
    assert int(r.status) == int(rj.status)
    assert int(r.sketch_d) == int(rj.sketch_d)
    assert _rel(r.x.numpy(), rj.x) <= x_rtol
    got, want = r.resnorms.numpy(), np.asarray(rj.resnorms)
    n = int(r.niter)
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-8, atol=1e-13)
    assert np.isnan(got[n + 1:]).all() and np.isnan(want[n + 1:]).all()
    assert abs(got[n] - want[n]) <= floor + 1e-8 * want[n]
    # the certificate is the true residual over the last sketched one
    # (want[n] / dj): each within its own tolerance
    d, dj = float(r.distortion), float(rj.distortion)
    assert abs(d - dj) <= dj * (2e-8 + (floor + 1e-13 * dj)
                                / max(want[n], 1e-300))


def _true_rel(A, b, x):
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# the sketch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,d", [(4096, 256), (2048, 400), (200, 1224),
                                 (37, 50)])
def test_sketch_apply_matches_jax(N, d):
    """The JAX draw carried across: the same embedding, float64 to
    round-off (the padding past N included, ``N`` not a square)."""
    S = _jax_sketch(N, d, seed=5)
    St = _carry(S)
    assert St.d == S.d and St.N == N
    x = np.random.RandomState(N).randn(N)
    np.testing.assert_allclose(F.sketch_apply(St, _t(x)).numpy(),
                               np.asarray(jsk.sketch_apply(S, jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12 * np.abs(x).max())
    z = x + 1j * np.random.RandomState(1).randn(N)
    np.testing.assert_allclose(F.sketch_apply(St, _t(z)).numpy(),
                               np.asarray(jsk.sketch_apply(S, jnp.asarray(z))),
                               rtol=1e-12, atol=1e-12 * np.abs(z).max())


def test_kron_sketch_shapes_and_draws():
    """The port's draw: the JAX package's factor shapes, a realized d at
    least the requested one, reproducible from its generator's seed; an
    int seed draws on the card (raises here)."""
    S = F.kron_sketch(4096, 256, seed=_gen(7))
    Sj = jsk.kron_sketch(4096, 256, seed=7)
    assert S.S1.shape == Sj.S1.shape and S.S2.shape == Sj.S2.shape
    assert S.signs.shape == Sj.signs.shape and S.d >= 256
    assert S.S1.dtype == torch.float32
    again = F.kron_sketch(4096, 256, seed=_gen(7))
    assert torch.equal(S.S1, again.S1) and torch.equal(S.signs, again.signs)
    assert set(S.signs.unique().tolist()) == {-1.0, 1.0}
    S64 = F.kron_sketch(100, 30, seed=_gen(1), dtype=torch.complex128)
    assert S64.S1.dtype == torch.float64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            F.kron_sketch(100, 30, seed=3)


def test_kron_sketch_is_an_embedding():
    N, d = 4096, 256
    S = F.kron_sketch(N, d, seed=_gen(7))
    assert S.d >= d
    rng = np.random.RandomState(0)
    ratios = np.array([
        float(torch.linalg.norm(F.sketch_apply(S, x)) / torch.linalg.norm(x))
        for x in (torch.tensor(rng.randn(N), dtype=torch.float32)
                  for _ in range(20))])
    assert np.all(np.abs(ratios - 1) < 0.5)
    assert abs(ratios.mean() - 1) < 0.1


def test_kron_sketch_approximate_orthogonality():
    N, d = 2048, 400
    S = F.kron_sketch(N, d, seed=_gen(3))
    x = torch.zeros(N)
    x[: N // 2] = 1.0
    y = torch.zeros(N)
    y[N // 2:] = 1.0
    sx, sy = F.sketch_apply(S, x), F.sketch_apply(S, y)
    cos = float(torch.abs(torch.vdot(sx, sy))
                / (torch.linalg.norm(sx) * torch.linalg.norm(sy)))
    assert cos < 0.25


def test_kron_sketch_smooth_grid_modes():
    n = 255
    N = n * n
    g = np.linspace(0, 1, n)
    xx, yy = np.meshgrid(g, g)
    m1 = _t((np.sin(np.pi * xx) * np.sin(np.pi * yy)).ravel())
    m2 = _t((np.sin(2 * np.pi * xx) * np.sin(np.pi * yy)).ravel())
    S = F.kron_sketch(N, 164, seed=_gen(0), dtype=torch.float64)
    s1, s2 = F.sketch_apply(S, m1), F.sketch_apply(S, m2)
    cos = float(torch.abs(torch.vdot(s1, s2))
                / (torch.linalg.norm(s1) * torch.linalg.norm(s2)))
    assert cos < 0.15
    for s, m in ((s1, m1), (s2, m2)):
        ratio = float(torch.linalg.norm(s) / torch.linalg.norm(m))
        assert abs(ratio - 1) < 0.35


def test_padded_kron_sketch_levels_are_isometric():
    N, d0 = 400, 64
    x = torch.tensor(np.random.RandomState(1).randn(N), dtype=torch.float32)
    xn = float(torch.linalg.norm(x))
    for level in (0, 1, 2):
        vals = []
        for s in range(24):
            S = tsk.padded_kron_sketch(N, d0 * 2 ** level, d0 * 4,
                                       seed=_gen(s))
            vals.append(float(torch.linalg.norm(F.sketch_apply(S, x))) / xn)
        mean = np.mean(np.square(vals))
        assert abs(mean - 1.0) < 0.35, (level, mean)
        d2 = S.S2.shape[0]
        active = -(-d0 * 2 ** level // d2)
        if active < S.S1.shape[0]:
            assert float(torch.abs(S.S1[active:]).max()) == 0.0
        Sj = jsk.padded_kron_sketch(N, d0 * 2 ** level, d0 * 4, seed=s)
        assert S.S1.shape == Sj.S1.shape
        assert int(torch.sum(torch.any(S.S1 != 0, dim=1))) == int(
            jnp.sum(jnp.any(Sj.S1 != 0, axis=1)))


# ---------------------------------------------------------------------------
# sketched_gmres
# ---------------------------------------------------------------------------


def _pair(A, b, m, seed=0, d=None, x0=None, **kw):
    """The JAX solve on the draw it makes from ``seed`` (the sketch passed
    in: the same computation) and the port's on that draw; ``A`` a numpy
    matrix."""
    N = b.shape[0]
    real = jnp.float32 if np.asarray(b).dtype in (np.float32, np.complex64) \
        else jnp.float64
    S = _jax_sketch(N, 8 * (m + 1) if d is None else d, seed, real)
    rj = _jax_solve(A, b, S, x0, maxiter=m, **kw)
    r = F.sketched_gmres(_t(A), _t(b), maxiter=m, sketch=_carry(S),
                         x0=None if x0 is None else _t(x0), **kw)
    return r, rj


def test_sketched_gmres_dense_nonsymmetric():
    A, rng = _dense_nonsym(200)
    b = rng.randn(200)
    r, rj = _pair(A, b, 150, tol=1e-8)
    _same(r, rj)
    assert int(r.status) == 0
    assert _true_rel(A, b, r.x.numpy()) <= 1e-8
    assert np.isfinite(r.resnorms.numpy()[: int(r.niter) + 1]).all()
    own = F.sketched_gmres(_t(A), _t(b), tol=1e-8, maxiter=150, seed=_gen(0))
    assert int(own.status) == 0 and _true_rel(A, b, own.x.numpy()) <= 1e-8


def test_sketched_gmres_quasi_optimal_vs_gmres():
    A, rng = _dense_nonsym(160, seed=5)
    b = rng.randn(160)
    m = 30
    r, rj = _pair(A, b, m, d=8 * (m + 1), tol=1e-14, k_ortho=4)
    _same(r, rj, x_rtol=1e-9)
    rg = F.gmres(_t(A), _t(b), tol=1e-14, maxiter=m)
    rel_g = _true_rel(A, b, rg.x.numpy().reshape(-1))
    own = F.sketched_gmres(_t(A), _t(b), tol=1e-14, maxiter=m, k_ortho=4,
                           sketch_dim=8 * (m + 1), seed=_gen(5))
    for x in (r.x, own.x):
        assert _true_rel(A, b, x.numpy()) <= 3 * rel_g + 1e-14


def test_sketched_gmres_complex():
    rng = np.random.RandomState(1)
    n = 120
    A = (np.diag(np.linspace(1, 10, n)).astype(complex)
         + 0.2 * (rng.randn(n, n) + 1j * rng.randn(n, n)) / np.sqrt(n))
    b = rng.randn(n) + 1j * rng.randn(n)
    r, rj = _pair(A, b, 100, tol=1e-8)
    _same(r, rj)
    assert int(r.status) == 0 and _true_rel(A, b, r.x.numpy()) <= 1e-8
    own = F.sketched_gmres(_t(A), _t(b), tol=1e-8, maxiter=100, seed=_gen(1))
    assert int(own.status) == 0 and _true_rel(A, b, own.x.numpy()) <= 1e-8


def test_sketched_gmres_preconditioned_convdiff():
    cdt = ops.convection_diffusion_2d(32, 32, device="cpu")
    Mt = ops.jacobi_preconditioner(cdt)
    b = np.ones(32 * 32)
    S = _jax_sketch(1024, 8 * 301)
    rj = _jax_solve(None, b, S, stencil="convdiff32_jacobi", tol=1e-9,
                    maxiter=300, k_ortho=4)
    r = F.sketched_gmres(cdt, _t(b), M=Mt, tol=1e-9, maxiter=300, k_ortho=4,
                         sketch=_carry(S))
    _same(r, rj, x_rtol=1e-9)
    assert int(r.status) == 0
    assert float(torch.linalg.norm(_t(b) - cdt(r.x)) / np.linalg.norm(b)) \
        <= 1e-9


def test_sketched_gmres_exact_termination():
    A, rng = _dense_nonsym(24, seed=2, spread=(1, 5), skew=0.1)
    b = rng.randn(24)
    r, rj = _pair(A, b, 40, tol=1e-12, k_ortho=3)
    assert int(r.niter) == int(rj.niter) and int(r.status) == 0
    assert _rel(r.x.numpy(), rj.x) <= 1e-10
    assert _true_rel(A, b, r.x.numpy()) <= 1e-12


def test_sketched_gmres_x0_and_zero_rhs():
    A, rng = _dense_nonsym(80, seed=4, spread=(1, 8), skew=0.2)
    b = rng.randn(80)
    x0 = rng.randn(80)
    r, rj = _pair(A, b, 60, tol=1e-10, x0=x0)
    _same(r, rj)
    assert int(r.status) == 0 and _true_rel(A, b, r.x.numpy()) <= 1e-10
    r0, rj0 = _pair(A, np.zeros(80), 10, tol=1e-10)
    _same(r0, rj0)
    assert int(r0.status) == 0 and int(r0.niter) == 0
    assert float(torch.linalg.norm(r0.x)) == 0.0
    assert float(r0.distortion) == 1.0


def test_sketched_gmres_shared_sketch_and_column_rhs():
    A, rng = _dense_nonsym(100, seed=6, spread=(1, 10), skew=0.2)
    S = _jax_sketch(100, 4 * 61, 0, jnp.float32)
    St = _carry(S)
    for k in range(2):
        b = rng.randn(100)
        rj = _jax_solve(A, b, S, tol=1e-9, maxiter=60)
        r = F.sketched_gmres(_t(A), _t(b)[:, None], tol=1e-9, maxiter=60,
                             sketch=St)
        assert r.x.shape == (100, 1)
        _same(r._replace(x=r.x[:, 0]), rj)
        assert int(r.status) == 0
        assert _true_rel(A, b, r.x.numpy()[:, 0]) <= 1e-9


def test_sketched_gmres_rejects_narrow_sketch():
    A, rng = _dense_nonsym(50, seed=0)
    b = rng.randn(50)
    with pytest.raises(ValueError, match="must exceed maxiter"):
        F.sketched_gmres(_t(A), _t(b), maxiter=40, sketch_dim=10)
    with pytest.raises(ValueError, match="must exceed maxiter"):
        JF.sketched_gmres(jnp.asarray(A), jnp.asarray(b), maxiter=40,
                          sketch_dim=10)


def test_sketched_gmres_maxiter_honest():
    A, rng = _dense_nonsym(150, seed=9, spread=(1, 3000), skew=0.5)
    A32 = np.asarray(A, dtype=np.float32)
    b = rng.randn(150).astype(np.float32)
    r, rj = _pair(A32, b, 20, tol=1e-14)
    assert int(r.status) == int(rj.status) == 1
    assert int(r.niter) == int(rj.niter) == 20
    assert r.x.dtype == torch.float32
    assert _true_rel(A32, b, r.x.numpy()) > 1e-14
    own = F.sketched_gmres(_t(A32), _t(b), tol=1e-14, maxiter=20,
                           seed=_gen(9))
    assert int(own.status) == 1


@pytest.mark.parametrize("window", [0, 3])
def test_sketched_gmres_stagnation_and_safety(window):
    """``stagnation_window`` and ``sketch_safety`` on a slowly converging
    system, float64."""
    A, rng = _dense_nonsym(120, seed=11, spread=(1, 200), skew=0.4)
    b = rng.randn(120)
    r, rj = _pair(A, b, 80, tol=1e-9, stagnation_window=window,
                  sketch_safety=0.5)
    _same(r, rj, x_rtol=1e-9)


def test_sketch_certificate_healthy_embedding():
    nx = 63
    lapt = ops.poisson_2d(nx, device="cpu")
    b = np.ones(nx * nx, np.float32)
    S = _jax_sketch(nx * nx, 8 * 31, 0, jnp.float32)
    rj = _jax_solve(None, b, S, stencil="poisson63", tol=1e-6, maxiter=30)
    r = F.sketched_gmres(lapt, _t(b), tol=1e-6, maxiter=30,
                         sketch=_carry(S))
    assert int(r.sketch_d) == int(rj.sketch_d) >= 8 * 30
    assert 0.2 < float(r.distortion) < 2.0
    own = F.sketched_gmres(lapt, _t(b), tol=1e-6, maxiter=30, seed=_gen(0))
    assert int(own.sketch_d) >= 8 * 30
    assert 0.2 < float(own.distortion) < 2.0


def test_sketch_certificate_flags_starved_embedding():
    nx = 63
    lapt = ops.poisson_2d(nx, device="cpu")
    b = torch.ones(nx * nx)
    S = _jax_sketch(nx * nx, 32, 0, jnp.float32)
    rj = _jax_solve(None, np.ones(nx * nx, np.float32), S,
                    stencil="poisson63", tol=1e-6, maxiter=30)
    r = F.sketched_gmres(lapt, b, tol=1e-6, maxiter=30, sketch=_carry(S))
    assert float(r.distortion) > 3.0 and float(rj.distortion) > 3.0
    assert not r.converged
    own = F.sketched_gmres(lapt, b, tol=1e-6, maxiter=30, sketch_dim=32,
                           seed=_gen(0))
    assert float(own.distortion) > 3.0
    assert not own.converged


# ---------------------------------------------------------------------------
# restarted_sketched_gmres: the JAX draws through the module-level names
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's restart driver draws through ``sketch.padded_kron_sketch``
    and ``sketch.kron_sketch``; these make the JAX package's draw from the
    seed the driver's generator carries.  Returns the seeds drawn."""
    seeds = []

    def jdtype(dtype):
        return {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]

    def padded(N, d_active, d_max, *, seed, dtype):
        seeds.append(seed.initial_seed())
        return _carry(jsk.padded_kron_sketch(
            N, d_active, d_max, seed=seed.initial_seed(),
            dtype=jdtype(dtype)))

    def plain(N, d, *, seed, dtype):
        seeds.append(seed.initial_seed())
        return _carry(jsk.kron_sketch(N, d, seed=seed.initial_seed(),
                                      dtype=jdtype(dtype)))

    monkeypatch.setattr(tsk, "padded_kron_sketch", padded)
    monkeypatch.setattr(tsk, "kron_sketch", plain)
    return seeds


def _same_restarted(r, rj, x_rtol=1e-10):
    assert int(r.niter) == int(rj.niter)
    assert int(r.status) == int(rj.status)
    assert int(r.sketch_d) == int(rj.sketch_d)
    assert _rel(r.x.numpy(), rj.x) <= x_rtol
    np.testing.assert_allclose(r.resnorms.numpy(), np.asarray(rj.resnorms),
                               rtol=1e-8, atol=1e-12)


def test_restarted_sketched_gmres_convdiff(jax_draws):
    cd = jops.convection_diffusion_2d(64, 64)
    Mj = jops.jacobi_preconditioner(cd)
    cdt = ops.convection_diffusion_2d(64, 64, device="cpu")
    Mt = ops.jacobi_preconditioner(cdt)
    kw = dict(tol=1e-8, maxiter=40, max_restarts=20, k_ortho=4)
    for scale in (1.0, 2.0):
        b = scale * np.ones(64 * 64)
        rj = JF.restarted_sketched_gmres(cd, jnp.asarray(b), M=Mj, **kw)
        r = F.restarted_sketched_gmres(cdt, _t(b), M=Mt, **kw)
        _same_restarted(r, rj, x_rtol=1e-8)
        assert int(r.status) == 0
        assert float(torch.linalg.norm(_t(b) - cdt(r.x))
                     / np.linalg.norm(b)) <= 1e-8
        assert int(r.niter) > 40
    assert jax_draws == [0, 0]


def test_restarted_escalates_on_distortion(jax_draws):
    nx = 63
    lap = jops.poisson_2d(nx)
    lapt = ops.poisson_2d(nx, device="cpu")
    b = np.ones(nx * nx, np.float32)
    kw = dict(tol=1e-6, maxiter=30, max_restarts=6, sketch_dim=32)
    frozen_j = JF.restarted_sketched_gmres(lap, jnp.asarray(b),
                                           distortion_limit=float("inf"),
                                           **kw)
    esc_j = JF.restarted_sketched_gmres(lap, jnp.asarray(b), **kw)
    frozen = F.restarted_sketched_gmres(lapt, _t(b),
                                        distortion_limit=float("inf"), **kw)
    esc = F.restarted_sketched_gmres(lapt, _t(b), **kw)
    # the JAX test's claims, on both draws
    for f, e in ((frozen, esc), (frozen_j, esc_j)):
        assert int(e.sketch_d) > int(f.sketch_d)
        assert float(e.resnorms[-1]) < 0.1 * float(f.resnorms[-1])
    # escalations redraw from seed + 7919 k (how many, float32 rounding
    # of the certificate near its limit decides: compared in float64 by
    # the explicit-sketch and fallback cases)
    assert jax_draws[:2] == [0, 0] and 7919 in jax_draws


def test_restarted_classic_fallback(jax_draws):
    nx = 63
    lap = jops.poisson_2d(nx)
    lapt = ops.poisson_2d(nx, device="cpu")
    b = np.ones(nx * nx, np.float32)
    kw = dict(tol=1e-3, maxiter=30, max_restarts=8, sketch_dim=32,
              max_escalations=0)
    rj = JF.restarted_sketched_gmres(lap, jnp.asarray(b), **kw)
    r = F.restarted_sketched_gmres(lapt, _t(b), **kw)
    for res in (r, rj):
        assert bool(res.converged)
        assert float(res.resnorms[-1]) <= 1e-3
    assert int(r.niter) == int(rj.niter)


def test_restarted_fallback_float64_matches_jax(jax_draws):
    """The classic fallback in float64 (``M`` handed over as ``Mr``):
    the stitched history and the iterate against the JAX package's."""
    nx = 31
    lap = jops.poisson_2d(nx)
    lapt = ops.poisson_2d(nx, device="cpu")
    Mj, Mt = jops.jacobi_preconditioner(lap), ops.jacobi_preconditioner(lapt)
    b = np.random.RandomState(4).randn(nx * nx)
    kw = dict(tol=1e-8, maxiter=20, max_restarts=4, sketch_dim=21,
              max_escalations=0, distortion_limit=0.0)
    rj = JF.restarted_sketched_gmres(lap, jnp.asarray(b), M=Mj, **kw)
    r = F.restarted_sketched_gmres(lapt, _t(b), M=Mt, **kw)
    _same_restarted(r, rj, x_rtol=1e-9)


def test_restarted_explicit_sketch_escalates_by_kron_sketch(jax_draws):
    """An explicit sketch: escalations redraw at double its d through
    ``kron_sketch`` (seed + 7919 k), as the JAX package."""
    rng = np.random.RandomState(0)
    N = 300
    A = np.diag(np.linspace(1, 60, N)) + 0.3 * rng.randn(N, N) / np.sqrt(N)
    b = rng.randn(N)
    S = jsk.kron_sketch(N, 64, seed=1, dtype=jnp.float64)
    kw = dict(tol=1e-12, maxiter=10, max_restarts=5, max_escalations=2,
              distortion_limit=0.0, classic_fallback=False, seed=3)
    rj = JF.restarted_sketched_gmres(jnp.asarray(A), jnp.asarray(b),
                                     sketch=S, **kw)
    r = F.restarted_sketched_gmres(_t(A), _t(b), sketch=_carry(S), **kw)
    _same_restarted(r, rj, x_rtol=1e-9)
    assert jax_draws == [3 + 7919, 3 + 2 * 7919]


def test_sketch_escalation_padded_levels():
    """tests/test_sketch.py's single-program escalation: every level a
    padded sketch of one shape (the port has no compile to share; its
    draws keep the shapes), and the padded level 0 solves to tolerance."""
    rng = np.random.RandomState(0)
    N = 300
    A = np.diag(np.linspace(1, 60, N)) + 0.3 * rng.randn(N, N) / np.sqrt(N)
    b = rng.randn(N)
    At = _t(A.astype(np.float32))
    bt = _t(b.astype(np.float32))
    shapes = []
    real = tsk.padded_kron_sketch

    def spy(*a, **k):
        S = real(*a, **k)
        shapes.append((tuple(S.S1.shape), tuple(S.S2.shape)))
        return S

    tsk.padded_kron_sketch = spy
    try:
        res = F.restarted_sketched_gmres(
            At, bt, tol=1e-12, maxiter=10, max_restarts=5,
            max_escalations=2, distortion_limit=0.0, classic_fallback=False)
        assert len(shapes) == 3 and len(set(shapes)) == 1
        assert torch.isfinite(res.resnorms[0])
        res2 = F.restarted_sketched_gmres(At, bt, tol=1e-5, maxiter=30,
                                          max_restarts=6, max_escalations=2)
    finally:
        tsk.padded_kron_sketch = real
    assert int(res2.status) == F.CONVERGED
    rel = np.linalg.norm(b - A @ res2.x.double().numpy()) / np.linalg.norm(b)
    assert rel <= 2e-5


# ---------------------------------------------------------------------------
# sketched_eigs
# ---------------------------------------------------------------------------


def _eigs_pair(A, k, m, which, seed=0, **kw):
    S = _jax_sketch(A.shape[0], 8 * (m + 1), seed,
                    jnp.float64 if A.dtype in (np.float64, np.complex128)
                    else jnp.float32)
    rj = JF.sketched_eigs(jnp.asarray(A), k=k, maxiter=m, which=which,
                          seed=seed, **kw)
    r = F.sketched_eigs(_t(A), k=k, maxiter=m, which=which, sketch=_carry(S),
                        **kw)
    np.testing.assert_allclose(r.theta.numpy(), np.asarray(rj.theta),
                               rtol=1e-10)
    np.testing.assert_allclose(r.pair_resnorms.numpy(),
                               np.asarray(rj.pair_resnorms), rtol=1e-6,
                               atol=1e-13)
    assert r.status == rj.status and r.niter == rj.niter == m
    return r


def test_sketched_eigs_dominant_spectrum():
    rng = np.random.RandomState(0)
    n = 400
    D = np.diag(np.r_[np.linspace(10, 5, 8), np.linspace(1, 0.1, n - 8)])
    Q = np.linalg.qr(rng.randn(n, n))[0]
    A = Q @ D @ Q.T + 0.05 * rng.randn(n, n) / np.sqrt(n)
    true = np.sort(np.linalg.eigvals(A).real)[::-1][:6]
    r = _eigs_pair(A, 6, 80, "lm")
    own = F.sketched_eigs(_t(A), k=6, maxiter=80, which="lm", seed=_gen(0))
    for res in (r, own):
        assert res.status == 0
        assert float(res.pair_resnorms.max()) < 1e-8
        got = np.sort(res.theta.numpy().real)[::-1]
        np.testing.assert_allclose(got, true, rtol=1e-7)
    assert r.U.shape == (n, 6) and r.U.dtype == torch.complex128


def test_sketched_eigs_complex_operator():
    rng = np.random.RandomState(3)
    n = 200
    diag = np.r_[np.linspace(10, 7, 4), np.linspace(1, 0.5, n - 4)]
    A = (np.diag(diag).astype(complex)
         + 0.1j * np.triu(rng.randn(n, n), 1) / np.sqrt(n))
    true = np.linalg.eigvals(A)
    true = true[np.argsort(-true.real)][:4]
    r = _eigs_pair(A, 4, 60, "lr")
    own = F.sketched_eigs(_t(A), k=4, maxiter=60, which="lr", seed=_gen(3))
    for res in (r, own):
        assert float(res.pair_resnorms.max()) < 1e-6
        got = res.theta.numpy()
        got = got[np.argsort(-got.real)]
        np.testing.assert_allclose(got.real, true.real, rtol=1e-5)


def test_sketched_eigs_matvec_only():
    cd = jops.convection_diffusion_2d(24, 24)
    cdt = ops.convection_diffusion_2d(24, 24, device="cpu")
    N = 24 * 24
    S = _jax_sketch(N, 8 * 71)
    rj = JF.sketched_eigs(cd, k=4, n=N, maxiter=70, which="lm")
    r = F.sketched_eigs(cdt, k=4, n=N, maxiter=70, which="lm",
                        sketch=_carry(S))
    np.testing.assert_allclose(r.theta.numpy(), np.asarray(rj.theta),
                               rtol=1e-10)
    assert float(r.pair_resnorms.min()) < 1e-4
    own = F.sketched_eigs(cdt, k=4, n=N, maxiter=70, which="lm",
                          seed=_gen(0))
    assert float(own.pair_resnorms.min()) < 1e-4


def test_sketched_eigs_which_and_v0():
    """Every ``which`` on a given ``v0``: the JAX package's whole Ritz set
    (``k = m``, one run) ordered by each ``which`` against the port's
    selection of 3; a float32 ``v0`` and matrix keep float32 (complex64
    Ritz vectors)."""
    from krypy_tpu_torch.functional.eigs import _selection_key

    A, rng = _dense_nonsym(90, seed=12, spread=(1, 9), skew=0.3)
    v0 = rng.randn(90)
    m = 40
    S = _jax_sketch(90, 8 * (m + 1))
    rj = JF.sketched_eigs(jnp.asarray(A), k=m, maxiter=m, which="lm",
                          v0=jnp.asarray(v0))
    every = np.asarray(rj.theta)
    assert every.shape == (m,)
    for which in ("lm", "sm", "lr", "sr", "li", "si"):
        want = every[np.argsort(_selection_key(every, which),
                                kind="stable")][:3]
        r = F.sketched_eigs(_t(A), k=3, maxiter=m, which=which, v0=_t(v0),
                            sketch=_carry(S))
        np.testing.assert_allclose(np.sort_complex(r.theta.numpy()),
                                   np.sort_complex(want), rtol=1e-9)
    r32 = F.sketched_eigs(_t(A.astype(np.float32)), k=3, maxiter=m,
                          which="sm", v0=_t(v0.astype(np.float32)),
                          seed=_gen(1))
    assert r32.U.dtype == torch.complex64


def test_sketched_eigs_validation():
    with pytest.raises(ValueError, match="n= or v0="):
        F.sketched_eigs(lambda x: x, k=3)
    with pytest.raises(ValueError, match="k must be"):
        F.sketched_eigs(torch.eye(10, dtype=torch.float64), k=0)
    with pytest.raises(ValueError, match="needs maxiter"):
        F.sketched_eigs(torch.eye(10, dtype=torch.float64), k=11,
                        maxiter=12)
    with pytest.raises(ValueError, match="must exceed maxiter"):
        F.sketched_eigs(torch.eye(50, dtype=torch.float64), k=2,
                        maxiter=40, sketch_dim=20, seed=_gen(0))
