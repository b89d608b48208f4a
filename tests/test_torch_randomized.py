"""The port's randomized low-rank primitives (``rsvd``, ``hutchpp``,
``nystrom_preconditioner``) and ``svds`` against krypy_tpu.functional's.

The JAX package draws its sketches with ``jax.random``, the port with a
``torch.Generator``: the parity cases pass the JAX package's own draw
(``krypy_tpu.functional.randomized._gaussian`` and its Rademacher probes,
from the same key) into the port's private cores (``_rsvd_core``,
``_nystrom_core``, ``_hutchpp_core``), float64, and compare: singular
values to ``1e-10`` relative, the rank-k factorization ``U diag(s) Vh``
(free of the singular vectors' signs) to ``1e-10`` of ``s_1``, the
certified residuals to ``1e-12`` absolute (both at round-off), the
Nystrom eigenvalue estimates and ``P^{-1} x`` to ``1e-10``, the
Hutch++ estimate and its standard error to ``1e-10``.  The port's own
draws are held to tests/test_randomized.py's statistical claims on the
same matrices.

``svds`` runs LOBPCG on the Gram operator, whose iteration count the
order of the block products steers (ROADMAP.md C): every case of
tests/test_svds.py holds the singular values to the JAX package's at that
test's tolerance, the statuses equal, and that test's explicit two-sided
triplet check on the port's vectors.

The card phase's problems at 31^2 (Poisson through K1's plain version):
``svds``/``rsvd`` against the closed form of the largest eigenvalues,
``hutchpp`` against the exact trace, ``nystrom_preconditioner`` as the
``M`` of ``cg`` on Poisson + mu I.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krypy_tpu import functional as JF
from krypy_tpu.functional import randomized as jrand
from krypy_tpu_torch import eigen, functional as F, ops
from krypy_tpu_torch.functional import randomized as trand

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _op(fn):
    """A bare callable that says where it lives (the port's entry points
    put their draws on the operator's device)."""
    fn.device = "cpu"
    return fn


def _jit(fn, *arrays):
    """``fn`` of the numpy ``arrays`` through ``jax.jit`` (one compile of
    the whole function costs a fifth of its eager first call's op-by-op
    compiles)."""
    return jax.jit(fn)(*(jnp.asarray(a) for a in arrays))


def _jax_gaussian(seed, shape, dtype=jnp.float64):
    return torch.from_numpy(np.array(
        jrand._gaussian(jax.random.PRNGKey(seed), shape, dtype)))


def _lowrank_plus_noise(m, n, k, seed=0, noise=1e-6):
    rng = np.random.RandomState(seed)
    U0 = np.linalg.qr(rng.randn(m, k))[0]
    V0 = np.linalg.qr(rng.randn(n, k))[0]
    s0 = np.logspace(2, 1, k)
    return U0 @ np.diag(s0) @ V0.T + noise * rng.randn(m, n), s0


def _rsvd_same(got, want, k):
    s_j = np.asarray(want.s)
    s_t = got.s.numpy()
    np.testing.assert_allclose(s_t, s_j, rtol=1e-10)
    rec_j = np.asarray(want.U) * s_j @ np.asarray(want.Vh)
    rec_t = got.U.numpy() * s_t @ got.Vh.numpy()
    assert np.abs(rec_t - rec_j).max() <= 1e-10 * s_j[0]
    np.testing.assert_allclose(got.resnorms.numpy(),
                               np.asarray(want.resnorms), rtol=0,
                               atol=1e-12)
    assert got.U.shape == want.U.shape and got.Vh.shape == want.Vh.shape


def test_rsvd_matches_jax_and_dense_svd():
    A, _ = _lowrank_plus_noise(300, 200, 10)
    want = _jit(lambda M: JF.rsvd(M, 10, p=10, q=2, seed=1), A)
    At = torch.tensor(A)
    blocks = trand._block_ops(At, None, 200, torch.float64, CPU)
    got = trand._rsvd_core(blocks, 10, _jax_gaussian(1, (200, 20)), 2)
    _rsvd_same(got, want, 10)
    # tests/test_randomized.py's claims on the port's own draw
    r = F.rsvd(At, 10, p=10, q=2, seed=1)
    sv = np.linalg.svd(A, compute_uv=False)[:10]
    np.testing.assert_allclose(r.s.numpy(), sv, rtol=1e-10)
    assert float(r.resnorms.max()) < 1e-10
    approx = r.U.numpy() * r.s.numpy() @ r.Vh.numpy()
    assert np.linalg.norm(A - approx, 2) < 1e-4


def test_rsvd_callable_auto_adjoint():
    A, _ = _lowrank_plus_noise(300, 200, 10, seed=3)
    At = torch.tensor(A)
    want = _jit(lambda M: JF.rsvd(lambda x: M @ x, 10, n=200, p=10, q=2,
                                  seed=1, dtype=jnp.float64), A)
    op = _op(lambda x: At @ x)
    blocks = trand._block_ops(op, None, 200, torch.float64, CPU)
    got = trand._rsvd_core(blocks, 10, _jax_gaussian(1, (200, 20)), 2)
    _rsvd_same(got, want, 10)
    r = F.rsvd(op, 10, n=200, p=10, q=2, seed=1, dtype=torch.float64)
    sv = np.linalg.svd(A, compute_uv=False)[:10]
    np.testing.assert_allclose(r.s.numpy(), sv, rtol=1e-10)


def test_rsvd_explicit_Ah():
    A, _ = _lowrank_plus_noise(120, 90, 6, seed=5)
    At = torch.tensor(A)
    want = _jit(lambda M: JF.rsvd(lambda x: M @ x, 6, Ah=lambda y: M.T @ y,
                                  n=90, p=8, q=2, seed=2,
                                  dtype=jnp.float64), A)
    op = _op(lambda x: At @ x)
    blocks = trand._block_ops(op, lambda y: At.T @ y, 90, torch.float64, CPU)
    got = trand._rsvd_core(blocks, 6, _jax_gaussian(2, (90, 14)), 2)
    _rsvd_same(got, want, 6)
    r = F.rsvd(op, 6, Ah=lambda y: At.T @ y, n=90, p=8, q=2, seed=2,
               dtype=torch.float64)
    sv = np.linalg.svd(A, compute_uv=False)[:6]
    np.testing.assert_allclose(r.s.numpy(), sv, rtol=1e-9)


def test_rsvd_complex():
    rng = np.random.RandomState(1)
    A = ((rng.randn(100, 80) + 1j * rng.randn(100, 80))
         @ np.diag(np.logspace(2, -2, 80)))
    want = _jit(lambda M: JF.rsvd(M, 5, p=10, q=3, seed=2), A)
    At = torch.tensor(A)
    blocks = trand._block_ops(At, None, 80, torch.complex128, CPU)
    Om = _jax_gaussian(2, (80, 15), jnp.complex128)
    got = trand._rsvd_core(blocks, 5, Om, 3)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s),
                               rtol=1e-10)
    np.testing.assert_allclose(got.resnorms.numpy(),
                               np.asarray(want.resnorms), rtol=1e-6)
    r = F.rsvd(At, 5, p=10, q=3, seed=2)
    sv = np.linalg.svd(A, compute_uv=False)[:5]
    np.testing.assert_allclose(r.s.numpy(), sv, rtol=1e-6)
    assert float(r.resnorms.max()) < 1e-3
    assert r.U.dtype == torch.complex128


def test_rsvd_requires_n_for_callables():
    with pytest.raises(ValueError):
        JF.rsvd(lambda x: x, 3)
    with pytest.raises(ValueError):
        F.rsvd(_op(lambda x: x), 3)


def test_gaussian_draw_statistics():
    """The port's own sketch: mean ~0, variance ~1 (complex: 1/2 in each
    part), reproducible from its seed, different across seeds."""
    g = trand._gaussian(trand._generator(3, CPU), (400, 50), torch.float64,
                        CPU)
    assert abs(float(g.mean())) < 0.02 and abs(float(g.var()) - 1) < 0.03
    again = trand._gaussian(trand._generator(3, CPU), (400, 50),
                            torch.float64, CPU)
    assert torch.equal(g, again)
    other = trand._gaussian(trand._generator(4, CPU), (400, 50),
                            torch.float64, CPU)
    assert not torch.equal(g, other)
    c = trand._gaussian(trand._generator(3, CPU), (400, 50),
                        torch.complex128, CPU)
    assert abs(float(c.real.var()) - 0.5) < 0.02
    assert abs(float(c.imag.var()) - 0.5) < 0.02
    z = trand._rademacher(trand._generator(3, CPU), (400, 50), torch.float64,
                          CPU)
    assert set(z.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(z.mean())) < 0.02


def _spd_decay(N, seed=0):
    rng = np.random.RandomState(seed)
    Q = np.linalg.qr(rng.randn(N, N))[0]
    lams = np.r_[np.logspace(4, 1, 50), np.ones(N - 50)]
    A = (Q * lams) @ Q.T
    return 0.5 * (A + A.T), rng


def _nystrom_pair(A, rank, N, seed, mu=0.0):
    """The JAX package's preconditioner and factors, and the port's core
    on the JAX draw."""
    P_j, (U_j, lam_j) = JF.nystrom_preconditioner(
        jnp.asarray(A), rank, N, mu=mu, seed=seed, dtype=jnp.float64,
        return_factors=True)
    Om = _jax_gaussian(seed, (N, rank + 10))
    P_t, (U_t, lam_t) = trand._nystrom_core(torch.tensor(A), rank, Om, mu,
                                            return_factors=True)
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-9,
                               atol=1e-10 * float(lam_j[0]))
    x = np.random.RandomState(seed + 1).randn(N)
    np.testing.assert_allclose(P_t(torch.tensor(x)).numpy(),
                               np.asarray(P_j(jnp.asarray(x))), rtol=1e-9,
                               atol=1e-10 * np.abs(x).max())
    return P_j, P_t


def test_nystrom_preconditioner_caps_cg_iterations():
    N = 500
    A, rng = _spd_decay(N)
    b = rng.randn(N)
    _nystrom_pair(A, 60, N, 0)
    At, bt = torch.tensor(A), torch.tensor(b)
    # the JAX test's claims on the port's own draw
    r_plain = F.cg(At, bt, tol=1e-8, maxiter=2000)
    P = F.nystrom_preconditioner(At, 60, N, seed=0, dtype=torch.float64)
    r_ny = F.cg(At, bt, M=P, tol=1e-8, maxiter=2000)
    assert int(r_ny.status) == 0
    assert int(r_ny.niter) <= int(r_plain.niter) // 3
    rel = float(torch.linalg.vector_norm(bt - At @ r_ny.x)
                / torch.linalg.vector_norm(bt))
    assert rel <= 1e-6


def test_nystrom_preconditioner_shifted_system():
    N = 400
    A, rng = _spd_decay(N, seed=2)
    mu = 0.5
    _nystrom_pair(A, 60, N, 1, mu=mu)
    Am = torch.tensor(A + mu * np.eye(N))
    b = torch.tensor(rng.randn(N))
    P, (U, lam) = F.nystrom_preconditioner(
        torch.tensor(A), 60, N, mu=mu, seed=1, dtype=torch.float64,
        return_factors=True)
    assert U.shape == (N, 60) and lam.shape == (60,)
    assert bool(torch.all(lam >= 0))
    r = F.cg(Am, b, M=P, tol=1e-8, maxiter=1000)
    assert int(r.status) == 0
    rel = float(torch.linalg.vector_norm(b - Am @ r.x)
                / torch.linalg.vector_norm(b))
    assert rel <= 1e-6


def test_nystrom_factors_approximate_spectrum():
    N = 300
    A, _ = _spd_decay(N, seed=4)
    _nystrom_pair(A, 30, N, 3)
    _, (U, lam) = F.nystrom_preconditioner(
        torch.tensor(A), 30, N, seed=3, dtype=torch.float64,
        return_factors=True)
    true = np.linalg.eigvalsh(A)[::-1][:10]
    np.testing.assert_allclose(lam.numpy()[:10], true, rtol=5e-2)


def _jax_probes(key, N, k, n_probes, dtype=jnp.float64):
    """The JAX package's Hutch++ sketch and probes for ``key``."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    Om = jrand._gaussian(k1, (N, k), dtype)
    Z = jax.random.rademacher(k2, (N, n_probes), jnp.float64).astype(dtype)
    return (torch.from_numpy(np.array(Om)), torch.from_numpy(np.array(Z)))


def _hutch_matrix(N=400):
    rng = np.random.RandomState(0)
    Q = np.linalg.qr(rng.randn(N, N))[0]
    lams = np.r_[np.logspace(3, 1, 40), np.ones(N - 40) * 0.5]
    A = (Q * lams) @ Q.T
    return 0.5 * (A + A.T)


@pytest.mark.parametrize("k,n_probes", [(48, 32), (2, 110)])
def test_hutchpp_matches_jax(k, n_probes):
    A = _hutch_matrix()
    est_j, se_j = _jit(lambda M: JF.hutchpp(M, 0, k=k, n_probes=n_probes),
                       A)
    blk, _ = trand._block_ops(torch.tensor(A), None, 400, torch.float64, CPU)
    est_t, se_t = trand._hutchpp_core(blk, *_jax_probes(0, 400, k, n_probes))
    np.testing.assert_allclose(float(est_t), float(est_j), rtol=1e-10)
    np.testing.assert_allclose(float(se_t), float(se_j), rtol=1e-10)


def test_hutchpp_trace_estimate():
    """tests/test_randomized.py's claims on the port's own draws: the
    head capturing the decay estimates the trace to 2e-3, better than a
    headless estimate at the same budget."""
    A = _hutch_matrix()
    true = np.trace(A)
    At = torch.tensor(A)
    est, se = F.hutchpp(At, 0, k=48, n_probes=32)
    assert abs(float(est) - true) / true < 2e-3
    assert float(se) >= 0.0
    est_small, _ = F.hutchpp(At, 0, k=2, n_probes=110)
    assert abs(float(est) - true) < abs(float(est_small) - true)


def test_hutchpp_callable_matches_matrix():
    rng = np.random.RandomState(2)
    N = 200
    A = rng.randn(N, N)
    A = A @ A.T
    At = torch.tensor(A)
    e1, _ = F.hutchpp(At, 5, k=32, n_probes=16)
    e2, _ = F.hutchpp(_op(lambda x: At @ x), 5, n=N, k=32, n_probes=16,
                      dtype=torch.float64)
    np.testing.assert_allclose(float(e1), float(e2), rtol=1e-10)
    # and the JAX package's statement of the same
    j1, _ = _jit(lambda M: JF.hutchpp(M, 5, k=32, n_probes=16), A)
    blk, _ = trand._block_ops(_op(lambda x: At @ x), None, N, torch.float64,
                              CPU)
    t1, _ = trand._hutchpp_core(blk, *_jax_probes(5, N, 32, 16))
    np.testing.assert_allclose(float(t1), float(j1), rtol=1e-10)


def test_hutchpp_requires_n_for_callables():
    with pytest.raises(ValueError):
        JF.hutchpp(lambda x: x, 0)
    with pytest.raises(ValueError):
        F.hutchpp(_op(lambda x: x), 0)


def test_public_signatures_match_jax():
    """The four names take the JAX package's arguments, in its order and
    with its defaults (``dtype``'s default as the torch dtype)."""
    import inspect

    from krypy_tpu.functional import svd as jsvd
    from krypy_tpu_torch.functional import svd as tsvd

    for jmod, tmod, name in ((jrand, trand, "rsvd"),
                             (jrand, trand, "hutchpp"),
                             (jrand, trand, "nystrom_preconditioner"),
                             (jsvd, tsvd, "svds")):
        js = inspect.signature(getattr(jmod, name)).parameters
        ts = inspect.signature(getattr(tmod, name)).parameters
        assert list(js) == list(ts), name
        for p in js:
            if p == "dtype" and js[p].default is not None:
                assert ts[p].default == torch.float32
            else:
                assert js[p].default == ts[p].default, (name, p)
    assert trand.RsvdResult._fields == jrand.RsvdResult._fields
    assert tsvd.SvdsResult._fields == jsvd.SvdsResult._fields


# ---------------------------------------------------------------------------
# svds
# ---------------------------------------------------------------------------


def _check_triplets(Am, r, k, rtol=1e-8):
    """tests/test_svds.py's explicit two-sided residual check."""
    U, s, Vh = r.U.numpy(), r.s.numpy(), r.Vh.numpy()
    s1 = s[0]
    for i in range(k):
        assert np.linalg.norm(Am @ Vh[i].conj() - s[i] * U[:, i]) <= \
            rtol * s1
        assert np.linalg.norm(Am.conj().T @ U[:, i] - s[i] * Vh[i].conj()) \
            <= rtol * s1
    assert np.allclose(U.conj().T @ U, np.eye(k), atol=1e-7)
    assert np.allclose(Vh @ Vh.conj().T, np.eye(k), atol=1e-7)


def _svds_pair(Am, rtol, **kw):
    want = _jit(lambda M: JF.svds(M, **kw), Am)
    got = F.svds(torch.tensor(Am), **kw)
    assert int(got.status) == int(want.status)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=rtol)
    return got


@pytest.mark.parametrize("shape,k", [((150, 60), 4), ((50, 140), 3)])
def test_svds_real_matches_jax(shape, k):
    rng = np.random.default_rng(0 if shape[0] > shape[1] else 1)
    Am = rng.standard_normal(shape)
    sv = np.linalg.svd(Am, compute_uv=False)
    got = _svds_pair(Am, 1e-9, k=k, tol=1e-10, maxiter=300)
    assert int(got.status) == 0
    np.testing.assert_allclose(got.s.numpy(), sv[:k], rtol=1e-9)
    _check_triplets(Am, got, k, rtol=1e-7)


def test_svds_complex():
    rng = np.random.default_rng(2)
    Am = rng.standard_normal((80, 50)) + 1j * rng.standard_normal((80, 50))
    sv = np.linalg.svd(Am, compute_uv=False)
    got = _svds_pair(Am, 1e-8, k=3, tol=1e-10, maxiter=300)
    assert int(got.status) == 0 and got.U.dtype == torch.complex128
    np.testing.assert_allclose(got.s.numpy(), sv[:3], rtol=1e-8)
    _check_triplets(Am, got, 3, rtol=1e-6)


def test_svds_callable_with_adjoint():
    rng = np.random.default_rng(3)
    Am = rng.standard_normal((90, 40))
    At = torch.tensor(Am)
    sv = np.linalg.svd(Am, compute_uv=False)
    want = _jit(lambda M: JF.svds(lambda v: M @ v, k=2, Ah=lambda y: M.T @ y,
                                  n=40, tol=1e-10, maxiter=300), Am)
    got = F.svds(_op(lambda v: At @ v), k=2, Ah=lambda y: At.T @ y, n=40,
                 tol=1e-10, maxiter=300)
    assert int(got.status) == int(want.status) == 0
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-9)
    np.testing.assert_allclose(got.s.numpy(), sv[:2], rtol=1e-9)


def test_svds_rank_deficient_tail():
    rng = np.random.default_rng(4)
    B = rng.standard_normal((100, 2))
    Am = B @ rng.standard_normal((2, 60))
    want = _jit(lambda M: JF.svds(M, k=4, tol=1e-8, maxiter=300), Am)
    got = F.svds(torch.tensor(Am), k=4, tol=1e-8, maxiter=300)
    s = got.s.numpy()
    sv = np.linalg.svd(Am, compute_uv=False)
    np.testing.assert_allclose(s[:2], np.asarray(want.s)[:2], rtol=1e-8)
    assert np.allclose(s[:2], sv[:2], rtol=1e-8)
    assert (s[2:] <= 1e-6 * s[0]).all()
    assert got.pair_resnorms.numpy().max() <= 1e-6
    assert np.all(np.isfinite(got.U.numpy()))


def test_svds_x0_overrides_k():
    rng = np.random.default_rng(5)
    Am = rng.standard_normal((40, 30))
    sv = np.linalg.svd(Am, compute_uv=False)
    X0 = rng.standard_normal((30, 4))
    want = _jit(lambda M, X: JF.svds(M, k=6, X0=X, tol=1e-9, maxiter=300),
                Am, X0)
    got = F.svds(torch.tensor(Am), k=6, X0=torch.tensor(X0), tol=1e-9,
                 maxiter=300)
    assert got.s.shape == want.s.shape == (4,)
    assert int(got.status) == int(want.status) == 0
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-8)
    np.testing.assert_allclose(got.s.numpy(), sv[:4], rtol=1e-8)


def test_svds_validation():
    with pytest.raises(ValueError, match="Ah="):
        F.svds(_op(lambda v: v), k=2, n=30)
    with pytest.raises(ValueError, match="n= or X0="):
        F.svds(_op(lambda v: v), k=2, Ah=lambda y: y)
    with pytest.raises(ValueError, match="Ah="):
        JF.svds(lambda v: v, k=2, n=30)


# ---------------------------------------------------------------------------
# the card phase's problems on Poisson (K1's plain version)
# ---------------------------------------------------------------------------


def _poisson_spectrum(nx):
    """Every eigenvalue of ``ops.poisson_2d(nx)`` by its closed form,
    sorted."""
    h = 1.0 / (nx + 1)
    s = 4.0 / h ** 2 * np.sin(np.arange(1, nx + 1) * np.pi * h / 2) ** 2
    return np.sort((s[:, None] + s[None, :]).ravel())


def test_poisson_svds_and_rsvd_against_closed_form():
    """The lsq phase's (b): ``svds`` (k = 6) on bench.py's Poisson
    operator through K1 with the operator as its own adjoint, against the
    closed form of its largest eigenvalues, at 31^2 (the top of Poisson's
    spectrum is a cluster whose relative gaps shrink as h^2: LOBPCG takes
    ~1000 iterations to tol 1e-6 at 31^2 and more than 3000 at 127^2);
    ``rsvd`` (k = 6, p = 10, q = 2) held by interlacing (each value at most
    the closed form's) and by its certified residual (a singular value of
    the closed form within ``resnorms[i] s_1`` of each), float64."""
    nx, k = 31, 6
    A = ops.poisson_2d(nx, impl="cuda", device="cpu")
    want = np.array([v for v, _, _ in
                     eigen.poisson_eigenvalues(nx, k, largest=True)])
    r = F.svds(A, k=k, Ah=A, tol=1e-6, maxiter=2000)
    assert r.converged
    np.testing.assert_allclose(r.s.numpy(), want, rtol=1e-9)
    q = F.rsvd(A, k, Ah=A, n=nx * nx, p=10, q=2, seed=0,
               dtype=torch.float64)
    s = q.s.numpy()
    assert np.all(s <= want * (1 + 1e-12))
    spec = _poisson_spectrum(nx)
    dist = np.abs(spec[None, :] - s[:, None]).min(axis=1)
    assert np.all(dist <= q.resnorms.numpy() * s[0] * (1 + 1e-9))


def test_poisson_hutchpp_within_its_standard_error():
    """The lsq phase's (c): Hutch++ on Poisson, whose trace is exactly N
    times its diagonal 4/h^2, within 5 of its standard errors."""
    nx = 31
    A = ops.poisson_2d(nx, impl="cuda", device="cpu")
    N = nx * nx
    true = N * 4.0 * (nx + 1) ** 2
    est, se = F.hutchpp(A, 0, n=N, k=16, n_probes=32, dtype=torch.float64)
    assert float(se) > 0
    assert abs(float(est) - true) <= 5 * float(se)


def test_poisson_nystrom_preconditioned_cg():
    """The lsq phase's (d): the Nystrom preconditioner of Poisson as
    ``M`` of ``cg`` on Poisson + mu I converges; it saves iterations only
    where its rank is a large share of N (Poisson's spectrum has no decay:
    its top is a cluster, ROADMAP.md C): at 31^2, mu = 1, a random
    right-hand side, rank 300 of 961 takes fewer iterations than plain CG,
    rank 20 as many."""
    nx, mu = 31, 1.0
    A = ops.poisson_2d(nx, impl="cuda", device="cpu")
    N = nx * nx
    shifted = lambda v: A(v) + mu * v
    b = torch.tensor(np.random.default_rng(0).standard_normal(N))
    plain = F.cg(shifted, b, tol=1e-8, maxiter=2000)
    its = {}
    for rank in (20, 300):
        P = F.nystrom_preconditioner(A, rank, N, mu=mu, seed=0,
                                     dtype=torch.float64)
        pre = F.cg(shifted, b, M=P, tol=1e-8, maxiter=2000)
        assert pre.converged
        x = pre.x
        assert float(torch.linalg.vector_norm(b - shifted(x))
                     / torch.linalg.vector_norm(b)) <= 1e-7
        its[rank] = int(pre.niter)
    assert plain.converged
    assert its[300] < int(plain.niter) <= its[20] + 1
