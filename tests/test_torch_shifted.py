"""The port's functional Arnoldi relation builder (``functional.arnoldi``)
and its multi-shift solvers (``shifted_cg``, ``shifted_gmres``,
``restarted_shifted_gmres``) against krypy_tpu.functional's on the same
numpy inputs, float64.

``arnoldi``: every case of tests/test_functional_arnoldi.py and the
one-reduce cases of tests/test_arnoldi.py, each test's own bounds on the
port's relation (Arnoldi residual, orthogonality, Hessenberg structure;
the Drkošová battery through that file's ``assert_arnoldi``), and the
JAX package's ``niter``/``invariant`` equal and, for the two-pass schemes
(whose relation round-off cannot steer), ``H`` and ``V`` to ``1e-12``.

Multi-shift: every case of tests/test_shifted.py but its sharded ones
(those run in tests/test_torch_parallel.py), with that test's claims on
the port's result and, against the JAX package, ``niter`` and the
statuses equal, ``X`` to ``1e-10`` relative (norm-wise) and the final
residuals to ``1e-12`` absolute (they sit at or near the round-off
floor).  The float32 cases (a tolerance below float32's floor) hold the
port to the JAX test's own claims: float32 reductions differ (ROADMAP.md
C).  The card phase's problems run at 31^2 through K1's plain version
(``impl="cuda"``) against the JAX package's plain stencils.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from krypy_tpu import functional as JF, ops as jops
from krypy_tpu_torch import functional as F, northstar, ops, utils
from test_arnoldi import assert_arnoldi

torch.set_num_threads(1)

ORTHOS = ("cgs", "cgs2", "mgs", "dmgs", "cgs2_1r")
TWO_PASS = ("cgs2", "dmgs", "cgs2_1r", "house")
_B = np.diag(np.linspace(1, 5, 10))


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


#: one jitted JAX relation per option set (``maxiter``, ``ortho``, which
#: matrices are given); the operator, start and matrices are traced
_JAX_ARNOLDI = {}


def _jax_arnoldi(matrix, v, **kw):
    arrays = {k: a for k, a in kw.items() if isinstance(a, np.ndarray)}
    static = {k: a for k, a in kw.items() if k not in arrays}
    key = (tuple(sorted(static.items())), tuple(sorted(arrays)),
           np.shape(matrix), np.asarray(matrix).dtype.str)
    fn = _JAX_ARNOLDI.get(key)
    if fn is None:
        fn = _JAX_ARNOLDI[key] = jax.jit(
            lambda A, v, arr: JF.arnoldi(A, v, **static, **arr))
    return fn(jnp.asarray(matrix), jnp.asarray(v),
              {k: jnp.asarray(a) for k, a in arrays.items()})


def _arnoldi_pair(matrix, v, **kw):
    """The JAX package's relation and the port's on the same inputs."""
    tkw = {k: _t(a) if isinstance(a, np.ndarray) else a
           for k, a in kw.items()}
    j = _jax_arnoldi(matrix, v, **kw)
    t = F.arnoldi(_t(matrix), _t(v), **tkw)
    assert int(t.niter) == int(j.niter)
    assert bool(t.invariant) == bool(j.invariant)
    assert t.V.shape == j.V.shape and t.H.shape == j.H.shape
    assert (t.P is None) == (j.P is None)
    if kw.get("ortho", "cgs2") in TWO_PASS:
        np.testing.assert_allclose(t.H.numpy(), np.asarray(j.H), rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(j.H).max()))
        np.testing.assert_allclose(t.V.numpy(), np.asarray(j.V), rtol=0,
                                   atol=1e-12)
    return t


@pytest.mark.parametrize("ortho", ORTHOS)
@pytest.mark.parametrize("name", ["spd", "nonsymm"])
@pytest.mark.parametrize("maxiter", [1, 5, 9])
def test_functional_arnoldi_relation(ortho, name, maxiter):
    matrix = getattr(helpers, f"matrix_{name}")()
    res = _arnoldi_pair(matrix, np.ones(10), maxiter=maxiter, ortho=ortho)
    n = int(res.niter)
    assert n <= maxiter
    V = res.V.numpy()[: n + 1].T
    H = res.H.numpy()[: n + 1, :n]
    An = np.linalg.norm(matrix, 2)
    assert np.linalg.norm(matrix @ V[:, :n] - V @ H) <= 1e-12 * An
    tol = 1e-8 if ortho in ("cgs", "mgs") else 1e-13
    assert np.linalg.norm(np.eye(n + 1) - V.conj().T @ V) <= tol
    assert np.linalg.norm(np.tril(H, -2)) == 0
    assert (np.real(np.diag(H[1:, :n])) >= 0).all()


def test_functional_arnoldi_lanczos():
    A = helpers.matrix_spd()
    res = _arnoldi_pair(A, np.ones(10), maxiter=8, ortho="lanczos")
    n = int(res.niter)
    V = res.V.numpy()[: n + 1].T
    H = res.H.numpy()[: n + 1, :n]
    assert np.linalg.norm(A @ V[:, :n] - V @ H) <= 1e-12
    assert np.linalg.norm(H[:n, :n] - H[:n, :n].T) == 0
    assert np.linalg.norm(np.triu(H[:n, :n], 2)) == 0


def test_functional_arnoldi_invariance():
    A = np.diag([1.0] * 8 + [2.0, 2.0])
    res = _arnoldi_pair(A, np.ones(10), maxiter=9)
    assert bool(res.invariant) and int(res.niter) == 2
    V = res.V.numpy()[:2].T
    H = res.H.numpy()[:2, :2]
    assert np.linalg.norm(A @ V - V @ H) <= 1e-12


@pytest.mark.parametrize("ortho", ["cgs2", "dmgs", "cgs2_1r"])
def test_functional_arnoldi_preconditioned(ortho):
    A = helpers.matrix_spd()
    Md = np.linspace(1, 3, 10)
    Mt = torch.tensor(Md)
    j = JF.arnoldi(jnp.asarray(A), jnp.ones(10), maxiter=8, ortho=ortho,
                   M=lambda x: x / Md)
    res = F.arnoldi(torch.tensor(A), torch.ones(10, dtype=torch.float64),
                    maxiter=8, ortho=ortho, M=lambda x: x / Mt)
    n = int(res.niter)
    assert n == int(j.niter)
    np.testing.assert_allclose(res.H.numpy(), np.asarray(j.H), atol=1e-12)
    np.testing.assert_allclose(res.P.numpy(), np.asarray(j.P), atol=1e-12)
    V = res.V.numpy()[: n + 1].T
    P = res.P.numpy()[: n + 1].T
    H = res.H.numpy()[: n + 1, :n]
    MA = np.diag(1.0 / Md) @ A
    assert np.linalg.norm(MA @ V[:, :n] - V @ H) <= 1e-12
    assert np.linalg.norm(V - np.diag(1.0 / Md) @ P) <= 1e-13
    assert np.linalg.norm(np.eye(n + 1) - P.T @ V) <= 1e-13


def test_functional_vs_eager_arnoldi():
    """The port's two lanes build the same relation (the JAX test's claim
    about its own)."""
    A = helpers.matrix_nonsymm()
    V_e, H_e = utils.arnoldi(torch.tensor(A),
                             torch.ones((10, 1), dtype=torch.float64),
                             maxiter=6, ortho="dmgs")
    res = F.arnoldi(torch.tensor(A), torch.ones(10, dtype=torch.float64),
                    maxiter=6, ortho="dmgs")
    n = int(res.niter)
    np.testing.assert_allclose(res.H.numpy()[: n + 1, :n], np.asarray(H_e),
                               atol=1e-12)


@pytest.mark.parametrize("name", ["spd", "nonsymm"])
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
def test_functional_arnoldi_house(name, maxiter):
    matrix = getattr(helpers, f"matrix_{name}")()
    res = _arnoldi_pair(matrix, np.ones(10), maxiter=maxiter, ortho="house")
    n = int(res.niter)
    inv = bool(res.invariant)
    cols = n if inv else n + 1
    V = res.V.numpy()[:cols].T
    H = res.H.numpy()[:cols, :n]
    An = np.linalg.norm(matrix, 2)
    assert np.linalg.norm(matrix @ V[:, :n] - V @ H) <= 1e-13 * An
    assert np.linalg.norm(np.eye(cols) - V.conj().T @ V) <= 1e-13
    if maxiter == 10:
        assert inv
    sub = np.diag(H[1:, :n]) if not inv else np.diag(H, -1)
    assert (np.real(sub) >= 0).all()


def test_functional_arnoldi_argument_checks():
    """The JAX function's refusals: Householder with ``M`` or ``ip``;
    ``cgs2_1r`` with ``M`` and ``ip``, or with a scalar-callable ``ip``."""
    eye = torch.eye(4, dtype=torch.float64)
    ones = torch.ones(4, dtype=torch.float64)
    for kw in (dict(ortho="house", M=lambda x: x),
               dict(ortho="house", ip=eye),
               dict(ortho="cgs2_1r", M=lambda x: x, ip=eye),
               dict(ortho="cgs2_1r", ip=lambda x, y: torch.vdot(x, y))):
        with pytest.raises(ValueError):
            F.arnoldi(eye, ones, maxiter=2, **kw)
        jkw = {k: jnp.eye(4) if v is eye else v for k, v in kw.items()}
        if "ip" in kw and callable(kw["ip"]):
            jkw["ip"] = lambda x, y: jnp.vdot(x, y)
        with pytest.raises(ValueError):
            JF.arnoldi(jnp.eye(4), jnp.ones(4), maxiter=2, **jkw)


@pytest.mark.parametrize("name", ["spd", "symm_indef", "nonsymm"])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
@pytest.mark.parametrize("weighted", [False, True])
def test_arnoldi_one_reduce_battery(name, unit, maxiter, weighted):
    """tests/test_arnoldi.py's one-reduce battery on the port: the
    Drkošová bounds at the two-pass class, ip ``None`` or ``B``."""
    matrix = getattr(helpers, f"matrix_{name}")()
    v = np.eye(10, 1) if unit else np.ones((10, 1))
    ip_B = _B if weighted else None
    res = _arnoldi_pair(matrix, v.reshape(-1), maxiter=maxiter,
                        ortho="cgs2_1r", ip=ip_B)
    n = int(res.niter)
    cols = n if bool(res.invariant) else n + 1
    V = jnp.asarray(res.V.numpy()[:cols].T)
    H = res.H.numpy()[:cols, :n]
    assert_arnoldi(matrix, v, V, H, None, maxiter, "dmgs", None, ip_B,
                   An=np.linalg.norm(matrix, 2))


@pytest.mark.parametrize("name", ["spd", "symm_indef", "nonsymm"])
@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("maxiter", [1, 5, 9, 10])
def test_arnoldi_one_reduce_dual_basis_M(name, unit, maxiter):
    matrix = getattr(helpers, f"matrix_{name}")()
    v = np.eye(10, 1) if unit else np.ones((10, 1))
    res = _arnoldi_pair(matrix, v.reshape(-1), maxiter=maxiter,
                        ortho="cgs2_1r", M=_B)
    n = int(res.niter)
    cols = n if bool(res.invariant) else n + 1
    V = jnp.asarray(res.V.numpy()[:cols].T)
    P = jnp.asarray(res.P.numpy()[:cols].T)
    H = res.H.numpy()[:cols, :n]
    assert_arnoldi(matrix, v, V, H, P, maxiter, "dmgs", _B, None,
                   An=np.linalg.norm(matrix, 2))


# ---------------------------------------------------------------------------
# multi-shift solvers
# ---------------------------------------------------------------------------


def _jax(name, *args, **kw):
    """The JAX package's ``name`` on these arguments through ``jax.jit``
    (one compile costs a fifth of an eager first call's)."""
    return jax.jit(lambda: getattr(JF, name)(*args, **kw))()


def _nonsym(n=300, seed=0):
    rng = np.random.default_rng(seed)
    d = np.linspace(1.0, 50.0, n)
    S = rng.standard_normal((n, n)) * 0.3 / np.sqrt(n)
    return np.diag(d) + S - S.T, rng.standard_normal(n)


def _same(got, want, x_rtol=1e-10, res_atol=1e-12):
    assert int(got.niter) == int(want.niter)
    assert got.status.numpy().tolist() == np.asarray(want.status).tolist()
    X, Xj = got.X.numpy(), np.asarray(want.X)
    assert X.shape == Xj.shape and X.dtype == Xj.dtype
    assert np.linalg.norm(X - Xj) <= x_rtol * np.linalg.norm(Xj)
    np.testing.assert_allclose(got.resnorms.numpy(),
                               np.asarray(want.resnorms), rtol=1e-6,
                               atol=res_atol)


def test_shifted_gmres_reported_equals_true_residual():
    Am, b = _nonsym()
    n = Am.shape[0]
    shifts = np.array([0.0, 0.5, 2.0, 10.0])
    kw = dict(maxiter=120, tol=1e-10)
    r = F.shifted_gmres(torch.tensor(Am), torch.tensor(b), shifts, **kw)
    _same(r, _jax("shifted_gmres", jnp.asarray(Am), jnp.asarray(b),
                              jnp.asarray(shifts), **kw))
    assert bool((r.status == F.CONVERGED).all())
    bn = np.linalg.norm(b)
    for i, s in enumerate(shifts):
        true = np.linalg.norm(b - (Am + s * np.eye(n)) @ r.X[i].numpy()) / bn
        assert true <= 1e-10
        assert abs(true - float(r.resnorms[i])) <= 1e-12


def test_shifted_gmres_matches_single_system_gmres():
    Am, b = _nonsym(200, 1)
    sigma = 3.0
    kw = dict(maxiter=100, tol=1e-11)
    r = F.shifted_gmres(torch.tensor(Am), torch.tensor(b), [sigma], **kw)
    _same(r, _jax("shifted_gmres", jnp.asarray(Am), jnp.asarray(b),
                              jnp.asarray([sigma]), **kw))
    single = F.gmres(torch.tensor(Am + sigma * np.eye(200)), torch.tensor(b),
                     tol=1e-11, maxiter=100)
    err = np.linalg.norm(r.X[0].numpy() - single.x.numpy())
    assert err <= 1e-8 * np.linalg.norm(single.x.numpy())


def test_shifted_gmres_complex_conjugate_symmetry():
    Am, b = _nonsym(200, 2)
    cs = np.array([1.0 + 2.0j, 1.0 - 2.0j])
    kw = dict(maxiter=100, tol=1e-10)
    r = F.shifted_gmres(torch.tensor(Am), torch.tensor(b), cs, **kw)
    _same(r, _jax("shifted_gmres", jnp.asarray(Am), jnp.asarray(b),
                              jnp.asarray(cs), **kw))
    assert bool((r.status == F.CONVERGED).all())
    assert np.abs(r.X[0].numpy().conj() - r.X[1].numpy()).max() == 0.0


def test_shifted_gmres_per_shift_status_honesty():
    n = 300
    d = np.linspace(1.0, 50.0, n)
    shifts = np.array([0.0, -0.99999999])
    kw = dict(maxiter=150, tol=1e-8)
    r = F.shifted_gmres(torch.tensor(np.diag(d)), torch.ones(n, dtype=torch.
                                                              float64),
                        shifts, **kw)
    j = _jax("shifted_gmres", jnp.asarray(np.diag(d)), jnp.ones(n),
                         jnp.asarray(shifts), **kw)
    # the near-singular member's condition number is ~5e7: its iterate
    # and its small least-squares residual (3e-8 against the JAX
    # package's 2.7e-8, both above tol) hold kappa eps of the JAX
    # package's
    _same(r, j, x_rtol=1e-6, res_atol=1e-8)
    assert int(r.status[0]) == F.CONVERGED
    assert int(r.status[1]) == F.MAXITER


def test_shifted_cg_matches_exact_solutions():
    n = 400
    d = np.linspace(1.0, 100.0, n)
    b = np.random.default_rng(0).standard_normal(n)
    shifts = np.array([0.0, 0.1, 1.0, 10.0, 100.0])
    r = F.shifted_cg(ops.diagonal(torch.tensor(d)), torch.tensor(b), shifts,
                     tol=1e-10, maxiter=500)
    _same(r, _jax("shifted_cg", jops.diagonal(jnp.asarray(d)), jnp.asarray(b),
                           jnp.asarray(shifts), tol=1e-10, maxiter=500))
    assert bool((r.status == F.CONVERGED).all())
    for i, s in enumerate(shifts):
        x_exact = b / (d + s)
        err = np.linalg.norm(r.X[i].numpy() - x_exact) / np.linalg.norm(
            x_exact)
        assert err <= 1e-8, (s, err)


def test_shifted_cg_matches_per_shift_cg():
    nx = 24
    lap = ops.poisson_2d(nx, device="cpu")
    b = torch.ones(nx * nx, dtype=torch.float64)
    shifts = [0.0, 50.0]
    r = F.shifted_cg(lap, b, shifts, tol=1e-10, maxiter=2000)
    _same(r, _jax("shifted_cg", jops.poisson_2d(nx), jnp.ones(nx * nx),
                           jnp.asarray(shifts), tol=1e-10, maxiter=2000))
    for i, s in enumerate(shifts):
        single = F.cg(lambda v, s=s: lap(v) + s * v, b, tol=1e-10,
                      maxiter=2000)
        err = np.linalg.norm(r.X[i].numpy() - single.x.numpy())
        assert err <= 1e-7 * np.linalg.norm(single.x.numpy())


@pytest.mark.parametrize("variant", ["classic", "1r"])
def test_shifted_cg_true_residual_honesty(variant):
    """An unreachable float32 tolerance reports MAXITER with a finite
    iterate (the JAX test's claims, on both packages)."""
    n = 500
    d = np.linspace(1e-3, 50.0, n).astype(np.float32)
    kw = dict(tol=1e-13, maxiter=1500, variant=variant)
    r = F.shifted_cg(ops.diagonal(torch.tensor(d)),
                     torch.ones(n, dtype=torch.float32), [0.0, 1.0], **kw)
    j = _jax("shifted_cg", jops.diagonal(jnp.asarray(d)), jnp.ones(n, jnp.float32),
                      jnp.asarray([0.0, 1.0]), **kw)
    for res in (r, j):
        assert int(res.status[0]) == F.MAXITER
        assert bool(np.all(np.isfinite(np.asarray(res.X))))
    assert r.X.dtype == torch.float32


def test_shifted_cg_one_reduce_matches_classic():
    lap = ops.poisson_2d(48, device="cpu")
    jlap = jops.poisson_2d(48)
    b = torch.ones(48 * 48, dtype=torch.float64)
    sh = [0.0, 0.5, 2.0, 10.0]
    rc = F.shifted_cg(lap, b, sh, tol=1e-10, maxiter=3000)
    r1 = F.shifted_cg(lap, b, sh, tol=1e-10, maxiter=3000, variant="1r")
    assert int(r1.niter) == int(rc.niter)
    assert r1.status.tolist() == [F.CONVERGED] * 4
    assert float((rc.X - r1.X).abs().max()) <= 1e-12
    for variant, res in (("classic", rc), ("1r", r1)):
        _same(res, _jax("shifted_cg", jlap, jnp.ones(48 * 48), jnp.asarray(sh),
                                 tol=1e-10, maxiter=3000, variant=variant))
    # off a mesh auto is the classic recurrence, as in the JAX package
    ra = F.shifted_cg(lap, b, sh, tol=1e-10, maxiter=3000, variant="auto")
    assert torch.equal(ra.X, rc.X)
    with pytest.raises(ValueError, match="variant"):
        F.shifted_cg(lap, b, sh, variant="bogus")


def test_shifted_cg_f32_divergence_guard_returns_best():
    n = 2000
    d = np.linspace(1e-2, 1e4, n).astype(np.float32)
    r = F.shifted_cg(ops.diagonal(torch.tensor(d)),
                     torch.ones(n, dtype=torch.float32), [0.0, 1.0],
                     tol=1e-12, maxiter=n)
    assert bool(torch.isfinite(r.X).all())
    assert float(r.resnorms.max()) < 1e-2
    assert int(r.status[0]) == F.MAXITER


def test_restarted_shifted_gmres_converges_where_single_cycle_cannot():
    Am, b = _nonsym(n=300, seed=3)
    shifts = np.array([0.0, 0.5, 2.0, 10.0])
    one = F.shifted_gmres(torch.tensor(Am), torch.tensor(b), shifts,
                          maxiter=25, tol=1e-8)
    assert not bool(one.converged.all())
    kw = dict(maxiter=25, max_restarts=12, tol=1e-8)
    r = F.restarted_shifted_gmres(torch.tensor(Am), torch.tensor(b), shifts,
                                  **kw)
    _same(r, JF.restarted_shifted_gmres(jnp.asarray(Am), jnp.asarray(b),
                                        jnp.asarray(shifts), **kw))
    assert bool(r.converged.all()), r.resnorms
    for i, s in enumerate(shifts):
        x = r.X[i].numpy()
        rel = np.linalg.norm(b - (Am @ x + s * x)) / np.linalg.norm(b)
        assert rel <= 1.1e-8
        assert abs(rel - float(r.resnorms[i])) <= 1e-10


def test_restarted_shifted_gmres_matches_per_shift_restarted_gmres():
    Am, b = _nonsym(n=200, seed=4)
    shifts = np.array([0.1, 1.0, 5.0])
    kw = dict(maxiter=20, max_restarts=15, tol=1e-9)
    r = F.restarted_shifted_gmres(torch.tensor(Am), torch.tensor(b), shifts,
                                  **kw)
    _same(r, JF.restarted_shifted_gmres(jnp.asarray(Am), jnp.asarray(b),
                                        jnp.asarray(shifts), **kw))
    assert bool(r.converged.all())
    for i, s in enumerate(shifts):
        ref = F.restarted_gmres(torch.tensor(Am + s * np.eye(200)),
                                torch.tensor(b), maxiter=20,
                                max_restarts=25, tol=1e-9)
        assert np.allclose(r.X[i].numpy(), ref.x.numpy(), rtol=1e-6,
                           atol=1e-8)


def test_restarted_shifted_gmres_complex_shifts_and_seed():
    Am, b = _nonsym(n=150, seed=5)
    shifts = np.array([0.5 + 0.3j, 2.0 - 1.0j, 4.0])
    kw = dict(maxiter=20, max_restarts=15, tol=1e-8, seed=1)
    r = F.restarted_shifted_gmres(torch.tensor(Am), torch.tensor(b), shifts,
                                  **kw)
    _same(r, JF.restarted_shifted_gmres(jnp.asarray(Am), jnp.asarray(b),
                                        jnp.asarray(shifts), **kw))
    assert bool(r.converged.all()), r.resnorms
    for i, s in enumerate(shifts):
        x = r.X[i].numpy()
        rel = np.linalg.norm(b - (Am @ x + s * x)) / np.linalg.norm(b)
        assert rel <= 1.1e-8
    with pytest.raises(ValueError, match="seed"):
        F.restarted_shifted_gmres(torch.tensor(Am), torch.tensor(b), shifts,
                                  seed=7)


def test_restarted_shifted_gmres_happy_breakdown():
    A = np.diag(np.arange(1.0, 9.0))
    b = np.zeros(8)
    b[2] = 1.0
    kw = dict(maxiter=6, max_restarts=5, tol=1e-10)
    r = F.restarted_shifted_gmres(torch.tensor(A), torch.tensor(b),
                                  [0.0, 1.0], **kw)
    _same(r, JF.restarted_shifted_gmres(jnp.asarray(A), jnp.asarray(b),
                                        jnp.asarray([0.0, 1.0]), **kw))
    assert bool(r.converged.all())
    np.testing.assert_allclose(r.X[0].numpy(), b / 3.0, atol=1e-12)
    np.testing.assert_allclose(r.X[1].numpy(), b / 4.0, atol=1e-12)


def test_restarted_shifted_gmres_easy_seed_hard_family():
    rng = np.random.default_rng(0)
    n = 300
    d = np.linspace(1.0, 50.0, n)
    S = rng.standard_normal((n, n)) * 0.3 / np.sqrt(n)
    A = np.diag(d) + S - S.T
    b = rng.standard_normal(n)
    kw = dict(maxiter=25, max_restarts=40, tol=1e-8)
    r = F.restarted_shifted_gmres(torch.tensor(A), torch.tensor(b),
                                  [1000.0, 0.0], **kw)
    _same(r, JF.restarted_shifted_gmres(jnp.asarray(A), jnp.asarray(b),
                                        jnp.asarray([1000.0, 0.0]), **kw))
    assert bool(r.converged.all()), r.resnorms
    for i, sg in enumerate([1000.0, 0.0]):
        x = r.X[i].numpy()
        rel = np.linalg.norm(b - (A @ x + sg * x)) / np.linalg.norm(b)
        assert rel <= 1.1e-8


def test_seed_cycle_cache_keeps_one_entry_per_operator():
    """A sequence of calls on one operator reuses its cycle functions (the
    JAX package's compiled-cycle cache, keyed alike)."""
    from krypy_tpu_torch.functional import shifted

    Am, b = _nonsym(n=60, seed=6)
    A = torch.tensor(Am)
    shifted._SEED_CYCLE_CACHE.clear()
    for _ in range(2):
        F.restarted_shifted_gmres(A, torch.tensor(b), [0.0, 1.0],
                                  maxiter=10, max_restarts=3, tol=1e-8)
    assert len(shifted._SEED_CYCLE_CACHE) == 1
    (cycle, _, _), = shifted._SEED_CYCLE_CACHE.values()
    assert cycle._keepalive == (A,)


def test_public_names_and_signatures_match_jax():
    import importlib
    import inspect

    for mod in ("arnoldi", "shifted", "lsq"):
        jmod = importlib.import_module(f"krypy_tpu.functional.{mod}")
        tmod = importlib.import_module(f"krypy_tpu_torch.functional.{mod}")
        assert jmod.__all__ == tmod.__all__
        for name in jmod.__all__:
            jo, to = getattr(jmod, name), getattr(tmod, name)
            if hasattr(jo, "_fields"):
                assert jo._fields == to._fields
            else:
                js = inspect.signature(jo).parameters
                ts = inspect.signature(to).parameters
                assert list(js) == list(ts), name
                assert all(js[p].default == ts[p].default for p in js), name


# ---------------------------------------------------------------------------
# the card phase's problems at 31^2 (K1's plain version)
# ---------------------------------------------------------------------------


def test_poisson_shifted_cg_through_k1_matches_jax():
    """The shifted phase's multi-shift CG: Poisson through K1 (``impl=
    "cuda"``), 8 shifts >= 0, classic and 1r, float64 against the JAX
    package's stencil, each member's true residual recomputed."""
    nx = 31
    A = ops.poisson_2d(nx, impl="cuda", device="cpu")
    b = np.random.default_rng(31).standard_normal(nx * nx)
    shifts = np.linspace(0.0, 7e3, 8)
    for variant in ("classic", "1r"):
        kw = dict(tol=1e-10, maxiter=2000, variant=variant)
        r = F.shifted_cg(A, torch.tensor(b), shifts, **kw)
        _same(r, _jax("shifted_cg", jops.poisson_2d(nx), jnp.asarray(b),
                               jnp.asarray(shifts), **kw))
        for i, s in enumerate(shifts):
            x = r.X[i]
            rel = float(torch.linalg.vector_norm(
                torch.tensor(b) - A(x) - s * x) / np.linalg.norm(b))
            assert rel <= 1e-10


def test_northstar_shifted_gmres_through_k1_matches_jax():
    """The shifted phase's ``shifted_gmres`` and ``restarted_shifted_gmres``
    on the north star's h^2-scaled operator through K1 with real shifts,
    float64, against the JAX package on its padded stencil."""
    nx = 31
    h2 = 1.0 / (nx + 1) ** 2
    A = ops.convection_diffusion_2d(nx, wind=(h2, 0.5 * h2), eps=h2,
                                    impl="cuda", pad_cols=True, device="cpu")
    jA = jops.convection_diffusion_2d(nx, wind=(h2, 0.5 * h2), eps=h2,
                                      impl="jnp", pad_cols=True)
    b = ops.pad_grid_vec(torch.tensor(
        np.random.default_rng(32).standard_normal(nx * nx)), nx, nx)
    shifts = np.array([0.0, 0.01, 0.1, 1.0])
    kw = dict(maxiter=60, tol=1e-8)
    r = F.shifted_gmres(A, b, shifts, **kw)
    _same(r, _jax("shifted_gmres", jA, jnp.asarray(b.numpy()),
                              jnp.asarray(shifts), **kw))
    kw = dict(maxiter=30, max_restarts=20, tol=1e-8)
    r = F.restarted_shifted_gmres(A, b, shifts, **kw)
    _same(r, JF.restarted_shifted_gmres(jA, jnp.asarray(b.numpy()),
                                        jnp.asarray(shifts), **kw))
    assert bool(r.converged.all())
    assert northstar.cd_coeffs(nx)[0] == pytest.approx(
        4.0 + 1.5 / (nx + 1))


def test_functional_exports_the_slice_names_as_jax():
    """The slice's 14 names are in ``krypy_tpu_torch.functional.__all__``
    as in the JAX package's, read by ``ast`` from both ``__init__``s; since
    the s-step lane was ported the port lacks none of the JAX package's
    names."""
    import ast
    import pathlib

    def exported(pkg):
        path = pathlib.Path(__file__).resolve().parents[1] / pkg / \
            "functional" / "__init__.py"
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and \
                    node.targets[0].id == "__all__":
                return set(ast.literal_eval(node.value))

    jax_names, port_names = exported("krypy_tpu"), exported(
        "krypy_tpu_torch")
    slice_names = {"ArnoldiResult", "arnoldi", "RsvdResult", "rsvd",
                   "hutchpp", "nystrom_preconditioner", "lsqr", "lsmr",
                   "SvdsResult", "svds", "ShiftedResult", "shifted_cg",
                   "shifted_gmres", "restarted_shifted_gmres"}
    assert slice_names <= jax_names and slice_names <= port_names
    assert jax_names - port_names == set()
    for name in slice_names:
        assert getattr(F, name) is not None
