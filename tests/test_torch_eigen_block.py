"""The port's block eigensolvers, ``lobpcg`` (classic and fused) and the
filtered window lane (``eigsh_window``, ``window_count``, ``kpm_dos``,
``estimate_spectrum_bounds``, ``jackson_cheby_coeffs``), against
krypy_tpu.functional's on the same numpy inputs, float64 on both sides
(float32 where the JAX test's case is float32).

Every case of tests/test_lobpcg.py and tests/test_filtered.py has its
counterpart here (the sharded ones in tests/test_torch_parallel.py's gloo
worlds), held by tests/torch_eigen_cases.py's rule: status and counts
equal, eigenvalues to ``1e-10`` relative (or the JAX test's looser
tolerance), the wanted subspaces to a principal angle of ``1e-8``, pair
residuals to ``1e-6`` relative above the solve's ``tol``, or the JAX
package's own spread under one ulp of the start block.

The probes of ``window_count`` and ``kpm_dos``: the JAX package draws
them with ``jax.random``, the port with a ``torch.Generator``.  The
parity cases carry the JAX probes into the port through a monkeypatched
``filtered._rademacher_rows`` (estimates to ``1e-10`` relative); the
port's own draw is held to the JAX tests' own tolerances against the
true count and the semicircle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_eigen_cases as ec
from krypy_tpu import functional as JF
from krypy_tpu.functional import filtered as jfil
from krypy_tpu_torch import functional as F
from krypy_tpu_torch.functional import filtered as tfil

torch.set_num_threads(1)


def _random_hermitian(n, seed=0, scale=10.0, complex_=False):
    """tests/test_filtered.py's dense oracle."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n))
                        + (1j * rng.standard_normal((n, n)) if complex_
                           else 0))
    ew = np.sort(rng.standard_normal(n)) * scale
    Am = (Q * ew) @ Q.conj().T
    return (Am + Am.conj().T) / 2, ew


@pytest.fixture
def jax_probes(monkeypatch):
    """The port's probes are the JAX package's Rademacher rows (the JAX
    PRNG key passes through the port's ``key`` position)."""
    def rows(A, key, n_probes, N, dtype=None, device=None):
        Z = jfil._rademacher_rows(None, key, n_probes, N)
        return torch.tensor(np.asarray(Z), device=device)

    monkeypatch.setattr(tfil, "_rademacher_rows", rows)


# ---------------------------------------------------------------------------
# tests/test_lobpcg.py's cases
# ---------------------------------------------------------------------------


D400 = np.linspace(1.0, 500.0, 400)


@pytest.mark.parametrize("which,k", [("sa", 5), ("la", 3)])
def test_lobpcg_diagonal(which, k):
    """The smallest case from each package's own default block."""
    kw = dict(k=k, which=which, tol=1e-9)
    if which == "la":
        kw["X0"] = ec.start_block(400, k)
    want = ec.hold("lobpcg", ec.diag(D400), rtol=1e-8, start="X0",
                   default=ec.start_block(400, k), **kw)
    assert want["status"] == 0


@pytest.mark.parametrize("variant", ["classic", "fused"])
def test_lobpcg_dense_matches_jax(variant):
    rng = np.random.default_rng(0)
    Br = rng.standard_normal((120, 120))
    Am = (Br + Br.T) / 2
    want = ec.hold("lobpcg", Am, k=4, which="sa", tol=1e-10,
                   variant=variant, X0=ec.start_block(120, 4), start="X0")
    assert want["status"] == 0
    np.testing.assert_allclose(want["theta"], np.linalg.eigvalsh(Am)[:4],
                               atol=1e-8)


def test_lobpcg_fused_matches_classic_on_jax_oracle():
    """tests/test_collectives_surface.py's fused parity problem, both
    variants held to the JAX package's."""
    rng = np.random.RandomState(5)
    A = np.diag(np.linspace(0.1, 30, 120))
    S = 0.02 * rng.randn(120, 120)
    A = A + S + S.T
    for variant in ("classic", "fused"):
        want = ec.hold("lobpcg", A, 4, n=120, tol=1e-9, maxiter=300,
                       variant=variant, X0=ec.start_block(120, 4),
                       start="X0")
        assert want["status"] == 0


def test_lobpcg_complex_hermitian():
    rng = np.random.default_rng(1)
    n = 100
    Br = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Am = (Br + Br.conj().T) / 2
    X0 = rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3))
    want = ec.hold("lobpcg", Am, X0=X0, which="la", tol=1e-9, rtol=1e-9,
                   start="X0")
    assert want["status"] == 0


def test_lobpcg_complex_matrix_default_start():
    """A complex matrix and no X0: the block takes the operator's complex
    dtype in both packages."""
    rng = np.random.default_rng(5)
    n = 60
    Br = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    Am = (Br + Br.conj().T) / 2
    r = F.lobpcg(torch.tensor(Am), k=3, which="sa", tol=1e-9)
    assert r.U.dtype == torch.complex128
    ec.hold("lobpcg", Am, k=3, which="sa", tol=1e-9, rtol=1e-9, start="X0",
            X0=ec.start_block(n, 3).astype(complex))


def test_lobpcg_generalized_pencil():
    rng = np.random.default_rng(2)
    n = 90
    Q = rng.standard_normal((n, n))
    Am = (Q + Q.T) / 2
    C = rng.standard_normal((n, n)) / np.sqrt(n)
    Bm = C @ C.T + np.eye(n)
    want = ec.hold("lobpcg", Am, k=3, B=Bm, tol=1e-10, start="X0",
                   X0=ec.start_block(n, 3))
    assert want["status"] == 0


def test_lobpcg_degenerate_cluster():
    nx = 24
    want = ec.hold("lobpcg", ec.lap2d(nx), k=4, n=nx * nx, which="sa",
                   tol=1e-8, maxiter=300, rtol=1e-7, start="X0",
                   X0=ec.start_block(nx * nx, 4))
    assert want["status"] == 0


def test_lobpcg_preconditioner_accelerates():
    d = np.geomspace(1.0, 1e6, 300)
    X0 = ec.start_block(300, 2)
    plain = ec.hold("lobpcg", ec.diag(d), k=2, which="sa", tol=1e-6,
                    maxiter=400, X0=X0, start="X0", rtol=1e-8,
                    subspace=False)
    prec = ec.hold("lobpcg", ec.diag(d), k=2, which="sa", tol=1e-6,
                   maxiter=400, M=ec.diag(1.0 / d), X0=X0, start="X0",
                   rtol=1e-8)
    assert prec["status"] == 0 and prec["niter"] <= 60
    assert prec["niter"] < plain["niter"] or plain["status"] != 0


def test_lobpcg_maxiter_honest():
    rng = np.random.default_rng(3)
    Br = rng.standard_normal((80, 80))
    Am = (Br + Br.T) / 2
    kw = dict(k=3, tol=1e-14, maxiter=2)
    want = ec.run("lobpcg", "jax", Am, **kw, X0=ec.start_block(80, 3))
    got = ec.run("lobpcg", "torch", Am, **kw, X0=ec.start_block(80, 3))
    assert got["status"] == want["status"] == 1
    assert got["niter"] == want["niter"] == 2
    np.testing.assert_array_equal(np.isnan(got["resnorms"]),
                                  np.isnan(want["resnorms"]))
    live = ~np.isnan(want["resnorms"])
    np.testing.assert_allclose(got["resnorms"][live],
                               want["resnorms"][live], rtol=1e-8)
    np.testing.assert_allclose(got["theta"], want["theta"], rtol=1e-10)


def test_lobpcg_x0_and_locking():
    d = np.linspace(1.0, 50.0, 200)
    X0 = np.zeros((200, 3))
    X0[0, 0] = 1.0
    X0[1, 1] = 1.0
    X0[:, 2] = np.cos(np.arange(200) * 0.31) + 0.01
    want = ec.hold("lobpcg", ec.diag(d), X0=X0, which="sa", tol=1e-9,
                   rtol=1e-9, start="X0")
    assert want["status"] == 0


def test_lobpcg_validation_errors():
    A = torch.eye(30, dtype=torch.float64)
    for match, args, kw in (
            ("3k <= N", (A,), dict(k=11)),
            ("which", (A,), dict(k=2, which="sm")),
            ("X0", (A,), dict(X0=torch.ones(30, dtype=torch.float64))),
            ("n= or X0=", (lambda v: v,), dict(k=2)),
            ("criterion", (A,), dict(k=2, criterion="abs")),
            ("unknown lobpcg variant", (A,), dict(k=2, variant="x")),
            ("standard problems only", (A,), dict(k=2, B=A,
                                                  variant="fused"))):
        with pytest.raises(ValueError, match=match):
            F.lobpcg(*args, **kw)


def test_lobpcg_backward_criterion_f32():
    """float32 on both sides: the backward criterion certifies, the
    relative one reports MAXITER."""
    d = np.concatenate([[1.0, 2.0, 3.0],
                        np.geomspace(10.0, 1e4, 509)]).astype(np.float32)
    X0 = ec.start_block(512, 3).astype(np.float32)
    for kw, status in ((dict(tol=2e-6, criterion="backward", maxiter=200), 0),
                       (dict(tol=2e-6, maxiter=60), 1)):
        want = ec.run("lobpcg", "jax", ec.diag(d), X0=X0, which="sa",
                      M=ec.diag(1.0 / d), **kw)
        got = ec.run("lobpcg", "torch", ec.diag(d), X0=X0, which="sa",
                     M=ec.diag(1.0 / d), **kw)
        assert got["theta"].dtype == np.float32
        assert got["status"] == want["status"] == status
        if status == 0:
            # the JAX test's tolerance (float32 rounding steers the
            # iterates)
            np.testing.assert_allclose(got["theta"], want["theta"],
                                       rtol=1e-3)
            assert got["pair"].max() <= 2e-6
            assert abs(got["niter"] - want["niter"]) <= 2
        else:
            # below the float32 floor: both run out their budget
            assert got["niter"] == want["niter"] == 60


def test_lobpcg_auto_is_classic_off_a_mesh():
    """``variant="auto"`` without a mesh runs the classic advance (the
    mesh pick is tests/test_torch_parallel.py's)."""
    d = np.linspace(1.0, 50.0, 90)
    kw = dict(k=3, tol=1e-9, X0=torch.tensor(ec.start_block(90, 3)))
    ra = F.lobpcg(ec.diag(d)["torch"], variant="auto", **kw)
    rc = F.lobpcg(ec.diag(d)["torch"], variant="classic", **kw)
    assert torch.equal(ra.theta, rc.theta) and int(ra.niter) == int(
        rc.niter)


def test_lobpcg_agrees_with_eigsh():
    nx = 20
    rl = ec.hold("lobpcg", ec.lap2d(nx), k=3, n=nx * nx, which="sa",
                 tol=1e-9, maxiter=300, X0=ec.start_block(nx * nx, 3),
                 start="X0", rtol=1e-8, subspace=False)
    re = F.eigsh(ec.lap2d(nx)["torch"], k=3, n=nx * nx, which="sa",
                 tol=1e-9, block_size=2)
    assert rl["status"] == 0 and re.converged
    np.testing.assert_allclose(rl["theta"], re.theta.numpy(), rtol=1e-8)


# ---------------------------------------------------------------------------
# tests/test_filtered.py's cases
# ---------------------------------------------------------------------------


def _window(Am, window, **kw):
    """eigsh_window in both packages from the same start block."""
    p = kw.pop("block")
    return ec.hold("eigsh_window", Am, window, start="X0",
                   X0=ec.start_block(Am.shape[0], p), **kw)


def test_window_dense_oracle():
    Am, ew = _random_hermitian(300, seed=0)
    want = _window(Am, (float(ew[140]) - 1e-6, float(ew[149]) + 1e-6),
                   block=16, tol=1e-9)
    assert want["status"] == 0 and want["n_inside"] == 10


def test_window_dense_default_block_and_bounds():
    """The same window from each package's own default block, bounds
    estimated by each package."""
    Am, ew = _random_hermitian(300, seed=0)
    window = (float(ew[140]) - 1e-6, float(ew[149]) + 1e-6)
    r = F.eigsh_window(torch.tensor(Am), window, block=16, tol=1e-9)
    j = jfil.eigsh_window(jnp.asarray(Am), window, block=16, tol=1e-9)
    np.testing.assert_allclose(r.bounds, j.bounds, rtol=1e-10)
    assert r.degree == j.degree and int(r.niter) == int(j.niter)
    np.testing.assert_allclose(r.theta.numpy()[:10], np.asarray(j.theta)[:10],
                               rtol=1e-10)


def test_window_laplacian_analytic():
    """A callable with ``n=`` (the port's with a ``device``)."""
    n = 400

    def jmv(v):
        lower = jnp.concatenate([v[1:], jnp.zeros(1, v.dtype)])
        upper = jnp.concatenate([jnp.zeros(1, v.dtype), v[:-1]])
        return 2.0 * v - lower - upper

    def tmv(v):
        z = torch.zeros(1, dtype=v.dtype)
        return 2.0 * v - torch.cat([v[1:], z]) - torch.cat([z, v[:-1]])

    tmv.device = "cpu"
    ew = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    lo, hi = float(ew[199]) - 1e-9, float(ew[204]) + 1e-9
    want = ec.hold("eigsh_window", {"jax": jmv, "torch": tmv}, (lo, hi),
                   n=n, tol=1e-9, degree=600, maxiter=200, start="X0",
                   X0=ec.start_block(n, 16), rtol=1e-9)
    assert want["status"] == 0 and want["n_inside"] == 6


def test_window_complex_hermitian():
    Am, ew = _random_hermitian(150, seed=3, complex_=True)
    want = ec.hold("eigsh_window", Am, (float(ew[70]) - 1e-6,
                                        float(ew[75]) + 1e-6),
                   block=10, tol=1e-9, start="X0",
                   X0=ec.start_block(150, 10).astype(complex))
    assert want["status"] == 0 and want["n_inside"] == 6


def test_window_saturated_block():
    Am, ew = _random_hermitian(200, seed=1)
    want = _window(Am, (float(ew[80]) - 1e-6, float(ew[99]) + 1e-6),
                   block=8, tol=1e-7, maxiter=60, subspace=False)
    assert want["saturated"]


def test_window_empty_is_honest():
    d = np.concatenate([np.linspace(0, 1, 50), np.linspace(9, 10, 50)])
    want = _window(np.diag(d), (4.0, 6.0), block=6, maxiter=8)
    assert want["n_inside"] == 0 and want["status"] == 1


def test_window_cross_check_shift_invert():
    Am, ew = _random_hermitian(200, seed=5)
    sigma = float((ew[99] + ew[100]) / 2)
    rw = _window(Am, (float(ew[97]) - 1e-6, float(ew[102]) + 1e-6),
                 block=10, tol=1e-9)
    Sinv = np.linalg.inv(Am - sigma * np.eye(200))
    sj, st = jnp.asarray(Sinv), torch.tensor(Sinv)
    rs = ec.hold("eigsh", Am, k=6, sigma=sigma, tol=1e-9, v0=ec.start(200),
                 inv={"jax": lambda v: sj @ v, "torch": lambda v: st @ v})
    assert rw["status"] == 0 and rs["status"] == 0 and rw["n_inside"] == 6
    np.testing.assert_allclose(np.sort(rw["theta"][:6]), np.sort(rs["theta"]),
                               atol=1e-7 * np.abs(ew).max())


def test_window_user_bounds_and_degree():
    Am, ew = _random_hermitian(150, seed=7)
    want = _window(Am, (float(ew[70]) - 1e-6, float(ew[74]) + 1e-6),
                   block=9, tol=1e-8, degree=250,
                   bounds=(float(ew[0]) - 1.0, float(ew[-1]) + 1.0))
    assert want["status"] == 0 and want["n_inside"] == 5


def test_window_f32_backward():
    Am, ew = _random_hermitian(200, seed=11)
    Am32 = Am.astype(np.float32)
    window = (float(ew[95]) - 1e-5, float(ew[100]) + 1e-5)
    # the float64 default block promotes the float32 matrix in both
    # packages
    want = _window(Am32, window, block=10, tol=2e-5, criterion="backward")
    assert want["theta"].dtype == np.float64
    assert want["status"] == 0 and want["n_inside"] == 6


def test_estimate_spectrum_bounds_matches_jax():
    Am, ew = _random_hermitian(250, seed=2)
    got = F.estimate_spectrum_bounds(torch.tensor(Am))
    want = jfil.estimate_spectrum_bounds(jnp.asarray(Am))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert got[0] <= ew[0] and got[1] >= ew[-1]
    v0 = ec.start(250)
    np.testing.assert_allclose(
        F.estimate_spectrum_bounds(torch.tensor(Am), v0=v0, m=16,
                                   safety=0.05),
        jfil.estimate_spectrum_bounds(jnp.asarray(Am), v0=v0, m=16,
                                      safety=0.05), rtol=1e-10)


@pytest.mark.parametrize("args", [(-0.2, 0.2, -1.0, 1.0, 120),
                                  (3.0, 7.5, 0.0, 50.0, 37),
                                  (-5.0, 0.5, -1.0, 1.0, 2)])
def test_jackson_coeffs_match_jax(args):
    got = F.jackson_cheby_coeffs(*args)
    want = jfil.jackson_cheby_coeffs(*args)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_jackson_coeffs_filter_shape():
    co, c, e = F.jackson_cheby_coeffs(-0.2, 0.2, -1.0, 1.0, 120)
    t = np.linspace(-1, 1, 2001)
    x = (t - c) / e
    T0, T1 = np.ones_like(x), x
    y = co[0] * T0 + co[1] * T1
    for j in range(2, len(co)):
        T0, T1 = T1, 2 * x * T1 - T0
        y += co[j] * T1
    assert y[np.abs(t) <= 0.15].min() > 0.5
    assert np.abs(y[np.abs(t) >= 0.4]).max() < 0.02
    assert y.min() > -0.01


def test_window_count_dense_matches_jax(jax_probes):
    Am, ew = _random_hermitian(400, seed=6)
    lo, hi = float((ew[149] + ew[150]) / 2), float((ew[219] + ew[220]) / 2)
    key = jax.random.PRNGKey(0)
    got = F.window_count(torch.tensor(Am), (lo, hi), key, n_probes=24,
                         degree=400)
    want = jfil.window_count(jnp.asarray(Am), (lo, hi), key, n_probes=24,
                             degree=400)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert abs(got[0] - 70) <= max(4 * got[1], 0.12 * 70)


def test_window_count_own_probes():
    """The port's own Rademacher draw (a seed, and a torch.Generator) to
    the JAX test's tolerance of the true count."""
    Am, ew = _random_hermitian(400, seed=6)
    lo, hi = float((ew[149] + ew[150]) / 2), float((ew[219] + ew[220]) / 2)
    for key in (0, torch.Generator().manual_seed(3)):
        cnt, se = F.window_count(torch.tensor(Am), (lo, hi), key,
                                 n_probes=24, degree=400)
        assert abs(cnt - 70) <= max(4 * se, 0.12 * 70), (cnt, se)
    a = F.window_count(torch.tensor(Am), (lo, hi), 5, n_probes=8, degree=50)
    assert a == F.window_count(torch.tensor(Am), (lo, hi), 5, n_probes=8,
                               degree=50)


def test_window_count_sizes_the_block(jax_probes):
    Am, ew = _random_hermitian(250, seed=8)
    lo, hi = float((ew[119] + ew[120]) / 2), float((ew[127] + ew[128]) / 2)
    key = jax.random.PRNGKey(1)
    cnt, se = F.window_count(torch.tensor(Am), (lo, hi), key, n_probes=24)
    np.testing.assert_allclose(
        (cnt, se), jfil.window_count(jnp.asarray(Am), (lo, hi), key,
                                     n_probes=24), rtol=1e-10)
    want = _window(Am, (lo, hi), block=int(np.ceil(1.3 * cnt)) + 4,
                   tol=1e-8)
    assert want["status"] == 0 and not want["saturated"]
    assert want["n_inside"] == 8


def test_kpm_dos_matches_jax(jax_probes):
    n = 600
    rng = np.random.default_rng(12)
    G = rng.standard_normal((n, n)) / np.sqrt(n)
    Am = (G + G.T) / np.sqrt(2)
    key = jax.random.PRNGKey(2)
    kw = dict(degree=200, n_probes=24, npoints=400)
    grid, dens = F.kpm_dos(torch.tensor(Am), key, **kw)
    jgrid, jdens = jfil.kpm_dos(jnp.asarray(Am), key, **kw)
    np.testing.assert_allclose(grid, np.asarray(jgrid), rtol=1e-10)
    np.testing.assert_allclose(dens, np.asarray(jdens), rtol=1e-9,
                               atol=1e-9 * np.abs(jdens).max())


def test_kpm_dos_own_probes_semicircle():
    """The port's own draw: integrates to N and matches the semicircle at
    mid-spectrum, as the JAX test demands."""
    n = 600
    rng = np.random.default_rng(12)
    G = rng.standard_normal((n, n)) / np.sqrt(n)
    Am = (G + G.T) / np.sqrt(2)
    grid, dens = F.kpm_dos(torch.tensor(Am), 2, degree=200, n_probes=24,
                           npoints=400)
    assert abs(np.trapezoid(dens, grid) - n) <= 0.05 * n
    mid = np.abs(grid) < 0.1
    np.testing.assert_allclose(dens[mid].mean(), 2.0 * n / (np.pi * 2.0),
                               rtol=0.1)


def test_window_validation():
    Am, _ = _random_hermitian(50, seed=0)
    A = torch.tensor(Am)
    for match, args, kw in (
            ("lo < hi", (A, (1.0, 1.0)), dict(block=4)),
            ("block", (A, (0.0, 1.0)), dict(block=0)),
            ("outside the spectrum", (A, (1e6, 2e6)), dict(block=4)),
            ("block=, k= or X0=", (A, (0.0, 1.0)), {}),
            ("n= or X0=", (lambda v: v, (0.0, 1.0)), dict(block=4)),
            ("criterion", (A, (0.0, 1.0)), dict(block=4, criterion="x"))):
        with pytest.raises(ValueError, match=match):
            F.eigsh_window(*args, **kw)


def test_window_x0_and_k_defaults():
    Am, ew = _random_hermitian(120, seed=4)
    lo, hi = float(ew[55]) - 1e-6, float(ew[58]) + 1e-6
    X0 = np.random.default_rng(0).standard_normal((120, 8))
    want = ec.hold("eigsh_window", Am, (lo, hi), X0=X0, tol=1e-8,
                   start="X0")
    assert want["theta"].shape == (8,) and want["status"] == 0
    rk = ec.hold("eigsh_window", Am, (lo, hi), k=4, tol=1e-8)
    assert rk["theta"].shape == (8,) and rk["n_inside"] == 4


# ---------------------------------------------------------------------------
# the slice as a whole: the eigen phase's (b) and (d) on the CPU
# ---------------------------------------------------------------------------


def test_lobpcg_vcycle_pipeline_matches_jax():
    """(b) of the eigen phase at 63^2: LOBPCG preconditioned by the padded
    float32 V-cycle (:func:`krypy_tpu_torch.eigen.poisson_vcycle`, K1-K3's
    plain versions) against the closed form and the JAX package's LOBPCG
    with an exact inverse for ``M``; each V-cycle application counted."""
    from krypy_tpu import ops as jops
    from krypy_tpu_torch import eigen, ops

    nx = 63
    A = ops.poisson_2d(nx, device="cpu")
    M, counts = eigen.poisson_vcycle(nx, "cuda", "cpu")
    r = F.lobpcg(A, 6, M=M, tol=1e-7)
    assert r.converged and counts["M"] == 6 * int(r.niter)
    want = [v for v, _, _ in eigen.poisson_eigenvalues(nx, 6)]
    np.testing.assert_allclose(r.theta.numpy(), want, rtol=1e-10)
    # the exact inverse of the 5-point Laplacian, Kronecker-assembled
    T = (2 * np.eye(nx) - np.eye(nx, k=1) - np.eye(nx, k=-1)) * (nx + 1) ** 2
    D = np.kron(T, np.eye(nx)) + np.kron(np.eye(nx), T)
    Dinv = jnp.asarray(np.linalg.inv(D))
    j = JF.lobpcg(jops.poisson_2d(nx), 6, n=nx * nx, M=lambda v: Dinv @ v,
                  tol=1e-7)
    assert int(j.status) == 0
    np.testing.assert_allclose(r.theta.numpy(), np.asarray(j.theta),
                               rtol=1e-10)


def test_poisson_window_pipeline_matches_jax(jax_probes):
    """(d) of the eigen phase at 63^2: eigsh_window on the window holding
    lambda_22 and the pair lambda_13 = lambda_31, with the outer bounds
    (0, 8/h^2), window_count and kpm_dos, each against the JAX package on
    the same operator (the JAX probes carried across) and the closed
    form."""
    from krypy_tpu import ops as jops
    from krypy_tpu_torch import eigen, ops

    nx = 63
    window, inside, bounds = eigen.poisson_window(nx)
    A = {"jax": jops.poisson_2d(nx), "torch": ops.poisson_2d(nx,
                                                             device="cpu")}
    want = ec.hold("eigsh_window", A, window, n=nx * nx, block=8,
                   degree=200, bounds=bounds, tol=1e-10, maxiter=40,
                   X0=ec.start_block(nx * nx, 8), start="X0")
    assert want["status"] == 0 and want["n_inside"] == 3
    np.testing.assert_allclose(np.sort(want["theta"][:3]), np.sort(inside),
                               rtol=1e-12)
    key = jax.random.PRNGKey(4)
    got = F.window_count(A["torch"], window, key, bounds=bounds, degree=200,
                         n_probes=24)
    np.testing.assert_allclose(got, jfil.window_count(
        A["jax"], window, key, bounds=bounds, degree=200, n_probes=24),
        rtol=1e-10)
    assert abs(got[0] - 3) <= max(4 * got[1], 0.12 * 3)
    grid, dens = F.kpm_dos(A["torch"], key, bounds=bounds)
    jgrid, jdens = jfil.kpm_dos(A["jax"], key, bounds=bounds)
    np.testing.assert_allclose(dens, np.asarray(jdens), rtol=1e-9,
                               atol=1e-9 * np.abs(jdens).max())
    assert abs(np.trapezoid(dens, grid) / (nx * nx) - 1) <= 0.05
