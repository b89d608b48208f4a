"""The port's ``eigsh`` (thick-restart and block Lanczos, shift-invert,
generalized pencils, ``ortho="cgs2_1r"``) and ``eigs`` (Krylov-Schur)
against krypy_tpu.functional's on the same numpy inputs, float64 on both
sides (float32 where the JAX test's case is float32).

Every case of tests/test_eigsh.py and tests/test_eigs.py has its
counterpart here (the sharded ones in tests/test_torch_parallel.py's gloo
worlds), held by tests/torch_eigen_cases.py's rule: status and counts
equal, eigenvalues to ``1e-10`` relative (or the JAX test's looser
tolerance), the wanted subspaces to a principal angle of ``1e-8``, pair
residuals to ``1e-6`` relative above the solve's ``tol``, or the JAX
package's own spread under one ulp of the start.  The default start is
held to numpy's ``cos`` separately
(:func:`test_default_start_is_the_jax_start`) and runs in two cases.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from threadpoolctl import threadpool_limits

import torch_eigen_cases as ec
from krypy_tpu import functional as JF, ops as jops
from krypy_tpu.functional import eigh as jeigh
from krypy_tpu_torch import functional as F, ops
from krypy_tpu_torch.functional import eigh as teigh

torch.set_num_threads(1)


def _hold(fn, A, kw, **opts):
    return ec.hold(fn, A, **opts, **kw)


def _run(fn, pkg, A, kw):
    return ec.run(fn, pkg, A, **kw)


_diag, _start, _lap2d = ec.diag, ec.start, ec.lap2d

def _laplacian_low_spectrum(nx, count):
    h = 1.0 / (nx + 1)
    vals = sorted(
        4 / h ** 2 * (np.sin(np.pi * i * h / 2) ** 2
                      + np.sin(np.pi * j * h / 2) ** 2)
        for i in range(1, 8) for j in range(1, 8))
    return np.asarray(vals[:count])


# ---------------------------------------------------------------------------
# the port's surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["eigh", "eigs", "lobpcg", "filtered"])
def test_public_names_and_signatures_match_jax(name):
    """Each module's ``__all__`` equals the JAX module's, and every public
    function takes the JAX parameters in the same order with the same
    defaults (``key`` of window_count/kpm_dos takes a torch.Generator or
    a seed in the PRNG key's place)."""
    import importlib

    jm = importlib.import_module(f"krypy_tpu.functional.{name}")
    pm = importlib.import_module(f"krypy_tpu_torch.functional.{name}")
    assert sorted(pm.__all__) == sorted(jm.__all__)
    for sym in jm.__all__:
        assert sym in F.__all__ and sym in JF.__all__
        jo, po = getattr(jm, sym), getattr(pm, sym)
        if inspect.isclass(jo):
            assert jo._fields == po._fields, sym
            continue
        js, ps = inspect.signature(jo), inspect.signature(po)
        assert [(p.name, p.kind, p.default) for p in js.parameters.values()] \
            == [(p.name, p.kind, p.default) for p in ps.parameters.values()], \
            sym


def test_default_start_is_the_jax_start():
    """The deterministic start vector and block: numpy's ``cos`` to one
    ulp, on the operator's device."""
    N = 1000
    want = _start(N)
    got = teigh._cos_start(N, torch.device("cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=4e-16, atol=4e-16)
    blk = teigh._cos_block(N, 3, torch.device("cpu")).numpy()
    for i in range(3):
        np.testing.assert_allclose(
            blk[i], np.cos(np.arange(N) * (0.7391 + 0.1137 * i))
            + 0.01 * (i + 1), rtol=4e-16, atol=4e-16)


def test_default_start_needs_a_device():
    """A bare callable with no ``v0`` and no device: the start goes to
    the card, which the CPU has not."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        F.eigsh(lambda v: v, k=2, n=40)
    d = torch.arange(1.0, 41.0, dtype=torch.float64)
    op = lambda v: d * v  # noqa: E731
    op.device = "cpu"
    r = F.eigsh(op, k=2, n=40, tol=1e-10)
    assert r.U.device.type == "cpu" and r.converged


_NUMPY_ENTRIES = {
    "eigsh": lambda A: F.eigsh(A, 2),
    "eigs": lambda A: F.eigs(A, 2),
    "lobpcg": lambda A: F.lobpcg(A, 2),
    "eigsh_window": lambda A: F.eigsh_window(A, (1.5, 3.5), block=4),
    "window_count": lambda A: F.window_count(A, (1.5, 3.5), 0),
    "kpm_dos": lambda A: F.kpm_dos(A, 0),
    "estimate_spectrum_bounds": lambda A: F.estimate_spectrum_bounds(A),
}


@pytest.mark.parametrize("entry", sorted(_NUMPY_ENTRIES))
def test_numpy_matrix_starts_on_the_card(entry):
    """A numpy ``A`` (whose ``device`` is "cpu" under numpy 2) with no
    start: the start goes to the card, as a numpy right-hand side does,
    which the CPU has not."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    A = np.diag(np.arange(1.0, 41.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        _NUMPY_ENTRIES[entry](A)


def test_numpy_matrix_start_device_is_the_default_card(monkeypatch):
    """``_start_device`` of a numpy matrix is the current CUDA device, and
    of a tensor or an operator with a ``device`` its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    A = np.eye(4)
    assert teigh._start_device(A) == torch.device("cuda", 0)
    assert teigh._start_device(torch.as_tensor(A)) == torch.device("cpu")
    op = lambda v: v  # noqa: E731
    op.device = "cpu"
    assert teigh._start_device(op) == torch.device("cpu")
    assert teigh._start_device(A, torch.zeros(4)) == torch.device("cpu")


# ---------------------------------------------------------------------------
# tests/test_eigsh.py's cases
# ---------------------------------------------------------------------------


D400 = np.linspace(1.0, 500.0, 400)


@pytest.mark.parametrize("which,k", [("sa", 5), ("la", 3)])
def test_eigsh_diagonal(which, k):
    """The smallest case from each package's own default start."""
    kw = dict(k=k, which=which, tol=1e-9)
    if which == "la":
        kw["v0"] = _start(400)
    want = _hold("eigsh", _diag(D400), kw, rtol=1e-9)
    assert want["status"] == 0


@pytest.mark.parametrize("ortho", ["cgs2", "cgs2_1r"])
def test_eigsh_dense_matches_jax(ortho):
    rng = np.random.default_rng(0)
    B = rng.standard_normal((120, 120))
    Am = (B + B.T) / 2
    want = _hold("eigsh", Am, dict(k=4, which="sa", tol=1e-10,
                                   v0=_start(120), ortho=ortho))
    assert want["status"] == 0
    np.testing.assert_allclose(want["theta"], np.linalg.eigvalsh(Am)[:4],
                               atol=1e-8)


def test_eigsh_complex_matrix_default_start():
    """A complex matrix and no v0: the start takes the operator's complex
    dtype in both packages."""
    rng = np.random.default_rng(9)
    B = rng.standard_normal((70, 70)) + 1j * rng.standard_normal((70, 70))
    Am = (B + B.conj().T) / 2
    r = F.eigsh(torch.tensor(Am), k=3, which="sa", tol=1e-9)
    assert r.U.dtype == torch.complex128
    _hold("eigsh", Am, dict(k=3, which="sa", tol=1e-9,
                            v0=_start(70).astype(complex)), rtol=1e-9)


def test_eigsh_complex_hermitian():
    rng = np.random.default_rng(1)
    B = rng.standard_normal((100, 100)) + 1j * rng.standard_normal((100, 100))
    Am = (B + B.conj().T) / 2
    v0 = rng.standard_normal(100) + 1j * rng.standard_normal(100)
    want = _hold("eigsh", Am, dict(k=3, which="la", v0=v0, tol=1e-10))
    assert want["status"] == 0


def test_eigsh_clustered_eigenvalues():
    d = np.r_[1.0, 1.0 + 1e-6, 1.0 + 2e-6, np.linspace(5, 100, 200)]
    _hold("eigsh", _diag(d), dict(k=3, which="sa", tol=1e-10, maxdim=30,
                                  v0=_start(d.size)), rtol=1e-9)


def test_eigsh_feeds_deflation():
    """The port's ``U`` drops straight into the port's deflated_gmres."""
    d = np.r_[1e-3, 5e-3, np.linspace(1, 10, 200)]
    _hold("eigsh", _diag(d), dict(k=2, which="sa", tol=1e-10,
                                  v0=_start(d.size)))
    A = ops.diagonal(torch.tensor(d))
    b = torch.ones(d.size, dtype=torch.float64)
    r = F.eigsh(A, k=2, which="sa", tol=1e-10, v0=torch.tensor(_start(
        d.size)))
    plain = F.gmres(A, b, tol=1e-8, maxiter=150)
    defl = F.deflated_gmres(A, b, r.U, tol=1e-8, maxiter=150)
    assert int(defl.status) == 0 and int(defl.niter) < int(plain.niter)


def test_eigsh_budget_honesty_float32():
    """An unreachable budget reports MAXITER (float32, as the JAX
    test)."""
    d = np.linspace(1.0, 1e6, 3000).astype(np.float32)
    kw = dict(k=4, which="sa", tol=1e-14, maxdim=12, max_restarts=1,
              v0=np.ones(3000, np.float32))
    want = _run("eigsh", "jax", _diag(d), kw)
    got = _run("eigsh", "torch", _diag(d), kw)
    assert got["status"] == want["status"] == 1
    assert got["niter"] == want["niter"]
    assert np.isfinite(got["theta"]).all()
    np.testing.assert_allclose(got["theta"], want["theta"], rtol=1e-4)


def _minres_inv(shift, tol, maxiter, op):
    """``(op - shift I)^{-1}`` by each package's own MINRES."""
    def jinv(r):
        return JF.minres(lambda u: op["jax"](u) - shift * u, r, tol=tol,
                         maxiter=maxiter).x

    def tinv(r):
        return F.minres(lambda u: op["torch"](u) - shift * u, r, tol=tol,
                        maxiter=maxiter).x

    return {"jax": jinv, "torch": tinv}


def _lap1d(n):
    return {"jax": jops.poisson_1d(n), "torch": ops.poisson_1d(n,
                                                                 device="cpu")}


def test_eigsh_shift_invert_interior():
    n = 300
    h = 1.0 / (n + 1)
    exact = (4.0 / h ** 2) * np.sin(np.arange(1, n + 1) * np.pi * h / 2) ** 2
    sigma = float(exact[105]) * 1.001
    lap = _lap1d(n)
    want = _hold("eigsh", lap, dict(
        k=3, sigma=sigma, inv=_minres_inv(sigma, 1e-12, 800, lap),
        tol=1e-8, maxdim=20, v0=_start(n)))
    assert want["status"] == 0


def test_eigsh_shift_invert_verifies_against_A():
    n = 200
    lap = _lap1d(n)
    want = _hold("eigsh", lap, dict(
        k=2, sigma=5e4, inv=_minres_inv(5e4, 0.3, 8, lap), tol=1e-10,
        maxdim=16, max_restarts=5, v0=_start(n)), subspace=False)
    assert want["status"] != 0


def test_eigsh_guards_match_jax():
    """Each guard of the JAX tests raises the same error in the port."""
    eye20, eye50 = torch.eye(20, dtype=torch.float64), torch.eye(
        50, dtype=torch.float64)
    eye30 = torch.eye(30, dtype=torch.float64)
    d = torch.diag(torch.arange(1.0, 41.0, dtype=torch.float64))
    cases = [
        ("inv", lambda: F.eigsh(eye20, k=2, sigma=1.0)),
        ("n= or v0=", lambda: F.eigsh(lambda v: v, k=2)),
        ("maxdim", lambda: F.eigsh(eye50, k=10, maxdim=10)),
        ("which", lambda: F.eigsh(eye50, k=2, which="zz")),
        ("BOTH", lambda: F.eigsh(eye20, k=2, B=eye20)),
        ("inv=", lambda: F.eigsh(eye20, k=2, B=eye20, Binv=eye20,
                                 sigma=1.0)),
        ("block_size", lambda: F.eigsh(eye30, k=2, block_size=0)),
        ("generalized", lambda: F.eigsh(eye30, k=2, B=eye30, Binv=eye30,
                                        block_size=2)),
        ("cgs2_1r", lambda: F.eigsh(d, k=2, block_size=2,
                                    ortho="cgs2_1r")),
        ("unknown eigsh ortho", lambda: F.eigsh(d, k=2, ortho="bogus")),
        ("cgs2_1r", lambda: F.eigsh(d, k=2, B=torch.eye(
            40, dtype=torch.float64), Binv=torch.eye(40, dtype=torch.float64),
            ortho="cgs2_1r")),
    ]
    for match, fn in cases:
        with pytest.raises(ValueError, match=match):
            fn()


def test_eigsh_early_invariance_excludes_dead_block():
    d = np.repeat(np.array([2.0, 3.0, 5.0, 8.0, 13.0]), 40)
    want = _hold("eigsh", _diag(d), dict(k=3, which="sa", tol=1e-10,
                                         maxdim=24, v0=_start(d.size)),
                 rtol=1e-9)
    assert want["status"] == 0
    np.testing.assert_allclose(want["theta"], [2.0, 3.0, 5.0], atol=1e-9)


def test_eigsh_fewer_reachable_pairs_than_k_is_honest():
    d = np.repeat(np.array([2.0, 7.0]), 30)
    want = _hold("eigsh", _diag(d), dict(k=3, which="sa", tol=1e-10,
                                         maxdim=10, max_restarts=3,
                                         v0=_start(d.size)),
                 subspace=False)
    assert want["status"] != 0


def test_eigsh_generalized_diagonal_pencil():
    n = 300
    a, mb = np.linspace(1.0, 200.0, n), np.linspace(0.5, 3.0, n)
    want = _hold("eigsh", _diag(a), dict(
        k=4, which="sa", B=_diag(mb), Binv=_diag(1.0 / mb), tol=1e-10,
        maxdim=40, v0=_start(n)), rtol=1e-9)
    assert want["status"] == 0


def test_eigsh_generalized_dense():
    rng = np.random.default_rng(5)
    n = 120
    Bd = rng.standard_normal((n, n))
    Bd = Bd @ Bd.T + n * np.eye(n)
    Ad = rng.standard_normal((n, n))
    Ad = (Ad + Ad.T) / 2
    want = _hold("eigsh", Ad, dict(k=3, which="sa", B=Bd,
                                   Binv=np.linalg.inv(Bd), tol=1e-10,
                                   maxdim=40, v0=_start(n)))
    np.testing.assert_allclose(want["theta"], scipy.linalg.eigh(
        Ad, Bd, eigvals_only=True)[:3], atol=1e-8)


def test_eigsh_generalized_shift_invert():
    n = 150
    rng = np.random.RandomState(7)
    Q = np.linalg.qr(rng.randn(n, n))[0]
    A = Q @ np.diag(np.linspace(1.0, 50.0, n)) @ Q.T
    A = (A + A.T) / 2
    Bd = np.linspace(0.5, 2.0, n)
    exact = scipy.linalg.eigh(A, np.diag(Bd), eigvals_only=True)
    sigma = float(exact[n // 2]) * 1.0007
    shifted = A - sigma * np.diag(Bd)
    js, ts = jnp.asarray(shifted), torch.tensor(shifted)
    jb, tb = jnp.asarray(Bd), torch.tensor(Bd)
    want = _hold("eigsh", A, dict(
        k=3, sigma=sigma, maxdim=24, tol=1e-8, n=n, v0=_start(n),
        inv={"jax": lambda v: jnp.linalg.solve(js, v),
             "torch": lambda v: torch.linalg.solve(ts, v)},
        B={"jax": lambda v: jb * v, "torch": lambda v: tb * v}))
    assert want["status"] == 0


def test_eigsh_generalized_sloppy_binv_is_honest():
    n = 100
    a, mb = np.linspace(1.0, 50.0, n), np.linspace(0.5, 2.0, n)
    want = _hold("eigsh", _diag(a), dict(
        k=3, which="sa", B=_diag(mb), Binv=_diag(1.0 / (mb + 0.3)),
        tol=1e-10, maxdim=30, max_restarts=10, v0=_start(n)),
        subspace=False)
    assert want["status"] != 0


def test_eigsh_block_converges_degenerate_pair():
    """Both members of the square Laplacian's degenerate pair (block_size
    2): the 4-dimensional subspace of the pair and its neighbours."""
    nx = 24
    want = _hold("eigsh", _lap2d(nx), dict(
        k=4, n=nx * nx, which="sa", tol=1e-8, block_size=2, maxdim=24,
        max_restarts=300, v0=_start(nx * nx)), rtol=1e-8)
    assert want["status"] == 0
    np.testing.assert_allclose(np.sort(want["theta"]),
                               _laplacian_low_spectrum(nx, 4), rtol=1e-8)


@pytest.mark.parametrize("bsz", [2, 3])
def test_eigsh_block_matches_dense(bsz):
    rng = np.random.default_rng(7)
    d = np.r_[0.5, 0.5, 0.5, 1.0, np.linspace(2, 10, 116)]
    Q, _ = np.linalg.qr(rng.standard_normal((120, 120)))
    A = Q * d @ Q.T
    A = 0.5 * (A + A.T)
    want = _hold("eigsh", A, dict(k=4, which="sa", tol=1e-9,
                                  block_size=bsz, maxdim=24, v0=_start(120)),
                 rtol=1e-8)
    assert want["status"] == 0


def test_eigsh_block_shift_invert_degenerate():
    nx = 16
    lap = _lap2d(nx)
    sigma = float(_laplacian_low_spectrum(nx, 4)[1]) * 0.9
    want = _hold("eigsh", lap, dict(
        k=4, n=nx * nx, sigma=sigma, inv=_minres_inv(sigma, 1e-12, 2000, lap),
        tol=1e-8, block_size=2, maxdim=24, max_restarts=100,
        v0=_start(nx * nx)), rtol=1e-7)
    assert want["status"] == 0


def test_eigsh_one_reduce_shift_invert():
    """``cgs2_1r`` composed with shift-invert (the second half of the JAX
    test of the one-reduce sweep)."""
    d = np.linspace(1.0, 60.0, 60)
    dj, dt = jnp.asarray(d), torch.tensor(d)
    want = _hold("eigsh", np.diag(d), dict(
        k=3, sigma=30.3, tol=1e-10, maxdim=24, ortho="cgs2_1r",
        v0=_start(60),
        inv={"jax": lambda v: v / (dj - 30.3),
             "torch": lambda v: v / (dt - 30.3)}), rtol=1e-9)
    assert want["status"] == 0


def test_lanczos_1r_sweep_matches_jax():
    """The lagged sweep itself on a dense Hermitian matrix: the port's
    ``H`` and basis against the JAX package's after one full sweep."""
    rng = np.random.default_rng(4)
    n, m = 80, 12
    B = rng.standard_normal((n, n))
    Am = (B + B.T) / 2
    v = _start(n)
    V0 = np.zeros((m + 1, n))
    V0[0] = v / np.linalg.norm(v)
    H0 = np.zeros((m + 1, m + 1))
    Aj = jnp.asarray(Am)
    Vj, Hj = jeigh.lanczos_1r_sweep(lambda x: Aj @ x, jnp.asarray(V0),
                                    jnp.asarray(H0), 0, m, jnp.float64,
                                    jnp.float64)
    At = torch.tensor(Am)
    Vt, Ht = teigh.lanczos_1r_sweep(lambda x: At @ x, torch.tensor(V0),
                                    torch.tensor(H0), 0, m, torch.float64,
                                    torch.float64)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=0,
                               atol=1e-11 * np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), rtol=0,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# tests/test_eigs.py's cases
# ---------------------------------------------------------------------------


def test_eigs_random_real_lm():
    rng = np.random.default_rng(0)
    n = 200
    Am = rng.standard_normal((n, n)) / np.sqrt(n)
    want = _hold("eigs", Am, dict(k=4, which="lm", tol=1e-10,
                                  v0=_start(n)), conj=True)
    assert want["status"] == 0


def test_eigs_complex_matrix():
    rng = np.random.default_rng(1)
    n = 150
    Am = (rng.standard_normal((n, n))
          + 1j * rng.standard_normal((n, n))) / np.sqrt(2 * n)
    want = _hold("eigs", Am, dict(k=3, which="lm", tol=1e-10,
                                  v0=_start(n)))
    assert want["status"] == 0


@pytest.mark.parametrize("which", ["lr", "sr", "li", "si"])
def test_eigs_which_grid(which):
    rng = np.random.default_rng(2)
    blocks = [np.array([[3.0]]), np.array([[-2.5]]),
              np.array([[0.5, 2.0], [-2.0, 0.5]])]
    bulk = rng.standard_normal((60, 60)) / np.sqrt(60) * 0.4
    Am = scipy.linalg.block_diag(*blocks, bulk)
    Q, _ = np.linalg.qr(rng.standard_normal(Am.shape))
    Am = Q @ Am @ Q.T
    want = _hold("eigs", Am, dict(k=2, which=which, tol=1e-9,
                                  max_restarts=300, v0=_start(64)),
                 rtol=1e-7, conj=which in ("lr", "sr"))
    assert want["status"] == 0


def test_eigs_convection_diffusion():
    """Nearest-zero pairs of the convection-diffusion stencil, the inverse
    applied densely (each package's own operator materialized)."""
    nx = 12
    N = nx * nx
    cd = jops.convection_diffusion_2d(nx, wind=(8.0, 4.0))
    Ad = np.column_stack([np.asarray(cd(jnp.eye(N, dtype=jnp.float64)[:, i]))
                          for i in range(N)])
    tcd = ops.convection_diffusion_2d(nx, wind=(8.0, 4.0), device="cpu")
    np.testing.assert_allclose(
        torch.stack([tcd(e) for e in torch.eye(N, dtype=torch.float64)],
                    1).numpy(), Ad, rtol=1e-13, atol=1e-10)
    Sinv = np.linalg.inv(Ad)
    sj, st = jnp.asarray(Sinv), torch.tensor(Sinv)
    want = _hold("eigs", {"jax": cd, "torch": tcd}, dict(
        k=3, n=N, sigma=0.0, tol=1e-10, v0=_start(N),
        inv={"jax": lambda v: sj.astype(v.dtype) @ v,
             "torch": lambda v: st.to(v.dtype) @ v}), rtol=1e-9, conj=True)
    assert want["status"] == 0


def test_eigs_shift_invert_interior():
    rng = np.random.default_rng(5)
    n = 120
    Am = rng.standard_normal((n, n)) / np.sqrt(n)
    sigma = 0.3 + 0.1j
    Sinv = np.linalg.inv(Am - sigma * np.eye(n))
    sj, st = jnp.asarray(Sinv), torch.tensor(Sinv)
    want = _hold("eigs", Am, dict(
        k=3, sigma=sigma, tol=1e-10, v0=_start(n),
        inv={"jax": lambda v: sj @ v, "torch": lambda v: st @ v}))
    assert want["status"] == 0


def test_eigs_agrees_with_eigsh_on_hermitian():
    rng = np.random.default_rng(3)
    n = 140
    B = rng.standard_normal((n, n))
    Am = (B + B.T) / 2
    want = _hold("eigs", Am, dict(k=3, which="lm", tol=1e-10,
                                  v0=_start(n)), conj=True)
    rs = F.eigsh(torch.tensor(Am), k=3, which="lm", tol=1e-10)
    np.testing.assert_allclose(np.sort(want["theta"].real),
                               np.sort(rs.theta.numpy()), atol=1e-8)


def test_eigs_invariant_subspace():
    rng = np.random.default_rng(7)
    n = 300
    U5, W5 = rng.standard_normal((n, 5)), rng.standard_normal((n, 5))
    Am = U5 @ np.diag([5.0, 4.0, 3.0, 2.0, 1.0]) @ W5.T / n
    want = _hold("eigs", Am, dict(k=3, which="lm", tol=1e-9, v0=_start(n)),
                 rtol=1e-8, conj=True)
    assert want["status"] == 0


def test_eigs_callable_with_n():
    """A bare callable with ``n=``; the port's start goes to the
    callable's ``device``."""
    rng = np.random.default_rng(9)
    n = 100
    Am = rng.standard_normal((n, n)) / np.sqrt(n)
    Aj, At = jnp.asarray(Am), torch.tensor(Am)

    def tmv(v):
        return At.to(v.dtype) @ v

    tmv.device = "cpu"
    want = _hold("eigs", {"jax": lambda v: Aj.astype(v.dtype) @ v,
                          "torch": tmv}, dict(k=2, n=n, tol=1e-10),
                 conj=True)
    assert want["status"] == 0


def test_eigs_f32():
    """A float32 operator: complex64 on both sides, pairs to float32
    accuracy."""
    rng = np.random.default_rng(11)
    n = 150
    Am = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    kw = dict(k=2, which="lm", tol=2e-5, max_restarts=300)
    want = _run("eigs", "jax", Am, kw)
    got = _run("eigs", "torch", Am, kw)
    assert got["theta"].dtype == np.complex64
    assert got["status"] == want["status"] == 0
    assert ec.theta_dev(want["theta"], got["theta"], conj=True) <= 1e-4


def test_eigs_one_reduce_matches_jax():
    rng = np.random.default_rng(0)
    n = 200
    Am = rng.standard_normal((n, n)) / np.sqrt(n)
    want = _hold("eigs", Am, dict(k=4, which="lm", tol=1e-10,
                                  ortho="cgs2_1r", v0=_start(n)), conj=True)
    assert want["status"] == 0


def test_eigs_validation_matches_jax():
    Am = torch.tensor(np.random.default_rng(0).standard_normal((40, 40)))
    for match, kw in (("which", dict(which="xx")),
                      ("requires inv", dict(sigma=1.0)),
                      ("only meaningful", dict(inv=lambda v: v)),
                      ("maxdim", dict(k=20, maxdim=21)),
                      ("unknown eigs ortho", dict(ortho="x"))):
        with pytest.raises(ValueError, match=match):
            F.eigs(Am, **dict(dict(k=2), **kw))
    with pytest.raises(ValueError, match="n= or v0="):
        F.eigs(lambda v: v, k=2)
    # the JAX package's own messages, for the record
    with pytest.raises(ValueError, match="which"):
        JF.eigs(jnp.eye(40), k=2, which="xx")


# ---------------------------------------------------------------------------
# the slice as a whole: the eigen phase's pipelines (krypy_tpu_torch.eigen)
# on the CPU, K1-K6's plain versions, against the JAX package
# ---------------------------------------------------------------------------


def test_closed_forms_against_dense_eigenvalues():
    """The closed forms that gate the card's eigen phase, against dense
    eigenvalues of each of the port's operators at 63^2: the north star's
    convection-diffusion by ``numpy.linalg.eigvals`` (its spectrum real:
    the stencil's off-diagonal products are positive), bench.py's Poisson
    by ``numpy.linalg.eigvalsh``."""
    from krypy_tpu_torch import eigen

    nx = 63
    N = nx * nx
    for op, closed in ((ops.poisson_2d(nx, device="cpu"),
                        eigen.poisson_eigenvalues),
                       (ops.convection_diffusion_2d(nx, device="cpu"),
                        eigen.cd_eigenvalues)):
        D = torch.stack([op(e) for e in torch.eye(N, dtype=torch.float64)],
                        dim=1).numpy()
        # one BLAS thread: the suite's workers share the host's cores, and
        # a full pool in each of them makes this dense solve ~15x slower
        with threadpool_limits(1):
            if closed is eigen.poisson_eigenvalues:
                ev = np.linalg.eigvalsh(D)
            else:
                ev = np.linalg.eigvals(D)
                assert np.abs(ev.imag).max() <= 1e-8 * np.abs(ev).max()
        want = np.sort(ev.real)[:8]
        got = np.array([v for v, _, _ in closed(nx, 8)])
        np.testing.assert_allclose(got, want, rtol=1e-9)


def test_poisson_shift_invert_pipeline_matches_jax():
    """(a) of the eigen phase at 31^2: the port's shift-invert block
    Lanczos through :func:`krypy_tpu_torch.eigen.poisson_inverse` (the
    refined float32 multigrid-CG, K1-K3's plain versions) against the JAX
    package's eigsh on the same operator with an exact inverse, and both
    against the closed form (both members of each degenerate pair)."""
    from krypy_tpu_torch import eigen

    nx = 31
    inv, A, counts = eigen.poisson_inverse(nx, "cuda", "cpu", tol=1e-9)
    r = F.eigsh(A, 6, sigma=0.0, inv=inv, block_size=2, tol=1e-8)
    assert r.converged and float(r.pair_resnorms.max()) <= 1e-8
    want = [v for v, _, _ in eigen.poisson_eigenvalues(nx, 6)]
    np.testing.assert_allclose(np.sort(r.theta.numpy()), want, rtol=1e-9)
    assert counts["solves"] == int(r.niter)  # one inverse per step
    lap = jops.poisson_2d(nx)
    D = np.stack([np.asarray(lap(e)) for e in np.eye(nx * nx)], 1)
    Dinv = jnp.asarray(np.linalg.inv(D))
    j = JF.eigsh(lap, 6, n=nx * nx, sigma=0.0, inv=lambda v: Dinv @ v,
                 block_size=2, tol=1e-8)
    assert int(j.status) == 0 and int(j.niter) == int(r.niter)
    np.testing.assert_allclose(np.sort(r.theta.numpy()),
                               np.sort(np.asarray(j.theta)), rtol=1e-9)


def test_northstar_krylov_schur_pipeline_matches_jax():
    """(c) of the eigen phase at 31^2: Krylov-Schur through
    :func:`krypy_tpu_torch.eigen.northstar_inverse` (the north star's
    refined GMRES on the real and imaginary parts; K1-K6's plain
    versions) against the JAX package's eigs with an exact inverse, both
    on the closed form of the north star's operator."""
    from krypy_tpu_torch import eigen

    nx = 31
    inv, A, counts = eigen.northstar_inverse(nx, "cuda", "cpu")
    r = F.eigs(A, 4, sigma=0.0, inv=inv, tol=1e-8)
    assert r.status == 0 and float(r.pair_resnorms.max()) <= 1e-6
    want = [v for v, _, _ in eigen.cd_eigenvalues(nx, 4)]
    th = r.theta.numpy()
    assert np.abs(th.imag).max() <= 1e-8 * np.abs(th).max()
    np.testing.assert_allclose(np.sort(th.real), want, rtol=1e-9)
    # the first cycle's vectors are real: one solve each
    assert counts["solves"] >= r.niter
    cd = jops.convection_diffusion_2d(nx)
    D = np.stack([np.asarray(cd(e)) for e in np.eye(nx * nx)], 1)
    Dinv = jnp.asarray(np.linalg.inv(D))
    j = JF.eigs(cd, 4, n=nx * nx, sigma=0.0,
                inv=lambda v: Dinv.astype(v.dtype) @ v, tol=1e-8)
    assert j.status == 0 and j.niter == r.niter
    np.testing.assert_allclose(np.sort(th.real),
                               np.sort(np.asarray(j.theta).real), rtol=1e-9)
