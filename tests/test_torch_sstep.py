"""The port's s-step lane (``krypy_tpu_torch.functional.sstep``: ``ca_cg``,
``ca_gmres`` with its three bases, ``restarted_ca_gmres``,
``newton_shifts`` and ``modified_leja``) against the JAX package on the
CPU, on every case of tests/test_sstep.py (the sharded two run in
tests/test_torch_parallel.py), float64 unless the reference case is
float32.

The JAX side runs each case once, through ``jax.jit`` where the
reference runs a compiled solve (one compile per case, shared by the
tests that read it through module-scoped fixtures).  Tolerances, float64:
equal ``niter`` and ``status``, iterates to ``1e-10`` of their largest
entry, histories to ``1e-10`` absolute (relative residuals: the entries
near the 1e-12 stop are rounding, the s-step recurrences carry a few
hundred ulps a block), except where the monomial basis at s = 8 makes
the history a rounding witness's: there the port's history stands within
twice the JAX package's own spread under one ulp of ``b`` at ``b[0]``
and at ``b[N // 2]`` (:func:`_ulp_spread`; 4.4e-5 on tests/test_sstep.py's
Poisson, where the float64 iterates still agree to 1e-13).  Float32 cases
hold what rounding does not steer: the status, the first block's
residual to ``1e-3`` relative (float32's sums in another order; from the
second block on, JAX's own history moves by ~2% under one ulp of ``b``),
the floor reached within a factor of 10, and a final float64 true
residual within ``F32_TRUE_RTOL`` = 0.1 relative (after 64-72 float32
steps JAX's own true residual moves by up to 2.1% under one ulp of ``b``,
the Chebyshev basis at s = 12, and the port's, whose sums run in another
order, lies up to 5% from it); then each reference case's own
assertions on the port's run.
The float32 monomial basis at s = 8 on 64^2 Poisson breaks down or runs
on by one ulp of ``b`` in the JAX package itself (BREAKDOWN after 16 or
24 steps, or MAXITER at 64 steps with the residual stuck near 0.6): the
port's run must be one of the two.
"""

import numpy as np
import pytest
import torch

from krypy_tpu_torch import functional as F, interop, ops
from krypy_tpu_torch.functional import sstep as S

jax = pytest.importorskip("jax")
jnp = jax.numpy

X_RTOL, HIST_ATOL = 1e-10, 1e-10
F32_HEAD_RTOL, F32_FLOOR_FACTOR, F32_TRUE_RTOL = 1e-3, 10.0, 0.1


def _J():
    from krypy_tpu import functional as JF, ops as jops

    return JF, jops


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(t):
    return interop.to_numpy(t) if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _hold(got, want, x_rtol=X_RTOL, hist_atol=HIST_ATOL):
    """Counts and status equal, the iterate and the history close."""
    assert int(got.niter) == int(want.niter)
    assert int(got.status) == int(want.status)
    xw = _np(want.x)
    np.testing.assert_allclose(_np(got.x), xw, rtol=0,
                               atol=x_rtol * max(np.abs(xw).max(), 1e-300))
    hw, hg = _np(want.resnorms), _np(got.resnorms)
    assert hg.shape == hw.shape
    np.testing.assert_array_equal(np.isnan(hg), np.isnan(hw))
    ok = ~np.isnan(hw)
    np.testing.assert_allclose(hg[ok], hw[ok], rtol=0, atol=hist_atol)


def _ulp_spread(fn, b):
    """The largest move of the JAX history under one ulp of ``b`` at
    ``b[0]`` and at ``b[N // 2]`` (``fn`` the compiled solve)."""
    base = np.asarray(fn(jnp.asarray(b)).resnorms)
    spread = 0.0
    for i in (0, b.size // 2):
        bb = b.copy()
        bb[i] = np.nextafter(bb[i], np.inf)
        h = np.asarray(fn(jnp.asarray(bb)).resnorms)
        ok = ~np.isnan(h) & ~np.isnan(base)
        spread = max(spread, float(np.max(np.abs(h[ok] - base[ok]))))
    return spread


def _hold_f32(got, want):
    """A float32 run: status equal, the first block within
    ``F32_HEAD_RTOL``, the floors within ``F32_FLOOR_FACTOR``."""
    assert int(got.status) == int(want.status)
    hw, hg = _np(want.resnorms), _np(got.resnorms)
    np.testing.assert_allclose(hg[:2], hw[:2], rtol=F32_HEAD_RTOL)
    fw, fg = np.nanmin(hw), np.nanmin(hg)
    assert fg <= F32_FLOOR_FACTOR * fw and fw <= F32_FLOOR_FACTOR * fg


def _true_rel(A, b, x):
    b = np.asarray(b, np.float64) if not np.iscomplexobj(b) else b
    return float(np.linalg.norm(b - A @ np.asarray(x)) / np.linalg.norm(b))


def _poisson(nx):
    """The port's 2-D Poisson operator on the CPU."""
    return ops.poisson_2d(nx, device="cpu")


# ---------------------------------------------------------------------------
# ca_cg
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cacg_jacobi():
    """tests/test_sstep.py:12's solves in JAX, s = 2, 4, 8, and plain CG."""
    JF, jops = _J()
    lap = jops.poisson_2d(64)
    Mj = jops.jacobi_preconditioner(lap)
    b = jnp.ones(64 * 64)
    out = {"cg": jax.jit(lambda v: JF.cg(lap, v, M=Mj, tol=1e-10,
                                         maxiter=500))(b)}
    for s in (2, 4, 8):
        fn = jax.jit(lambda v, s=s: JF.ca_cg(
            lap, v, s=s, M=Mj, tol=1e-10, maxiter=500))
        out[s] = fn(b)
        if s == 8:
            out["spread", s] = _ulp_spread(fn, np.ones(64 * 64))
    return out


@pytest.mark.parametrize("s", [2, 4, 8])
def test_ca_cg_matches_jax_jacobi_poisson(cacg_jacobi, s):
    lap = _poisson(64)
    Mt = ops.jacobi_preconditioner(lap)
    b = torch.ones(64 * 64, dtype=torch.float64)
    res = F.ca_cg(lap, b, s=s, M=Mt, tol=1e-10, maxiter=500)
    spread = cacg_jacobi.get(("spread", s))
    _hold(res, cacg_jacobi[s],
          hist_atol=HIST_ATOL if spread is None else 2 * spread)
    # the reference's own assertions
    assert int(res.status) == 0
    rel = float(torch.linalg.vector_norm(b - lap(res.x))
                / torch.linalg.vector_norm(b))
    assert rel <= 1e-9
    ref = cacg_jacobi["cg"]
    if s <= 4:
        assert int(res.niter) <= int(ref.niter) + s
    else:
        assert int(res.niter) <= 2 * int(ref.niter)


def test_ca_cg_multigrid_matches_jax():
    JF, jops = _J()
    Mg = jops.multigrid_poisson_preconditioner(63, coarsest=7)
    lap = jops.poisson_2d(63)
    want = jax.jit(lambda v: JF.ca_cg(lap, v, s=4, M=Mg, tol=1e-10,
                                      maxiter=64))(jnp.ones(63 * 63))
    res = F.ca_cg(_poisson(63), torch.ones(63 * 63, dtype=torch.float64),
                  s=4, M=ops.multigrid_poisson_preconditioner(
                      63, coarsest=7, device="cpu"), tol=1e-10, maxiter=64)
    _hold(res, want)
    assert int(res.status) == 0 and int(res.niter) <= 12


def test_ca_cg_dense_spd_unpreconditioned_matches_jax():
    JF, _ = _J()
    r = np.random.RandomState(0)
    Q, _ = np.linalg.qr(r.randn(80, 80))
    A = Q @ np.diag(np.linspace(1, 50, 80)) @ Q.T
    b = A @ r.randn(80)
    want = jax.jit(lambda v: JF.ca_cg(jnp.asarray(A), v, s=4, tol=1e-10,
                                      maxiter=400))(jnp.asarray(b))
    res = F.ca_cg(_t(A), _t(b), s=4, tol=1e-10, maxiter=400)
    _hold(res, want)
    assert int(res.status) == 0 and _true_rel(A, b, res.x) <= 1e-9


def test_ca_cg_f32_floor_reports_maxiter_as_jax():
    """Below the float32 floor both stagnate-stop with MAXITER."""
    JF, jops = _J()
    lap = jops.poisson_2d(64)
    Mj = jops.jacobi_preconditioner(lap)
    want = jax.jit(lambda v: JF.ca_cg(lap, v, s=4, M=Mj, tol=1e-13,
                                      maxiter=3000))(
        jnp.ones(64 * 64, jnp.float32))
    lapt = _poisson(64)
    res = F.ca_cg(lapt, torch.ones(64 * 64), s=4,
                  M=ops.jacobi_preconditioner(lapt), tol=1e-13,
                  maxiter=3000)
    assert res.x.dtype == torch.float32
    _hold_f32(res, want)
    assert int(res.status) == 1
    assert np.nanmin(_np(res.resnorms)) < 1e-4


def test_ca_cg_counts_blocks_and_explicit_residual():
    """``niter`` is blocks x s and ``resnorms`` one entry per block (NaN
    beyond); ``explicit_residual=False`` runs the recurrence residual, as
    the JAX package's."""
    JF, _ = _J()
    r = np.random.RandomState(0)
    Q, _ = np.linalg.qr(r.randn(40, 40))
    A = Q @ np.diag(np.linspace(1, 20, 40)) @ Q.T
    b = r.randn(40)
    want = jax.jit(lambda v: JF.ca_cg(
        jnp.asarray(A), v, s=3, tol=1e-9, maxiter=60, lam_est=20.0,
        explicit_residual=False))(jnp.asarray(b))
    res = F.ca_cg(_t(A), _t(b), s=3, tol=1e-9, maxiter=60, lam_est=20.0,
                  explicit_residual=False)
    _hold(res, want)
    nb = int(res.niter) // 3
    hist = _np(res.resnorms)
    assert hist.shape == (21,) and np.isnan(hist[nb + 1:]).all()


# ---------------------------------------------------------------------------
# ca_gmres
# ---------------------------------------------------------------------------

GM_CASES = [(1, "monomial"), (2, "monomial"), (4, "monomial"),
            (2, "newton"), (4, "newton"),
            (2, "chebyshev"), (4, "chebyshev"), (8, "chebyshev")]


@pytest.fixture(scope="module")
def gm_problem():
    r = np.random.RandomState(0)
    A = np.diag(np.linspace(1, 10, 80)) + 0.1 * r.randn(80, 80)
    b = r.randn(80)
    JF, _ = _J()
    ref = jax.jit(lambda v: JF.gmres(jnp.asarray(A), v, tol=1e-12,
                                     maxiter=60))(jnp.asarray(b))
    return A, b, ref


@pytest.mark.parametrize("s,basis", GM_CASES)
def test_ca_gmres_matches_jax_and_gmres_at_block_boundaries(gm_problem, s,
                                                            basis):
    JF, _ = _J()
    A, b, ref = gm_problem
    want = jax.jit(lambda v: JF.ca_gmres(jnp.asarray(A), v, s=s, basis=basis,
                                         tol=1e-12, maxiter=60))(
        jnp.asarray(b))
    res = F.ca_gmres(_t(A), _t(b), s=s, basis=basis, tol=1e-12, maxiter=60)
    _hold(res, want)
    # the reference's own assertions
    assert int(res.status) == 0
    rg, rc = np.asarray(ref.resnorms), _np(res.resnorms)
    bdry_rel = 2e-4 if basis == "chebyshev" else 1e-6
    for j in range(1, int(res.niter) // s):
        if j * s <= int(ref.niter):
            assert rc[j] == pytest.approx(rg[j * s], rel=bdry_rel)
    assert _true_rel(A, b, res.x) <= 1e-11


@pytest.mark.parametrize("s", [2, 4])
def test_ca_gmres_arnoldi_relation_matches_jax(s):
    JF, _ = _J()
    r = np.random.RandomState(1)
    A = np.diag(np.linspace(1, 10, 60)) + 0.05 * r.randn(60, 60)
    b = r.randn(60)
    want, wint = jax.jit(lambda v: JF.ca_gmres(
        jnp.asarray(A), v, s=s, tol=1e-12, maxiter=40,
        return_internal=True))(jnp.asarray(b))
    res, internal = F.ca_gmres(_t(A), _t(b), s=s, tol=1e-12, maxiter=40,
                               return_internal=True)
    _hold(res, want)
    K = int(res.niter)
    V = _np(internal["V"])[: K + 1]
    H = _np(internal["H"])[: K + 1, :K]
    np.testing.assert_allclose(V, np.asarray(wint["V"])[: K + 1], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(H, np.asarray(wint["H"])[: K + 1, :K],
                               rtol=0, atol=1e-9)
    assert float(internal["lam"]) == pytest.approx(float(wint["lam"]),
                                                   rel=1e-12)
    assert np.linalg.norm(A @ V[:K].T - V[: K + 1].T @ H) \
        / np.linalg.norm(H) < 1e-12
    assert np.linalg.norm(V @ V.T.conj() - np.eye(K + 1)) < 1e-11


def test_ca_gmres_preconditioned_matches_jax():
    JF, jops = _J()
    lap = jops.poisson_2d(32)
    Mj = jops.jacobi_preconditioner(lap)
    want = jax.jit(lambda v: JF.ca_gmres(lap, v, s=4, Ml=Mj, Mr=Mj,
                                         tol=1e-10, maxiter=512))(
        jnp.ones(32 * 32))
    lapt = _poisson(32)
    Mt = ops.jacobi_preconditioner(lapt)
    b = torch.ones(32 * 32, dtype=torch.float64)
    res = F.ca_gmres(lapt, b, s=4, Ml=Mt, Mr=Mt, tol=1e-10, maxiter=512)
    _hold(res, want)
    assert int(res.status) == 0
    assert float(torch.linalg.vector_norm(b - lapt(res.x))
                 / torch.linalg.vector_norm(b)) <= 1e-8


def test_ca_gmres_multigrid_matches_jax():
    JF, jops = _J()
    lap = jops.poisson_2d(63)
    Mg = jops.multigrid_poisson_preconditioner(63, coarsest=7)
    want = jax.jit(lambda v: JF.ca_gmres(lap, v, s=4, Ml=Mg, tol=1e-10,
                                         maxiter=64))(jnp.ones(63 * 63))
    res = F.ca_gmres(_poisson(63), torch.ones(63 * 63, dtype=torch.float64),
                     s=4, Ml=ops.multigrid_poisson_preconditioner(
                         63, coarsest=7, device="cpu"),
                     tol=1e-10, maxiter=64)
    _hold(res, want)
    assert int(res.status) == 0 and int(res.niter) <= 16


def test_ca_gmres_f32_floor_reports_maxiter_as_jax():
    """(The port runs first: right after XLA's CPU run, torch's float32
    products here took 100x their time on this host.)"""
    JF, jops = _J()
    res = F.ca_gmres(_poisson(64), torch.ones(64 * 64), s=4, tol=1e-13,
                     maxiter=256)
    lap = jops.poisson_2d(64)
    want = jax.jit(lambda v: JF.ca_gmres(lap, v, s=4, tol=1e-13,
                                         maxiter=256))(
        jnp.ones(64 * 64, jnp.float32))
    assert res.x.dtype == torch.float32
    _hold_f32(res, want)
    assert int(res.status) != 0
    assert np.nanmin(_np(res.resnorms)) < 1e-3


def _f32_true_rel(lap64, x):
    b = torch.ones(lap64.shape[0], dtype=torch.float64)
    x = torch.tensor(np.asarray(x), dtype=torch.float64)
    return float(torch.linalg.vector_norm(b - lap64(x))
                 / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def f32_poisson_runs():
    """tests/test_sstep.py's unpreconditioned float32 Poisson at 64^2 in
    JAX: GMRES(64), the monomial and Newton bases at s = 8, GMRES(72)
    and the Chebyshev basis at s = 8 and 12."""
    JF, jops = _J()
    lap = jops.poisson_2d(64)
    b = np.ones(64 * 64, np.float32)
    kw = dict(tol=0.0, stagnation_window=10 ** 9)
    out = {
        "gmres64": jax.jit(lambda v: JF.gmres(lap, v, tol=0.0,
                                              maxiter=64))(b),
        "gmres72": jax.jit(lambda v: JF.gmres(lap, v, tol=0.0,
                                              maxiter=72))(b)}
    for basis, s, maxiter in (("monomial", 8, 64), ("newton", 8, 64),
                              ("chebyshev", 8, 72), ("chebyshev", 12, 72)):
        out[basis, s] = jax.jit(lambda v, basis=basis, s=s, m=maxiter:
                                JF.ca_gmres(lap, v, s=s, basis=basis,
                                            maxiter=m, **kw))(jnp.asarray(b))
    return out


def test_ca_gmres_newton_survives_where_monomial_breaks_as_jax(
        f32_poisson_runs):
    lap = _poisson(64)
    b = torch.ones(64 * 64)
    kw = dict(tol=0.0, maxiter=64, stagnation_window=10 ** 9)
    mono = F.ca_gmres(lap, b, s=8, basis="monomial", **kw)
    newt = F.ca_gmres(lap, b, s=8, basis="newton", **kw)
    wm, wn = f32_poisson_runs["monomial", 8], f32_poisson_runs["newton", 8]
    assert int(wm.status) == 2  # BREAKDOWN in the JAX package
    assert int(newt.niter) == int(wn.niter) == 64
    ref = f32_poisson_runs["gmres64"]
    got, want = _f32_true_rel(lap, newt.x), _f32_true_rel(lap, wn.x)
    assert got <= 1.5 * _f32_true_rel(lap, ref.x)
    assert got == pytest.approx(want, rel=F32_TRUE_RTOL)
    # the monomial basis: one of the JAX package's one-ulp outcomes
    if int(mono.status) == 2:
        assert int(mono.niter) < 64
    else:
        assert int(mono.status) == 1 and int(mono.niter) == 64
        assert _f32_true_rel(lap, mono.x) >= 10 * got


def test_ca_gmres_chebyshev_survives_s12_f32_as_jax(f32_poisson_runs):
    lap = _poisson(64)
    b = torch.ones(64 * 64)
    ref = _f32_true_rel(lap, f32_poisson_runs["gmres72"].x)
    for s in (8, 12):
        ch = F.ca_gmres(lap, b, s=s, basis="chebyshev", tol=0.0, maxiter=72,
                        stagnation_window=10 ** 9)
        want = f32_poisson_runs["chebyshev", s]
        assert int(ch.niter) == int(want.niter) == 72
        got = _f32_true_rel(lap, ch.x)
        assert got <= 1.1 * ref
        assert got == pytest.approx(_f32_true_rel(lap, want.x),
                                    rel=F32_TRUE_RTOL)


@pytest.mark.parametrize("basis", ["newton", "chebyshev"])
def test_ca_gmres_explicit_shifts_match_jax(basis):
    JF, _ = _J()
    r = np.random.RandomState(3)
    A = np.diag(np.linspace(1, 10, 60)) + 0.05 * r.randn(60, 60)
    ev = np.linalg.eigvals(A)
    b = r.randn(60)
    want = jax.jit(lambda v: JF.ca_gmres(jnp.asarray(A), v, s=4, basis=basis,
                                         shifts=ev, tol=1e-12,
                                         maxiter=40))(jnp.asarray(b))
    res = F.ca_gmres(_t(A), _t(b), s=4, basis=basis, shifts=ev, tol=1e-12,
                     maxiter=40)
    _hold(res, want)
    assert int(res.status) == 0 and _true_rel(A, b, res.x) <= 1e-11


@pytest.mark.parametrize("basis,tol,rel", [("newton", 1e-12, 1e-10),
                                           ("chebyshev", 1e-10, 1e-9)])
def test_ca_gmres_complex_matches_jax(basis, tol, rel):
    """Complex systems: the Newton basis' complex shifts, the Chebyshev
    ellipse's complex center (tests/test_sstep.py's two complex cases)."""
    JF, _ = _J()
    if basis == "newton":
        r = np.random.RandomState(5)
        A = (np.diag(np.linspace(1, 8, 48))
             + 0.1 * (r.randn(48, 48) + 1j * r.randn(48, 48)))
        b = r.randn(48) + 1j * r.randn(48)
        maxiter = 48
    else:
        r = np.random.RandomState(7)
        A = (np.diag(np.linspace(1, 10, 80)) + 0.1 * r.randn(80, 80)
             + 0.05j * r.randn(80, 80))
        b = r.randn(80) + 1j * r.randn(80)
        maxiter = 60
    want, wint = jax.jit(lambda v: JF.ca_gmres(
        jnp.asarray(A), v, s=4, basis=basis, tol=tol, maxiter=maxiter,
        return_internal=True))(jnp.asarray(b))
    res, internal = F.ca_gmres(_t(A), _t(b), s=4, basis=basis, tol=tol,
                               maxiter=maxiter, return_internal=True)
    _hold(res, want)
    if basis == "newton":
        np.testing.assert_allclose(_np(internal["shifts"]),
                                   np.asarray(wint["shifts"]), rtol=1e-10)
    else:
        for g, w in zip(internal["ellipse"], wint["ellipse"]):
            assert complex(g) == pytest.approx(complex(w), rel=1e-10)
    assert _true_rel(A, b, res.x) <= rel


def test_modified_leja_is_the_jax_ordering():
    from krypy_tpu.functional import sstep as JS

    ev = np.array([3.0, 1.0 + 2.0j, 1.0 - 2.0j, -4.0, 0.5])
    out = F.modified_leja(ev)
    assert out[0] == -4.0
    i = int(np.argmax(out.imag > 0))
    assert out[i + 1] == np.conj(out[i])
    assert sorted(out.tolist(), key=abs) == sorted(ev.tolist(), key=abs)
    rng = np.random.default_rng(0)
    for k in (1, 5, 12, 33):
        pts = rng.standard_normal(k) + 1j * rng.standard_normal(k)
        pts = np.concatenate([pts, pts.conj(), rng.standard_normal(3)])
        np.testing.assert_array_equal(F.modified_leja(pts),
                                      JS.modified_leja(pts))
        for s in (1, 2, 3, 4, 8):
            np.testing.assert_array_equal(S._leja_head(pts, s),
                                          JS._leja_head(pts, s))
            for real_np in (np.float32, np.float64):
                head = pts[:max(s - 1, 1)]
                for g, w in zip(S._ordered_shift_arrays(head, s, real_np),
                                JS._ordered_shift_arrays(head, s, real_np)):
                    np.testing.assert_array_equal(g, w)


def test_newton_shifts_match_jax():
    JF, _ = _J()
    r = np.random.RandomState(11)
    A = np.diag(np.linspace(1, 10, 80)) + 0.05 * r.randn(80, 80)
    b = r.randn(80)
    for s, warmup in ((4, None), (4, 12), (10, None)):
        want = JF.newton_shifts(jnp.asarray(A), jnp.asarray(b), s,
                                warmup=warmup)
        got = F.newton_shifts(_t(A), _t(b), s, warmup=warmup)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_ca_gmres_zero_rhs_as_jax():
    JF, _ = _J()
    want = jax.jit(lambda v: JF.ca_gmres(jnp.eye(16), v, s=2,
                                         maxiter=8))(jnp.zeros(16))
    res = F.ca_gmres(torch.eye(16, dtype=torch.float64),
                     torch.zeros(16, dtype=torch.float64), s=2, maxiter=8)
    _hold(res, want)
    assert int(res.status) == 0
    assert float(torch.linalg.vector_norm(res.x)) == 0.0


def test_ca_gmres_shift_tuple_matches_host_shifts():
    """The pre-ordered ``(theta_re, theta_im)`` form, as host arrays and
    as tensors, gives the iterates of the host-ordered path (the port's
    counterpart of tests/test_sstep.py:322), and both the JAX package's
    iterates."""
    JF, _ = _J()
    r = np.random.RandomState(11)
    A = np.diag(np.linspace(1, 10, 80)) + 0.05 * r.randn(80, 80)
    b = r.randn(80)
    ev = F.newton_shifts(_t(A), _t(b), 4)
    kw = dict(s=4, basis="newton", tol=1e-12, maxiter=40)
    host = F.ca_gmres(_t(A), _t(b), shifts=ev, **kw)
    ordered = S._leja_head(F.modified_leja(ev), 4)
    for pair in ((ordered.real, ordered.imag),
                 (torch.tensor(ordered.real), torch.tensor(ordered.imag))):
        tup = F.ca_gmres(_t(A), _t(b), shifts=pair, **kw)
        assert int(tup.status) == int(host.status)
        np.testing.assert_array_equal(_np(tup.x), _np(host.x))
    want = jax.jit(lambda v: JF.ca_gmres(
        jnp.asarray(A), v, shifts=(jnp.asarray(ordered.real),
                                   jnp.asarray(ordered.imag)), **kw))(
        jnp.asarray(b))
    _hold(host, want)
    with pytest.raises(ValueError, match="shape"):
        F.ca_gmres(_t(A), _t(b), shifts=(ordered.real[:3], ordered.imag[:3]),
                   **kw)


def test_ca_gmres_basis_dtype_bf16_matches_jax():
    """bfloat16 basis storage, float32 accumulation, real systems only:
    ``niter`` and status as the JAX package's, the first block to 1e-3
    relative, and the floor (eps(bfloat16) kappa, reached in the second
    block: past it the history is the basis' rounding) within a factor of
    10."""
    JF, _ = _J()
    r = np.random.RandomState(0)
    A = (np.diag(np.linspace(1, 10, 128)) + 0.05 * r.randn(128, 128)).astype(
        np.float32)
    b = r.randn(128).astype(np.float32)
    want = jax.jit(lambda v: JF.ca_gmres(jnp.asarray(A), v, s=4, tol=1e-3,
                                         maxiter=40,
                                         basis_dtype=jnp.bfloat16))(
        jnp.asarray(b))
    res = F.ca_gmres(_t(A), _t(b), s=4, tol=1e-3, maxiter=40,
                     basis_dtype=torch.bfloat16)
    assert int(res.niter) == int(want.niter)
    assert int(res.status) == int(want.status)
    _hold_f32(res, want)
    with pytest.raises(ValueError, match="real systems"):
        F.ca_gmres(_t(A.astype(np.complex64)), _t(b.astype(np.complex64)),
                   basis_dtype=torch.bfloat16)


def test_ca_gmres_unknown_basis_raises():
    with pytest.raises(ValueError, match="basis"):
        F.ca_gmres(torch.eye(4, dtype=torch.float64),
                   torch.ones(4, dtype=torch.float64), basis="legendre")


def test_ca_gmres_rank_deficient_panel_stays_finite_as_jax():
    JF, jops = _J()
    n = 256
    h = 1.0 / (n + 1)
    b = np.sin(np.arange(1, n + 1) * np.pi * h).astype(np.float32)
    lap = jops.poisson_1d(n)
    want = jax.jit(lambda v: JF.ca_gmres(lap, v, tol=1e-6, maxiter=16, s=4,
                                         basis="newton"))(jnp.asarray(b))
    r = F.ca_gmres(ops.poisson_1d(n, device="cpu"), _t(b), tol=1e-6,
                   maxiter=16, s=4, basis="newton")
    rn = _np(r.resnorms)
    assert np.all(np.isfinite(_np(r.x)))
    finite = rn[np.isfinite(rn)]
    assert finite.size > 1 and float(np.nanmin(rn)) < 1e-2
    wn = np.asarray(want.resnorms)
    assert np.isfinite(wn).sum() == finite.size
    assert float(np.nanmin(rn)) <= F32_FLOOR_FACTOR * float(np.nanmin(wn))


# ---------------------------------------------------------------------------
# restarted_ca_gmres
# ---------------------------------------------------------------------------


def _hold_restarted(got, want, x_rtol=X_RTOL):
    """The restart loop's concatenated history: same length, entries
    to ``HIST_ATOL``; status and the iterate as :func:`_hold`."""
    assert int(got.status) == int(want.status)
    hw, hg = np.asarray(want.resnorms), _np(got.resnorms)
    assert hg.shape == hw.shape
    np.testing.assert_allclose(hg, hw, rtol=0, atol=HIST_ATOL)
    xw = np.asarray(want.x)
    np.testing.assert_allclose(_np(got.x), xw, rtol=0,
                               atol=x_rtol * np.abs(xw).max())


@pytest.mark.parametrize("basis", ["newton", "chebyshev"])
def test_restarted_ca_gmres_matches_jax_and_caches_shifts(basis, monkeypatch):
    """tests/test_sstep.py:205 and :382 (48^2 Poisson, s = 4 Newton and
    s = 8 Chebyshev, restarts of 40 steps): the concatenated histories and
    iterates as the JAX package's; a second right-hand side takes the
    operator's cached shifts (no warm-up)."""
    JF, jops = _J()
    s = 4 if basis == "newton" else 8
    kw = dict(s=s, maxiter=40, max_restarts=30, tol=1e-9, basis=basis)
    want = JF.restarted_ca_gmres(jops.poisson_2d(48), jnp.ones(48 * 48),
                                 **kw)
    lap = _poisson(48)
    b = torch.ones(48 * 48, dtype=torch.float64)
    S._CA_SHIFTS_CACHE.clear()
    res = F.restarted_ca_gmres(lap, b, **kw)
    _hold_restarted(res, want)
    assert int(res.status) == 0
    assert float(torch.linalg.vector_norm(b - lap(res.x))
                 / torch.linalg.vector_norm(b)) <= 1e-8
    hist = _np(res.resnorms)
    assert len(hist) > 11 and hist[-1] <= 1e-9
    assert len(S._CA_SHIFTS_CACHE) == 1
    calls = []
    monkeypatch.setattr(S, "newton_shifts",
                        lambda *a, **k: calls.append(1))
    res2 = F.restarted_ca_gmres(lap, 1.5 * b, **kw)
    assert int(res2.status) == 0 and not calls


@pytest.mark.parametrize("refresh", [True, False])
def test_restarted_ca_gmres_shift_refresh_matches_jax(refresh):
    """tests/test_sstep.py:265: planted small outliers, s = 8, with and
    without ``refresh_shifts``; the refreshed run no worse than the
    static one (the reference's assertion).  The iterate to ``1e-9`` of
    its largest entry: eleven cycles of s = 8 blocks on eigenvalues down
    to 1e-4 (the largest entries ~3e3)."""
    JF, jops = _J()
    r = np.random.RandomState(5)
    d = np.linspace(1.0, 50.0, 400)
    d[:4] = [1e-4, 5e-4, 2e-3, 1e-2]
    b = r.randn(400)
    kw = dict(s=8, maxiter=40, max_restarts=10, tol=1e-10)
    want = JF.restarted_ca_gmres(jops.diagonal(jnp.asarray(d)),
                                 jnp.asarray(b), refresh_shifts=refresh,
                                 **kw)
    A = ops.diagonal(_t(d))
    res = F.restarted_ca_gmres(A, _t(b), refresh_shifts=refresh, **kw)
    _hold_restarted(res, want, x_rtol=1e-9)
    other = F.restarted_ca_gmres(A, _t(b), refresh_shifts=not refresh, **kw)

    def true_rel(x):
        return float(np.linalg.norm(b - d * _np(x)) / np.linalg.norm(b))

    fresh, static = (res, other) if refresh else (other, res)
    assert np.isfinite(true_rel(fresh.x))
    assert true_rel(fresh.x) <= 1.1 * true_rel(static.x)


def test_restarted_ca_gmres_monomial_and_shift_forms():
    """The monomial basis needs no shifts; explicit estimates and the
    pre-ordered tuple give the same cycles."""
    r = np.random.RandomState(3)
    A = np.diag(np.linspace(1, 10, 60)) + 0.05 * r.randn(60, 60)
    b = _t(r.randn(60))
    mono = F.restarted_ca_gmres(_t(A), b, s=4, maxiter=12, max_restarts=8,
                                tol=1e-10, basis="monomial")
    assert int(mono.status) == 0
    ev = np.linalg.eigvals(A)
    kw = dict(s=4, maxiter=12, max_restarts=8, tol=1e-10,
              refresh_shifts=False)
    a = F.restarted_ca_gmres(_t(A), b, shifts=ev, **kw)
    tre, tim = S._ordered_shift_arrays(ev, 4, np.float64)
    t = F.restarted_ca_gmres(_t(A), b, shifts=(tre, tim), **kw)
    np.testing.assert_array_equal(_np(a.x), _np(t.x))
    np.testing.assert_array_equal(_np(a.resnorms), _np(t.resnorms))


def test_sstep_entry_points_put_numpy_on_the_card():
    """A numpy right-hand side goes to ``"cuda"``: where torch sees no
    card the solvers raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the numpy input goes there")
    A = torch.eye(8, dtype=torch.float64)
    for call in (lambda: F.ca_cg(A, np.ones(8)),
                 lambda: F.ca_gmres(A, np.ones(8)),
                 lambda: F.newton_shifts(A, np.ones(8), 2),
                 lambda: F.restarted_ca_gmres(A, np.ones(8))):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
