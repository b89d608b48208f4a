"""The port's unpadded multigrid lane (krypy_tpu_torch.ops) against
krypy_tpu.ops on the same numpy inputs: one V-cycle application of
``multigrid_poisson_preconditioner`` without ``pad_cols``, the exact
coarse solve ``poisson_dst_solver`` and the red-black
``ssor_poisson_preconditioner``; and the padded lane's ``nu_pre`` of 0 and
1 and ``coarse_sweeps=0`` held to the unpadded lane; and K1's coarse
form (``kernels.stencil.stencil5_coarse``, its plain version on the CPU)
against the JAX package's coarse solve on both layouts.

Tolerances: float64 ``rtol = 1e-12`` relative to the largest output entry
(the two packages sum the same terms in the same order; the FFT of the
DST differs in its last bits); ``A (M b) = b`` of the DST solver to
1e-10; the V-cycle's symmetry ``<x, M y> = <M x, y>`` to 1e-12; float32
against the JAX Pallas lane ``atol = 5e-6 * max(1, max|want|)``, the
bound of tests/test_torch_ops.py's padded V-cycle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu import ops as jops
from krypy_tpu_torch import interop, ops
from krypy_tpu_torch.kernels import stencil as tst

torch.set_num_threads(1)


def _t(a):
    return interop.from_numpy(np.asarray(a), "cpu")


def _close(got, want, rtol=1e-12):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _rhs(nx, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(nx * nx).astype(dtype)


@pytest.mark.parametrize("coarse_solver", [None, "dst"])
@pytest.mark.parametrize("nu_pre", [0, 1, 2])
@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
@pytest.mark.parametrize("nx", [31, 63, 127])
def test_vcycle_matches_jax(nx, smoother, nu_pre, coarse_solver):
    """One unpadded V-cycle, float64, every smoother and presmoothing
    count, the sweep and the DST coarse solve, ``scale != 1``."""
    kw = dict(nu_pre=nu_pre, nu_post=2, coarsest=7, coarse_sweeps=5,
              coarse_solver=coarse_solver, smoother=smoother, scale=2.5)
    Mj = jops.multigrid_poisson_preconditioner(nx, **kw)
    Mt = ops.multigrid_poisson_preconditioner(nx, device="cpu", **kw)
    assert Mt.shape == Mj.shape
    r = _rhs(nx, nx + nu_pre)
    got = interop.to_numpy(Mt(_t(r)))
    assert got.dtype == np.float64
    _close(got, np.asarray(Mj(jnp.asarray(r))))


@pytest.mark.parametrize("coarse_sweeps", [0, 1, 6])
def test_vcycle_coarse_sweeps_match_jax(coarse_sweeps):
    """The coarse level's sweep count, rbgs rounding up to (forward,
    reverse) pairs, and none at all."""
    nx = 31
    for smoother in ("jacobi", "rbgs"):
        kw = dict(coarsest=15, coarse_sweeps=coarse_sweeps,
                  smoother=smoother, nu_post=1)
        r = _rhs(nx, 3)
        _close(interop.to_numpy(ops.multigrid_poisson_preconditioner(
                   nx, device="cpu", **kw)(_t(r))),
               np.asarray(jops.multigrid_poisson_preconditioner(nx, **kw)(
                   jnp.asarray(r))))


def test_vcycle_callable_coarse_solver_matches_jax():
    nx = 31
    kw = dict(coarsest=7, coarse_sweeps=5)
    Mt = ops.multigrid_poisson_preconditioner(
        nx, coarse_solver=ops.poisson_dst_solver(7, device="cpu"),
        device="cpu", **kw)
    Mj = jops.multigrid_poisson_preconditioner(
        nx, coarse_solver=jops.poisson_dst_solver(7), **kw)
    r = _rhs(nx, 4)
    _close(interop.to_numpy(Mt(_t(r))), np.asarray(Mj(jnp.asarray(r))))


@pytest.mark.parametrize("nx,ny", [(7, 7), (15, 9), (31, 31)])
def test_dst_solver_matches_jax_and_inverts_poisson(nx, ny):
    b = np.random.default_rng(nx * ny).standard_normal(nx * ny)
    St = ops.poisson_dst_solver(nx, ny, device="cpu")
    assert St.shape == (nx * ny, nx * ny)
    x = St(_t(b))
    _close(interop.to_numpy(x),
           np.asarray(jops.poisson_dst_solver(nx, ny)(jnp.asarray(b))))
    # an exact inverse of the Dirichlet Laplacian
    Ax = ops.poisson_2d(nx, ny, device="cpu")(x)
    np.testing.assert_allclose(interop.to_numpy(Ax), b, rtol=0,
                               atol=1e-10 * np.max(np.abs(b)))


@pytest.mark.parametrize("omega,sweeps", [(1.0, 1), (1.3, 2)])
def test_ssor_matches_jax(omega, sweeps):
    nx = 31
    r = _rhs(nx, 5)
    got = ops.ssor_poisson_preconditioner(nx, omega=omega, sweeps=sweeps,
                                          device="cpu")(_t(r))
    want = jops.ssor_poisson_preconditioner(nx, omega=omega,
                                            sweeps=sweeps)(jnp.asarray(r))
    _close(interop.to_numpy(got), np.asarray(want))


def test_vcycle_cuda_lane_matches_pallas():
    """float32 at nx = 511: the port's ``impl="cuda"`` lane (K1's plain
    version on the CPU at every level) against the JAX Pallas lane, its
    stencil interpreted on the 511 level."""
    nx = 511
    kw = dict(coarsest=127, coarse_sweeps=2, nu_post=2)
    Mj = jops.multigrid_poisson_preconditioner(nx, impl="pallas", **kw)
    Mt = ops.multigrid_poisson_preconditioner(nx, impl="cuda", device="cpu",
                                              **kw)
    r = _rhs(nx, 23, np.float32)
    want = np.asarray(Mj(jnp.asarray(r)))
    got = interop.to_numpy(Mt(_t(r)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want,
                               atol=5e-6 * max(1.0, float(np.max(np.abs(
                                   want)))))


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
def test_vcycle_is_symmetric(smoother):
    """``<x, M y> = <M x, y>``: the V-cycle is a symmetric operator (the
    post-smoother mirrors the pre-smoother), which CG needs of a
    preconditioner."""
    nx = 63
    M = ops.multigrid_poisson_preconditioner(nx, coarsest=7, coarse_sweeps=6,
                                             smoother=smoother, device="cpu")
    rng = np.random.default_rng(8)
    x, y = _t(rng.standard_normal(nx * nx)), _t(rng.standard_normal(nx * nx))
    lhs, rhs = float(torch.dot(x, M(y))), float(torch.dot(M(x), y))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), abs(rhs))


@pytest.mark.parametrize("kw", [dict(nu_pre=1), dict(nu_pre=0),
                                dict(coarse_sweeps=0),
                                dict(nu_pre=1, coarse_sweeps=1)],
                         ids=["nu_pre1", "nu_pre0", "coarse0", "nu1_coarse1"])
@pytest.mark.parametrize("nx", [15, 63])
def test_padded_few_sweeps_match_unpadded(nx, kw):
    """The padded lane with fewer than two presmoothing sweeps or no
    coarse sweep runs as many sweeps as the unpadded lane (the JAX padded
    lane runs one more: ROADMAP.md queue C), so the two agree on the
    logical region as tests/test_padded.py holds them (coefficient-form
    rounding only); the pads stay zero."""
    kw = {"coarsest": 7, "coarse_sweeps": 12, **kw}
    mg = ops.multigrid_poisson_preconditioner(nx, device="cpu", **kw)
    mgp = ops.multigrid_poisson_preconditioner(nx, pad_cols=True,
                                               device="cpu", **kw)
    r = _rhs(nx, 9)
    got = mgp(ops.pad_grid_vec(_t(r), nx, nx))
    u = interop.to_numpy(got).reshape(mgp.nx_pad, mgp.ny_pad)
    assert np.all(u[nx:, :] == 0.0) and np.all(u[:, nx:] == 0.0)
    np.testing.assert_allclose(
        interop.to_numpy(ops.unpad_grid_vec(got, nx, nx)),
        interop.to_numpy(mg(_t(r))), rtol=1e-12, atol=1e-12)


def test_padded_cuda_lane_few_sweeps_match_unpadded():
    """The same at nx = 511 on the padded ``impl="cuda"`` lane (the
    kernels' plain versions on the CPU), float32, ``nu_pre = 1``."""
    nx = 511
    kw = dict(nu_pre=1, coarsest=255, coarse_sweeps=2, impl="cuda",
              device="cpu")
    mg = ops.multigrid_poisson_preconditioner(nx, **kw)
    mgp = ops.multigrid_poisson_preconditioner(nx, pad_cols=True, **kw)
    r = _t(_rhs(nx, 10, np.float32))
    want = interop.to_numpy(mg(r))
    got = interop.to_numpy(ops.unpad_grid_vec(
        mgp(ops.pad_grid_vec(r, nx, nx)), nx, nx))
    np.testing.assert_allclose(got, want,
                               atol=5e-6 * max(1.0, float(np.max(np.abs(
                                   want)))))


def test_level_operators_match_jax():
    """``_lap2d_grid``, ``_restrict_fw`` and ``_prolong_bilinear`` on a
    15-grid, and the gallery's ``readme_diag`` and ``poisson_1d``."""
    rng = np.random.default_rng(12)
    u, c = rng.standard_normal((15, 15)), rng.standard_normal((7, 7))
    h2 = (1.0 / 16) ** 2
    _close(interop.to_numpy(ops._lap2d_grid(_t(u), h2)),
           np.asarray(jops._lap2d_grid(jnp.asarray(u), h2)))
    _close(interop.to_numpy(ops._restrict_fw(_t(u))),
           np.asarray(jops._restrict_fw(jnp.asarray(u))))
    _close(interop.to_numpy(ops._prolong_bilinear(_t(c), 15)),
           np.asarray(jops._prolong_bilinear(jnp.asarray(c), 15)))
    x = rng.standard_normal(100)
    for name in ("readme_diag", "poisson_1d"):
        At = getattr(ops, name)(100, device="cpu")
        Aj = getattr(jops, name)(100)
        assert At.shape == Aj.shape
        np.testing.assert_array_equal(interop.to_numpy(At.diag),
                                      np.asarray(Aj.diag))
        _close(interop.to_numpy(At(_t(x))), np.asarray(Aj(jnp.asarray(x))))


def test_multigrid_masks_are_built_once(monkeypatch):
    """The rbgs colour masks are made when the operator is built, one pair
    per level, and never while it is applied."""
    calls = []
    made = ops._checkerboard
    monkeypatch.setattr(ops, "_checkerboard",
                        lambda *a: calls.append(a[:2]) or made(*a))
    M = ops.multigrid_poisson_preconditioner(63, coarsest=7, smoother="rbgs",
                                             device="cpu")
    assert [n for n, _ in calls] == [63, 31, 15, 7]
    M(torch.ones(63 * 63, dtype=torch.float64))
    assert len(calls) == 4


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("sweeps", [1, 2, 59, 60])
@pytest.mark.parametrize("n", [7, 31])
@pytest.mark.parametrize("pad", [False, True], ids=["unpadded", "padded"])
def test_coarse_form_matches_jax(pad, n, sweeps, dtype):
    """K1's coarse form (its plain version on the CPU) against the JAX
    package's coarse solve: ``multigrid_poisson_preconditioner(n,
    coarsest=n, coarse_sweeps=k)``, whose whole V-cycle is the coarsest
    level's damped-Jacobi sweeps (unpadded: ``k`` sweeps from zero;
    padded: ``u = w r`` and ``k - 1`` sweeps); and the port's own
    V-cycle built alike on both lanes (``impl="cuda"`` reaches the coarse
    form in float32).  float64 to 1e-12; float32 ``atol = max(2e-7
    max|want|, 4 x the plain version's own float32 error against
    float64)``."""
    kw = dict(coarsest=n, coarse_sweeps=sweeps, pad_cols=pad)
    R, P = (ops.pad_rows_width(n), ops.pad_cols_width(n)) if pad else (n, n)
    rng = np.random.default_rng(n * 100 + sweeps)
    buf = np.zeros((R, P))
    buf[:n, :n] = rng.standard_normal((n, n))
    r = buf.reshape(-1)
    want = np.asarray(jops.multigrid_poisson_preconditioner(n, **kw)(
        jnp.asarray(r.astype(dtype))))
    h2 = (1.0 / (n + 1)) ** 2

    def coarse(dt):
        return interop.to_numpy(tst.stencil5_coarse(
            _t(r.astype(dt)), nx=R, ny=P, coeffs=ops._lap_coeffs(h2),
            w=0.8 / (4.0 / h2), sweeps=sweeps, ncols=n, nrows=n))

    got = [coarse(dtype)]
    got += [interop.to_numpy(ops.multigrid_poisson_preconditioner(
        n, impl=impl, device="cpu", **kw)(_t(r.astype(dtype))))
        for impl in ("cuda", "torch")]
    if dtype == np.float64:
        for g in got:
            _close(g, want)
        return
    own = float(np.max(np.abs(got[0].astype(np.float64) - coarse(
        np.float64))))
    atol = max(2e-7 * float(np.max(np.abs(want))), 4.0 * own)
    for g in got:
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, want, rtol=0, atol=atol)
