"""The port's Newton-Krylov (krypy_tpu_torch.functional.newton_krylov),
its nonlinear-Schrödinger problem (ops.nls_residual_2d,
ops.nls_jacobian_sequence), K1's forward-mode rule and BASELINE config 5
against the JAX package on the same numpy inputs.

Tolerances and why:
- Newton on tests/test_newton.py's problems in float64: equal step counts
  and status; the first two residual norms to 1e-9 relative, the inner
  counts of the first two solves equal; from the third step on, rounding
  steers both packages: on the 200-point Bratu problem the JAX package's
  own third residual moves by up to 3.5% and its fourth inner count over
  102-105 when x0 changes by 1e-16 (ROADMAP.md queue C), so those are
  held within 5% and 3 iterations; roots to 1e-8 relative, as
  tests/test_newton.py holds the JAX package to scipy.  One Newton step
  from the same state (the JAX iterate handed over through
  ``interop.from_numpy``) agrees to 1e-9.
- K1's rule: ``torch.func.jvp`` of the port's ``F`` (``impl="cuda"``: K1
  through its Function, the plain version inside on the CPU) against
  ``jax.jvp`` of the JAX ``F``, float64 to 1e-12 relative, float32 to
  2e-6 of the largest entry (the stencil's grouped form against the JAX
  formula).
- Config 5 at suite.py's small size 24^2 (float32) on both lanes against
  benchmarks/suite.py's function: equal Newton steps and inner counts,
  both converged, the float32 floor to 5% (two float32 residual norms).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu_torch import functional as F, interop, ops, suite
from krypy_tpu_torch.kernels import stencil as kst

torch.set_num_threads(1)

_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_suite():
    spec = importlib.util.spec_from_file_location(
        "krypy_benchmarks_suite", _ROOT / "benchmarks" / "suite.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bratu(n=200, lam=3.0):
    h = 1.0 / (n + 1)

    def Fj(u):
        upad = jnp.pad(u, 1)
        return (upad[2:] - 2 * u + upad[:-2]) / h**2 + lam * jnp.exp(u)

    def Ft(u):
        upad = torch.nn.functional.pad(u, (1, 1))
        return (upad[2:] - 2 * u + upad[:-2]) / h**2 + lam * torch.exp(u)

    return Fj, Ft, n


def _hold(rt, rj, tol_f0):
    """The port's Newton run against the JAX package's (module docstring)."""
    assert rt.niter == rj.niter and rt.status == rj.status
    ht, hj = rt.resnorms, np.asarray(rj.resnorms)
    assert ht.shape == hj.shape
    np.testing.assert_allclose(ht[:2], hj[:2], rtol=1e-9)
    np.testing.assert_allclose(ht[2:-1], hj[2:-1], rtol=0.05)
    if rt.status == F.CONVERGED:
        assert ht[-1] <= tol_f0 and hj[-1] <= tol_f0
    it, ij = rt.inner_history, np.asarray(rj.inner_history)
    np.testing.assert_array_equal(it[:2], ij[:2])
    assert np.all(np.abs(it - ij) <= 3)
    assert rt.inner_history.shape[0] == rt.inner_walls.shape[0] == rt.niter


@pytest.mark.parametrize("recycle", [0, 3])
def test_bratu_matches_jax(recycle):
    Fj, Ft, n = _bratu()
    rj = JF.newton_krylov(Fj, jnp.zeros(n, jnp.float64), tol=1e-10,
                          inner_maxiter=200, recycle=recycle)
    rt = F.newton_krylov(Ft, torch.zeros(n, dtype=torch.float64), tol=1e-10,
                         inner_maxiter=200, recycle=recycle)
    assert rt.status == F.CONVERGED and rt.niter <= 6
    _hold(rt, rj, 1e-10 * rt.resnorms[0])
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)


def test_bratu_rounding_witness():
    """The witness behind ``_hold``'s tolerances from the third step on
    (ROADMAP.md queue C): the JAX package's own run from x0 = +-1e-16
    instead of zeros moves ||F_3|| by more than 1% and the fourth solve's
    inner count."""
    Fj, _, n = _bratu()
    runs = [JF.newton_krylov(Fj, jnp.full(n, eps, jnp.float64), tol=1e-10,
                             inner_maxiter=200) for eps in (1e-16, -1e-16)]
    f3 = [float(np.asarray(r.resnorms)[3]) for r in runs]
    assert abs(f3[0] - f3[1]) > 0.01 * f3[0]
    assert int(runs[0].inner_history[3]) != int(runs[1].inner_history[3])


def test_bratu_quadratic_convergence_and_recycling_gain():
    Fj, Ft, n = _bratu()
    plain = F.newton_krylov(Ft, torch.zeros(n, dtype=torch.float64),
                            tol=1e-10, inner_maxiter=200)
    h = plain.resnorms
    ratios = h[1:] / h[:-1]
    assert ratios[-1] < 0.1 * ratios[-2]
    rec = F.newton_krylov(Ft, torch.zeros(n, dtype=torch.float64),
                          tol=1e-10, inner_maxiter=200, recycle=3)
    assert rec.inner_iters < plain.inner_iters


def test_one_step_from_the_jax_iterate():
    """The JAX package's iterate after two steps, handed to the port: one
    more Newton step in both packages from the same state."""
    Fj, Ft, n = _bratu()
    r2 = JF.newton_krylov(Fj, jnp.zeros(n, jnp.float64), tol=1e-10,
                          maxiter=2, inner_maxiter=200)
    x2 = np.asarray(r2.x)
    sj = JF.newton_krylov(Fj, jnp.asarray(x2), tol=1e-10, maxiter=1,
                          inner_maxiter=200)
    st = F.newton_krylov(Ft, interop.from_numpy(x2, "cpu"), tol=1e-10,
                         maxiter=1, inner_maxiter=200)
    np.testing.assert_array_equal(st.inner_history, sj.inner_history)
    np.testing.assert_allclose(st.resnorms, np.asarray(sj.resnorms),
                               rtol=1e-9)
    xj = np.asarray(sj.x)
    assert np.linalg.norm(interop.to_numpy(st.x) - xj) <= \
        1e-9 * np.linalg.norm(xj)


def test_line_search_matches_jax():
    n = 100
    h = 1.0 / (n + 1)

    def Fj(u):
        upad = jnp.pad(u, 1)
        return (upad[2:] - 2 * u + upad[:-2]) / h**2 + 3.0 * jnp.exp(u)

    def Ft(u):
        upad = torch.nn.functional.pad(u, (1, 1))
        return (upad[2:] - 2 * u + upad[:-2]) / h**2 + 3.0 * torch.exp(u)

    kw = dict(tol=1e-9, inner_maxiter=300)
    r = F.newton_krylov(Ft, torch.full((n,), 2.0, dtype=torch.float64),
                        maxiter=80, **kw)
    rj = JF.newton_krylov(Fj, jnp.full(n, 2.0, jnp.float64), maxiter=80,
                          **kw)
    assert r.status == F.CONVERGED == rj.status
    np.testing.assert_allclose(r.resnorms[:2], np.asarray(rj.resnorms)[:2],
                               rtol=1e-9)
    x0 = torch.full((n,), 4.0, dtype=torch.float64)
    pure = F.newton_krylov(Ft, x0, maxiter=40, line_search=False, **kw)
    ls = F.newton_krylov(Ft, x0, maxiter=40, **kw)
    assert pure.resnorms[-1] > 10 * pure.resnorms[0]
    assert ls.resnorms[-1] < ls.resnorms[0]
    lsj = JF.newton_krylov(Fj, jnp.full(n, 4.0, jnp.float64), maxiter=40,
                           **kw)
    np.testing.assert_allclose(ls.resnorms[:3], np.asarray(lsj.resnorms)[:3],
                               rtol=1e-9)


def test_budget_honesty():
    _, Ft, n = _bratu()
    r = F.newton_krylov(Ft, torch.zeros(n, dtype=torch.float64), tol=1e-12,
                        maxiter=1, inner_maxiter=5)
    assert r.status == F.MAXITER
    assert bool(torch.all(torch.isfinite(r.x)))


def test_linear_problem_one_step_matches_jax():
    d = np.linspace(1.0, 10.0, 50)
    b = np.random.default_rng(0).standard_normal(50)
    kw = dict(tol=1e-12, eta_max=1e-12, inner_maxiter=60)
    rj = JF.newton_krylov(lambda u: jnp.asarray(d) * u - jnp.asarray(b),
                          jnp.zeros(50, jnp.float64), **kw)
    rt = F.newton_krylov(lambda u: torch.tensor(d) * u - torch.tensor(b),
                         torch.zeros(50, dtype=torch.float64), **kw)
    assert rt.status == F.CONVERGED and rt.niter == rj.niter <= 2
    np.testing.assert_array_equal(rt.inner_history, rj.inner_history)
    np.testing.assert_allclose(rt.x.numpy(), b / d, rtol=1e-10)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10)


# ---------------------------------------------------------------------------
# the nonlinear-Schrödinger problem and K1's forward-mode rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nx", [16, 13])
def test_nls_residual_and_jvp_match_jax(impl, dtype, nx):
    """``F`` and ``torch.func.jvp`` of it (through K1's Function with
    ``impl="cuda"``) against ``jax.jvp`` of the JAX package's ``F``."""
    Fj, uj = jops.nls_residual_2d(nx, kappa=1.0, lam=25.0, amplitude=3.0,
                                  dtype=getattr(jnp, dtype))
    Ft, ut = ops.nls_residual_2d(nx, kappa=1.0, lam=25.0, amplitude=3.0,
                                 dtype=getattr(torch, dtype), impl=impl,
                                 device="cpu")
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    state = interop.nls_to_numpy(Ft, ut)
    want = interop.nls_to_numpy(Fj, uj)
    tol = 1e-12 if dtype == "float64" else 2e-6
    g_scale = np.abs(want["g"]).max()
    assert np.abs(state["g"] - want["g"]).max() <= tol * g_scale
    rng = np.random.default_rng(nx)
    x = (rng.standard_normal(nx * nx)).astype(dtype)
    v = (rng.standard_normal(nx * nx)).astype(dtype)
    pj, tj = jax.jvp(Fj, (jnp.asarray(x),), (jnp.asarray(v),))
    pt, tt = torch.func.jvp(Ft, (torch.tensor(x),), (torch.tensor(v),))
    scale = np.abs(np.asarray(tj)).max()
    assert np.abs(tt.numpy() - np.asarray(tj)).max() <= tol * scale
    scale = np.abs(np.asarray(pj)).max()
    assert np.abs(pt.numpy() - np.asarray(pj)).max() <= tol * scale
    assert float(torch.linalg.vector_norm(Ft(ut))) <= 1e-3


def test_k1_rule_against_plain_jvp():
    """K1's Function against ``torch.func.jvp`` of its plain version: in
    ``x`` and ``g`` together, in ``g`` alone, nested (an affine map's
    second derivative is 0), under ``torch.autograd.forward_ad``; reverse
    mode raises."""
    nx, ny = 7, 9
    co = (4.0, -1.0, -1.2, -0.9, -1.1)
    rng = np.random.default_rng(1)
    x, v, g, gt = (torch.tensor(rng.standard_normal(nx * ny))
                   for _ in range(4))

    def k1(u, gg):
        return kst.stencil5_affine(u, gg, nx=nx, ny=ny, coeffs=co,
                                   alpha=0.3, beta=-2.0)

    def plain(u, gg):
        return kst.stencil5_affine_torch(u.reshape(nx, ny),
                                         gg.reshape(nx, ny), co, nx, ny,
                                         0.3, -2.0).reshape(-1)

    for args, tans in (((x, g), (v, gt)), ((x,), (v,))):
        fk = (lambda u: k1(u, g)) if len(args) == 1 else k1
        fp = (lambda u: plain(u, g)) if len(args) == 1 else plain
        pk, tk = torch.func.jvp(fk, args, tans)
        pp, tp = torch.func.jvp(fp, args, tans)
        torch.testing.assert_close(pk, pp, rtol=0, atol=1e-13)
        torch.testing.assert_close(tk, tp, rtol=0, atol=1e-13)
    _, tg = torch.func.jvp(lambda gg: k1(x, gg), (g,), (gt,))
    torch.testing.assert_close(tg, -2.0 * gt, rtol=0, atol=1e-15)
    second = torch.func.jvp(
        lambda u: torch.func.jvp(lambda w: k1(w, g), (u,), (v,))[1],
        (x,), (v,))[1]
    assert float(second.abs().max()) == 0.0
    import torch.autograd.forward_ad as fwAD

    want = torch.func.jvp(lambda u: plain(u, g), (x,), (v,))[1]
    with fwAD.dual_level():
        out = k1(fwAD.make_dual(x, v), g)
        torch.testing.assert_close(fwAD.unpack_dual(out).tangent, want,
                                   rtol=0, atol=1e-13)
    with pytest.raises(NotImplementedError, match="no reverse mode.*AT="):
        k1(x.clone().requires_grad_(), g).sum().backward()
    # the plain path: no transform, no grad, no Function
    torch.testing.assert_close(k1(x, g), plain(x, g), rtol=0, atol=0)


def test_nls_jacobian_sequence_matches_jax():
    seq_t = ops.nls_jacobian_sequence(40, n_sys=3, device="cpu")
    seq_j = jops.nls_jacobian_sequence(40, n_sys=3)
    x = np.random.default_rng(2).standard_normal(40)
    for At, Aj in zip(seq_t, seq_j):
        np.testing.assert_allclose(At(torch.tensor(x)).numpy(),
                                   np.asarray(Aj(jnp.asarray(x))),
                                   rtol=1e-13)
        np.testing.assert_allclose(At.diag.numpy(), np.asarray(Aj.diag),
                                   rtol=1e-15)
        np.testing.assert_allclose(At.rebuild(At.params)(torch.tensor(x)),
                                   At(torch.tensor(x)), rtol=0, atol=0)
    assert seq_t[0].family == seq_t[1].family


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_config5_matches_benchmarks_suite(impl):
    """BASELINE config 5 at benchmarks/suite.py's small size, on both
    lanes (``impl="cuda"`` runs K1's plain version inside its Function
    here), against the JAX package's own pipeline."""
    want = _config5_jax()
    got = suite.config5_nls_newton_recycling(24, impl=impl, device="cpu")
    assert got["converged"] and want["converged"]
    assert got["newton_steps"] == want["newton_steps"] == 5
    assert got["inner_iters"] == want["inner_iters"]
    assert got["selected_widths"] is None
    assert abs(got["eval_floor"] - want["eval_floor"]) <= \
        0.05 * want["eval_floor"]
    assert got["fnorm_final"] <= got["tol"] * max(got["f0"], 1.0)
    assert len(got["walls_s"]) == got["newton_steps"]
    # every F call and every Jacobian action counted: the residual, 5
    # trial steps and the 4 floor probes besides the Jacobian actions
    assert got["f_calls"] - got["jvp_calls"] == 10


_C5 = {}


def _config5_jax():
    if "want" not in _C5:
        _C5["want"] = _jax_suite().config5_nls_newton_recycling(24)
    return _C5["want"]
