"""The port's AutoRecyclingGmres (krypy_tpu_torch.functional) against
krypy_tpu.functional.AutoRecyclingGmres on the cases of
tests/test_auto_recycling.py, and BASELINE config 5a (suite.py's config 6,
the auto-width variant) at suite.py's small size 24^2.

The driver chooses widths from measured walls (``_observe``), and two
runs do not share a clock.  So the comparisons never let each package
choose from its own clock: either the JAX driver's timing table ``_tau``
(and, where stated, its last solve's internals) is carried into the port
before each solve (``interop.auto_state_from_numpy``), or both drivers'
``_observe`` are fed the same recorded per-iteration walls
(``_RECORDED``: the walls of a width-w solve as ``niter * (1 + 0.1 w)``
ms).  Then the chosen widths must be equal, the iteration counts equal,
and the predicted steps (from each package's own float32 Ritz values)
within 1e-3 relative.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krypy_tpu import functional as JF, ops as jops
from krypy_tpu.functional import deflation as jdefl
from krypy_tpu_torch import functional as F, interop, ops, suite
from krypy_tpu_torch.functional import deflation as defl

torch.set_num_threads(1)

_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _outlier_sequence(n=300, n_sys=5, n_outliers=4):
    base = np.linspace(1, 2, n)
    base[:n_outliers] = np.logspace(-4, -1.7, n_outliers)
    ds = [(base * (1 + 0.01 * i)).astype(np.float32) for i in range(n_sys)]
    seq_j = [jops.diagonal(jnp.asarray(d)) for d in ds]
    seq_t = [ops.diagonal(torch.tensor(d)) for d in ds]
    b = np.ones(n, np.float32)
    return seq_j, seq_t, b


def _preds_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert abs(g - w) <= 1e-3 * max(abs(w), 1.0)


def _side_by_side(auto_j, auto_t, seq_j, seq_t, b, kw):
    """Solve the sequence in both packages; before each port solve the JAX
    driver's timing table is carried into the port."""
    iters_j, iters_t = [], []
    bt = torch.tensor(b)
    for Aj, At in zip(seq_j, seq_t):
        interop.auto_state_from_numpy(
            auto_t, interop.auto_state_to_numpy(auto_j), "cpu",
            keys=("tau",))
        iters_j.append(int(auto_j.solve(Aj, jnp.asarray(b), **kw).niter))
        iters_t.append(int(auto_t.solve(At, bt, **kw).niter))
    return iters_j, iters_t


@pytest.mark.parametrize("widths", [None, (0, 4)])
def test_auto_matches_jax_on_the_outlier_sequence(widths):
    seq_j, seq_t, b = _outlier_sequence()
    n = b.shape[0]
    kw = dict(tol=1e-4, maxiter=n)
    auto_j = JF.AutoRecyclingGmres(max_vectors=4, hermitian=True,
                                   widths=widths)
    auto_t = F.AutoRecyclingGmres(max_vectors=4, hermitian=True,
                                  widths=widths)
    assert auto_t._widths == auto_j._widths
    auto_j.warmup(seq_j[0], jnp.asarray(b), **kw)
    assert auto_t.warmup(seq_t[0], torch.tensor(b), **kw) is auto_t
    iters_j, iters_t = _side_by_side(auto_j, auto_t, seq_j, seq_t, b, kw)
    assert auto_t.selected_widths == auto_j.selected_widths
    assert iters_t == iters_j
    _preds_close(auto_t.predicted_steps, auto_j.predicted_steps)
    # the JAX test's properties, on the port's own run
    assert auto_t.selected_widths[0] == 0
    assert all(w > 0 for w in auto_t.selected_widths[1:])
    assert min(iters_t[1:]) < iters_t[0]
    if widths is not None:
        assert all(w in (0, 4) for w in auto_t.selected_widths)
    for pred, actual in zip(auto_t.predicted_steps[1:], iters_t[1:]):
        assert actual <= 3 * pred + 5 and pred <= 10 * actual + 5


def test_auto_beats_narrow_fixed_width():
    _, seq_t, b = _outlier_sequence()
    n = b.shape[0]
    kw = dict(tol=1e-4, maxiter=n)
    bt = torch.tensor(b)
    auto = F.AutoRecyclingGmres(max_vectors=4, hermitian=True)
    fixed = F.RecyclingGmres(n_vectors=2, which="sm", hermitian=True)
    a_it = [int(auto.solve(op, bt, **kw).niter) for op in seq_t]
    f_it = [int(fixed.solve(op, bt, **kw).niter) for op in seq_t]
    assert sum(a_it[1:]) <= sum(f_it[1:])


def test_auto_from_the_jax_state():
    """A fresh port driver given the JAX driver's timing table AND last
    internals chooses the JAX driver's next width and basis."""
    seq_j, seq_t, b = _outlier_sequence(n_sys=3)
    n = b.shape[0]
    kw = dict(tol=1e-4, maxiter=n)
    auto_j = JF.AutoRecyclingGmres(max_vectors=4, hermitian=True)
    for Aj in seq_j[:2]:
        auto_j.solve(Aj, jnp.asarray(b), **kw)
    state = interop.auto_state_to_numpy(auto_j)
    auto_t = interop.auto_state_from_numpy(
        F.AutoRecyclingGmres(max_vectors=4, hermitian=True), state, "cpu",
        keys=("tau", "internals", "selected_widths"))
    assert auto_t.selected_widths == auto_j.selected_widths
    Uj = auto_j._next_deflation_basis(kw)
    Ut = auto_t._next_deflation_basis(kw)
    assert auto_t.selected_widths[-1] == auto_j.selected_widths[-1] > 0
    _preds_close(auto_t.predicted_steps[-1:], auto_j.predicted_steps[-1:])
    Qj, _ = np.linalg.qr(np.asarray(Uj, np.float64))
    Qt, _ = np.linalg.qr(interop.to_numpy(Ut).astype(np.float64))
    assert np.linalg.norm(Qt - Qj @ (Qj.T @ Qt), 2) <= 1e-3


def test_auto_timing_model_updates():
    _, seq_t, b = _outlier_sequence(n_sys=3)
    n = b.shape[0]
    auto = F.AutoRecyclingGmres(max_vectors=3, hermitian=True)
    auto.warmup(seq_t[0], torch.tensor(b), tol=1e-4, maxiter=n)
    for op in seq_t:
        auto.solve(op, torch.tensor(b), tol=1e-4, maxiter=n)
    assert 0 in auto._tau
    assert any(w in auto._tau for w in auto.selected_widths[1:])
    assert all(t > 0 for t in auto._tau.values())
    # the extrapolation of an unmeasured width, as the JAX driver's
    a = defl.AutoRecyclingGmres(max_vectors=4, growth=0.05)
    aj = jdefl.AutoRecyclingGmres(max_vectors=4, growth=0.05)
    for d, wall in ((0, 2.0), (2, 1.0), (0, 3.0)):
        a._observe(d, 10, wall)
        aj._observe(d, 10, wall)
    assert a._tau == aj._tau
    assert [a._tau_of(d) for d in range(5)] == \
        [aj._tau_of(d) for d in range(5)]
    with pytest.raises(ValueError):
        F.AutoRecyclingGmres(max_vectors=3, widths=(0, 7))


def test_auto_nonhermitian_falls_back_like_jax():
    """Complex Ritz values make every candidate unevaluable; both drivers
    fall back to the fixed-width extraction."""
    rng = np.random.default_rng(3)
    n = 14 * 14
    b = rng.standard_normal(n).astype(np.float32)
    opj = jops.convection_diffusion_2d(14, 14, wind=(8.0, 4.0), eps=0.05)
    opt = ops.convection_diffusion_2d(14, 14, wind=(8.0, 4.0), eps=0.05,
                                      device="cpu")
    auto_j = JF.AutoRecyclingGmres(max_vectors=3, hermitian=False)
    auto_t = F.AutoRecyclingGmres(max_vectors=3, hermitian=False)
    kw = dict(tol=1e-5, maxiter=n)
    it_j, it_t = _side_by_side(auto_j, auto_t, [opj] * 2, [opt] * 2, b, kw)
    assert auto_t.selected_widths == auto_j.selected_widths
    assert auto_t.selected_widths[0] == 0
    assert auto_t.selected_widths[1] in (0, 3)
    assert it_t[0] == it_j[0]
    assert abs(it_t[1] - it_j[1]) <= 1


# ---------------------------------------------------------------------------
# config 5a
# ---------------------------------------------------------------------------


def _RECORDED(orig):
    """``_observe`` fed the recorded per-iteration walls instead of the
    measured one."""
    def observe(self, width, niter, wall_s):
        return orig(self, width, niter, niter * 1e-3 * (1.0 + 0.1 * width))
    return observe


def test_newton_auto_recycling_integration():
    func, _ = ops.nls_residual_2d(16, kappa=1.0, lam=25.0, device="cpu")
    auto = F.AutoRecyclingGmres(max_vectors=3, hermitian=True)
    res = F.newton_krylov(func, torch.zeros(256), tol=1e-6, maxiter=15,
                          inner_maxiter=200, recycling_solver=auto,
                          warmup=True)
    assert res.converged
    assert len(auto.selected_widths) == res.niter
    assert max(res.inner_history) < 200


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_config5a_matches_benchmarks_suite(impl, monkeypatch):
    monkeypatch.setattr(jdefl.AutoRecyclingGmres, "_observe",
                        _RECORDED(jdefl.AutoRecyclingGmres._observe))
    monkeypatch.setattr(defl.AutoRecyclingGmres, "_observe",
                        _RECORDED(defl.AutoRecyclingGmres._observe))
    want = _config5a_jax()
    got = suite.config5_nls_newton_recycling(24, auto=True, impl=impl,
                                             device="cpu")
    assert got["converged"] and want["converged"]
    assert got["newton_steps"] == want["newton_steps"] == 5
    assert got["selected_widths"] == want["selected_widths"]
    assert got["inner_iters"] == want["inner_iters"]
    assert all(w in range(6) for w in got["selected_widths"])
    assert got["fnorm_final"] <= got["tol"] * max(got["f0"], 1.0)


_C5A = {}


def _config5a_jax():
    if "want" not in _C5A:
        spec = importlib.util.spec_from_file_location(
            "krypy_benchmarks_suite", _ROOT / "benchmarks" / "suite.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _C5A["want"] = mod.config5_nls_newton_recycling(24, auto=True)
    return _C5A["want"]
